"""flexflow_tpu_torch.serving: prefill/decode over the paged KV pool or the
ring with continuous batching, the prefix cache and chunked prefill,
serving under failure (deadlines, load shedding, the guarded decode with
per-slot quarantine, the graceful drain), LSTM graphs with their carry as
decode state, and greedy speculative decoding."""
from .kvcache import (DecodeState, GARBAGE_BLOCK,  # noqa: F401
                      KV_DTYPES, ServingState)
from .scheduler import (BlockAccountingError, BlockAllocator,  # noqa: F401
                        ContextOverflowError, ContinuousBatchScheduler,
                        QueueFullError, Request, ServingRejection,
                        bucket_for, default_buckets)
from .prefix import PrefixCache, PrefixNode  # noqa: F401
from .engine import ServingEngine, ServingStats  # noqa: F401
from .resilience import (AdmissionController, OUTCOMES,  # noqa: F401
                         OverloadError, ServingResilience)
from .speculative import SpeculativeDecoder  # noqa: F401
from .tenancy import (TENANT_TIERS, TenantPolicy,  # noqa: F401
                      parse_tenant_tiers)
