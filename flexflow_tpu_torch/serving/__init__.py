"""flexflow_tpu_torch.serving: prefill/decode over the paged KV pool with
continuous batching, the prefix cache and chunked prefill."""
from .kvcache import DecodeState, GARBAGE_BLOCK, ServingState  # noqa: F401
from .scheduler import (BlockAccountingError, BlockAllocator,  # noqa: F401
                        ContextOverflowError, ContinuousBatchScheduler,
                        QueueFullError, Request, ServingRejection,
                        bucket_for, default_buckets)
from .prefix import PrefixCache, PrefixNode  # noqa: F401
from .engine import ServingEngine, ServingStats  # noqa: F401
