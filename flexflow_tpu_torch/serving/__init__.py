"""flexflow_tpu_torch.serving: prefill/decode over the paged KV pool or the
ring with continuous batching, the prefix cache and chunked prefill,
serving under failure (deadlines, load shedding, the guarded decode with
per-slot quarantine, the graceful drain, device-loss failover), LSTM
graphs with their carry as decode state, greedy speculative decoding, the
serving search, and the serving fleet with tenancy at its door and the
request journal."""
from .kvcache import (DecodeState, GARBAGE_BLOCK,  # noqa: F401
                      KV_DTYPES, ServingState)
from .scheduler import (BlockAccountingError, BlockAllocator,  # noqa: F401
                        ContextOverflowError, ContinuousBatchScheduler,
                        QueueFullError, Request, ServingRejection,
                        bucket_for, default_buckets)
from .prefix import PrefixCache, PrefixNode  # noqa: F401
from .engine import ServingEngine, ServingStats  # noqa: F401
from .speculative import SpeculativeDecoder  # noqa: F401
from .resilience import (AdmissionController,  # noqa: F401
                         DecodeStateLostError, DeviceLossError,
                         OUTCOMES, OverloadError, ServingResilience)
from .search import (ServingCandidate, ServingPlan,  # noqa: F401
                     ServingSearchError, serving_search)
from .tenancy import (QuotaExceededError, TENANT_TIERS,  # noqa: F401
                      TenantPolicy, TenantRegistry, WeightedFairQueue,
                      parse_tenant_tiers)
from .journal import (JournalCorruptError, NOOP_JOURNAL,  # noqa: F401
                      NoopJournal, RequestJournal, journal_from_config)
from .fleet import (CircuitBreaker, FLEET_HEALTH,  # noqa: F401
                    FLEET_MIN_RETRY_AFTER_MS, FleetCrashed, FleetReplica,
                    FleetStats, ServingFleet, lint_replica_plans,
                    plan_replicas)
