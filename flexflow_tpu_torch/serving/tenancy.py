"""Multi-tenant SLO tiers and the weighted fair queue at the fleet door
(port of ``flexflow_tpu.serving.tenancy``, jax-free there and copied
here).

Every request carries a ``tenant`` label and the fleet door schedules
across per-tenant backlogs with virtual finish times instead of a single
FIFO. Three built-in tiers — ``interactive`` / ``standard`` / ``batch`` —
differ in WFQ weight, shed priority, per-tier deadline default and
token-rate quota. The spec string accepted by ``--tenant-tiers``
overrides or extends them:

    NAME:WEIGHT[:DEADLINE_MS[:QUOTA_TOKENS_PER_S]][,NAME:...]

``FFConfig.parse_args`` parses it at parse time, so a malformed spec fails
fast. Scheduling law: the queue is deterministic in the submission
sequence — virtual clocks advance only on append and popleft, never from
wall time — so replaying the same submissions gives the same service
order, and a stream's tokens do not depend on the tenants it is
co-scheduled with.
"""
from __future__ import annotations

import bisect
from collections import deque
from dataclasses import dataclass, replace
from typing import Deque, Dict, Iterator, List, Optional, Tuple

from .scheduler import Request, ServingRejection

# canonical tier names; unknown tenants inherit standard's parameters
# (but keep their own WFQ backlog and accounting rows)
TENANT_TIERS = ("interactive", "standard", "batch")


@dataclass(frozen=True)
class TenantPolicy:
    """Per-tier scheduling parameters enforced at the fleet door."""
    name: str
    # WFQ weight: tokens of service per unit of virtual time.  Higher
    # weight -> earlier virtual finish -> served ahead of heavier
    # backlogs from lighter tenants.
    weight: float = 4.0
    # tier deadline default (ms), applied when the request carries none;
    # 0 = no tier default (config.request_timeout_ms still applies)
    deadline_ms: float = 0.0
    # token-rate quota (tokens/s, burst = 1 s worth); 0 = unlimited
    quota_tokens_per_s: float = 0.0
    # who sheds first under queue pressure: 0 = first, higher = later
    shed_priority: int = 1


_DEFAULT_POLICIES: Dict[str, TenantPolicy] = {
    "interactive": TenantPolicy("interactive", weight=8.0, shed_priority=2),
    "standard": TenantPolicy("standard", weight=4.0, shed_priority=1),
    "batch": TenantPolicy("batch", weight=1.0, shed_priority=0),
}


class QuotaExceededError(ServingRejection):
    """Tenant token-rate quota exhausted; ledgered as ``quota_exceeded``."""


def parse_tenant_tiers(spec: str) -> Dict[str, TenantPolicy]:
    """Parse a ``--tenant-tiers`` spec into a policy dict (fail fast)."""
    out: Dict[str, TenantPolicy] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2 or len(parts) > 4:
            raise ValueError(
                "--tenant-tiers entries must be "
                "NAME:WEIGHT[:DEADLINE_MS[:QUOTA_TOKENS_PER_S]], got "
                f"{entry!r}")
        name = parts[0].strip()
        if not name:
            raise ValueError(f"--tenant-tiers entry has empty name: {entry!r}")
        if name in out:
            raise ValueError(f"--tenant-tiers names {name!r} twice")
        try:
            weight = float(parts[1])
            deadline = float(parts[2]) if len(parts) > 2 else 0.0
            quota = float(parts[3]) if len(parts) > 3 else 0.0
        except ValueError:
            raise ValueError(
                f"--tenant-tiers entry {entry!r}: WEIGHT/DEADLINE_MS/"
                "QUOTA_TOKENS_PER_S must be numeric")
        if weight <= 0:
            raise ValueError(
                f"--tenant-tiers entry {entry!r}: WEIGHT must be > 0")
        if deadline < 0 or quota < 0:
            raise ValueError(
                f"--tenant-tiers entry {entry!r}: DEADLINE_MS and "
                "QUOTA_TOKENS_PER_S must be >= 0")
        base = _DEFAULT_POLICIES.get(name)
        out[name] = TenantPolicy(
            name, weight=weight, deadline_ms=deadline,
            quota_tokens_per_s=quota,
            shed_priority=base.shed_priority if base else 1)
    return out


class TenantRegistry:
    """Policy lookup + token-bucket quota accounting per tenant."""

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None):
        self.policies: Dict[str, TenantPolicy] = dict(_DEFAULT_POLICIES)
        if policies:
            self.policies.update(policies)
        # tenant -> (allowance_tokens, last_refill_ms)
        self._buckets: Dict[str, Tuple[float, float]] = {}

    @classmethod
    def from_config(cls, config) -> "TenantRegistry":
        spec = getattr(config, "tenant_tiers", "") or ""
        return cls(parse_tenant_tiers(spec) if spec else None)

    def policy(self, tenant: Optional[str]) -> TenantPolicy:
        name = tenant or "standard"
        pol = self.policies.get(name)
        if pol is None:
            # unknown tenants get standard's parameters under their own
            # name so WFQ backlogs and ledgers stay per-tenant
            pol = replace(self.policies["standard"], name=name)
        return pol

    def max_shed_priority(self) -> int:
        return max((p.shed_priority for p in self.policies.values()),
                   default=1)

    def charge(self, tenant: Optional[str], tokens: int,
               now_ms: float) -> Tuple[bool, float]:
        """Debit ``tokens`` from the tenant's bucket.

        Returns ``(ok, retry_after_ms)`` — retry_after_ms is how long
        until the bucket refills enough, 0 when the charge succeeded or
        the tenant has no quota.
        """
        pol = self.policy(tenant)
        rate = float(pol.quota_tokens_per_s)
        if rate <= 0:
            return True, 0.0
        burst = rate  # 1 s worth
        allowance, last = self._buckets.get(pol.name, (burst, now_ms))
        allowance = min(burst, allowance + rate * max(now_ms - last, 0.0) / 1e3)
        if allowance >= tokens:
            self._buckets[pol.name] = (allowance - tokens, now_ms)
            return True, 0.0
        self._buckets[pol.name] = (allowance, now_ms)
        return False, (tokens - allowance) / rate * 1e3


class WeightedFairQueue:
    """Virtual-finish-time fair queue over per-tenant backlogs.

    Service order: a request's virtual finish time is
    ``max(vclock, last_vft[tenant]) + max_new_tokens / weight``; the
    queue pops ascending VFT with submission sequence as tie-break, and
    the virtual clock advances to each popped VFT.  Single-tenant
    traffic therefore degenerates to exact FIFO, and a saturating
    low-weight tenant can displace a fresh high-weight request by at
    most one quantum (its own in-progress entry) — the no-starvation
    property the tests pin.

    ``appendleft`` feeds a rescue lane served before the fair queue:
    migration re-queues use it so harvested in-flight work stays ahead
    of queued work (the migration order), bypassing VFT accounting.

    The API is deque-compatible (append/appendleft/extend/popleft/
    len/iter/clear/delitem) so existing fleet code and tests that poke
    ``fleet.queue`` keep working.
    """

    def __init__(self, registry: Optional[TenantRegistry] = None):
        self.registry = registry or TenantRegistry()
        self._rescue: Deque[Request] = deque()
        self._order: List[Tuple[float, int, Request]] = []
        self._seq = 0
        self._vclock = 0.0
        self._last_vft: Dict[str, float] = {}

    def _vft(self, req: Request) -> float:
        pol = self.registry.policy(getattr(req, "tenant", None))
        cost = max(int(req.max_new_tokens), 1) / max(pol.weight, 1e-9)
        return max(self._vclock, self._last_vft.get(pol.name, 0.0)) + cost

    def append(self, req: Request) -> None:
        pol = self.registry.policy(getattr(req, "tenant", None))
        vft = self._vft(req)
        self._last_vft[pol.name] = vft
        bisect.insort(self._order, (vft, self._seq, req))
        self._seq += 1

    def appendleft(self, req: Request) -> None:
        self._rescue.appendleft(req)

    def extend(self, reqs) -> None:
        for r in reqs:
            self.append(r)

    def popleft(self) -> Request:
        if self._rescue:
            return self._rescue.popleft()
        if not self._order:
            raise IndexError("pop from an empty WeightedFairQueue")
        vft, _seq, req = self._order.pop(0)
        self._vclock = max(self._vclock, vft)
        return req

    def clear(self) -> None:
        self._rescue.clear()
        self._order.clear()

    def __len__(self) -> int:
        return len(self._rescue) + len(self._order)

    def __bool__(self) -> bool:
        return bool(self._rescue) or bool(self._order)

    def __iter__(self) -> Iterator[Request]:
        # iteration order == service order (rescue lane first), so
        # remove_by_identity() indexes line up with __delitem__
        yield from self._rescue
        for _vft, _seq, req in self._order:
            yield req

    def __delitem__(self, i: int) -> None:
        if i < len(self._rescue):
            del self._rescue[i]
        else:
            del self._order[i - len(self._rescue)]

    def queued_by_tenant(self) -> Dict[str, int]:
        """Door depth per explicit tenant (untenanted requests omitted)."""
        out: Dict[str, int] = {}
        for req in self:
            t = getattr(req, "tenant", None)
            if t:
                out[t] = out.get(t, 0) + 1
        return out

    def backlog_tokens_ahead(self, tenant: Optional[str]) -> int:
        """Tokens scheduled before a hypothetical new ``tenant`` request.

        Prices the rejected tenant's own virtual queue position: the
        rescue lane plus every queued entry whose VFT sorts at or before
        the virtual start a new request of this tenant would receive.
        """
        pol = self.registry.policy(tenant)
        start = max(self._vclock, self._last_vft.get(pol.name, 0.0))
        # a one-token probe request of this tenant would finish at:
        probe_vft = start + 1.0 / max(pol.weight, 1e-9)
        ahead = sum(max(int(r.max_new_tokens), 1) for r in self._rescue)
        for vft, _seq, req in self._order:
            if vft <= probe_vft:
                ahead += max(int(req.max_new_tokens), 1)
        return ahead
