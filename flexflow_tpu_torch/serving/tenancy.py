"""Multi-tenant SLO tiers: the ``--tenant-tiers`` spec and its policies
(port of the parser half of ``flexflow_tpu.serving.tenancy``, jax-free
there and copied here).

Three built-in tiers — ``interactive`` / ``standard`` / ``batch`` — differ
in WFQ weight, shed priority, per-tier deadline default and token-rate
quota. The spec string accepted by ``--tenant-tiers`` overrides or extends
them:

    NAME:WEIGHT[:DEADLINE_MS[:QUOTA_TOKENS_PER_S]][,NAME:...]

``FFConfig.parse_args`` parses it at parse time, so a malformed spec fails
fast as in the JAX package. The registry, the weighted fair queue and the
quota rejection apply the tiers at the serving fleet's door and come with
the fleet (ROADMAP A.8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

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
