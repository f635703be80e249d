"""Three small faults of the port against the JAX package, repaired, each
held against the JAX package on the CPU:

* ``--tenant-tiers`` is parsed at parse time (``serving/tenancy.py``,
  copied from the JAX package): the malformed specs of
  ``tests/test_multitenant.py`` raise ``ValueError`` in both packages'
  ``FFConfig.parse_args``, and both accept a valid spec and the empty
  default, with equal policies.
* ``save_checkpoint``, ``restore_checkpoint``, ``latest_checkpoint`` and
  ``ChaosPlan`` are exported at the top level, as by the JAX package.
* ``ServingStats.batch_occupancy(n_slots)`` and ``prefix_reuse_rate()``
  exist and give the JAX values on the same counters; ``summary()``
  reads the reuse rate from the method. Exact equality: both are the same
  float division.
"""
import dataclasses

import pytest

import flexflow_tpu as fj
import flexflow_tpu_torch as ft
from flexflow_tpu.serving import ServingStats as JaxServingStats
from flexflow_tpu.serving.tenancy import \
    parse_tenant_tiers as jax_parse_tenant_tiers
from flexflow_tpu_torch.serving import ServingStats, parse_tenant_tiers

BAD_TIERS = ("gold", "gold:0", "gold:-1", "gold:2:x", "a:1,a:2",
             "gold:1:2:3:4", ":1")


@pytest.mark.parametrize("spec", BAD_TIERS)
def test_malformed_tenant_tiers_raise_at_parse_in_both_packages(spec):
    for pkg in (fj, ft):
        with pytest.raises(ValueError):
            pkg.FFConfig().parse_args(["--tenant-tiers", spec])


@pytest.mark.parametrize("spec", ["gold:8:500:1000,bronze:1", "",
                                  "interactive:3,batch:0.5:20"])
def test_valid_tenant_tiers_parse_alike(spec):
    for pkg in (fj, ft):
        c = pkg.FFConfig()
        c.parse_args(["--tenant-tiers", spec])
        assert c.tenant_tiers == spec
    ours = {k: dataclasses.asdict(v)
            for k, v in parse_tenant_tiers(spec).items()}
    theirs = {k: dataclasses.asdict(v)
              for k, v in jax_parse_tenant_tiers(spec).items()}
    assert ours == theirs


def test_top_level_exports():
    from flexflow_tpu_torch import (ChaosPlan, latest_checkpoint,
                                    restore_checkpoint, save_checkpoint)
    from flexflow_tpu_torch.execution import checkpoint
    from flexflow_tpu_torch.resilience import chaos

    assert save_checkpoint is checkpoint.save_checkpoint
    assert restore_checkpoint is checkpoint.restore_checkpoint
    assert latest_checkpoint is checkpoint.latest_checkpoint
    assert ChaosPlan is chaos.ChaosPlan
    for name in ("save_checkpoint", "restore_checkpoint",
                 "latest_checkpoint", "ChaosPlan"):
        assert hasattr(fj, name) and hasattr(ft, name)


COUNTERS = [
    dict(),
    dict(tokens_generated=10, prefills=2, decode_steps=4),
    dict(tokens_generated=30, prefills=3, decode_steps=9,
         prefix_tokens_reused=40, prefill_tokens_computed=24),
    dict(tokens_generated=3, prefills=5, decode_steps=1,
         prefill_tokens_computed=7),
    dict(prefix_tokens_reused=5),
]


@pytest.mark.parametrize("counters", COUNTERS)
def test_serving_stats_rates_match_jax(counters):
    ours, theirs = ServingStats(), JaxServingStats()
    for k, v in counters.items():
        setattr(ours, k, v)
        setattr(theirs, k, v)
    for n_slots in (1, 2, 8):
        assert ours.batch_occupancy(n_slots) == \
            theirs.batch_occupancy(n_slots)
    assert ours.prefix_reuse_rate() == theirs.prefix_reuse_rate()
    a, b = ours.summary(), theirs.summary()
    assert a.get("prefix_reuse_rate") == b.get("prefix_reuse_rate")
