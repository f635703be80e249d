"""``preflight_config`` in the port against the JAX package's.

Each case sets one doomed flag combination as attributes of a fresh
config in both packages. Both ``preflight_config`` functions raise
``PreflightError`` on it, and both ``compile`` calls raise it first (the
port's ``compile`` runs the check before any other work, as the JAX one
does, so an attribute set after parsing is judged too). The missing
``--calibrate-from-trace`` file is the exception: the port raises
``PreflightError``; the JAX function raises ``UnboundLocalError`` (its
function-local ``import os`` shadows the module's), a reference condition
recorded here as it is.
"""
import os

import pytest

import flexflow_tpu as fj
import flexflow_tpu_torch as ft
from flexflow_tpu.resilience.preflight import (
    PreflightError as JaxPreflightError, preflight_config as jax_preflight)
from flexflow_tpu_torch.resilience.preflight import (PreflightError,
                                                      preflight_config)

MISSING = "/nonexistent-dir-for-preflight/x"

# (case id, attribute settings, a phrase of the message both raise)
CASES = [
    ("strategy_fallback", dict(strategy_fallback="maybe"),
     "--strategy-fallback"),
    ("audit_tol", dict(audit_tol=0), "--audit-tol"),
    ("memory_budget", dict(memory_budget_mb=-1), "--memory-budget-mb"),
    ("keep_checkpoints", dict(checkpoint_dir="ck", keep_checkpoints=0),
     "--keep-checkpoints"),
    ("resume_auto", dict(resume="auto"), "--resume auto"),
    ("remat", dict(remat="some"), "--remat"),
    ("schedule", dict(schedule="zigzag"), "--schedule"),
    ("virtual_stages_1", dict(pipeline_virtual_stages=1),
     "--virtual-stages"),
    ("virtual_stages_schedule",
     dict(pipeline_virtual_stages=2, schedule="1f1b"), "interleaved"),
    ("collective_overlap", dict(collective_overlap="maybe"),
     "--collective-overlap"),
    ("static_analysis", dict(static_analysis="loud"), "--static-analysis"),
    ("drift_tolerance", dict(drift_tolerance=0), "--drift-tolerance"),
    ("auto_recalibrate", dict(auto_recalibrate=True), "--profile-ops"),
    ("pods", dict(num_pods=-1), "--pods"),
    ("dcn_gbps_negative", dict(dcn_gbps=-1.0), "--dcn-gbps"),
    ("dcn_gbps_one_pod", dict(dcn_gbps=10.0), "multi-pod"),
    ("hierarchical_search", dict(search_hierarchical="always"),
     "--hierarchical-search"),
    ("serve_loop", dict(serve_loop="fast"), "--serve-loop"),
    ("seq_shards", dict(seq_shards=0), "--seq-shards"),
    ("seq_shards_ring", dict(seq_shards=2, kv_cache="ring"),
     "--kv-cache paged"),
    ("context_buckets", dict(context_buckets="4096,1024"),
     "--context-buckets"),
    ("context_buckets_ring", dict(context_buckets="1024", kv_cache="ring"),
     "--kv-cache paged"),
    ("autoscale", dict(autoscale="auto"), "--autoscale"),
    ("replicas_negative", dict(min_replicas=-1, autoscale="on"),
     "--min-replicas"),
    ("replicas_without_autoscale", dict(max_replicas=4),
     "--autoscale on"),
    ("replicas_order", dict(min_replicas=4, max_replicas=2,
                            autoscale="on"), "--max-replicas"),
    ("tenant_tiers", dict(tenant_tiers="gold"), "--tenant-tiers"),
    ("journal_negative", dict(journal_sync_ms=-1.0), "--journal-sync-ms"),
    ("journal_without_dir", dict(journal_commit_every=4),
     "--request-journal"),
    ("journal_parent", dict(request_journal=MISSING + "/journal"),
     "parent directory"),
]


def _configs(settings):
    jc, tc = fj.FFConfig(), ft.FFConfig()
    for c in (jc, tc):
        c.batch_size = 4
        for k, v in settings.items():
            setattr(c, k, v)
    return jc, tc


def _tiny(pkg, config, **model_kw):
    ff = pkg.FFModel(config, **model_kw)
    ff.dense(ff.create_tensor((4, 8)), 3)
    ff.compile(loss_type=pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    return ff


@pytest.mark.parametrize("settings,phrase",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_both_packages_refuse_the_same_setting(settings, phrase):
    jc, tc = _configs(settings)
    with pytest.raises(JaxPreflightError) as je:
        jax_preflight(jc)
    with pytest.raises(PreflightError) as te:
        preflight_config(tc)
    assert phrase in str(je.value) and str(te.value) == str(je.value)
    # compile judges the attribute before any other work, in both
    with pytest.raises(JaxPreflightError):
        _tiny(fj, jc)
    with pytest.raises(PreflightError, match=phrase.replace("-", r"\-")):
        _tiny(ft, tc, device="cpu")


def test_missing_calibration_trace_raises_preflight_error_in_the_port():
    """The JAX function reaches its function-local ``import os`` only
    after the read, so the flag raises ``UnboundLocalError`` there (a
    reference condition); the port raises the ``PreflightError`` the
    check was written to raise."""
    jc, tc = _configs(dict(calibrate_from_trace=MISSING + ".jsonl"))
    with pytest.raises(UnboundLocalError):
        jax_preflight(jc)
    with pytest.raises(PreflightError, match="no such profile file"):
        preflight_config(tc)
    with pytest.raises(PreflightError, match="--calibrate-from-trace"):
        _tiny(ft, tc, device="cpu")


def test_sound_settings_pass_both(tmp_path):
    """The defaults and a sound combination of every checked flag pass
    both functions; the port compiles with them."""
    trace = tmp_path / "ops.jsonl"
    trace.write_text("")
    settings = dict(
        strategy_fallback="off", audit_tol=0.1, memory_budget_mb=0,
        checkpoint_dir=str(tmp_path / "ck"), keep_checkpoints=1,
        resume="auto", remat="full", schedule="interleaved",
        pipeline_virtual_stages=2, collective_overlap="on",
        static_analysis="strict", drift_tolerance=0.5,
        auto_recalibrate=True, profile_ops=str(tmp_path / "p.jsonl"),
        num_pods=2, dcn_gbps=25.0, search_hierarchical="on",
        serve_loop="async", context_buckets="1024,4096", autoscale="on",
        min_replicas=1, max_replicas=2, tenant_tiers="gold:2,free:1",
        request_journal=str(tmp_path / "journal"), journal_sync_ms=5.0)
    for s in ({}, settings):
        jc, tc = _configs(s)
        jax_preflight(jc)
        preflight_config(tc)
    _, tc = _configs(dict(settings, calibrate_from_trace=str(trace)))
    preflight_config(tc)
    assert os.path.isfile(str(trace))
