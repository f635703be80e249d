"""The strategy-safety cascade in the port against the JAX package's, on
one device (the one-device cases of tests/test_strategy_safety.py and
tests/test_static_analysis.py; the four-rank ones are in
tests/test_torch_strategy_safety.py, whose helpers these share).

The port runs in this process with no process group, the JAX package on
one of its virtual devices, both from the JAX package's weights. Held:
the same rejected plans, counters and final strategy ``describe()``
(the one-device plan is the JAX package's data-parallel mesh of one; the
last resort keeps the one-device path under full remat), the audit
probes' scalars within 1e-5, the memory gate on the port's count of one
eager CPU step, and the obs events and telemetry block of a fallback.
"""
import itertools
import json

import numpy as np
import pytest

import flexflow_tpu_torch.parallel.pcg as port_pcg
from flexflow_tpu_torch.resilience import (AuditError, ChaosPlan,
                                           MemoryBudgetError,
                                           StrategyCompileError,
                                           StrategySafetyError)

import torch_safety_pairs as sfp
from test_torch_strategy_safety import (TOL, _data, _jax_build,
                                        _jax_counters, _jax_fit, _world)
from torch_mesh_pairs import jax_weights


def _port_model(model="mlp2", **config):
    port_pcg._node_guid = itertools.count(1)
    return sfp.build(model, None, **config)


def _pair(model="mlp2", **config):
    """(JAX model on one device, port model) from the same weights."""
    with pytest.MonkeyPatch.context() as mp:
        _world(mp, 1)
        jff = _jax_build(model, **config)
    ff = _port_model(model, **config)
    ff.set_params_numpy(jax_weights(jff))
    return jff, ff


def _one_device_fit(jff, ff, x, y, **chaos):
    with pytest.MonkeyPatch.context() as mp:
        _world(mp, 1)
        want = _jax_fit(jff, x, y, chaos)
    err = ""
    try:
        ff.fit(x, y, epochs=1, chaos=ChaosPlan(**chaos))
    except Exception as e:
        err = e
    return want, err


def test_fallback_last_resort_dp_full_remat():
    """A data-parallel model has no runners-up: the last resort is full
    remat on the same devices (on one process without a process group,
    the one-device path), and a second failure exhausts the chain."""
    x, y = _data()
    jff, ff = _pair(only_data_parallel=True)
    want, err = _one_device_fit(jff, ff, x, y, fail_compiles=1)
    c = ff._last_cascade
    assert err == "" and want["error"] == ""
    assert _jax_counters(c) == want["counters"]
    assert c.final_desc == want["final"] == "mesh=(1,) remat=full"
    assert ff.mesh is None and ff.strategy.remat == "full"
    assert ff.executor.remat_plan.level == "full"
    jff, ff = _pair(only_data_parallel=True)
    want, err = _one_device_fit(jff, ff, x, y, fail_compiles=99, once=False)
    assert isinstance(err, StrategySafetyError) and "exhausted" in str(err)
    assert "exhausted" in want["error"]
    assert [d for d, _r in ff._last_cascade.failures] == want["failed"]
    assert "injected compile failure" in "\n".join(
        r for _d, r in ff._last_cascade.failures)


def test_fallback_off_refuses():
    x, y = _data()
    jff, ff = _pair(strategy_fallback="off", audit_strategy=True)
    want, err = _one_device_fit(jff, ff, x, y, fail_compiles=1)
    assert isinstance(err, StrategyCompileError) and "chaos" in str(err)
    assert want["error"].startswith("StrategyCompileError")
    assert ff._last_cascade.fallbacks == 0 == want["counters"][3]


def test_audit_refusal_without_fallback():
    x, y = _data()
    jff, ff = _pair(audit_strategy=True, strategy_fallback="off")
    want, err = _one_device_fit(jff, ff, x, y, wrong_reshard=True)
    assert isinstance(err, AuditError) and "audit failed" in str(err)
    assert want["error"].startswith("AuditError")
    np.testing.assert_allclose(
        np.array([[r.loss_candidate, r.loss_reference,
                   r.grad_norm_candidate, r.grad_norm_reference,
                   float(r.passed)] for r in ff._last_cascade.audit_reports]),
        want["reports"], **TOL)


def test_memory_budget_gate():
    """A generous budget passes with no fallback; a 1 MiB budget rejects
    both plans (the params alone exceed it) and the diagnosis lists
    them. The port's peak is its count of one eager step on the CPU."""
    x, y = _data(features=256)
    jff, ff = _pair("big", only_data_parallel=True, memory_budget_mb=4096)
    want, err = _one_device_fit(jff, ff, x, y)
    assert err == "" and ff._last_cascade.fallbacks == 0
    assert _jax_counters(ff._last_cascade) == want["counters"]
    (desc, peak), = ff._last_cascade.memory_peaks
    params = sum(a.nbytes for ws in ff.get_params_numpy().values()
                 for a in ws.values())
    assert desc == "mesh=(1,)" and 2 * params < peak < 8 * params
    jff, ff = _pair("big", only_data_parallel=True, memory_budget_mb=1)
    want, err = _one_device_fit(jff, ff, x, y)
    assert isinstance(err, StrategySafetyError)
    assert "exceeds --memory-budget-mb" in str(err) and \
        "exhausted" in str(err)
    assert [d for d, _r in ff._last_cascade.failures] == want["failed"] \
        == ["mesh=(1,)", "mesh=(1,) remat=full"]


def test_memory_budget_enforced_with_fallback_off():
    x, y = _data(features=256)
    jff, ff = _pair("big", only_data_parallel=True, memory_budget_mb=1,
                    strategy_fallback="off")
    want, err = _one_device_fit(jff, ff, x, y)
    assert isinstance(err, MemoryBudgetError) and "exceeds" in str(err)
    assert want["error"].startswith("MemoryBudgetError")


def test_cascade_with_dataset_smaller_than_batch():
    x, y = _data()
    jff, ff = _pair(only_data_parallel=True, audit_strategy=True)
    with pytest.MonkeyPatch.context() as mp:
        _world(mp, 1)
        jff.fit(x[:4], y[:4], epochs=1)
    ff.fit(x[:4], y[:4], epochs=1)
    c = ff._last_cascade
    assert c is not None and c.fallbacks == 0 and c.audits == 0
    assert _jax_counters(c) == _jax_counters(jff._last_cascade)


def test_plain_fit_does_not_arm_cascade():
    x, y = _data()
    ff = _port_model(only_data_parallel=True, checkpoint_dir="",
                     max_bad_steps=0)
    ff.fit(x, y, epochs=1, chaos=ChaosPlan(nan_at_steps={3}))
    assert ff._last_cascade is None


def test_scale_fallback_when_no_reduction_site():
    """A data-parallel graph has no reduction to break: the graph-level
    injection falls back to the grad-norm scale with a warning."""
    x, y = _data(0.25)
    jff, ff = _pair("mlp3", audit_strategy=True, only_data_parallel=True)
    chaos = dict(wrong_reshard=True, wrong_reshard_mode="duplicate")
    with pytest.warns(UserWarning, match="no injection site"):
        want, err = _one_device_fit(jff, ff, x, y, **chaos)
    assert err == "" and want["mode"] == "scale"
    assert ff._last_cascade.audit_failures == 1 == want["counters"][5]
    assert _jax_counters(ff._last_cascade) == want["counters"]


def test_fallback_emits_obs_events(tmp_path):
    """``strategy_fallback`` and ``strategy_fallback_final`` land on the
    tracer, and the telemetry's ``strategy_safety`` block counts the
    hop."""
    from flexflow_tpu_torch import obs

    x, y = _data()
    ff = _port_model(telemetry_file=str(tmp_path / "tel.json"))
    tracer = obs.enable(trace_file=str(tmp_path / "trace.json"))
    try:
        ff.fit(x, y, epochs=1, chaos=ChaosPlan(fail_compiles=1))
        tracer.write(str(tmp_path / "trace.json"))
    finally:
        obs.disable()
    names = [ev.get("name") for ev in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]]
    assert "strategy_fallback" in names
    assert "strategy_fallback_final" in names
    ss = json.loads((tmp_path / "tel.json").read_text())["strategy_safety"]
    assert ss["fallbacks"] == 1
    assert ss["final_strategy"] == ff.strategy.describe()
