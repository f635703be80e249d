"""The strategy-safety cascade in the port against the JAX package's
(the cases of tests/test_strategy_safety.py and the cascade cases of
tests/test_static_analysis.py).

Both packages run each case at the same world: four ranks (the port's
gloo processes, ``tests/torch_safety_pairs.py``; the JAX package with
``jax.devices`` cut to four of its virtual devices) for the searched,
tensor-parallel and pipeline plans, one device (the port in this process,
with no process group; the JAX package on one virtual device) for the
data-parallel ones. The search prices both on the same machine fields
(``tests/torch_search_pairs.jax_fields``), so it ranks the same plans;
every case starts from the JAX package's weights. Held: the same fallback
path (the rejected plans, in order), the same counters and final
strategy ``describe()``, and the audit probes' loss and grad norm within
1e-5 of the JAX ones (fp32). The compile probe leaves the params, the
optimizer's step count and ``_rng_counter`` bitwise as they were, and a
weight edited before ``fit`` survives a fallback hop. The port's own
additions: every rank of the world reaches the same verdicts, and the
``drop`` injection's dynamic effect is recorded against the JAX one.
"""
import itertools

import numpy as np
import pytest

import jax

import flexflow_tpu as fj
import flexflow_tpu.parallel.pcg as jax_pcg
from flexflow_tpu.parallel import strategies as jax_strategies
from flexflow_tpu.parallel.strategy import \
    data_parallel_strategy as jax_dp_strategy
from flexflow_tpu.resilience import ChaosPlan as JaxChaosPlan
from flexflow_tpu.resilience import StrategyCascade as JaxCascade
from flexflow_tpu.resilience import audit_strategy as jax_audit
from flexflow_tpu.search.machine_model import TPUMachineModel
from flexflow_tpu_torch.search.machine_model import GPUMachineModel

import torch_dist_pairs as tp
import torch_safety_pairs as sfp
import torch_search_pairs as sp
from torch_mesh_pairs import jax_weights, write_case

WORLD = 4
BATCH = 8
TOL = dict(rtol=1e-5, atol=1e-5)
# slow compute, fast links: the search ranks tensor-parallel plans first
MACHINE = ("generation = h100-sxm\npeak_flops = 1e9\n"
           "hbm_bandwidth = 1e13\nici_bandwidth = 1e12\n"
           "ici_latency = 1e-12\nmatmul_efficiency = 0.8\n"
           "hbm_efficiency = 0.5\nupdate_hbm_efficiency = 0.5\n"
           "matmul_flops_f32 = 0\n")


def _data(scale=1.0, features=16, n=64):
    rng = np.random.default_rng(0)
    x = scale * rng.normal(size=(n, features)).astype(np.float32)
    return x.astype(np.float32), rng.integers(0, 10, size=n).astype(
        np.int32)


# the four-rank fits train two steps
W4_SAMPLES = 2 * BATCH


# ------------------------------------------------------------ JAX side
def _jax_build(model, strategy=None, **config):
    """``torch_safety_pairs.build`` in the JAX package."""
    c = fj.FFConfig()
    c.batch_size, c.search_budget = BATCH, 8
    c.enable_sequence_parallel = False
    for k, v in config.items():
        if k not in ("machine_model_version", "machine_model_file"):
            setattr(c, k, v)
    ff = fj.FFModel(c)
    if model == "big":
        x = ff.create_tensor((BATCH, 256), name="x")
        t = ff.relu(ff.dense(x, 512, name="d1"))
        t = ff.dense(ff.dense(t, 512, name="d2"), 10, name="d3")
    else:
        x = ff.create_tensor((BATCH, 16), name="x")
        t = ff.relu(ff.dense(x, 32, name="d1"))
        if model == "mlp3":
            t = ff.relu(ff.dense(t, 32, name="d2"))
            ff.softmax(ff.dense(t, 10, name="d3"), name="probs")
        else:
            ff.dense(t, 10, name="d2")
    fn = None
    if strategy:
        kind, *sizes = strategy.split(":")
        a, b = ([int(s) for s in sizes] + [1, 1])[:2]
        if kind == "dp":
            def fn(pcg):
                return jax_dp_strategy(pcg, a)
        elif kind == "hybrid":
            def fn(pcg):
                return jax_strategies.hybrid_data_tensor_strategy(
                    pcg, a, b)
        else:
            def fn(pcg):
                s = jax_dp_strategy(pcg, WORLD)
                s.pipeline = (a, b, 2)
                return s
    ff.compile(optimizer=fj.SGDOptimizer(ff, lr=0.05),
               loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy_fn=fn)
    return ff


def _jax_counters(c):
    return [c.static_checks, c.static_rejects, c.compile_probes,
            c.fallbacks, c.audits, c.audit_failures]


def _jax_reports(c):
    return np.array([[r.loss_candidate, r.loss_reference,
                      r.grad_norm_candidate, r.grad_norm_reference,
                      float(r.passed)] for r in c.audit_reports]
                    ).reshape(-1, 5)


def _jax_fit(ff, x, y, chaos):
    plan = JaxChaosPlan(**chaos)
    err = ""
    try:
        ff.fit(x, y, epochs=1, chaos=plan)
    except Exception as e:
        err = f"{type(e).__name__}: {e}"
    c = ff._last_cascade
    return dict(final=c.final_desc, counters=_jax_counters(c),
                rules=list(c.static_rules),
                failed=[d for d, _r in c.failures],
                reasons=[r for _d, r in c.failures],
                reports=_jax_reports(c), error=err,
                defect=plan.injected_defect, mode=plan.wrong_reshard_mode,
                injected=plan.wrong_reshards_injected)


def _world(mp, n, machine_path=None):
    """Cut the JAX package's devices to ``n`` (its fallback, preflight and
    mesh read ``jax.devices()``), and detect ``machine_path``'s machine."""
    real = jax.devices
    mp.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:n])
    if machine_path:
        mp.setattr(TPUMachineModel, "detect", staticmethod(
            lambda num_chips=None, **k: TPUMachineModel(**sp.jax_fields(
                GPUMachineModel.from_file(machine_path, num_chips or n)))))


# (name, rank case, model, strategy, config, chaos / extra, data scale)
W4_CASES = [
    ("compile_fail", "fit", "mlp2", None, {}, dict(fail_compiles=1), 1.0),
    ("preserved", "preverify", "mlp2", None, {}, dict(fail_compiles=1),
     1.0),
    ("probe", "preverify", "mlp2", None, dict(audit_strategy=True), {},
     1.0),
    ("audit_dp", "audit", "mlp2", "dp:4", {}, {}, 1.0),
    ("audit_hybrid", "audit", "mlp2", "hybrid:2:2", {}, {}, 1.0),
    ("audit_searched", "audit", "mlp2", None, {}, {}, 1.0),
    ("audit_remat", "audit", "mlp2", "dp:4", dict(remat="full"), {}, 1.0),
    ("audit_pipe", "audit", "mlp2", "pipe:2:2", {}, {}, 1.0),
    ("audit_reject", "fit", "mlp2", None, dict(audit_strategy=True),
     dict(wrong_reshard=True), 1.0),
    ("static_dup", "fit", "mlp3", "hybrid:2:2", dict(audit_strategy=True),
     dict(wrong_reshard=True, wrong_reshard_mode="duplicate"), 0.25),
    ("dynamic_dup", "fit", "mlp3", "hybrid:2:2",
     dict(audit_strategy=True, static_analysis="off"),
     dict(wrong_reshard=True, wrong_reshard_mode="duplicate",
          wrong_reshard_factor=4.0), 0.25),
    ("drop", "fit", "mlp3", "hybrid:2:2",
     dict(audit_strategy=True, static_analysis="off"),
     dict(wrong_reshard=True, wrong_reshard_mode="drop"), 0.25),
]


def _jax_case(ff, kind, chaos, x, y):
    """The JAX package's run of a case on its compiled model ``ff``."""
    if kind == "fit":
        return _jax_fit(ff, x, y, chaos)
    if kind == "audit":
        r = jax_audit(ff, x[:BATCH], y[:BATCH], tol=0.05)
        return dict(report=[r.loss_candidate, r.loss_reference,
                            r.grad_norm_candidate, r.grad_norm_reference,
                            float(r.passed)], strategy=r.strategy)
    cascade = JaxCascade.maybe_create(ff, JaxChaosPlan(**chaos))
    cascade.preverify([x], ff._prep_label(y), BATCH)
    return dict(counters=_jax_counters(cascade), final=cascade.final_desc,
                reports=_jax_reports(cascade))


def w4_runs(tmp_path_factory, names):
    """The ``W4_CASES`` named: the JAX package's results, and the port's
    four gloo ranks' under ``root``; (root, {name: JAX result})."""
    root = str(tmp_path_factory.mktemp("safety"))
    path = f"{root}/machine.cfg"
    with open(path, "w") as f:
        f.write(MACHINE)
    machine = dict(machine_model_version=1, machine_model_file=path)
    cases, models, want = [], {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _world(mp, WORLD, path)
        # the JAX models first (their weights are the cases' inputs), then
        # the JAX runs while the ranks run theirs
        for name, kind, model, strategy, config, chaos, scale in W4_CASES:
            if name not in names:
                continue
            x, y = _data(scale, n=W4_SAMPLES)
            mp.setattr(jax_pcg, "_node_guid", itertools.count(1))
            models[name] = _jax_build(model, strategy, **config)
            write_case(root, name, x, y, jax_weights(models[name]))
            cases.append((name, kind, dict(
                model=model, strategy=strategy, chaos=chaos,
                edit=name == "preserved", config=dict(config, **machine))))
        procs = tp.start(WORLD, root, cases, main=sfp.rank_main)
        for name, kind, _m, _s, _c, chaos, scale in W4_CASES:
            if name in names:
                want[name] = _jax_case(models[name], kind, chaos,
                                       *_data(scale, n=W4_SAMPLES))
    tp.finish(procs, root, timeout=240)
    return root, want


DEFECTS = ("static_dup", "dynamic_dup", "drop")


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    return w4_runs(tmp_path_factory,
                   [c[0] for c in W4_CASES if c[0] not in DEFECTS])


def _ranks(root, name):
    return [tp.load(root, name, r) for r in range(WORLD)]


def same_path_on_every_rank(runs, name):
    """The same rejected plans, counters and final strategy on every rank
    as the JAX package at the same world; the audits' scalars within
    1e-5; no rank raised."""
    root, want = runs
    want = want[name]
    for g in _ranks(root, name):
        assert str(g["error"]) == "" and want["error"] == ""
        assert str(g["final"]) == want["final"] == str(g["live"])
        assert g["counters"].tolist() == want["counters"]
        assert list(g["rules"]) == want["rules"]
        assert list(g["failed"]) == want["failed"]
        assert str(g["mode"]) == want["mode"]
        assert int(g["injected"]) == want["injected"]
        np.testing.assert_allclose(g["reports"], want["reports"], **TOL)
        assert np.isfinite(g["losses"]).all() and \
            len(g["losses"]) == W4_SAMPLES // BATCH


@pytest.mark.parametrize("name", ["compile_fail", "audit_reject"])
def test_the_cascade_takes_the_jax_path_on_every_rank(w4, name):
    same_path_on_every_rank(w4, name)


def test_compile_failure_falls_to_the_ranked_runner_up(w4):
    root, want = w4
    g = _ranks(root, "compile_fail")[0]
    assert want["compile_fail"]["failed"] == ["mesh=(1, 4)"]
    assert str(g["final"]) == "mesh=(2, 2)"
    assert "injected compile failure" in str(g["reasons"][0])
    assert g["counters"].tolist() == [2, 0, 2, 1, 0, 0]


def test_scale_injection_fails_the_audit_and_falls_back(w4):
    root, want = w4
    g = _ranks(root, "audit_reject")[0]
    assert g["counters"].tolist()[3:] == [1, 2, 1]
    np.testing.assert_allclose(g["reports"][0, 2], 2 * g["reports"][0, 3],
                               rtol=1e-5)
    assert str(g["final"]) != want["audit_reject"]["failed"][0]


@pytest.mark.parametrize("name", ["audit_dp", "audit_hybrid",
                                  "audit_searched", "audit_remat",
                                  "audit_pipe"])
def test_audit_passes_legitimate_strategies(w4, name):
    """dp, tensor-parallel, searched, remat and pipeline plans agree with
    the one-device reference, and their scalars are the JAX package's."""
    root, want = w4
    for g in _ranks(root, name):
        np.testing.assert_allclose(g["report"], want[name]["report"], **TOL)
        assert g["report"][4] == 1.0
        assert str(g["strategy"]) == want[name]["strategy"]


def test_fallback_preserves_preseeded_weights(w4):
    root, _want = w4
    for g in _ranks(root, "preserved"):
        assert g["counters"][3] == 1
        assert np.all(g["after/d1_0/bias"] == 0.125)
        for k in g:
            if k.startswith("before/"):
                np.testing.assert_array_equal(
                    g["after/" + k[len("before/"):]], g[k])


def test_compile_probe_and_audit_leave_the_run_as_it_was(w4):
    """No fallback: the probe step ran on clones, so the params, the
    optimizer's step count and ``_rng_counter`` are bitwise unchanged; the
    audit's scalars are the JAX ones."""
    root, want = w4
    for g in _ranks(root, "probe"):
        assert g["counters"].tolist() == want["probe"]["counters"]
        assert g["step"][0] == g["step"][1] and g["rng"][0] == g["rng"][1]
        for k in g:
            if k.startswith("before/"):
                np.testing.assert_array_equal(
                    g["after/" + k[len("before/"):]], g[k])
        np.testing.assert_allclose(g["reports"], want["probe"]["reports"],
                                   **TOL)


