"""The drift sentinel, the re-ranking and the closed calibration loop in
the port against the JAX package's (tests/test_calibration.py).

The cross-package comparisons use fixed ``OpRecord``\\ s, no clocks: both
simulators price the same four-dense MLP on the same machine fields
(``tests/torch_search_pairs.jax_fields``: the port's fp32 matmul rate off,
the JAX rule), the per-op overhead zeroed so a calibration bend is a lie
of its full size, and every record's measured time is fixed. The
sentinel's per-key and aggregate ratios agree within 1e-6 and it flags
the same keys, before and after one key's calibration is bent 5x; the
repair (``calibrate_from_profile``) and ``rerank_candidates`` re-price to
the same times and order. One fit-level closed loop runs in the port
alone, on the CPU's clock: a key perturbed 8x is flagged and repaired
into the band (which key is worst, or whether another key also leaves
the band, depends on the clock's noise and is not asserted).
"""
import dataclasses
import json

import numpy as np
import pytest

import flexflow_tpu as fj
import flexflow_tpu_torch as ft
from flexflow_tpu.obs.drift import DriftSentinel as JaxSentinel
from flexflow_tpu.obs.profile import OpRecord as JaxRecord
from flexflow_tpu.search.calibration import \
    rerank_candidates as jax_rerank
from flexflow_tpu.search.machine_model import TPUMachineModel
from flexflow_tpu.search.simulator import OpSharding as JaxSharding
from flexflow_tpu.search.simulator import Simulator as JaxSimulator
from flexflow_tpu.search.unity import RankedCandidate as JaxCandidate
from flexflow_tpu_torch.obs.drift import DriftSentinel
from flexflow_tpu_torch.obs.profile import OpProfile, OpRecord
from flexflow_tpu_torch.search.calibration import rerank_candidates
from flexflow_tpu_torch.search.machine_model import GPUMachineModel
from flexflow_tpu_torch.search.simulator import OpSharding, Simulator
from flexflow_tpu_torch.search.unity import RankedCandidate

import torch_search_pairs as sp

REL = 1e-6


def _mlp(pkg, batch=16, **cfg):
    """Four dense layers, the two middle ones the same op shape (one key
    for two nodes), and a softmax (tests/test_calibration.py:34-52)."""
    c = pkg.FFConfig()
    c.batch_size = batch
    for k, v in cfg.items():
        setattr(c, k, v)
    ff = pkg.FFModel(c, device="cpu") if pkg is ft else pkg.FFModel(c)
    t = ff.create_tensor((batch, 8))
    for width, act in ((16, True), (16, True), (16, True), (4, False)):
        t = ff.dense(t, width, pkg.ActiMode.AC_MODE_RELU if act
                     else pkg.ActiMode.AC_MODE_NONE)
    ff.softmax(t)
    ff.compile(optimizer=pkg.AdamOptimizer(ff, alpha=0.01),
               loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[pkg.MetricsType.METRICS_ACCURACY])
    return ff


def _sims():
    machine = GPUMachineModel.detect(1, device="cpu")
    jsim = JaxSimulator(TPUMachineModel(**sp.jax_fields(machine)))
    tsim = Simulator(machine)
    for s in (jsim, tsim):
        s.op_overhead = 0.0
    return jsim, tsim


def _records(sim, pcg, rec_cls, sh_cls, scale):
    """One record a distinct key, in node order; measured = the fixed
    ``scale`` of its position times 10 us."""
    out, seen = [], set()
    for node in pcg.compute_nodes():
        ins = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
        k = repr(sim._op_key(node, ins))
        if k in seen:
            continue
        seen.add(k)
        out.append(rec_cls(
            name=node.name, op_type=node.op.op_type.name, key=k,
            in_shapes=[list(s) for s in ins],
            sharding=dataclasses.asdict(sh_cls()), dcn=(1, 1),
            measured_fwd_s=1e-5 * scale[len(out)],
            count=sum(1 for n in pcg.compute_nodes()
                      if repr(sim._op_key(n, [
                          pcg.nodes[g].out_shapes[i] for g, i in n.inputs]))
                      == k)))
    return out


def _by_name(summary, records):
    names = {r.key: r.name for r in records}
    return ({names[k]: d["ratio"] for k, d in summary["per_key"].items()},
            summary["aggregate_ratio"])


def _bend(sim, pcg, factor):
    node = pcg.compute_nodes()[0]
    ins = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
    key = sim._op_key(node, ins)
    sim._key_calibration[key] = \
        sim._key_calibration.get(key, sim.calibration) * factor
    sim.invalidate_op_keys([key])
    return node.name


SCALE = (0.5, 1.0, 2.0, 0.9, 1.1)


def test_sentinel_ratios_and_flags_match_jax():
    jff, tff = _mlp(fj), _mlp(ft)
    jsim, tsim = _sims()
    jrec = _records(jsim, jff.pcg, JaxRecord, JaxSharding, SCALE)
    trec = _records(tsim, tff.pcg, OpRecord, OpSharding, SCALE)
    assert [r.name for r in jrec] == [r.name for r in trec]
    assert [r.count for r in trec] == [1, 2, 1, 1]
    for bent in (False, True):
        if bent:
            assert _bend(jsim, jff.pcg, 5) == _bend(tsim, tff.pcg, 5)
        js = JaxSentinel(jsim, jff.pcg, tolerance=0.25)
        ts = DriftSentinel(tsim, tff.pcg, tolerance=0.25)
        jd, td = js.observe(jrec, step=1), ts.observe(trec, step=1)
        (jr, ja), (tr, ta) = (_by_name(js.ratios(jrec), jrec),
                              _by_name(ts.ratios(trec), trec))
        assert set(jr) == set(tr)
        for name in jr:
            assert tr[name] == pytest.approx(jr[name], rel=REL), name
        assert ta == pytest.approx(ja, rel=REL)
        names = {r.key: r.name for r in trec}
        jnames = {r.key: r.name for r in jrec}
        assert sorted(names[k] for k in td["out_of_band"]) == \
            sorted(jnames[k] for k in jd["out_of_band"])
        assert td["worst_key"] == jd["worst_key"]
        assert td["worst_ratio"] == pytest.approx(jd["worst_ratio"],
                                                  rel=REL)
        if not bent:
            clean = dict(tr)
    # the bend is a 5x lie about that key alone
    bent_name = trec[0].name
    assert tr[bent_name] == pytest.approx(clean[bent_name] / 5, rel=REL)
    assert all(tr[n] == pytest.approx(clean[n], rel=REL)
               for n in tr if n != bent_name)


def test_repair_moves_the_same_keys_to_the_same_ratios():
    jff, tff = _mlp(fj), _mlp(ft)
    jsim, tsim = _sims()
    _bend(jsim, jff.pcg, 8)
    _bend(tsim, tff.pcg, 8)
    jrec = _records(jsim, jff.pcg, JaxRecord, JaxSharding, SCALE)
    trec = _records(tsim, tff.pcg, OpRecord, OpSharding, SCALE)
    from flexflow_tpu.obs.profile import OpProfile as JaxProfile

    jrep = jsim.calibrate_from_profile(JaxProfile(jrec), jff.pcg)
    trep = tsim.calibrate_from_profile(OpProfile(trec), tff.pcg)
    assert trep["updated"] == jrep["updated"] >= 1
    jr, _ = _by_name(JaxSentinel(jsim, jff.pcg).ratios(jrec), jrec)
    tr, _ = _by_name(DriftSentinel(tsim, tff.pcg).ratios(trec), trec)
    for name in jr:
        assert tr[name] == pytest.approx(jr[name], rel=REL), name
        assert 1 / 1.25 <= tr[name] <= 1.25


def test_rerank_candidates_matches_jax():
    """The stale chain (full remat priced faster) re-priced on both
    packages' simulators: the same times, the same order, the live plan
    first."""
    jff, tff = _mlp(fj), _mlp(ft)
    jsim, tsim = _sims()
    stale = [((1, 1), "none", 1e-3), ((1, 1), "full", 1e-9),
             ((1, 1), "selective", 2e-9)]
    jff._strategy_candidates = [JaxCandidate(mesh_shape=m, remat=r,
                                             sim_time=t)
                                for m, r, t in stale]
    tff._strategy_candidates = [RankedCandidate(mesh_shape=m, remat=r,
                                                sim_time=t)
                                for m, r, t in stale]
    tff.config.enable_sequence_parallel = True  # the JAX default
    assert rerank_candidates(tff, tsim) is jax_rerank(jff, jsim) is True
    got = [(c.remat, c.sim_time) for c in tff._strategy_candidates]
    want = [(c.remat, c.sim_time) for c in jff._strategy_candidates]
    assert [r for r, _ in got] == [r for r, _ in want]
    assert got[0][0] == "none"
    for (_r, t), (_w, u) in zip(got, want):
        assert t == pytest.approx(u, rel=REL)
    tff._strategy_candidates = tff._strategy_candidates[:1]
    assert rerank_candidates(tff, tsim) is False


def test_closed_loop_fit_flags_and_repairs_a_perturbed_key(tmp_path,
                                                          monkeypatch):
    """Two profiled fits under ``--auto-recalibrate``: the first settles
    the CPU-measured ruler; one key is then bent 8x (far above the CPU
    clock's noise) and the second fit's sentinel flags it and repairs it
    into the band. The telemetry's calibration block and the JSONL
    profile record both passes."""
    prof = str(tmp_path / "prof.jsonl")
    tel = str(tmp_path / "tel.json")
    ff = _mlp(ft, profile_ops=prof, auto_recalibrate=True,
              telemetry_file=tel, drift_tolerance=0.25)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=64).astype(np.int32)
    ff.fit(x, y, epochs=1)
    cal = json.loads(open(tel).read())["calibration"]
    assert cal["profiled_keys"] == 4
    sim = ff._calibration_sim
    victim = _bend(sim, ff.pcg, 8)
    flagged = []
    observe = DriftSentinel.observe

    def observed(self, records, step=0):
        out = observe(self, records, step=step)
        names = {r.key: r.name for r in records}
        flagged.extend(names[k] for k in out["out_of_band"])
        return out

    monkeypatch.setattr(DriftSentinel, "observe", observed)
    ff.fit(x, y, epochs=1)
    cal = json.loads(open(tel).read())["calibration"]
    assert cal["out_of_band"] >= 1 and cal["recalibrations"] >= 1
    assert victim in flagged  # the sentinel flags the bent key
    names = {r.key: r.name for r in ff.op_profile}
    post = {names[k]: d["ratio"] for k, d in
            ff._drift_sentinel.ratios(ff.op_profile)["per_key"].items()}
    assert 1 / 1.25 <= post[victim] <= 1.25
    lines = [json.loads(ln) for ln in open(prof) if ln.strip()]
    assert len(lines) == 8 and {ln["event"] for ln in lines} == \
        {"op_profile"}
