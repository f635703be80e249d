"""The simulator's measured side on the CPU: ``measure_operator_cost``,
``calibrate_from_pcg``, ``Executor.profile_ops`` / ``profile_model`` and
``--profiling``'s per-op block.

* ``measure_operator_cost`` runs the node's own op (``ops.base.run_op``)
  on tensors from a seeded generator, forward and ``"grad"`` (forward plus
  ``torch.autograd.grad``), caches by key, and runs on the CPU only when
  ``device="cpu"`` is asked for: without a card and without it, it raises.
* ``calibrate_from_pcg(device="cpu")`` stores a per-key ratio for the
  distinct op shapes it measured, and ``op_cost`` then reproduces each
  measurement (the JAX package's calibration law).
* ``profile_model`` returns one record per distinct op shape of the live
  graph (counts summing to the compute nodes), keyed as the op-cost
  cache, with the simulator's prediction; the records round-trip through
  JSONL and ``calibrate_from_profile`` folds them in.
* ``fit`` under ``--profiling`` prints the per-op block.

The card's side (B1 and B2 launched inside the measurement) is
``tests/test_torch_search_cuda.py``.
"""
import pytest
import torch

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.bert import BertConfig, build_bert
from flexflow_tpu_torch.obs.profile import OpProfile, profile_model
from flexflow_tpu_torch.search.machine_model import GPUMachineModel
from flexflow_tpu_torch.search.simulator import OpSharding, Simulator


def _bert(**cfg):
    c = ft.FFConfig()
    c.batch_size = 4
    for k, v in cfg.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device="cpu")
    build_bert(ff, BertConfig.tiny(batch_size=4))
    ff.compile(optimizer=ft.AdamOptimizer(None, alpha=1e-3),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _node(pcg, op_type):
    n = [n for n in pcg.compute_nodes() if n.op.op_type.name == op_type][0]
    return n, [pcg.nodes[g].out_shapes[i] for g, i in n.inputs], \
        [pcg.nodes[g].out_dtypes[i] for g, i in n.inputs]


def test_measure_runs_the_op_forward_and_grad_on_the_cpu_when_asked():
    ff = _bert()
    sim = Simulator(GPUMachineModel.detect(1, device="cpu"))
    for op_type in ("OP_MULTIHEAD_ATTENTION", "OP_LINEAR"):
        node, ins, dts = _node(ff.pcg, op_type)
        fwd = sim.measure_operator_cost(node, ins, in_dtypes=dts,
                                        device="cpu")
        grad = sim.measure_operator_cost(node, ins, in_dtypes=dts,
                                         device="cpu", direction="grad")
        assert fwd > 0 and grad > 0
        # cached by (op params, in-shapes, dtype, direction)
        assert sim.measure_operator_cost(node, ins, in_dtypes=dts,
                                         device="cpu") == fwd
    if not torch.cuda.is_available():
        fresh = Simulator(GPUMachineModel.detect(1, device="cpu"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fresh.measure_operator_cost(node, ins, in_dtypes=dts)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GPUMachineModel.detect(1)


def test_calibrate_from_pcg_reproduces_its_measurements():
    ff = _bert()
    sim = Simulator(GPUMachineModel.detect(1, device="cpu"))
    n = sim.calibrate_from_pcg(ff.pcg, max_ops=4, device="cpu")
    assert n == 4 and len(sim._key_calibration) == 4
    for node in ff.pcg.compute_nodes():
        ins = [ff.pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
        key = sim._op_key(node, ins)
        if key not in sim._key_calibration:
            continue
        t = sim._measure_cache[key + ("None", "fwd")]
        got = sim.op_cost(node, ins, OpSharding()).forward_time
        assert abs(got - max(t, sim.op_overhead + 0.1 * t)) <= 1e-9 * t


def test_profile_model_records_join_the_cost_model(tmp_path):
    ff = _bert()
    sim = Simulator(GPUMachineModel.detect(1, device="cpu"))
    x = torch.randn(4, 16, 64, generator=torch.Generator().manual_seed(0))
    recs = profile_model(ff, [x], iters=2, sim=sim)
    assert sum(r.count for r in recs) == len(ff.pcg.compute_nodes())
    assert len({r.key for r in recs}) == len(recs)
    assert all(r.measured_fwd_s > 0 and r.predicted_fwd_s > 0 for r in recs)
    path = str(tmp_path / "ops.jsonl")
    OpProfile(recs).write_jsonl(path)
    back = OpProfile.read_jsonl(path)
    assert [r.key for r in back.records] == [r.key for r in recs]
    rep = sim.calibrate_from_profile(back, ff.pcg)
    assert rep["matched"] == len(recs)


def test_profiling_fit_prints_the_per_op_block(capsys):
    import numpy as np

    ff = _bert(profiling=True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16, 64)).astype(np.float32)
    y = rng.integers(0, 2, (8, 1)).astype(np.int32)
    ff.fit(x, y, epochs=1)
    out = capsys.readouterr().out
    assert "PER-OP PROFILE (fwd, measured standalone, top 8" in out
    assert len(ff.per_op_profile) == 8
    assert all(t > 0 and est > 0 for _n, _o, t, est in ff.per_op_profile)


def test_the_step_takes_the_strategys_searched_remat_level():
    """ROADMAP C.10: the train step resolved its remat plan from
    ``--remat`` alone, so a searched ``Strategy.remat`` never reached it
    (the JAX executor resolves the flag, then the strategy's level). Now
    a strategy of remat "full" checkpoints the step's blocks, with the
    same loss and grads as the plain step."""
    import numpy as np
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel.strategy import data_parallel_strategy

    def fn(level):
        def build(pcg):
            s = data_parallel_strategy(pcg, 1)
            s.remat = level
            return s
        return build

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 16, 64)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, (4, 1)).astype(np.int32))
    got = {}
    try:
        for level in ("none", "full"):
            c = ft.FFConfig()
            c.batch_size, c.seed = 4, 0
            ff = ft.FFModel(c, device="cpu")
            build_bert(ff, BertConfig.tiny(batch_size=4))
            ff.compile(loss_type=ft.LossType.
                       LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                       strategy_fn=fn(level))
            loss, _l, grads = ff.executor.loss_and_grads(ff.params, [x], y)
            plan = ff.executor.remat_plan
            got[level] = (float(loss), grads,
                          plan.level if plan is not None else "none")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert got["full"][2] == "full" and got["none"][2] == "none"
    assert abs(got["full"][0] - got["none"][0]) <= 1e-6
    for n, ws in got["none"][1].items():
        for w, g in ws.items():
            torch.testing.assert_close(got["full"][1][n][w], g, rtol=1e-5,
                                       atol=1e-6)
