"""Strategy safety, the drift loop and ``--debug-nans`` on the card (skips
without one).

* ``Executor.train_step_memory_analysis`` reads the CUDA allocator: the
  captured step's peak (its eager first call, then the capture into the
  program's private pool and the replay) is at least the eager step's,
  the clones it runs on leave the params untouched, and ``--remat full``
  lowers it.
* The cascade's compile probe on CUDA leaves the params, the optimizer
  state and ``_rng_counter`` bitwise as they were, its program holds no
  clone after it, and a scripted compile failure falls to full remat with
  B1 / B2 launched in the fallback's probe and audit.
* The closed calibration loop repairs a key bent 8x on the card's clock.
* ``--debug-nans`` raises naming the node, and its eager step launches
  B1 / B2 as the captured step does, to the same loss.

This file imports neither jax nor flexflow_tpu.
"""
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash kernels)")
    return torch.device("cuda")


def _bert(device, **cfg):
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.models.bert import BertConfig, build_bert

    c = ft.FFConfig()
    c.batch_size = 2
    c.compute_dtype = ft.DataType.DT_BFLOAT16
    for k, v in cfg.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device=device)
    build_bert(ff, BertConfig(batch_size=2, seq_len=512, hidden=1024,
                              num_heads=16, num_layers=2,
                              intermediate=4096))
    ff.compile(optimizer=ft.AdamOptimizer(None, alpha=1e-3),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _data(n=2):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, 512, 1024), dtype=np.float32),
            rng.integers(0, 2, (n, 1)).astype(np.int32))


def _state(ff):
    return [t.detach().clone() for ws in ff.params.values()
            for t in ws.values()] + \
        [t.detach().clone() for t in _leaves(ff.opt_state)]


def _leaves(tree):
    from flexflow_tpu_torch.execution.graphs import _tensors_of

    return _tensors_of(tree)


@pytest.mark.cuda
def test_memory_analysis_reads_the_allocator_over_the_capture(device):
    ff = _bert(device)
    x, y = _data()
    xs = [torch.from_numpy(x).to(device)]
    lab = torch.from_numpy(ff._prep_label(y)).to(device)
    before = _state(ff)
    ex = ff.executor
    eager = ex.train_step_memory_analysis(ff.params, ff.opt_state, xs, lab,
                                          capture=False)
    captured = ex.train_step_memory_analysis(ff.params, ff.opt_state, xs,
                                             lab)
    ff.config.remat = "full"
    try:
        remat = ex.train_step_memory_analysis(ff.params, ff.opt_state, xs,
                                              lab)
    finally:
        ff.config.remat = ""
    assert eager["source"] == captured["source"] == "cuda_allocator"
    assert captured["peak_memory_in_bytes"] >= \
        eager["peak_memory_in_bytes"] > captured["argument_size_in_bytes"]
    assert remat["peak_memory_in_bytes"] < captured["peak_memory_in_bytes"]
    assert not ex.make_train_step().program._entries  # no clone held
    for a, b in zip(before, _state(ff)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_compile_probe_leaves_the_run_as_it_was(device):
    from flexflow_tpu_torch.resilience import StrategyCascade

    ff = _bert(device, audit_strategy=True)
    x, y = _data()
    before, rng0 = _state(ff), ff._rng_counter
    cascade = StrategyCascade.maybe_create(ff)
    cascade.preverify([x], ff._prep_label(y), 2)
    assert cascade.compile_probes == 1 and cascade.audits == 1
    assert cascade.audit_reports[0].passed
    assert ff._rng_counter == rng0
    for a, b in zip(before, _state(ff)):
        assert torch.equal(a, b)
    assert not ff.executor.make_train_step().program._entries


@pytest.mark.cuda
def test_compile_failure_falls_to_full_remat_with_the_kernels(device):
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.resilience import ChaosPlan

    ff = _bert(device, audit_strategy=True)
    x, y = _data()
    weights = ff.get_params_numpy()
    fa.reset_launch_count()
    ff.fit([x], y, epochs=1, chaos=ChaosPlan(fail_compiles=1))
    c = ff._last_cascade
    assert c.fallbacks == 1 and c.final_desc == "mesh=(1,) remat=full"
    assert ff.mesh is None and ff.executor.remat_plan.level == "full"
    # the fallback's probe step, the audit's two probes and the loop's
    # step: B1 twice a layer a step under full remat (the recompute)
    assert fa.launch_count("flash_fwd") >= 2 * 2 + 2 * 2
    assert fa.launch_count("flash_bwd_fused") >= 2 * 2
    assert set(weights) == set(ff.get_params_numpy())


@pytest.mark.cuda
def test_drift_loop_repairs_a_bent_key_on_the_card(device, tmp_path):
    import flexflow_tpu_torch as ft

    c = ft.FFConfig()
    c.batch_size = 64
    c.profile_ops = str(tmp_path / "ops.jsonl")
    c.auto_recalibrate = True
    ff = ft.FFModel(c, device=device)
    t = ff.create_tensor((64, 1024))
    for _ in range(3):
        t = ff.dense(t, 1024, ft.ActiMode.AC_MODE_RELU)
    ff.softmax(ff.dense(t, 16))
    ff.compile(loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 1024)).astype(np.float32)
    y = rng.integers(0, 16, (64, 1)).astype(np.int32)
    ff.fit(x, y, epochs=1)
    sim, pcg = ff._calibration_sim, ff.pcg
    node = pcg.compute_nodes()[0]
    key = sim._op_key(node, [pcg.nodes[g].out_shapes[i]
                             for g, i in node.inputs])
    sim._key_calibration[key] = sim._key_calibration.get(
        key, sim.calibration) * 8
    sim.invalidate_op_keys([key])
    ff.fit(x, y, epochs=1)
    post = ff._drift_sentinel.ratios(ff.op_profile)["per_key"][repr(key)]
    assert 1 / 1.25 <= post["ratio"] <= 1.25


@pytest.mark.cuda
def test_debug_nans_names_the_node_and_steps_eagerly(device):
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import flash_attention as fa

    c = ft.FFConfig()
    c.debug_nans = True
    c.batch_size = 4
    tiny = ft.FFModel(c, device=device)
    tiny.dense(tiny.log(tiny.create_tensor((4, 8)), name="lg"), 3)
    tiny.compile(loss_type=ft.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    with pytest.raises(FloatingPointError, match="'lg_0'"):
        tiny.executor.make_train_step()(
            tiny.params, tiny.opt_state, [-torch.ones((4, 8), device=device)],
            torch.zeros((4, 3), device=device), torch.Generator())
    x, y = _data()
    xs = [torch.from_numpy(x).to(device)]
    lab = torch.from_numpy(y).to(device)
    ref, dbg = _bert(device), _bert(device, debug_nans=True)
    dbg.set_params_numpy(ref.get_params_numpy())
    want = float(ref.executor.make_train_step(capture=False)(
        ref.params, ref.opt_state, xs, lab, torch.Generator())[2])
    step = dbg.executor.make_train_step()
    assert getattr(step, "program", None) is None
    fa.reset_launch_count()
    got = float(step(dbg.params, dbg.opt_state, xs, lab,
                     torch.Generator())[2])
    assert fa.launch_count("flash_fwd") == 2
    assert fa.launch_count("flash_bwd_fused") == 2
    assert got == pytest.approx(want, rel=1e-6)
