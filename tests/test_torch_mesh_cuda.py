"""The mesh path on the card: a NCCL process group of one (the chip host has
one GPU; several ranks are held on the CPU over gloo, tests/
test_torch_mesh_*.py). A tiny BERT proxy whose attention takes the flash
kernels (head dim 64, seq 128) under ``hybrid_data_tensor_strategy(dp=1,
tp=1)`` on a (1, 1) mesh, synchronous and with ``--collective-overlap
on``: its captured fit captures once and gives the eager fit's losses and
params, and both launch B1 and B2 once a layer a step.

This file imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.models.bert import BertConfig, build_bert
from flexflow_tpu_torch.parallel.strategies import \
    hybrid_data_tensor_strategy

LAYERS, STEPS = 2, 4
# fp32 B2 adds each CTA's dQ partial by reduce-adds in no fixed order, so
# the eager and the captured runs differ in the last bits of a step's
# grads, which Adam's normalised update can carry to ~1e-6 of a param
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def nccl_one(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL and the CUDA kernels)")
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    yield torch.device("cuda", torch.cuda.current_device())
    dist.destroy_process_group()


def _model(overlap: bool):
    c = ft.FFConfig()
    c.batch_size, c.seed = 4, 0
    c.collective_overlap = "on" if overlap else "off"
    ff = ft.FFModel(c)
    build_bert(ff, BertConfig(batch_size=4, seq_len=128, hidden=128,
                              num_heads=2, num_layers=LAYERS,
                              intermediate=256))
    ff.compile(optimizer=ft.AdamOptimizer(None, alpha=1e-3),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy_fn=lambda pcg: hybrid_data_tensor_strategy(pcg, 1,
                                                                  1))
    return ff


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_mesh_fit_captures_once_and_replays_the_eager_fit(nccl_one,
                                                          overlap):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4 * STEPS, 128, 128)).astype(np.float32)
    y = rng.integers(0, 2, (4 * STEPS, 1)).astype(np.int32)
    runs = {}
    for capture in (True, False):
        ff = _model(overlap)
        assert ff.mesh.shape == {"data": 1, "model": 1}
        assert ff.device == nccl_one
        ff._capture_steps = capture
        fa.reset_launch_count()
        ff.fit(x, y, epochs=1)
        torch.cuda.synchronize()
        launches = {k: fa.launch_count(k) for k in ("flash_fwd",
                                                    "flash_bwd_fused")}
        assert launches == {"flash_fwd": LAYERS * STEPS,
                            "flash_bwd_fused": LAYERS * STEPS}
        if capture:
            assert ff.executor.make_train_step().program.captures == 1
        runs[capture] = (np.array(ff.fit_history.loss),
                         ff.get_params_numpy())
    (lc, pc), (le, pe) = runs[True], runs[False]
    np.testing.assert_allclose(lc, le, **TOL)
    for n in pe:
        for w in pe[n]:
            np.testing.assert_allclose(pc[n][w], pe[n][w], **TOL,
                                       err_msg=f"{n}.{w}")
