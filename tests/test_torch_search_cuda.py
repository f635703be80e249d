"""The search's measured side on the card (skips without one).

* ``GPUMachineModel.detect`` reads the card: its name's entry, its
  capacity, the telemetry's dense peak.
* ``Simulator.measure_operator_cost`` times the port's attention op on
  CUDA tensors and the flash kernels run inside it: B1 once a call of the
  forward, B1 and B2 once each a call of ``"grad"`` (two warm-up calls and
  the captured graph's calls, counted through its replays).
* ``Executor.profile_ops`` times a distinct op shape of the live graph on
  the card.

This file imports neither jax nor flexflow_tpu.
"""
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
    for k, v in cfg.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device=device)
    build_bert(ff, BertConfig(batch_size=2, seq_len=512, hidden=1024,
                              num_heads=16, num_layers=1,
                              intermediate=4096))
    ff.compile(optimizer=ft.AdamOptimizer(None, alpha=1e-3),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


@pytest.mark.cuda
def test_detect_reads_the_card(device):
    from flexflow_tpu_torch.obs.telemetry import detect_peak_flops
    from flexflow_tpu_torch.search.machine_model import (GPUMachineModel,
                                                         detect_generation)

    m = GPUMachineModel.detect(1, device=device)
    assert m.generation == detect_generation(torch.cuda.get_device_name(0))
    assert m.hbm_capacity == torch.cuda.get_device_properties(0).total_memory
    assert m.peak_flops == detect_peak_flops()


@pytest.mark.cuda
@pytest.mark.parametrize("direction,want", [
    ("fwd", {"flash_fwd": 1, "flash_bwd_fused": 0}),
    ("grad", {"flash_fwd": 1, "flash_bwd_fused": 1})])
def test_measure_launches_the_flash_kernels(device, direction, want):
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.search.machine_model import GPUMachineModel
    from flexflow_tpu_torch.search.simulator import _MEASURE_ITERS, Simulator

    ff = _bert(device)
    pcg = ff.pcg
    node = [n for n in pcg.compute_nodes()
            if n.op.op_type.name == "OP_MULTIHEAD_ATTENTION"][0]
    ins = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
    sim = Simulator(GPUMachineModel.detect(1, device=device))
    before = {k: fa._launches[k] for k in want}
    t = sim.measure_operator_cost(node, ins, compute_dtype=torch.bfloat16,
                                  direction=direction, device=device)
    calls = 2 + 2 * _MEASURE_ITERS  # warm-ups, capture (its first
    # replay), the timed replay
    assert {k: fa._launches[k] - before[k] for k in want} == \
        {k: v * calls for k, v in want.items()}
    assert 0 < t < 1e-2


@pytest.mark.cuda
def test_profile_ops_times_the_live_graph(device):
    ff = _bert(device)
    x = torch.randn(2, 512, 1024, device=device)
    raw = ff.executor.profile_ops(ff.params, [x], iters=2)
    assert sum(r["count"] for r in raw) == len(ff.pcg.compute_nodes())
    assert all(0 < r["measured_fwd_s"] < 1e-1 for r in raw)
