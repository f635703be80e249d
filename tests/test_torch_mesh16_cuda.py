"""A.5's third part on the card: ``chip_smoke.py`` phase 16 at its
reduced depth (BERT-Large widths). Resilience on threaded dp 2 ranks (a
NaN on one rank's plan skipped and rolled back on both, a preemption on
one rank's plan stopping both after the same step, both ending in the
band of uninterrupted runs); weights over the data axis (a rank's bytes
at half plain dp's, params in the band, B1 / B2 on the rank's half) and
that step captured once on a NCCL mesh of one card with its all-gathers
and reduce-scatters, next to ``--fusion`` under hybrid(1, 1); and the
pipeline stages' step programs (captures in the warm-up and none after,
params within the band of the eager run, B1 / B2 counted in the replays).

This file imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh16_cuda.py
"""
import os
import sys
import tempfile

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

LAYERS = 2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash kernels)")
    return "test"


@pytest.fixture(scope="module")
def base(card):
    with tempfile.TemporaryDirectory() as root:
        yield cs.mesh16_resilience(torch.device("cuda"), card, root)


@pytest.mark.cuda
def test_one_rank_nan_and_preemption_agree_on_both_ranks(base):
    # mesh16_resilience fails inside when a rank disagrees or leaves the
    # band; here the counters it read
    assert base["nan"]["summary"]["skipped_steps"] == 1
    assert base["resume"]["summary"]["last_resume_step"] == \
        cs.MESH16_PREEMPT_STEP + 1
    assert base["bytes_per_rank"][0] > 0


@pytest.mark.cuda
def test_data_axis_weights_halve_a_rank_and_stay_in_the_band(base, card):
    got = cs.mesh16_fsdp(torch.device("cuda"), card, base)
    assert 0.5 <= got["ratio"] < 0.52
    assert got["launches"]["flash_fwd"] > 0


@pytest.mark.cuda
def test_fsdp_and_fused_steps_capture_once_on_a_nccl_mesh(base, card):
    got = cs.mesh16_nccl(torch.device("cuda"), card, base)
    assert got["fsdp"]["captures"] == got["fused"]["captures"] == 1
    assert got["fused"]["regions"] >= 1


@pytest.mark.cuda
def test_pipeline_stages_run_as_captured_programs(card):
    dev = torch.device("cuda")
    pipe = {"threaded": cs.pipe_threaded(dev, card, layers=LAYERS)}
    got = cs.pipe16_captured(dev, card, pipe, layers=LAYERS)
    for caps in got["captures"]:
        assert caps[0] > 0 and caps[-1] == caps[-2]
