"""Pipeline parallelism on the card: ``chip_smoke.py`` phase 15 (a) at two
layers of the BERT-Large proxy (its widths, fp32): four ranks as threads on
the one card through the smoke's harness group (torch's threaded test
group with point-to-point added as copies), pp 4 x dp 1 under gpipe, 1f1b
and interleaved (v 2) and pp 2 x dp 2 under 1f1b; each run's losses and
params within the band of uninterrupted one-device runs, and each rank's
B1 / B2 launches twice / once a microbatch and attention layer of its
chunks (stage remat full). Then B1 and B2 against their plain versions at
the microbatch shape (b2 h16 s512 d64, fp32).

This file imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_pipeline_cuda.py
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

LAYERS = 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash kernels)")
    return "test"


@pytest.mark.cuda
def test_pipeline_runs_on_threaded_ranks_within_the_band(card):
    got = cs.pipe_threaded(torch.device("cuda"), card, layers=LAYERS)
    assert len(got["runs"]) == len(cs.PIPE_RUNS)
    # a run's ranks hold the LAYERS attention layers between them, once a
    # data index: pp 4 x dp 1 once, pp 2 x dp 2 twice
    copies = sum(dp for _s, _pp, dp, _v in cs.PIPE_RUNS)
    b2 = LAYERS * cs.PIPE_MICRO * cs.PIPE_STEPS * copies
    assert got["totals"] == {"flash_fwd": 2 * b2, "flash_bwd_fused": b2}


@pytest.mark.cuda
def test_flash_kernels_at_the_microbatch_shape(card):
    # fails inside when a kernel disagrees with its plain version
    assert cs.fa_case(torch.device("cuda"), card, "bert_micro", "fp32",
                      timed=False) == {}
