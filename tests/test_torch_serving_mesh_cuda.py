"""Serving on a mesh on the card (skips without one).

* B5's segment mode (``flash_decode_segment``) against its plain version
  at GPT-2 small's decode shape (8 slots, 12 heads, d64, 16-token blocks,
  32 blocks a slot), fp32 and bf16, native and int8 pools, 2 and 4
  segments: the partials where a segment holds a key, the exact empty
  partial (-1e30, 0, 0) where it holds none (also over NaN blocks), and
  the combined read against the whole read; a segment launch inside a
  CUDA graph replays to the eager launch's partials.
* A small GPT-2 served with ``--seq-shards`` 2 and 4 on the card: greedy
  streams equal the unsharded engine's, and the segment launches are
  counted.
* The same GPT-2 under tp 2 on two ranks as threads on the one card
  (eager): streams equal the one card's on every rank, and each rank's
  pool holds half the heads.

This file imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_mesh_cuda.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

GPT2 = dict(batch_size=2, seq_len=256, hidden=256, num_heads=4,
            num_layers=2, intermediate=1024, vocab_size=1024)
PROMPTS = [[5, 6, 7, 8, 9] * 4, [11, 12, 13], list(range(40, 81))]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash-decode kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dname, int8):
    from flexflow_tpu_torch.serving.kvcache import quantize_kv

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dname]
    per_layer, tables, n_keys = cs.decode_inputs(
        torch.float32 if int8 else dtype, device, 1)
    q, k, v = per_layer[0]
    if int8:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return q.to(dtype), kq, vq, dict(kscale=ks, vscale=vs), tables, \
            n_keys
    return q, k, v, {}, tables, n_keys


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [2, 4])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dname", ["fp32", "bf16"])
def test_segment_partials_match_plain(device, dname, int8, segments):
    from flexflow_tpu_torch.kernels import flash_decode as fd
    from flexflow_tpu_torch.kernels.seqpar_decode import (MASK_NEG,
                                                          combine_partials)

    q, k, v, sc, tables, n_keys = _inputs(device, dname, int8)
    cols = cs.MAX_BLOCKS // segments
    got = [fd.flash_decode_segment(q, k, v, tables, n_keys, s * cols,
                                   (s + 1) * cols, **sc)
           for s in range(segments)]
    want = [fd.flash_decode_segment_plain(q, k, v, tables, n_keys,
                                          s * cols, (s + 1) * cols, **sc)
            for s in range(segments)]
    tol = cs.KERNEL_ATOL[dname]
    empty = 0
    for s in range(segments):
        held = n_keys > s * cols * cs.BLOCK
        (m, l, acc), (pm, pl, pacc) = got[s], want[s]
        assert m[~held].eq(MASK_NEG).all()
        assert l[~held].eq(0).all() and acc[~held].eq(0).all()
        empty += int((~held).sum())
        # the partial's max and the rescaled sums, where a key is held
        assert (m[held] - pm[held]).abs().max() <= tol
        ratio = (acc[held] / l[held][..., None]) - (pacc[held]
                                                    / pl[held][..., None])
        assert ratio.abs().max() <= tol
    assert empty > 0
    whole = fd.flash_decode_plain(q, k, v, tables, n_keys, **sc).float()
    comb = combine_partials(got)[:, :, 0]
    assert (comb - whole).abs().max() <= tol
    assert (comb - combine_partials(want)[:, :, 0]).abs().max() <= tol


@pytest.mark.cuda
def test_segment_over_nan_blocks_is_the_empty_partial(device):
    from flexflow_tpu_torch.kernels import flash_decode as fd

    q, k, v, _sc, tables, n_keys = _inputs(device, "fp32", False)
    n_keys = torch.full_like(n_keys, cs.BLOCK)  # the first block only
    k, v = k.clone(), v.clone()
    k[tables[:, 1:].flatten().long()] = float("nan")
    v[tables[:, 1:].flatten().long()] = float("nan")
    m, l, acc = fd.flash_decode_segment(q, k, v, tables, n_keys, 1,
                                        cs.MAX_BLOCKS)
    assert m.eq(-1e30).all() and l.eq(0).all() and acc.eq(0).all()
    m0, l0, acc0 = fd.flash_decode_segment(q, k, v, tables, n_keys, 0, 1)
    assert torch.isfinite(acc0).all() and l0.gt(0).all()


@pytest.mark.cuda
def test_segment_launch_replays_in_a_graph(device):
    from flexflow_tpu_torch.kernels import flash_decode as fd

    q, k, v, _sc, tables, n_keys = _inputs(device, "bf16", False)
    eager = fd.flash_decode_segment(q, k, v, tables, n_keys, 8, 24)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        out = fd.flash_decode_segment(q, k, v, tables, n_keys, 8, 24)
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


def _model(device, strategy_fn=None):
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

    c = FFConfig()
    c.batch_size, c.seed, c.kv_block_size = 2, 0, 16
    ff = FFModel(c, device=device)
    build_gpt2(ff, GPT2Config(**GPT2))
    ff.compile(strategy_fn=strategy_fn)
    return ff


def _engine(ff, **kw):
    from flexflow_tpu_torch.serving.engine import ServingEngine

    return ServingEngine(ff, n_slots=2, max_decode_len=GPT2["seq_len"],
                         **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_seq_sharded_serving_matches_unsharded(device, kv_dtype):
    from flexflow_tpu_torch.kernels import flash_decode as fd

    ff = _model(device)
    want = _engine(ff, kv_dtype=kv_dtype).generate(PROMPTS,
                                                   max_new_tokens=8)
    for shards in (2, 4):
        fd.reset_launch_count()
        eng = _engine(ff, kv_dtype=kv_dtype, seq_shards=shards,
                      context_buckets=(64, 256))
        got = eng.generate(PROMPTS, max_new_tokens=8)
        torch.cuda.synchronize()
        name = "flash_decode_segment" + ("_int8" if kv_dtype == "int8"
                                         else "")
        assert fd.launch_count(name) >= \
            shards * GPT2["num_layers"] * eng.stats.decode_steps
        assert got == want


@pytest.mark.cuda
def test_tp2_threaded_serving_matches_one_card(device):
    from flexflow_tpu_torch.parallel.strategies import \
        hybrid_data_tensor_strategy

    one = _model(device)
    eng = _engine(one)
    want = eng.generate(PROMPTS, max_new_tokens=8)
    weights = one.get_params_numpy()

    def body(r):
        ff = _model(device, lambda pcg: hybrid_data_tensor_strategy(
            pcg, dp=1, tp=2))
        ff._capture_steps = False
        ff.set_params_numpy(weights)
        e = _engine(ff)
        got = e.generate(PROMPTS, max_new_tokens=8)
        return got, next(iter(e.state.caches.values()))[0].shape[1], \
            e.stats.kv_pool_bytes_per_rank

    out = cs.threaded_ranks(2, body, "tp2 serving")
    for r in range(2):
        got, heads, pool = out[r]
        assert got == want
        assert heads == GPT2["num_heads"] // 2
        assert pool * 2 == eng.stats.kv_pool_bytes_per_rank
    assert np.all([out[0][0] == out[1][0]])
