"""The captured step programs (``flexflow_tpu_torch/execution/graphs.py``)
against the eager step bodies, on the card. Every test here needs an
NVIDIA GPU and skips without one (nothing is captured on the CPU, where
``tests/test_torch_step_program.py`` covers the programs' plumbing).

* the captured train step against the eager one over four steps, fp32 and
  bf16, tiny widths: losses and params within the stated bands, the same
  kernel launches a step, one capture;
* greedy decode streams and decode logits of a captured engine equal an
  eager engine's, and ``decode_compiles`` is 1 across a generate with
  prefix hits, chunk prefill and slot reuse;
* a captured step with attention dropout draws a fresh mask on every
  replay, equal to the eager step's for the same generator state;
* after ``set_params_numpy`` the programs capture anew and read the new
  weights;
* the flash kernels (B1-B4) with the dropout seed given as a device tensor
  equal the int-seed launches bit for bit and the plain versions;
* a model's graph pools are released once the model is gone.

It imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py
"""
import gc

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
import flexflow_tpu_torch.kernels.flash_attention as fa
import flexflow_tpu_torch.kernels.flash_decode as fd
from flexflow_tpu_torch.models.bert import BertConfig, build_bert
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

B = 4
# captured vs eager after several steps: fp32 differs only where the fused
# backward (B2) adds dQ by reduce-adds in no fixed order; bf16 in the band
# of a bf16 step (chip_smoke.py's TRAIN_TOL)
STEP_TOL = {"fp32": (1e-5, 1e-5), "bf16": (2e-2, 5e-2)}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs capture on the card "
                    "only)")
    return torch.device("cuda")


def _bert(dev, compute="fp32", dropout=0.0, optimizer=None, seed=3):
    config = ft.FFConfig()
    config.batch_size, config.seed = B, seed
    if compute == "bf16":
        config.compute_dtype = ft.DataType.DT_BFLOAT16
    ff = ft.FFModel(config, device=dev)
    build_bert(ff, BertConfig(batch_size=B, seq_len=128, hidden=128,
                              num_heads=2, num_layers=2, intermediate=256,
                              dropout=dropout))
    ff.compile(optimizer=optimizer or ft.AdamOptimizer(ff, alpha=1e-3),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[ft.MetricsType.METRICS_ACCURACY])
    return ff


def _bert_data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 128, 128)).astype(np.float32),
            rng.integers(0, 2, (n, 1)).astype(np.int32))


def _rel(a, b):
    num = sum(float((x - y).float().norm()) ** 2 for x, y in zip(a, b))
    den = sum(float(y.float().norm()) ** 2 for y in b)
    return (num / max(den, 1e-30)) ** 0.5


def _flat_params(ff):
    return [t for ws in ff.params.values() for t in ws.values()]


def _fa_counts():
    return {n: fa.launch_count(n) for n in fa.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_captured_train_steps_equal_eager(compute):
    dev = _cuda()
    x, y = _bert_data(4 * B)
    runs = {}
    for capture in (False, True):
        ff = _bert(dev, compute)
        ff._capture_steps = capture
        fa.reset_launch_count()
        perf = ff.fit(x, y, epochs=1, shuffle=False)
        torch.cuda.synchronize()
        runs[capture] = (ff, _fa_counts(), list(ff.fit_history.loss),
                         perf.train_correct)
    (eff, ecounts, eloss, ecorrect), (gff, gcounts, gloss, gcorrect) = \
        runs[False], runs[True]
    assert gff.executor.make_train_step().program.captures == 1
    assert gcounts == ecounts and gcounts["flash_fwd"] == 2 * 4
    assert gcorrect == ecorrect
    ltol, ptol = STEP_TOL[compute]
    assert len(set(gloss)) == len(gloss) == 4
    for a, b in zip(gloss, eloss):
        assert abs(a - b) <= ltol * max(1.0, abs(b)), (gloss, eloss)
    assert _rel(_flat_params(gff), _flat_params(eff)) <= ptol


def _gpt2(dev, seed=42):
    config = ft.FFConfig()
    config.batch_size, config.seed, config.kv_block_size = 2, seed, 8
    ff = ft.FFModel(config, device=dev)
    build_gpt2(ff, GPT2Config(batch_size=2, seq_len=64, hidden=256,
                              num_heads=4, num_layers=2, intermediate=512,
                              vocab_size=128))
    ff.compile()
    return ff


def _prompts():
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 128, 16).tolist()
    return [shared + [5, 6, 7], shared + [9, 3, 2, 8],
            rng.integers(1, 128, 21).tolist(), [3, 1, 4, 1, 5],
            shared + [1], rng.integers(1, 128, 30).tolist()]


def _serve(ff, capture, kv_dtype="native"):
    ff._capture_steps = capture
    eng = ft.ServingEngine(ff, max_decode_len=64, n_slots=3,
                           prefill_chunk_tokens=8, kv_dtype=kv_dtype)
    outs = eng.generate(_prompts(), max_new_tokens=12)
    return eng, outs


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_captured_decode_streams_equal_eager(kv_dtype):
    dev = _cuda()
    ff = _gpt2(dev)
    _eng, want = _serve(ff, False, kv_dtype)
    name = "flash_decode_int8" if kv_dtype == "int8" else "flash_decode"
    before = fd.launch_count(name)
    eng, got = _serve(ff, True, kv_dtype)
    torch.cuda.synchronize()
    stats = eng.stats
    assert got == want
    # prefix hits, chunk prefill, 6 requests over 3 slots: one capture
    assert stats.prefix_hits >= 1 and stats.chunked_prefills >= 1
    assert stats.requests_served == 6
    assert eng.decode_compiles == 1
    assert fd.launch_count(name) - before == 2 * stats.decode_steps
    # a second generate on the same engine replays the same graph
    assert eng.generate(_prompts()[:2], max_new_tokens=4) == \
        [w[:4] for w in want[:2]]
    assert eng.decode_compiles == 1


def _decode_logits(ff, capture, steps=6):
    """Teacher-forced decode logits of one slot, eager or captured."""
    from flexflow_tpu_torch.serving.kvcache import (DecodeState,
                                                    paged_pool_entry,
                                                    scatter_prefill_paged)

    dev = ff.device
    seq = np.random.default_rng(3).integers(1, 128, 24).tolist()
    plen = 16
    ex = ff.executor
    _lg, _last, cache = ex.make_prefill_step(16, 64)(
        ff.params, [torch.tensor([seq[:plen]], dtype=torch.int32,
                                 device=dev)],
        torch.tensor([plen], dtype=torch.int32, device=dev))
    table = torch.arange(1, 9, dtype=torch.int32, device=dev)
    caches = {n: tuple(scatter_prefill_paged(
        paged_pool_entry(leaf, 9, 8, "native"), leaf, table, 8)
        for leaf in leaves) for n, leaves in cache.items()}
    state = DecodeState(caches=caches, lengths=torch.tensor(
        [plen], dtype=torch.int32, device=dev), block_tables=table[None])
    decode = ex.make_decode_step(64, block_size=8, capture=capture)
    rows = []
    for s in range(steps):
        tok = torch.tensor([[seq[plen + s]]], dtype=torch.int32, device=dev)
        logits, state = decode(ff.params, [tok], state)
        rows.append(logits[0])
    return torch.stack(rows)


@pytest.mark.cuda
def test_captured_decode_logits_equal_eager():
    dev = _cuda()
    ff = _gpt2(dev)
    want = _decode_logits(ff, False)
    got = _decode_logits(ff, True)
    # the steps' outputs are copies: each row its own step's logits
    assert not torch.equal(got[0], got[-1])
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_captured_dropout_step_draws_a_fresh_mask_each_replay():
    dev = _cuda()
    ff = _bert(dev, dropout=0.1, optimizer=ft.SGDOptimizer(None, lr=0.01))
    ex = ff.executor
    x, y = _bert_data(B, seed=1)
    xs = [torch.tensor(x, device=dev)]
    lab = torch.tensor(ff._prep_label(y), device=dev)
    step, eager = ex.make_train_step(), ex.make_train_step(capture=False)
    snap = [t.clone() for t in _flat_params(ff)]

    def restore():
        for t, s in zip(_flat_params(ff), snap):
            t.copy_(s)

    def run(fn, k):
        restore()
        _p, _s, loss, _m = fn(ff.params, ff.opt_state, xs, lab,
                              torch.Generator().manual_seed(k))
        torch.cuda.synchronize()
        return float(loss), [t.clone() for t in _flat_params(ff)]

    run(step, 0)                       # eager first call of the shape
    captured = {k: run(step, k) for k in (1, 2)}   # capture, replay
    assert step.program.captures == 1
    assert captured[1][0] != captured[2][0]        # the mask moved
    for k, (loss, params) in captured.items():
        want_loss, want_params = run(eager, k)
        assert abs(loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
        # SGD: the update is lr * grad, so the grads agree as closely
        assert _rel([p - s for p, s in zip(params, snap)],
                    [p - s for p, s in zip(want_params, snap)]) <= 1e-4
    assert run(step, 1)[0] == captured[1][0]      # same seed, same mask


@pytest.mark.cuda
def test_set_params_numpy_recaptures_with_the_new_weights():
    dev = _cuda()
    ff, other = _gpt2(dev), _gpt2(dev, seed=9)
    prompts = _prompts()[:3]
    ff.generate(prompts, max_new_tokens=6, max_decode_len=64)
    ff.set_params_numpy(other.get_params_numpy())
    got = ff.generate(prompts, max_new_tokens=6, max_decode_len=64)
    other._capture_steps = False
    assert got == other.generate(prompts, max_new_tokens=6,
                                 max_decode_len=64)
    assert ff._serving_engine.decode_compiles == 1
    # the train step too: a fresh program over the new tensors
    bert, fresh = _bert(dev), _bert(dev, seed=8)
    x, y = _bert_data(3 * B)
    bert.fit(x, y, epochs=1, shuffle=False)
    bert.set_params_numpy(fresh.get_params_numpy())
    bert._rng_counter = fresh._rng_counter = 0
    bert.fit(x, y, epochs=1, shuffle=False)
    fresh._capture_steps = False
    fresh.fit(x, y, epochs=1, shuffle=False)
    np.testing.assert_allclose(bert.fit_history.loss,
                               fresh.fit_history.loss, rtol=1e-5)
    assert bert.executor.make_train_step().program.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal,sq,d,fused", [
    (True, 192, 128, True), (False, 128, 128, True),
    (True, 512, 64, False), (False, 512, 128, False)])
def test_flash_kernels_read_the_seed_from_device_memory(dtype, causal, sq,
                                                        d, fused):
    """B1-B4 with dropout 0.1, the seed given as an int (made a device
    tensor by the wrapper), a 0-d int64 and a 0-d int32 device tensor:
    bitwise equal launches, within the plain versions' tolerance."""
    dev = _cuda()
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.tensor(rng.standard_normal((2, 3, sq, d)),
                                dtype=dtype, device=dev) for _ in range(4))
    seed = 2 ** 32 - 77
    seeds = [seed, torch.tensor(seed, dtype=torch.int64, device=dev),
             torch.tensor(seed - 2 ** 32, dtype=torch.int32, device=dev)]
    outs = []
    for s in seeds:
        out, lse = fa._flash_forward(q, k, v, causal, 64, 64, 0.1, s)
        dq, dk, dv = fa._flash_backward(q, k, v, out, lse, do, causal, 64,
                                        64, 0.1, s, fused=fused)
        outs.append((out, lse, dk, dv, dq))
    torch.cuda.synchronize()
    # the fused backward adds dQ by reduce-adds in no fixed order
    exact = 4 if fused else 5
    for other in outs[1:]:
        for a, b in zip(outs[0][:exact], other[:exact]):
            assert torch.equal(a, b)
    out, lse, dk, dv, dq = outs[-1]
    want_out, want_lse = fa.flash_forward_plain(q, k, v, causal, 64, 64, 0.1,
                                                seed)
    out_tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2,
               torch.float16: 4e-3}[dtype]
    assert (out.float() - want_out.float()).abs().max() <= out_tol
    assert (lse - want_lse).abs().max() <= 1e-4
    want = fa.flash_backward_plain(q, k, v, out, lse, do, causal, 64, 64,
                                   0.1, seed, fused=fused)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2,
           torch.float16: 4e-3}[dtype]
    for g, w in zip((dq, dk, dv), want):
        scale = max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() / scale <= tol


@pytest.mark.cuda
def test_graph_pools_return_when_the_model_goes():
    """A model that trained through its captured step gives back every
    byte once it is collected (a first model makes what the process keeps:
    cuBLAS workspaces of the capture stream)."""
    dev = _cuda()
    x, y = _bert_data(3 * B)
    reserved = []
    for _ in range(2):
        gc.collect()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved(dev))
        ff = _bert(dev)
        ff.fit(x, y, epochs=1, shuffle=False)
        assert ff.executor.make_train_step().program.captures == 1
        assert torch.cuda.memory_reserved(dev) > reserved[-1]
        del ff
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(dev) <= reserved[-1]
