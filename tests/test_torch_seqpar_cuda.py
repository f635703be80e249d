"""Sequence parallelism on the card (skips without one).

* B1-B4 at a ring block's position offsets (the diagonal block, causal,
  and one below it), dropout 0.1, fp32 and bf16, against their plain
  versions: O and lse, and the fused and two-pass backwards; a launch
  with zero offsets is bitwise the launch without them, and offsets move
  the mask.
* The ring of one rank is the whole-sequence flash call: its forward
  bitwise, its backward (B3 + B4) within the kernels' tolerance of the
  fused one; on four threaded ranks the ring on the kernels matches the
  same loop on the plain flash functions (causal, dropout 0.1).
* A small causal GPT-2 (d 64, seq 1024, two layers, fp32) trains one step
  under ``long_context_strategy(dp=1, sp=4)`` in ``ring`` and in
  ``alltoall`` mode on four ranks as threads on the one card (the smoke's
  harness group with point-to-point and ``all_to_all_single``), against
  the one-device step from the same weights and batch; B1 / B3 / B4
  counted per rank.

This file imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_seqpar_cuda.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

# (O absolute, grads relative to their largest element): the smoke's
FA_TOL = cs.FA_TOL
BLOCKS = {"diag": (True, (1536, 1536)), "below": (False, (1536, 512))}
GPT2 = dict(batch_size=1, seq_len=1024, hidden=256, num_heads=4,
            num_layers=2, intermediate=1024, vocab_size=1000)
WORLD = 4


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash kernels)")
    return torch.device("cuda")


def _inputs(dtype, device, h=4, s=512, d=64):
    gen = torch.Generator(device=device).manual_seed(0)
    return [torch.randn((1, h, s, d), generator=gen, device=device).to(dtype)
            for _ in range(4)]


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("dname", ["fp32", "bf16"])
def test_kernels_at_ring_offsets_match_plain(device, dname, block):
    from flexflow_tpu_torch.kernels import flash_attention as fa

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dname]
    causal, (qo, ko) = BLOCKS[block]
    q, k, v, do = _inputs(dtype, device)
    shard = (0, 0, q.shape[1], qo, ko)
    args = (causal, 128, 128, 0.1, 0x5EED)
    want_o, want_lse = fa.flash_forward_plain(q, k, v, *args, shard)
    got_o, got_lse = fa._flash_forward(q, k, v, *args, shard)
    out_tol, grad_tol = FA_TOL[dname]
    assert float((got_o.float() - want_o.float()).abs().max()) <= out_tol
    assert float((got_lse - want_lse).abs().max()) <= 1e-4
    for fused in (True, False):
        got = fa._flash_backward(q, k, v, want_o, want_lse, do, *args,
                                 fused=fused, shard=shard)
        want = fa.flash_backward_plain(q, k, v, want_o, want_lse, do, *args,
                                       fused=fused, shard=shard)
        for g, w in zip(got, want):
            assert _rel(g, w) <= grad_tol, (fused, _rel(g, w))


@pytest.mark.cuda
def test_zero_offsets_are_the_launch_without_them(device):
    from flexflow_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _inputs(torch.bfloat16, device)
    h = q.shape[1]
    run = {}
    for key, shard in (("none", None), ("zero", (0, 0, h, 0, 0)),
                       ("moved", (0, 0, h, 1536, 512))):
        out, lse = fa._flash_forward(q, k, v, False, 128, 128, 0.1, 7, shard)
        grads = fa._flash_backward(q, k, v, out, lse, do, False, 128, 128,
                                   0.1, 7, fused=False, shard=shard)
        run[key] = (out,) + tuple(grads)
    assert all(torch.equal(a, b) for a, b in zip(run["none"], run["zero"]))
    assert not torch.equal(run["none"][0], run["moved"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["fp32", "bf16"])
def test_ring_of_one_rank_is_the_flash_call(device, dname):
    from flexflow_tpu_torch.kernels.flash_attention import flash_attention
    from flexflow_tpu_torch.kernels.ring_attention import (SeqGroup,
                                                           ring_attention)

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dname]
    q, k, v, do = _inputs(dtype, device, h=8, s=1024)
    leaves = [[t.clone().requires_grad_() for t in (q, k, v)]
              for _ in range(2)]
    ring = ring_attention(*leaves[0], SeqGroup(None, 1, 0, -1, -1), True)
    flash = flash_attention(*leaves[1], True)
    assert torch.equal(ring, flash)
    ring.backward(do)
    flash.backward(do)
    for a, b in zip(leaves[0], leaves[1]):
        assert _rel(a.grad, b.grad) <= FA_TOL[dname][1]


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["fp32", "bf16"])
def test_ring_matches_its_plain_loop_on_threaded_ranks(device, dname):
    """Four ranks as threads: the ring on the kernels against
    ``ring_attention(..., plain=True)`` (the same loop on the plain flash
    functions), causal, dropout 0.1, outputs and grads."""
    from flexflow_tpu_torch.kernels.ring_attention import (SeqGroup,
                                                           ring_attention)

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dname]
    full = _inputs(dtype, device, h=4, s=WORLD * 256)
    out_tol, grad_tol = FA_TOL[dname]

    def body(r):
        import torch.distributed as dist

        sg = SeqGroup.of(dist.group.WORLD, WORLD, r)
        blocks = [t[:, :, r * 256:(r + 1) * 256].contiguous()
                  for t in full]
        got = []
        for plain in (False, True):
            leaves = [t.clone().requires_grad_() for t in blocks[:3]]
            out = ring_attention(*leaves, sg, True, dropout=0.1, seed=11,
                                 shard=(0, 0, 4), plain=plain)
            out.backward(blocks[3])
            got.append([out.detach()] + [t.grad for t in leaves])
        return got

    out = cs.threaded_ranks(WORLD, body, f"ring plain {dname}",
                            backend=cs.threaded_p2p_backend())
    for r in range(WORLD):
        kern, plain = out[r]
        assert float((kern[0].float() - plain[0].float()).abs().max()) \
            <= out_tol
        for g, w in zip(kern[1:], plain[1:]):
            assert _rel(g, w) <= grad_tol, (r, _rel(g, w))


def _gpt2(device, strategy_fn=None):
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

    c = ft.FFConfig()
    c.batch_size, c.seed = 1, 5
    ff = ft.FFModel(c, device=device)
    _ids, logits = build_gpt2(ff, GPT2Config(**GPT2))
    ff.softmax(logits)
    ff.compile(optimizer=ft.AdamOptimizer(None, alpha=1e-4),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy_fn=strategy_fn)
    return ff


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ring", "alltoall"])
def test_long_context_step_on_threaded_ranks(device, mode):
    from flexflow_tpu_torch.parallel.strategies import long_context_strategy

    rng = np.random.default_rng(0)
    x = rng.integers(0, GPT2["vocab_size"], (1, GPT2["seq_len"])).astype(
        np.int32)
    y = rng.integers(0, GPT2["vocab_size"], (1, GPT2["seq_len"])).astype(
        np.int32)
    ref = _gpt2(device)
    weights = ref.get_params_numpy()
    loss, _l, grads = ref.executor.loss_and_grads(
        ref.params, [torch.from_numpy(x).to(device)],
        torch.from_numpy(ref._prep_label(y)).to(device))
    want = (float(loss), [g for ws in grads.values() for g in ws.values()])

    def body(r):
        ff = _gpt2(device, lambda pcg: long_context_strategy(
            pcg, dp=1, sp=WORLD, mode=mode))
        ff._capture_steps = False
        ff.set_params_numpy(weights)
        ex = ff.executor
        loss, logits, grads = ex.loss_and_grads(
            ff.params, [torch.from_numpy(x).to(device)],
            torch.from_numpy(ff._prep_label(y)).to(device))
        return float(loss), [ex.gather_param(n, w, g)
                             for n, ws in grads.items()
                             for w, g in ws.items()], tuple(logits.shape)

    per_rank = {}
    with cs.longctx_launch_counter(per_rank):
        out = cs.threaded_ranks(WORLD, body, f"seqpar {mode}",
                                backend=cs.threaded_p2p_backend())
    layers = GPT2["num_layers"]
    for r in range(WORLD):
        loss, full, shape = out[r]
        assert abs(loss - want[0]) <= 1e-4 * abs(want[0])
        assert cs.rel_norm(full, want[1]) <= 1e-4
        assert shape == (1, GPT2["seq_len"] // WORLD, GPT2["vocab_size"])
        # ring, causal: rank r runs r + 1 blocks a layer; Ulysses: one
        # whole-sequence call (fused backward at seq 1024)
        fwd = (r + 1) * layers if mode == "ring" else layers
        assert per_rank[(f"rank{r}", "flash_fwd")] == fwd
        if mode == "ring":
            assert per_rank[(f"rank{r}", "flash_bwd_dkv")] == fwd
            assert per_rank[(f"rank{r}", "flash_bwd_dq")] == fwd
        else:
            assert per_rank[(f"rank{r}", "flash_bwd_fused")] == layers
