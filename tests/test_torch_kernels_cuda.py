"""The port's CUDA kernels against their plain-PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one (the
kernels have no CPU mode; their plain versions are checked against the JAX
package on the CPU in the other tests/test_torch_*.py files).

This file imports neither jax nor flexflow_tpu, so on a GPU host without
JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

import flexflow_tpu_torch.kernels.flash_decode as fd


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def _decode_inputs(seed, dtype, dev, slots=3, heads=4, dim=64, bs=8, mb=4,
                   n_keys=(1, 13, 32)):
    rng = np.random.default_rng(seed)
    n_blocks = slots * mb + 1
    q = rng.standard_normal((slots, heads, dim))
    k = rng.standard_normal((n_blocks, heads, bs, dim))
    v = rng.standard_normal((n_blocks, heads, bs, dim))
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(slots, mb)
    f = [torch.tensor(a, dtype=dtype, device=dev) for a in (q, k, v)]
    i = [torch.tensor(a, dtype=torch.int32, device=dev)
         for a in (tables, np.asarray(n_keys))]
    return f + i


# fp32: summation order only; bf16/fp16: the output rounding of the dtype
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2),
                                        (torch.float16, 2e-3)])
@pytest.mark.parametrize("dim,bs", [(64, 8), (128, 16), (256, 5), (40, 3),
                                    (33, 4)])
def test_flash_decode_kernel_matches_plain(dtype, atol, dim, bs):
    dev = _cuda()
    args = _decode_inputs(0, dtype, dev, dim=dim, bs=bs,
                          n_keys=(1, 2 * bs + 1, 4 * bs))
    before = fd.launch_count()
    got = fd.flash_decode(*args)
    torch.cuda.synchronize()
    assert fd.launch_count() == before + 1
    want = fd.flash_decode_plain(*args)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_decode_kernel_on_unaligned_pools(dtype, atol):
    """Pools that start one element past an aligned address take the
    kernel's scalar loads instead of its vector loads; same results."""
    dev = _cuda()
    q, k, v, tables, nk = _decode_inputs(2, dtype, dev)

    def unaligned(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    ku, vu = unaligned(k), unaligned(v)
    assert ku.is_contiguous() and ku.data_ptr() % 8 != 0
    got = fd.flash_decode(q, ku, vu, tables, nk)
    want = fd.flash_decode_plain(q, k, v, tables, nk)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_flash_decode_kernel_refuses_what_it_does_not_take():
    dev = _cuda()
    q, k, v, tables, nk = _decode_inputs(1, torch.float32, dev)
    with pytest.raises(TypeError):
        fd.flash_decode(q, k.half(), v.half(), tables, nk)
    with pytest.raises(TypeError):
        fd.flash_decode(q, k, v, tables.long(), nk)
    with pytest.raises(ValueError):
        fd.flash_decode(q, k.transpose(2, 3), v, tables, nk)


# ------------------------------------------------- flash attention (B1-B4)
import flexflow_tpu_torch.kernels.flash_attention as fa  # noqa: E402

# fp32: summation order (and dQ's atomics) only. bf16/fp16: P and dS are
# rounded to the dtype before each product, and a probability one fp32 ulp
# apart on the two sides can round to neighbouring values; outputs round
# once more. Gradients are judged relative to their largest element.
FA_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2),
          torch.float16: (4e-3, 4e-3)}


def _fa_inputs(seed, dtype, dev, b=2, h=3, sq=256, sk=256, d=64):
    rng = np.random.default_rng(seed)
    shapes = [(b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d)]
    return [torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
            for s in shapes]


def _rel_err(got, want):
    scale = max(1.0, want.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / scale


# The two-pass grads are held tile by tile too: each 64-row tile's largest
# error over that tile's own largest element. Under a long causal band a
# late key's dV (or a late query's dQ) is several times smaller than the
# global limit, so a kernel that skipped late key blocks or q tiles would
# pass that alone.
TILE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}


def _tile_rel_err(got, want, rows=64):
    g, w = (t.float().reshape(-1, t.shape[-2], t.shape[-1])
            for t in (got, want))
    pad = -g.shape[1] % rows
    g, w = (torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(
        t.shape[0], -1, rows * t.shape[-1]) for t in (g, w))
    err, scale = (g - w).abs().amax(-1), w.abs().amax(-1)
    return (err / scale.clamp_min(1e-30)).max().item()


def _launch_kinds(fn):
    """The device kernels one call of ``fn`` launches under torch.profiler,
    counted by kind: a flash kernel by its name, else reduce, fill (or
    memset), mul, copy; any other kernel by its own name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {}
    for n in (e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA):
        low = n.lower()
        kind = next((k for k in fa.KERNELS if k in low), None) or (
            "reduce" if "reduce" in low
            else "fill" if "fill" in low or "memset" in low
            else "mul" if "mul" in low
            else "copy" if "copy" in low else n)
        kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal,sq,sk,d,dropout", [
    (False, 256, 256, 64, 0.0),
    (True, 256, 256, 64, 0.0),
    (True, 128, 256, 64, 0.0),     # rectangular band, offset sk - sq
    (True, 192, 192, 128, 0.1),
    (False, 128, 128, 128, 0.1),
])
def test_flash_attention_kernels_match_plain(dtype, causal, sq, sk, d,
                                             dropout):
    dev = _cuda()
    q, k, v, do = _fa_inputs(0, dtype, dev, sq=sq, sk=sk, d=d)
    seed = 20261016
    out_tol, grad_tol = FA_TOL[dtype]
    before = {n: fa.launch_count(n) for n in fa.KERNELS}
    out, lse = fa._flash_forward(q, k, v, causal, 64, 64, dropout, seed)
    want_out, want_lse = fa.flash_forward_plain(q, k, v, causal, 64, 64,
                                                dropout, seed)
    torch.cuda.synchronize()
    assert (out.float() - want_out.float()).abs().max().item() <= out_tol
    assert (lse - want_lse).abs().max().item() <= 1e-4
    for fused in (True, False):
        got = fa._flash_backward(q, k, v, want_out, want_lse, do, causal, 64,
                                 64, dropout, seed, fused=fused)
        want = fa.flash_backward_plain(q, k, v, want_out, want_lse, do,
                                       causal, 64, 64, dropout, seed,
                                       fused=fused)
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == dtype
            assert _rel_err(g, w) <= grad_tol, (name, fused, _rel_err(g, w))
    after = {n: fa.launch_count(n) - before[n] for n in fa.KERNELS}
    assert after == {"flash_fwd": 1, "flash_bwd_fused": 1,
                     "flash_bwd_dkv": 1, "flash_bwd_dq": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [((0, 4), (2, 4)), ((2, 4), (0, 4)),
                                   ((2, 4), (2, 4))])
def test_flash_kernels_on_a_shard_hash_global_coordinates(dtype, causal,
                                                          block):
    """B1-B4 on a data- or tensor-parallel rank's (batch, head) block with
    its offsets: the output, lse and grads of the unsharded call at that
    block (the same dropout mask), and the plain versions' on the same
    block; without the offsets the block draws another mask."""
    dev = _cuda()
    q, k, v, do = _fa_inputs(3, dtype, dev, b=4, h=4, sq=128, sk=128)
    rate, seed = 0.1, 20261018
    out_tol, grad_tol = FA_TOL[dtype]
    o, lse = fa._flash_forward(q, k, v, causal, 64, 64, rate, seed)
    (b0, b1), (h0, h1) = block
    sl = (slice(b0, b1), slice(h0, h1))
    qs, ks, vs, ds = (t[sl].contiguous() for t in (q, k, v, do))
    shard = (b0, h0, 4)
    so, slse = fa._flash_forward(qs, ks, vs, causal, 64, 64, rate, seed,
                                 shard)
    po, plse = fa.flash_forward_plain(qs, ks, vs, causal, 64, 64, rate,
                                      seed, shard)
    bare, _ = fa._flash_forward(qs, ks, vs, causal, 64, 64, rate, seed)
    torch.cuda.synchronize()
    assert torch.equal(so, o[sl]) and torch.equal(slse, lse[sl])
    assert (so.float() - po.float()).abs().max().item() <= out_tol
    assert not torch.equal(bare, so)
    for fused in (True, False):
        full = fa._flash_backward(q, k, v, o, lse, do, causal, 64, 64, rate,
                                  seed, fused=fused)
        got = fa._flash_backward(qs, ks, vs, so, slse, ds, causal, 64, 64,
                                 rate, seed, fused=fused, shard=shard)
        plain = fa.flash_backward_plain(qs, ks, vs, so, slse, ds, causal,
                                        64, 64, rate, seed, fused=fused,
                                        shard=shard)
        torch.cuda.synchronize()
        for name, g, f, p in zip(("dq", "dk", "dv"), got, full, plain):
            assert _rel_err(g, f[sl]) <= grad_tol, (name, fused)
            assert _rel_err(g, p) <= grad_tol, (name, fused)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,h,causal,sq,sk,d,dropout", [
    (4, 40, False, 256, 256, 64, 0.0),    # b*h 160: more than one wave
    (4, 40, True, 192, 192, 128, 0.0),    # ... with ragged 128-row tiles
    (1, 2, False, 2048, 2048, 64, 0.0),   # long fused: the ring wraps
    (1, 2, True, 2048, 2048, 128, 0.0),   # many times
    (2, 4, False, 512, 512, 64, 0.1),
    (2, 4, True, 512, 512, 128, 0.1),
])
def test_flash_attention_hopper_kernels_match_plain(dtype, b, h, causal, sq,
                                                    sk, d, dropout):
    """The 16-bit forward and fused backward (wgmma, TMA ring, dQ by bulk
    reduce-add) at shapes past the small cases above: several waves of
    CTAs, seq 2048 (which the JAX rule still sends to the fused backward),
    dropout at seq 512."""
    dev = _cuda()
    q, k, v, do = _fa_inputs(7, dtype, dev, b=b, h=h, sq=sq, sk=sk, d=d)
    seed = 977
    out_tol, grad_tol = FA_TOL[dtype]
    blk = 128 if sq % 128 == 0 else 64
    fa.reset_launch_count()
    out, lse = fa._flash_forward(q, k, v, causal, blk, blk, dropout, seed)
    want_out, want_lse = fa.flash_forward_plain(q, k, v, causal, blk, blk,
                                                dropout, seed)
    got = fa._flash_backward(q, k, v, want_out, want_lse, do, causal, blk,
                             blk, dropout, seed, fused=True)
    want = fa.flash_backward_plain(q, k, v, want_out, want_lse, do, causal,
                                   blk, blk, dropout, seed, fused=True)
    torch.cuda.synchronize()
    assert fa.launch_count("flash_fwd") == 1
    assert fa.launch_count("flash_bwd_fused") == 1
    assert (out.float() - want_out.float()).abs().max().item() <= out_tol
    assert (lse - want_lse).abs().max().item() <= 1e-4
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= grad_tol, (name, _rel_err(g, w))


# B3 + B4 cases, for every dtype
TWO_PASS_CASES = [
    (4, 40, False, 256, 256, 64, 0.0),    # b*h 160: more than one wave
    (4, 40, True, 256, 256, 128, 0.0),
    (1, 2, True, 4096, 4096, 64, 0.0),    # the rings wrap many times, B4's
    (1, 2, True, 2048, 2048, 128, 0.0),   # reversed order under the band
    (1, 3, True, 1024, 2048, 64, 0.0),    # rectangular causal band
    (2, 3, True, 192, 192, 64, 0.0),      # ragged: a 128-row CTA spans 192
    (2, 3, False, 192, 192, 128, 0.0),
    (2, 4, True, 512, 512, 64, 0.1),      # dropout
    (2, 4, True, 512, 512, 128, 0.1),
    (2, 4, False, 512, 512, 128, 0.1),
]


def _two_pass_matches_plain(dtype, b, h, causal, sq, sk, d, dropout):
    """One B3 and one B4 launch against the plain two-pass walk: grads
    within FA_TOL of their largest element and TILE_TOL of each tile's;
    neither kernel has atomics, so a second call and a CUDA-graph replay
    are bitwise equal to the first call."""
    dev = _cuda()
    q, k, v, do = _fa_inputs(11, dtype, dev, b=b, h=h, sq=sq, sk=sk, d=d)
    seed = 4242
    _out_tol, grad_tol = FA_TOL[dtype]
    blk = 128 if sq % 128 == 0 and sk % 128 == 0 else 64
    out, lse = fa.flash_forward_plain(q, k, v, causal, blk, blk, dropout,
                                      seed)
    args = (q, k, v, out, lse, do, causal, blk, blk, dropout, seed)
    fa.reset_launch_count()
    got = fa._flash_backward(*args, fused=False)
    torch.cuda.synchronize()
    assert {n: fa.launch_count(n) for n in fa.KERNELS} == {
        "flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dkv": 1,
        "flash_bwd_dq": 1}
    want = fa.flash_backward_plain(*args, fused=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        assert _rel_err(g, w) <= grad_tol, (name, _rel_err(g, w))
        assert _tile_rel_err(g, w) <= TILE_TOL[dtype], (
            name, _tile_rel_err(g, w))
    again = fa._flash_backward(*args, fused=False)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fa._flash_backward(*args, fused=False)
    graph.replay()
    torch.cuda.synchronize()
    for name, g, a, c in zip(("dq", "dk", "dv"), got, again, captured):
        assert torch.equal(g, a), name
        assert torch.equal(g, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,causal,sq,sk,d,dropout", TWO_PASS_CASES)
def test_fp32_two_pass_backward_matches_plain(b, h, causal, sq, sk, d,
                                              dropout):
    """The fp32 dK/dV (B3) and dQ (B4) kernels (cp.async ring, 128-bit
    shared loads, warp-owned score rows)."""
    _two_pass_matches_plain(torch.float32, b, h, causal, sq, sk, d, dropout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,h,causal,sq,sk,d,dropout", TWO_PASS_CASES)
def test_16bit_two_pass_backward_matches_plain(dtype, b, h, causal, sq, sk,
                                               d, dropout):
    """The 16-bit dK/dV (B3, ``flash_bwd_dkv_sm90``) and dQ (B4,
    ``flash_bwd_dq_sm90``) kernels (wgmma, TMA rings)."""
    _two_pass_matches_plain(dtype, b, h, causal, sq, sk, d, dropout)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,causal,sq,sk,d,dropout", [
    (4, 40, False, 256, 256, 64, 0.0),    # b*h 160: more than one wave
    (4, 40, True, 256, 256, 128, 0.0),
    (1, 2, True, 4096, 4096, 64, 0.0),    # the copy ring wraps many times
    (1, 2, True, 2048, 2048, 128, 0.0),   # one stage at d 128
    (1, 3, True, 1024, 2048, 64, 0.0),    # rectangular causal band
    (2, 3, True, 192, 512, 128, 0.0),
    (2, 3, True, 192, 192, 64, 0.0),      # ragged: a 128-row CTA spans 192
    (2, 3, False, 192, 192, 64, 0.0),
    (2, 4, True, 512, 512, 64, 0.1),      # dropout
    (2, 4, False, 192, 256, 128, 0.1),
])
def test_fp32_forward_matches_plain(b, h, causal, sq, sk, d, dropout):
    """The fp32 forward (B1, ``flash_fwd_f32``: cp.async ring, 128-bit
    shared loads, two warp groups on alternate k tiles) against the plain
    tile walk, one launch each: O within 2e-5 and lse within 1e-4."""
    dev = _cuda()
    q, k, v, _do = _fa_inputs(12, torch.float32, dev, b=b, h=h, sq=sq, sk=sk,
                              d=d)
    seed = 777
    out_tol, _grad_tol = FA_TOL[torch.float32]
    blk = 128 if sq % 128 == 0 and sk % 128 == 0 else 64
    fa.reset_launch_count()
    out, lse = fa._flash_forward(q, k, v, causal, blk, blk, dropout, seed)
    torch.cuda.synchronize()
    assert fa.launch_count("flash_fwd") == 1
    want, want_lse = fa.flash_forward_plain(q, k, v, causal, blk, blk,
                                            dropout, seed)
    assert (out - want).abs().max().item() <= out_tol
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,causal,sq,sk,d,dropout", [
    (8, 12, True, 512, 512, 64, 0.0),     # GPT-2 small's training shape
    (1, 3, True, 1024, 2048, 64, 0.0),    # rectangular causal band
    (2, 3, True, 192, 192, 64, 0.0),      # ragged: a 128-key CTA spans 192
    (2, 3, False, 192, 192, 128, 0.0),
    (2, 4, True, 512, 512, 128, 0.1),     # dropout at d 128 (one stage)
    (4, 40, False, 256, 256, 64, 0.0),    # b*h 160: more than one wave
])
def test_fp32_fused_backward_matches_plain(b, h, causal, sq, sk, d,
                                           dropout):
    """The fp32 fused backward (B2, ``flash_bwd_fused_f32``: B3's cp.async
    ring and warp groups, delta in-kernel, dQ by vector reduce-adds)
    against the plain fused walk, one launch each. dQ's partials meet in
    reduce-adds in no fixed order, so it is not bitwise repeatable: every
    gradient is held within 1e-4 of its largest element."""
    dev = _cuda()
    q, k, v, do = _fa_inputs(13, torch.float32, dev, b=b, h=h, sq=sq, sk=sk,
                             d=d)
    seed = 9191
    _out_tol, grad_tol = FA_TOL[torch.float32]
    blk = 128 if sq % 128 == 0 and sk % 128 == 0 else 64
    out, lse = fa.flash_forward_plain(q, k, v, causal, blk, blk, dropout,
                                      seed)
    fa.reset_launch_count()
    got = fa._flash_backward(q, k, v, out, lse, do, causal, blk, blk,
                             dropout, seed, fused=True)
    torch.cuda.synchronize()
    assert {n: fa.launch_count(n) for n in fa.KERNELS} == {
        "flash_fwd": 0, "flash_bwd_fused": 1, "flash_bwd_dkv": 0,
        "flash_bwd_dq": 0}
    want = fa.flash_backward_plain(q, k, v, out, lse, do, causal, blk, blk,
                                   dropout, seed, fused=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        assert _rel_err(g, w) <= grad_tol, (name, _rel_err(g, w))


@pytest.mark.cuda
def test_fused_backward_launches_no_host_side_delta():
    """The fused CUDA route launches exactly: the fill of the fp32 dQ
    buffer, q's pre-scale, the fused kernel, dQ's 1/sqrt(d) scale and its
    cast; the kernel computes delta itself, so no fp32 reduction runs."""
    dev = _cuda()
    q, k, v, do = _fa_inputs(5, torch.bfloat16, dev, sq=256, sk=256)
    out, lse = fa._flash_forward(q, k, v, False, 64, 64)
    kinds = _launch_kinds(lambda: fa._flash_backward(
        q, k, v, out, lse, do, False, 64, 64, fused=True))
    assert kinds == {"flash_bwd_fused": 1, "fill": 1, "mul": 2, "copy": 1}, \
        kinds


@pytest.mark.cuda
def test_two_pass_backward_launch_set():
    """The two-pass CUDA route launches exactly: q's pre-scale, delta =
    rowsum(dO * O) from dO as given (two casts to fp32, a product, a sum),
    the dK/dV kernel and the dQ kernel (which scales dQ by 1/sqrt(d)
    itself): no fill, no fp32 dQ buffer, no cast of dQ."""
    dev = _cuda()
    q, k, v, do = _fa_inputs(6, torch.bfloat16, dev, sq=256, sk=256)
    out, lse = fa._flash_forward(q, k, v, True, 64, 64)
    kinds = _launch_kinds(lambda: fa._flash_backward(
        q, k, v, out, lse, do, True, 64, 64, fused=False))
    assert kinds == {"flash_bwd_dkv": 1, "flash_bwd_dq": 1, "mul": 2,
                     "copy": 2, "reduce": 1}, kinds


@pytest.mark.cuda
def test_flash_attention_autograd_launches_the_kernels():
    """Through the autograd Function: grads equal the plain version's, and
    the backward takes the fused schedule at this shape."""
    dev = _cuda()
    q, k, v, do = _fa_inputs(3, torch.float32, dev, sq=512, sk=512)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launch_count()
    out = fa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    assert fa.launch_count("flash_fwd") == 1
    assert fa.launch_count("flash_bwd_fused") == 1
    o_w, l_w = fa.flash_forward_plain(q, k, v, True)
    want = fa.flash_backward_plain(q, k, v, o_w, l_w, do, True)
    assert (out - o_w).abs().max().item() <= 2e-5
    for g, w in zip(grads, want):
        assert _rel_err(g, w) <= 1e-4


@pytest.mark.cuda
def test_flash_attention_kernels_refuse_what_they_do_not_take():
    dev = _cuda()
    q, k, v, _ = _fa_inputs(1, torch.float32, dev, sq=128, sk=128, d=32)
    with pytest.raises(ValueError, match="head_dim"):
        fa._flash_forward(q, k, v, False, 64, 64)
    q, k, v, _ = _fa_inputs(1, torch.float32, dev, sq=96, sk=96)
    with pytest.raises(ValueError, match="multiple"):
        fa._flash_forward(q, k, v, False, 32, 32)
    q, k, v, _ = _fa_inputs(1, torch.float32, dev, sq=128, sk=128)
    with pytest.raises(TypeError):
        fa._flash_forward(q, k.half(), v, False, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fa._flash_forward(q.transpose(2, 3).contiguous().transpose(2, 3),
                          k, v, False, 64, 64)
    flat = torch.empty(k.numel() + 1, device=dev)
    k_off = flat[1:].view(k.shape)  # contiguous, 4 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte"):
        fa._flash_forward(q, k_off, v, False, 64, 64)


# ------------------------------------------------- flash decode, int8 pools
def _int8_pools(k, v):
    from flexflow_tpu_torch.serving.kvcache import quantize_kv

    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return kq, vq, ks, vs


# q in fp32 (summation order only) or 16-bit (the output's rounding); the
# dequantized keys are the same fp32 values on both sides
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2),
                                        (torch.float16, 2e-3)])
@pytest.mark.parametrize("dim,bs", [(64, 16), (128, 8), (40, 3)])
def test_flash_decode_int8_kernel_matches_plain(dtype, atol, dim, bs):
    dev = _cuda()
    q, k, v, tables, nk = _decode_inputs(4, torch.float32, dev, dim=dim,
                                         bs=bs, n_keys=(1, 2 * bs + 1, 4 * bs))
    kq, vq, ks, vs = _int8_pools(k, v)
    q = q.to(dtype)
    before = fd.launch_count("flash_decode_int8")
    got = fd.flash_decode(q, kq, vq, tables, nk, kscale=ks, vscale=vs)
    torch.cuda.synchronize()
    assert fd.launch_count("flash_decode_int8") == before + 1
    assert got.dtype == dtype
    want = fd.flash_decode_plain(q, kq, vq, tables, nk, kscale=ks,
                                 vscale=vs)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_flash_decode_int8_kernel_refuses_what_it_does_not_take():
    dev = _cuda()
    q, k, v, tables, nk = _decode_inputs(5, torch.float32, dev)
    kq, vq, ks, vs = _int8_pools(k, v)
    with pytest.raises(ValueError, match="kscale"):
        fd.flash_decode(q, kq, vq, tables, nk)
    with pytest.raises(TypeError):
        fd.flash_decode(q, kq, vq, tables, nk, kscale=ks.double(),
                        vscale=vs)
    with pytest.raises(TypeError):
        fd.flash_decode(q, kq, v, tables, nk, kscale=ks, vscale=vs)


# ------------------------------------- flash decode, keys split across CTAs
def _split_case(seed, dtype, dev, int8, slots, heads, hd, vd, bs, mb, n_keys,
                unaligned=False):
    """(args, kwargs) of one flash_decode call: pools of ``slots * mb + 1``
    blocks (int8 with scales, or of ``dtype``), random tables."""
    rng = np.random.default_rng(seed)
    n_blocks = slots * mb + 1
    pool_dtype = torch.float32 if int8 else dtype
    q = torch.tensor(rng.standard_normal((slots, heads, hd)), dtype=dtype,
                     device=dev)
    k, v = (torch.tensor(rng.standard_normal((n_blocks, heads, bs, d)),
                         dtype=pool_dtype, device=dev) for d in (hd, vd))
    tables = torch.tensor(
        rng.permutation(np.arange(1, n_blocks)).reshape(slots, mb),
        dtype=torch.int32, device=dev)
    nk = torch.tensor(n_keys, dtype=torch.int32, device=dev)
    kw = {}
    if int8:
        k, v, ks, vs = _int8_pools(k, v)
        kw = dict(kscale=ks, vscale=vs)
    if unaligned:
        def shift(t):
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            view = flat[1:].view(t.shape)
            view.copy_(t)
            return view
        k, v = shift(k), shift(v)
    return (q, k, v, tables, nk), kw


def _chunk_keys(dtype, int8, slots, heads, hd, vd, bs, mb):
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[dtype]
    return bs * fd.chunk_blocks(fd._library(), slots, heads, hd, vd, bs, mb,
                                int8, code)


DECODE_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2,
               torch.float16: 2e-3}


# long contexts with few slots, where the split matters most, and key
# counts at the chunk edges, 0 and past the table's extent (mb * bs)
@pytest.mark.cuda
@pytest.mark.parametrize("int8,dtype,hd,vd,bs,mb", [
    (False, torch.float32, 64, 64, 16, 256),
    (False, torch.bfloat16, 128, 128, 8, 256),
    (False, torch.float16, 256, 256, 32, 128),
    (False, torch.bfloat16, 64, 128, 16, 64),
    (False, torch.float32, 128, 64, 32, 128),
    (False, torch.float32, 40, 72, 8, 64),
    (True, torch.bfloat16, 64, 64, 16, 256),
    (True, torch.float32, 128, 256, 8, 256),
    (True, torch.float16, 256, 64, 32, 64),
])
def test_flash_decode_split_keys_match_plain(int8, dtype, hd, vd, bs, mb):
    dev = _cuda()
    heads = 2
    full = mb * bs
    for slots, edges in ((1, [full]), (2, [full - 3, full // 2 + 1])):
        args, kw = _split_case(7, dtype, dev, int8, slots, heads, hd, vd, bs,
                               mb, edges)
        got = fd.flash_decode(*args, **kw)
        want = fd.flash_decode_plain(*args, **kw)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= DECODE_ATOL[dtype], (slots, edges, err)
    ck = _chunk_keys(dtype, int8, 8, heads, hd, vd, bs, mb)
    assert ck < full  # the long slots take several chunks
    edges = [ck - 1, ck, ck + 1, 0, full + 7, 1, full, 2 * ck + 1]
    for unaligned in (False, True):
        args, kw = _split_case(8, dtype, dev, int8, 8, heads, hd, vd, bs, mb,
                               edges, unaligned=unaligned)
        got = fd.flash_decode(*args, **kw)
        want = fd.flash_decode_plain(*args, **kw)
        assert torch.all(got[3] == 0)  # no keys: zeros
        err = (got.float() - want.float()).abs().max().item()
        assert err <= DECODE_ATOL[dtype], (edges, unaligned, err)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_graph_replays_equal_an_eager_call(int8):
    """The split kernel's partials merge in chunk order, so a call is
    bitwise repeatable; it captures into a CUDA graph (its scratch comes
    from the wrapper, its ticket counters stay zero between launches) and
    every replay equals the eager call. One launch a call."""
    dev = _cuda()
    name = "flash_decode_int8" if int8 else "flash_decode"
    args, kw = _split_case(9, torch.bfloat16, dev, int8, 8, 12, 64, 64, 16,
                           32, [512, 1, 300, 17, 0, 511, 128, 64])
    before = fd.launch_count(name)
    eager = fd.flash_decode(*args, **kw)
    again = fd.flash_decode(*args, **kw)
    assert fd.launch_count(name) == before + 2
    assert torch.equal(eager, again)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        out = fd.flash_decode(*args, **kw)
    assert fd.launch_count(name) == before + 3
    for _ in range(2):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    want = fd.flash_decode_plain(*args, **kw)
    assert (eager.float() - want.float()).abs().max().item() <= 2e-2


# ------------------------------------------------------------------ top-k
import flexflow_tpu_torch.kernels.topk as tk  # noqa: E402


def _topk_rows(seed, rows, dim, dtype, dev):
    """Random rows with injected ties (a repeated maximum, and a value
    repeated across the top-k boundary) and one row with two finite
    entries (the rest -inf), as far as there are rows."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((rows, dim)), dtype=torch.float32)
    x[0, [3, 70, dim - 1]] = 9.0
    if rows > 1:
        x[1, [5, 6, 200 % dim]] = 7.5
        x[1, [1, 2]] = 8.0
    if rows > 2:
        x[2] = float("-inf")
        x[2, [dim // 2, 1]] = torch.tensor([0.5, -3.0])
    return x.to(dtype).to(dev)


def _topk_equals_plain(x, k):
    before = tk.launch_count()
    vals, idx = tk.topk(x, k)
    torch.cuda.synchronize()
    assert tk.launch_count() == before + 1
    want_v, want_i = tk.topk_plain(x, k)
    assert vals.dtype == x.dtype and idx.dtype == torch.int32
    assert torch.equal(idx, want_i)
    assert torch.equal(vals, want_v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,dim", [
    (8, 50304), (5, 128), (3, 1001),
    (1, 50304), (1, 1001), (1, 128), (8, 1001), (8, 128),
    (128, 50304), (128, 1001), (128, 128),
    (200, 50304), (200, 1001), (200, 128)])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_topk_kernel_equals_plain(dtype, rows, dim, k):
    """One launch a call, values and indices equal to the plain sweeps':
    rows split across CTAs (1 and 8 rows), one CTA a row (128 and 200
    rows), rows shorter than a chunk."""
    dev = _cuda()
    _topk_equals_plain(_topk_rows(rows * dim + k, rows, dim, dtype, dev), k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,dim", [(1, 50304), (8, 50304), (4, 8192)])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_topk_kernel_ties_across_chunks(dtype, rows, dim, k):
    """An equal maximum in different chunks goes to the lowest index, ties
    across the k-th place straddle a chunk edge, and rows with fewer than
    k finite entries (none, one) still give k distinct indices, equal to
    the plain sweeps'."""
    dev = _cuda()
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[dtype]
    chunk, chunks, _kp = tk.chunking(rows, dim, k, code)
    assert chunks > 1
    rng = np.random.default_rng(rows + dim + k)
    x = torch.tensor(rng.standard_normal((rows, dim)), dtype=torch.float32)
    edge = chunk * (chunks // 2)  # the first element of a middle chunk
    x[0, [dim - 1, edge, edge - 1, 7]] = 6.0
    x[0, [chunk - 1, chunk, 2 * chunk + 5]] = 5.0
    if rows > 1:
        x[1] = float("-inf")
        x[1, edge] = 1.0
        x[2] = float("-inf")
    _topk_equals_plain(x.to(dtype).to(dev), k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows", [1, 8, 200])
@pytest.mark.parametrize("k", [1, 8])
def test_topk_kernel_on_rows_of_equal_values(dtype, rows, k):
    """Rows where thousands of elements tie at the top (all zeros, all
    -inf, a maximum repeated across a whole chunk): far more candidates
    reach a CTA's first threshold than it gathers, so it raises the
    threshold and walks again; the lowest indices still win."""
    dev = _cuda()
    dim = 50304
    x = torch.zeros((rows, dim), dtype=torch.float32)
    if rows > 1:
        x[1] = float("-inf")
        x[-1, 5000:9000] = 3.0
    _topk_equals_plain(x.to(dtype).to(dev), k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_topk_graph_replays_equal_an_eager_call(k):
    """The split kernel captures into a CUDA graph (its scratch comes from
    the wrapper, its ticket counters stay zero between launches), and every
    replay equals the eager call bitwise. One launch a call."""
    dev = _cuda()
    x = _topk_rows(31, 8, 50304, torch.float32, dev)
    before = tk.launch_count()
    eager_v, eager_i = tk.topk(x, k)
    again_v, again_i = tk.topk(x, k)
    assert tk.launch_count() == before + 2
    assert torch.equal(eager_v, again_v) and torch.equal(eager_i, again_i)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        vals, idx = tk.topk(x, k)
    assert tk.launch_count() == before + 3
    for _ in range(2):
        vals.zero_()
        idx.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(vals, eager_v) and torch.equal(idx, eager_i)
    from flexflow_tpu_torch.kernels.tickets import ticket_buffer
    assert int(ticket_buffer("topk", dev, 8).abs().sum()) == 0
    want_v, want_i = tk.topk_plain(x, k)
    assert torch.equal(eager_v, want_v) and torch.equal(eager_i, want_i)


@pytest.mark.cuda
def test_topk_kernel_backward_scatters_the_values_cotangent():
    dev = _cuda()
    x = _topk_rows(11, 4, 256, torch.float32, dev)
    x[2] = torch.randn(256, device=dev)
    x.requires_grad_(True)
    vals, idx = tk.topk(x, 5)
    w = torch.randn_like(vals)
    (gx,) = torch.autograd.grad((vals * w).sum(), x)
    want = torch.zeros_like(x).scatter(-1, idx.long(), w)
    assert torch.equal(gx, want)


# ---------------------------------------------------------------- softmax
import flexflow_tpu_torch.kernels.softmax as sm  # noqa: E402

# fp32: summation order only (probabilities <= 1). 16-bit: each output is
# rounded once on both sides, and an fp32 value one ulp apart can round to
# the neighbouring 16-bit value: one bf16 ulp below 1 is 2**-8 (fp16
# 2**-11); gradients the same, relative to their largest element
SM_TOL = {torch.float32: 2e-6, torch.bfloat16: 2 ** -8,
          torch.float16: 2 ** -11}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,dim", [(64, 50304), (16, 1024), (5, 1001),
                                      (2, 70000)])
def test_softmax_kernels_match_plain(dtype, rows, dim):
    """Rows that fit shared memory and one that does not (70000 fp32),
    vector loads and the scalar form (dim 1001)."""
    dev = _cuda()
    rng = np.random.default_rng(rows + dim)
    x = torch.tensor(rng.standard_normal((rows, dim)) * 4.0,
                     dtype=dtype, device=dev)
    g = torch.tensor(rng.standard_normal((rows, dim)), dtype=dtype,
                     device=dev)
    sm.reset_launch_count()
    p = sm._forward(x)
    dx = sm._backward(p, g)
    torch.cuda.synchronize()
    assert sm.launch_count("softmax_fwd") == 1
    assert sm.launch_count("softmax_bwd") == 1
    want_p = sm.softmax_plain(x)
    want_dx = sm.softmax_bwd_plain(p, g)
    assert p.dtype == dtype and dx.dtype == dtype
    assert (p.float() - want_p.float()).abs().max().item() <= SM_TOL[dtype]
    scale = want_dx.float().abs().max().item()
    assert (dx.float() - want_dx.float()).abs().max().item() \
        <= SM_TOL[dtype] * max(scale, 1e-30) + 1e-12


@pytest.mark.cuda
def test_softmax_autograd_launches_both_kernels():
    dev = _cuda()
    x = torch.randn(8, 2048, device=dev, requires_grad=True)
    w = torch.randn(8, 2048, device=dev)
    sm.reset_launch_count()
    p = sm.softmax(x)
    (gx,) = torch.autograd.grad((p * w).sum(), x)
    assert sm.launch_count("softmax_fwd") == 1
    assert sm.launch_count("softmax_bwd") == 1
    xr = x.detach().clone().requires_grad_(True)
    (gr,) = torch.autograd.grad((torch.softmax(xr, -1) * w).sum(), xr)
    assert (gx - gr).abs().max().item() <= 1e-6


# ----------------------------------------- non-finite rows (serving chaos)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,dim", [(8, 50304), (128, 1001)])
@pytest.mark.parametrize("k", [1, 8])
def test_topk_kernel_on_non_finite_rows(dtype, rows, dim, k):
    """The sampler's top-k fed a quarantined slot's logits: a row of NaN,
    a row with NaN in every other element, a row with NaN at a few places
    and rows with +inf / -inf entries. The kernel returns, in one launch;
    every row without a NaN (the inf rows included) equals the plain
    sweeps' values and indices, and a NaN row's indices are in range and
    distinct (the selection clamps NaN, as -inf, to -FLT_MAX: its token is
    drawn and discarded, as in the JAX loop)."""
    dev = _cuda()
    x = _topk_rows(rows + dim + k, rows, dim, torch.float32, "cpu")
    x[1] = float("nan")
    x[3, ::2] = float("nan")
    x[4, [0, dim // 3, dim - 1]] = float("nan")
    x[5, [10, 20]] = float("inf")
    x[6, [7, dim - 2]] = float("-inf")
    x = x.to(dtype).to(dev)
    before = tk.launch_count()
    vals, idx = tk.topk(x, k)
    torch.cuda.synchronize()
    assert tk.launch_count() == before + 1
    want_v, want_i = tk.topk_plain(x, k)
    nan_rows = torch.isnan(x).any(dim=-1)
    healthy = ~nan_rows
    assert torch.equal(idx[healthy], want_i[healthy])
    assert torch.equal(vals[healthy], want_v[healthy])
    for r in torch.nonzero(nan_rows)[:, 0].tolist():
        got = idx[r].tolist()
        assert all(0 <= i < dim for i in got) and len(set(got)) == k


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mb", [4, 64])
def test_flash_decode_on_a_poisoned_slot(int8, mb):
    """A slot whose KV blocks are NaN (the serving chaos poison: the rows
    of a native pool, the scales of an int8 one), with one chunk a slot
    (mb 4) and keys split across CTAs (mb 64): the poisoned slot's output
    is NaN in every element, as the plain version's, and every other slot
    equals the same launch on unpoisoned pools bit for bit and the plain
    version within DECODE_ATOL."""
    dev = _cuda()
    slots, heads, bs, victim = 8, 12, 16, 2
    full = mb * bs
    args, kw = _split_case(11, torch.float32, dev, int8, slots, heads, 64,
                           64, bs, mb, [full, 5, full // 2, 1, full - 3,
                                        bs, 2 * bs + 1, full])
    clean = fd.flash_decode(*args, **kw)
    q, k, v, tables, nk = args
    used = -(-int(nk[victim]) // bs)
    blocks = tables[victim, :used].long()
    if int8:
        kw = {n: s.clone().index_fill_(0, blocks, float("nan"))
              for n, s in kw.items()}
    else:
        k = k.clone().index_fill_(0, blocks, float("nan"))
        v = v.clone().index_fill_(0, blocks, float("nan"))
    before = fd.launch_count("flash_decode_int8" if int8 else
                             "flash_decode")
    got = fd.flash_decode(q, k, v, tables, nk, **kw)
    torch.cuda.synchronize()
    assert fd.launch_count("flash_decode_int8" if int8 else
                           "flash_decode") == before + 1
    want = fd.flash_decode_plain(q, k, v, tables, nk, **kw)
    assert torch.isnan(got[victim]).all() and torch.isnan(want[victim]).all()
    rest = [s for s in range(slots) if s != victim]
    assert torch.equal(got[rest], clean[rest])
    assert (got[rest] - want[rest]).abs().max().item() <= \
        DECODE_ATOL[torch.float32]
