"""The port's flash attention against the JAX package's, on the CPU.

The same seeded q, k, v and dO go through JAX's Pallas kernels in
interpret mode (``_flash_forward`` / ``_flash_backward`` /
``flash_attention(..., interpret=True)``) and the port's plain versions
(``flash_forward_plain`` / ``flash_backward_plain`` / the autograd
Function on CPU tensors), which walk the same tiles:

* O and lse, and dq/dk/dv in the fused one-pass schedule and in the
  two-pass one, fp32 within atol/rtol 1e-5 (summation order only);
* gradients through the autograd Function against ``jax.grad`` of JAX's
  ``flash_attention``;
* cases: non-causal; causal sq = sk; causal sq=128 < sk=256 (band offset);
  blocks of 64 at seq 256 (several tiles, causal tile skipping); dropout
  0.1 with one seed shared by both packages;
* the dropout keep-scale masks equal bit for bit over random coordinates;
* bf16 inputs: O within atol 2e-2 and grads within 2e-2 of their largest
  element (both sides round P and dS to bf16 before each product, and a
  probability one fp32 ulp apart can round to neighbouring bf16 values),
  in the fused schedule and, case by case (causal, non-causal, a
  rectangular band, head dim 128, dropout), in the two-pass one: the
  reference the CUDA dK/dV and dQ kernels are held against on the card;
* ``FFModel.sdpa`` (``SDPAOp``, the second route to the kernels) on both
  its routes, predict outputs within 1e-5.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu.kernels.flash_attention  # noqa: F401
import flexflow_tpu_torch.kernels.flash_attention as fa

jfa = sys.modules["flexflow_tpu.kernels.flash_attention"]

# as in torch_training_pairs: no oversubscribing the host under parallel
# test workers
torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
SEED = 0xC0FFEE

# (causal, seq_q, seq_k, block_q, block_k, dropout)
CASES = [
    (False, 128, 128, 128, 128, 0.0),
    (True, 128, 128, 128, 128, 0.0),
    (True, 128, 256, 128, 128, 0.0),
    (True, 256, 256, 64, 64, 0.0),
    (False, 256, 256, 64, 64, 0.1),
    (True, 256, 256, 64, 64, 0.1),
]


def _inputs(sq, sk, seed=0, b=2, h=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                      (b, h, sq, d))]


def _t(arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("causal,sq,sk,bq,bk,dropout", CASES)
def test_forward_and_both_backward_schedules_match_jax(causal, sq, sk, bq,
                                                       bk, dropout):
    arrays = _inputs(sq, sk)
    q, k, v, do = _j(arrays)
    seed = jnp.uint32(SEED)
    o_j, lse_j = jfa._flash_forward(q, k, v, causal, bq, bk, True,
                                    dropout=dropout, seed=seed)
    tq, tk, tv, tdo = _t(arrays)
    o_t, lse_t = fa.flash_forward_plain(tq, tk, tv, causal, bq, bk, dropout,
                                        SEED)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)
    # both backward schedules from the same (O, lse)
    o_in, lse_in = torch.tensor(np.asarray(o_j)), torch.tensor(
        np.asarray(lse_j))
    for fused in (True, False):
        want = jfa._flash_backward(q, k, v, o_j, lse_j, do, causal, bq, bk,
                                   True, dropout=dropout, seed=seed,
                                   fused=fused)
        got = fa.flash_backward_plain(tq, tk, tv, o_in, lse_in, tdo, causal,
                                      bq, bk, dropout, SEED, fused=fused)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=f"{name} fused={fused}")


@pytest.mark.parametrize("causal,sq,sk,bq,bk,dropout", [CASES[2], CASES[5]])
def test_autograd_function_matches_jax_grad(causal, sq, sk, bq, bk,
                                            dropout):
    arrays = _inputs(sq, sk, seed=1)
    q, k, v, do = _j(arrays)

    def f(q, k, v):
        out = jfa.flash_attention(q, k, v, causal, bq, bk, True,
                                  dropout=dropout, seed=jnp.uint32(SEED))
        return jnp.sum(out * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    leaves = [t.requires_grad_() for t in _t(arrays[:3])]
    out = fa.flash_attention(*leaves, causal=causal, block_q=bq,
                             block_k=bk, dropout=dropout, seed=SEED)
    (out * torch.tensor(arrays[3])).sum().backward()
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_backward_schedule_follows_the_jax_rule(monkeypatch):
    """None picks fused below the residency budget and two-pass above it,
    in both packages; the plain schedules agree with each other."""
    assert fa.FUSED_BWD_RESIDENT_BUDGET == jfa.FUSED_BWD_RESIDENT_BUDGET
    assert fa.use_fused_backward(512, 64)
    assert not fa.use_fused_backward(16384, 64)
    monkeypatch.setattr(fa, "FUSED_BWD_RESIDENT_BUDGET", 128 * 64 * 10)
    assert not fa.use_fused_backward(256, 64)
    tq, tk, tv, tdo = _t(_inputs(256, 256, seed=2))
    o, lse = fa.flash_forward_plain(tq, tk, tv, True, 64, 64)
    auto = fa._flash_backward(tq, tk, tv, o, lse, tdo, True, 64, 64)
    two = fa._flash_backward(tq, tk, tv, o, lse, tdo, True, 64, 64,
                             fused=False)
    for a, b in zip(auto, two):
        assert torch.equal(a, b)


def test_dropout_masks_are_bit_identical_to_jax():
    rng = np.random.default_rng(3)
    n = 4096
    bh = rng.integers(0, 2 ** 20, n)
    qp = rng.integers(0, 2 ** 31, n)
    kp = rng.integers(0, 2 ** 31, n)
    for rate, seed in ((0.1, 0), (0.5, 2 ** 32 - 1), (0.9, 123456789)):
        want = np.asarray(jfa.dropout_keep_scale_nd(
            jnp.uint32(seed), jnp.asarray(bh, jnp.uint32),
            jnp.asarray(qp, jnp.uint32), jnp.asarray(kp, jnp.uint32), rate))
        got = fa.dropout_keep_scale_plain(seed, torch.tensor(bh),
                                          torch.tensor(qp),
                                          torch.tensor(kp), rate).numpy()
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert 0 < (got == 0).mean() < 1


def test_bf16_inputs_in_band():
    causal, sq, sk, bq, bk = True, 256, 256, 64, 64
    arrays = _inputs(sq, sk, seed=4)
    q, k, v, do = _j(arrays, jnp.bfloat16)
    o_j, lse_j = jfa._flash_forward(q, k, v, causal, bq, bk, True)
    tq, tk, tv, tdo = _t(arrays, torch.bfloat16)
    o_t, lse_t = fa.flash_forward_plain(tq, tk, tv, causal, bq, bk)
    assert o_t.dtype == torch.bfloat16
    o_jf = np.asarray(o_j.astype(jnp.float32))
    assert np.abs(o_t.float().numpy() - o_jf).max() <= 2e-2
    assert np.abs(lse_t.numpy() - np.asarray(lse_j)).max() <= 2e-2
    want = jfa._flash_backward(q, k, v, o_j, lse_j, do, causal, bq, bk,
                               True, fused=True)
    got = fa.flash_backward_plain(
        tq, tk, tv, torch.tensor(o_jf).to(torch.bfloat16),
        torch.tensor(np.asarray(lse_j)), tdo, causal, bq, bk, fused=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max() / max(1.0, np.abs(w).max())
        assert err <= 2e-2, (name, err)


# (causal, seq_q, seq_k, head_dim, dropout) of the bf16 two-pass cases
BF16_TWO_PASS = [
    (True, 256, 256, 64, 0.0),
    (False, 256, 256, 64, 0.0),
    (True, 128, 256, 64, 0.0),     # rectangular band, offset sk - sq
    (True, 256, 256, 128, 0.0),
    (True, 256, 256, 64, 0.1),
]


@pytest.mark.parametrize("causal,sq,sk,d,dropout", BF16_TWO_PASS)
def test_bf16_two_pass_matches_jax(causal, sq, sk, d, dropout):
    """The two-pass backward (dK/dV walk, then the dQ walk, delta from dO
    outside) in bf16 from the same inputs, O and lse: grads within 2e-2 of
    their largest element, as for the fused schedule above."""
    bq = bk = 64
    arrays = _inputs(sq, sk, seed=8, d=d)
    q, k, v, do = _j(arrays, jnp.bfloat16)
    seed = jnp.uint32(SEED)
    o_j, lse_j = jfa._flash_forward(q, k, v, causal, bq, bk, True,
                                    dropout=dropout, seed=seed)
    want = jfa._flash_backward(q, k, v, o_j, lse_j, do, causal, bq, bk,
                               True, dropout=dropout, seed=seed, fused=False)
    tq, tk, tv, tdo = _t(arrays, torch.bfloat16)
    o_in = torch.tensor(np.asarray(o_j.astype(jnp.float32))).to(
        torch.bfloat16)
    got = fa.flash_backward_plain(tq, tk, tv, o_in,
                                  torch.tensor(np.asarray(lse_j)), tdo,
                                  causal, bq, bk, dropout, SEED, fused=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max() / max(1.0, np.abs(w).max())
        assert err <= 2e-2, (name, err)


def test_entry_point_validates_like_jax():
    tq, tk, tv, _ = _t(_inputs(128, 64, seed=5))
    with pytest.raises(ValueError, match="seq_q <= seq_k"):
        fa.flash_attention(tq, tk, tv, causal=True)
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention(tq, tk, tv, dropout=0.1)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(tq, tk, tv, block_q=96)


@pytest.mark.parametrize("use_flash,causal,masked", [
    (True, False, False),
    (True, True, False),
    ("auto", True, False),     # CPU tensors: "auto" takes the einsum core
    (True, False, True),       # a mask sends even use_flash to the core
])
def test_sdpa_op_matches_jax(use_flash, causal, masked):
    """``FFModel.sdpa`` on pre-projected q/k/v: the flash route (plain
    versions here, interpret mode in JAX) or the einsum core, with an
    additive mask on the core route; predict outputs within 1e-5."""
    import flexflow_tpu as fj
    import flexflow_tpu_torch as ft

    b, h, s, d = 2, 2, 128, 64
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal((b, h, s, d)).astype(np.float32)
              for _ in range(3)]
    if masked:
        arrays.append(np.where(rng.random((b, h, s, s)) < 0.2, -1e9,
                               0.0).astype(np.float32))
    outs = []
    for pkg in (fj, ft):
        config = pkg.FFConfig()
        config.batch_size = b
        ff = pkg.FFModel(config) if pkg is fj else \
            pkg.FFModel(config, device="cpu")
        ins = [ff.create_tensor(a.shape) for a in arrays]
        ff.sdpa(*ins[:3], attn_mask=ins[3] if masked else None,
                causal=causal)
        for layer in ff._layers:
            layer.attrs["use_flash"] = use_flash
        ff.compile()
        outs.append(np.asarray(ff.predict(arrays)))
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
