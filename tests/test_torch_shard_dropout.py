"""The dropout hashes in global coordinates, on the CPU through the plain
versions (the card tests in tests/test_torch_kernels_cuda.py hold the
kernels to the same law).

The counter hash of B1-B4 keys on ``bh = b * H + h``. A data- or
tensor-parallel rank holds a block of the batch and of the heads, so it
passes its offsets and the global head count (``shard``): its forward
output, lse and grads must equal the unsharded call's at that block, for
the fused (B2) and the two-pass (B3 + B4) backward; without the offsets
the block draws another mask. The einsum core (``mha_core``) and the
dropout op (``ops.elementwise.dropout_mask``: the element's flat index in
the whole tensor) follow the same law.
"""
import numpy as np
import pytest
import torch

from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.ops.attention import mha_core
from flexflow_tpu_torch.ops.elementwise import dropout_mask

B, H, S, D = 4, 4, 128, 16
RATE, SEED = 0.1, 0x5EED
# (batch block, head block): a tp rank, a dp rank, a dp x tp rank
BLOCKS = [((0, 4), (2, 4)), ((2, 4), (0, 4)), ((2, 4), (2, 4))]


def _inputs():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(B, H, S, D, generator=g) for _ in range(4)]


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("fused", [True, False])
def test_flash_plain_on_a_shard_is_the_unsharded_block(block, fused):
    q, k, v, do = _inputs()
    o, lse = fa.flash_forward_plain(q, k, v, False, 64, 64, RATE, SEED)
    grads = fa.flash_backward_plain(q, k, v, o, lse, do, False, 64, 64,
                                    RATE, SEED, fused=fused)
    (b0, b1), (h0, h1) = block
    sl = (slice(b0, b1), slice(h0, h1))
    qs, ks, vs, ds = (t[sl].contiguous() for t in (q, k, v, do))
    shard = (b0, h0, H)
    so, slse = fa.flash_forward_plain(qs, ks, vs, False, 64, 64, RATE, SEED,
                                      shard)
    torch.testing.assert_close(so, o[sl], rtol=0, atol=0)
    torch.testing.assert_close(slse, lse[sl], rtol=0, atol=0)
    got = fa.flash_backward_plain(qs, ks, vs, so, slse, ds, False, 64, 64,
                                  RATE, SEED, fused=fused, shard=shard)
    for g, w in zip(got, grads):
        torch.testing.assert_close(g, w[sl], rtol=0, atol=0)
    bare, _ = fa.flash_forward_plain(qs, ks, vs, False, 64, 64, RATE, SEED)
    assert not torch.equal(bare, o[sl])


@pytest.mark.parametrize("block", BLOCKS)
def test_einsum_core_on_a_shard_is_the_unsharded_block(block):
    q, k, v, _ = _inputs()
    want = mha_core(q, k, v, dropout=RATE, seed=SEED)
    (b0, b1), (h0, h1) = block
    sl = (slice(b0, b1), slice(h0, h1))
    got = mha_core(q[sl], k[sl], v[sl], dropout=RATE, seed=SEED,
                   shard=(b0, h0, H))
    torch.testing.assert_close(got, want[sl], rtol=0, atol=0)


@pytest.mark.parametrize("offsets,shape", [((2, 0, 0), (2, 8, 16)),
                                           ((0, 0, 8), (4, 8, 8)),
                                           ((2, 4, 8), (2, 4, 8))])
def test_dropout_op_mask_on_a_shard_is_the_unsharded_block(offsets, shape):
    full = (4, 8, 16)
    want = dropout_mask(SEED, full, RATE, torch.device("cpu"))
    got = dropout_mask(SEED, shape, RATE, torch.device("cpu"),
                       global_shape=full, offsets=offsets)
    sl = tuple(slice(o, o + n) for o, n in zip(offsets, shape))
    torch.testing.assert_close(got, want[sl], rtol=0, atol=0)
    keep = float((want > 0).float().mean())
    assert abs(keep - (1 - RATE)) < 0.05
    assert np.isfinite(got.numpy()).all()
