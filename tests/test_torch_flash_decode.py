"""flash_decode in the PyTorch port against the JAX package.

The port's plain version (``flash_decode_plain``, the CPU path of its
wrapper) is held against the JAX Pallas kernel run in interpret mode and
against the JAX masked-gather reference, on the same seeded numpy inputs:
S=3 slots, 4 heads, head_dim 64, block_size 8, 4 blocks per slot, random
non-contiguous block tables, and key counts covering 1, a non-multiple of
the block size, an exact multiple and the full table. The CUDA kernel
itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.kernels.flash_decode import (_reference_decode,
                                               flash_decode as jax_decode)
import flexflow_tpu_torch.kernels.flash_decode as fd

S, H, D, BS, MB, N_BLOCKS = 3, 4, 64, 8, 4, 16
# fp32: the two implementations differ only in summation order
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 inputs: outputs are rounded to bf16 (8 mantissa bits), so one ulp of
# a value near 1 is 2**-7 ~ 8e-3; 2e-2 allows a couple of ulps
BF16_ATOL = 2e-2

N_KEYS_CASES = [
    (1, 13, 32),    # one key, a non-multiple of bs, the full mb * bs
    (16, 8, 5),     # exact multiples of bs (2 * bs, bs) and a short tail
    (32, 31, 2),
]


def _inputs(seed, n_keys, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    kpool = rng.standard_normal((N_BLOCKS, H, BS, D)).astype(np.float32)
    vpool = rng.standard_normal((N_BLOCKS, H, BS, D)).astype(np.float32)
    # distinct, shuffled, non-contiguous blocks per slot (never block 0)
    perm = rng.permutation(np.arange(1, N_BLOCKS))[:S * MB]
    tables = perm.reshape(S, MB).astype(np.int32)
    nk = np.asarray(n_keys, np.int32)
    return q, kpool, vpool, tables, nk


def _port(q, kpool, vpool, tables, nk, tdtype=torch.float32):
    out = fd.flash_decode_plain(
        torch.tensor(q, dtype=tdtype), torch.tensor(kpool, dtype=tdtype),
        torch.tensor(vpool, dtype=tdtype), torch.tensor(tables),
        torch.tensor(nk))
    return out.float().numpy()


@pytest.mark.parametrize("n_keys", N_KEYS_CASES)
def test_plain_matches_jax_interpret_fp32(n_keys):
    q, kpool, vpool, tables, nk = _inputs(0, n_keys)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(kpool),
                                 jnp.asarray(vpool), jnp.asarray(tables),
                                 jnp.asarray(nk), interpret=True))
    np.testing.assert_allclose(_port(q, kpool, vpool, tables, nk), want,
                               **F32_TOL)


@pytest.mark.parametrize("n_keys", N_KEYS_CASES)
def test_plain_matches_jax_gather_reference_fp32(n_keys):
    q, kpool, vpool, tables, nk = _inputs(1, n_keys)
    want = np.asarray(_reference_decode()(
        jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(tables), jnp.asarray(nk), 1.0 / np.sqrt(D)))
    np.testing.assert_allclose(_port(q, kpool, vpool, tables, nk), want,
                               **F32_TOL)


@pytest.mark.parametrize("n_keys", N_KEYS_CASES[:2])
def test_plain_matches_jax_interpret_bf16(n_keys):
    q, kpool, vpool, tables, nk = _inputs(2, n_keys)
    bf = jnp.bfloat16
    want = np.asarray(jax_decode(
        jnp.asarray(q, bf), jnp.asarray(kpool, bf), jnp.asarray(vpool, bf),
        jnp.asarray(tables), jnp.asarray(nk), interpret=True)
    ).astype(np.float32)
    # the bf16 roundings of the inputs are identical in both frameworks
    # (round-to-nearest-even from the same fp32 values)
    got = _port(q, kpool, vpool, tables, nk, tdtype=torch.bfloat16)
    assert np.max(np.abs(got - want)) <= BF16_ATOL


def test_wrapper_takes_plain_path_on_cpu_without_launching():
    q, kpool, vpool, tables, nk = _inputs(3, N_KEYS_CASES[0])
    args = [torch.tensor(a) for a in (q, kpool, vpool, tables, nk)]
    fd.reset_launch_count()
    out = fd.flash_decode(*args)
    assert fd.launch_count() == 0
    torch.testing.assert_close(out, fd.flash_decode_plain(*args),
                               rtol=0, atol=0)


def test_plain_clamps_keys_to_the_table_and_zeroes_empty_slots():
    """n_keys past mb * bs attends to the whole table (the TPU grid has mb
    steps); a slot with no keys returns zeros."""
    q, kpool, vpool, tables, _ = _inputs(4, N_KEYS_CASES[0])
    args = [torch.tensor(a) for a in (q, kpool, vpool, tables)]
    full = fd.flash_decode_plain(*args, torch.tensor([MB * BS] * S,
                                                     dtype=torch.int32))
    over = fd.flash_decode_plain(*args, torch.tensor([MB * BS + 5] * S,
                                                     dtype=torch.int32))
    torch.testing.assert_close(over, full, rtol=0, atol=0)
    empty = fd.flash_decode_plain(*args, torch.zeros(S, dtype=torch.int32))
    assert torch.count_nonzero(empty) == 0
