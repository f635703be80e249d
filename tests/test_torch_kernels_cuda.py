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
