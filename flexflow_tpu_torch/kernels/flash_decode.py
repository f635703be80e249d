"""Paged single-token attention ("flash decode"): the serving decode step's
attention read over the paged KV pool.

Port of ``flexflow_tpu/kernels/flash_decode.py`` (the Pallas split-K
``_decode_kernel``). The CUDA kernel is ``csrc/flash_decode.cu``; its
header says what bounds it (bytes: the used K/V rows) and how the design
follows from that. Beside it:

* :func:`flash_decode_plain` — the same function in plain PyTorch, walking
  the same per-block online-softmax loop (the TPU kernel's grid order,
  clamp and mask). The CPU path and the tests use it; on the card it is
  only the reference the kernel is held against.
* :func:`flash_decode` — the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises. It never falls back.
* :func:`launch_count` — kernel launches since the last
  :func:`reset_launch_count`, so a run can show it went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

NEG_INF = -1e30

_launches = 0


def launch_count() -> int:
    """CUDA launches of the flash-decode kernel since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _scale(head_dim: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)


def flash_decode_plain(q, kpool, vpool, block_tables, n_keys, *,
                       sm_scale: Optional[float] = None):
    """Plain-PyTorch flash decode, step for step the TPU kernel's loop.

    q            (n_slots, heads, head_dim), any float dtype
    kpool/vpool  (n_blocks, heads, block_size, kd|vd)
    block_tables (n_slots, max_blocks_per_slot) int
    n_keys       (n_slots,) int — keys each slot attends (position + 1)

    For block step j of every slot: the pool block is
    ``tables[s, min(j, used - 1)]`` (steps past the last used block clamp to
    it), keys at global position >= n_keys are masked, and (m, l, acc)
    follow the online-softmax recurrence in fp32; a slot only updates on
    steps that hold at least one of its keys. Returns
    (n_slots, heads, vd) in q's dtype; a slot with no keys gets zeros.
    """
    import torch

    n_slots, heads, head_dim = q.shape
    block_size = kpool.shape[2]
    vd = vpool.shape[-1]
    mb = block_tables.shape[1]
    dev = q.device
    qf = q.float() * _scale(head_dim, sm_scale)
    tables = block_tables.long()
    nk = n_keys.long()
    used = (nk + block_size - 1) // block_size
    m = torch.full((n_slots, heads, 1), NEG_INF, device=dev)
    l = torch.zeros((n_slots, heads, 1), device=dev)
    acc = torch.zeros((n_slots, heads, vd), device=dev)
    rows = torch.arange(n_slots, device=dev)
    offs = torch.arange(block_size, device=dev)
    for j in range(mb):
        jj = torch.clamp(torch.clamp(used - 1, min=0), max=j)
        blk = tables[rows, jj]
        k = kpool[blk].float()                       # (S, h, bs, kd)
        v = vpool[blk].float()                       # (S, h, bs, vd)
        s = torch.einsum("shd,shkd->shk", qf, k)
        live = (j * block_size + offs)[None, :] < nk[:, None]   # (S, bs)
        s = torch.where(live[:, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        step = (j * block_size < nk)[:, None, None]   # slot has keys here
        acc = torch.where(step, acc * corr
                          + torch.einsum("shk,shkd->shd", p, v), acc)
        l = torch.where(step, l * corr + p.sum(dim=-1, keepdim=True), l)
        m = torch.where(step, m_new, m)
    out = torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)),
                      torch.zeros_like(acc))
    return out.to(q.dtype)


def _dtype_code(dtype) -> int:
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise TypeError(f"flash_decode: unsupported dtype {dtype} (the kernel "
                        "takes float32, bfloat16 and float16)")
    return codes[dtype]


def _library():
    from .build import load

    lib = load("flash_decode")
    fn = lib.ff_flash_decode
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_inputs(q, kpool, vpool, block_tables, n_keys) -> None:
    import torch

    if q.dim() != 3 or kpool.dim() != 4 or vpool.dim() != 4:
        raise ValueError("flash_decode: q must be (S, h, d) and the pools "
                         "(n_blocks, h, block_size, d)")
    n_slots, heads, hd = q.shape
    if kpool.shape[:3] != vpool.shape[:3] or kpool.shape[1] != heads \
            or kpool.shape[3] != hd:
        raise ValueError(
            f"flash_decode: pool shapes {tuple(kpool.shape)} / "
            f"{tuple(vpool.shape)} do not match q {tuple(q.shape)}")
    if not (1 <= hd <= 256 and 1 <= vpool.shape[3] <= 256):
        raise ValueError("flash_decode: head dims must be in [1, 256], got "
                         f"{hd} and {vpool.shape[3]}")
    if not 1 <= n_slots <= 65535:
        raise ValueError(f"flash_decode: {n_slots} slots (1..65535)")
    if block_tables.dim() != 2 or block_tables.shape[0] != n_slots \
            or tuple(n_keys.shape) != (n_slots,):
        raise ValueError("flash_decode: block_tables must be (S, mb) and "
                         "n_keys (S,)")
    if block_tables.dtype != torch.int32 or n_keys.dtype != torch.int32:
        raise TypeError("flash_decode: block_tables and n_keys must be int32")
    if not (kpool.dtype == vpool.dtype == q.dtype):
        raise TypeError(f"flash_decode: q {q.dtype} and pools {kpool.dtype}/"
                        f"{vpool.dtype} must share one dtype")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool),
                    ("block_tables", block_tables), ("n_keys", n_keys)):
        if t.device != q.device:
            raise ValueError(f"flash_decode: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")


def flash_decode(q, kpool, vpool, block_tables, n_keys, *,
                 sm_scale: Optional[float] = None):
    """Single-token paged attention: ``(n_slots, heads, vd)`` in q's dtype.

    Shapes as in :func:`flash_decode_plain`. On CUDA tensors this launches
    ``csrc/flash_decode.cu`` (fp32, bf16 or fp16; q and pools of one dtype;
    head dims <= 256; int32 tables and counts; contiguous) and raises on
    anything else; CPU tensors take :func:`flash_decode_plain`."""
    global _launches
    import torch

    if q.device.type == "cpu":
        return flash_decode_plain(q, kpool, vpool, block_tables, n_keys,
                                  sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    _check_cuda_inputs(q, kpool, vpool, block_tables, n_keys)
    from .build import check

    lib = _library()
    n_slots, heads, hd = q.shape
    vd = vpool.shape[3]
    out = torch.empty((n_slots, heads, vd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.ff_flash_decode(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
        block_tables.data_ptr(), n_keys.data_ptr(), out.data_ptr(),
        n_slots, heads, hd, vd, kpool.shape[2], block_tables.shape[1],
        _scale(hd, sm_scale), _dtype_code(q.dtype), stream)
    check(lib, code, "flash_decode launch")
    _launches += 1
    return out
