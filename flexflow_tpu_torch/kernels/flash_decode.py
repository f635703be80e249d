"""Paged single-token attention ("flash decode"): the serving decode step's
attention read over the paged KV pool.

Port of ``flexflow_tpu/kernels/flash_decode.py`` (the Pallas split-K
``_decode_kernel``, both branches: native-dtype pools, and int8 pools with
f32 per-(token, head) scales). The CUDA kernel is ``csrc/flash_decode.cu``
(``ff_flash_decode``, ``ff_flash_decode_int8``); its header says what
bounds it (the used K/V rows, and at decode sizes the latency of fetching
them) and how the design follows from that: each (slot, head)'s keys are
split into chunks of whole blocks across CTAs, sized from the launch's
shape and the SM count (:func:`chunk_blocks`), never from the key counts,
and the last CTA of a (slot, head) merges the chunks' partials in chunk
order, in the same launch. Beside it:

* :func:`flash_decode_plain` — the same function in plain PyTorch, walking
  the same per-block online-softmax loop (the TPU kernel's grid order,
  clamp and mask). The CPU path and the tests use it; on the card it is
  only the reference the kernel is held against.
* :func:`flash_decode` — the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises. It never falls back.
  It allocates the output and the chunks' fp32 scratch with
  ``torch.empty`` on every call, so a launch can be captured in a CUDA
  graph and replayed. The per-(slot, head) ticket counters are state kept
  across calls: made zeroed on the first eager call of a device (a first
  call inside a capture raises), left zero by every launch, and shared by
  all launches on the device, which must therefore run on one stream.
* :func:`launch_count` — launches of each branch (``"flash_decode"``,
  ``"flash_decode_int8"``) since the last :func:`reset_launch_count`, so a
  run can show it went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

NEG_INF = -1e30

KERNELS = ("flash_decode", "flash_decode_int8")
_launches = dict.fromkeys(KERNELS, 0)


def launch_count(kernel: str = "flash_decode") -> int:
    """CUDA launches of one branch of the kernel (native pools by default,
    ``"flash_decode_int8"`` for int8 pools) since the last reset."""
    return _launches[kernel]


def reset_launch_count() -> None:
    for name in KERNELS:
        _launches[name] = 0


def _scale(head_dim: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)


def flash_decode_plain(q, kpool, vpool, block_tables, n_keys, *,
                       sm_scale: Optional[float] = None, kscale=None,
                       vscale=None):
    """Plain-PyTorch flash decode, step for step the TPU kernel's loop.

    q            (n_slots, heads, head_dim), any float dtype
    kpool/vpool  (n_blocks, heads, block_size, kd|vd) — a float dtype, or
                 int8 with ``kscale``/``vscale`` (n_blocks, heads,
                 block_size) f32 per-(token, head) scales
    block_tables (n_slots, max_blocks_per_slot) int
    n_keys       (n_slots,) int — keys each slot attends (position + 1)

    For block step j of every slot: the pool block is
    ``tables[s, min(j, used - 1)]`` (steps past the last used block clamp to
    it), keys at global position >= n_keys are masked, and (m, l, acc)
    follow the online-softmax recurrence in fp32; a slot only updates on
    steps that hold at least one of its keys. An int8 block is dequantized
    in fp32 (``k.float() * scale``) as the TPU kernel does. Returns
    (n_slots, heads, vd) in q's dtype; a slot with no keys gets zeros, and
    a NaN in a slot's live keys or values makes its row NaN, as in the
    kernel.
    """
    import torch

    int8 = _check_scales(kpool, kscale, vscale)
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
        if int8:
            k = k * kscale[blk][..., None]
            v = v * vscale[blk][..., None]
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
    # a slot with no keys gets zeros; otherwise acc / l, so a non-finite
    # key or value row (a poisoned KV block) reaches the output as the
    # kernel's division and the TPU kernel's give it
    has = (nk > 0)[:, None, None]
    out = torch.where(has, acc / torch.where(has, l, torch.ones_like(l)),
                      torch.zeros_like(acc))
    return out.to(q.dtype)


def _check_scales(kpool, kscale, vscale) -> bool:
    """True for an int8 pool (which needs both scale arrays)."""
    import torch

    if kpool.dtype == torch.int8:
        if kscale is None or vscale is None:
            raise ValueError("flash_decode: int8 pools need kscale/vscale")
        return True
    if kscale is not None or vscale is not None:
        raise ValueError("flash_decode: scales are for int8 pools only")
    return False


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
    if lib.ff_flash_decode.argtypes is None:
        tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.ff_flash_decode.argtypes = [ctypes.c_void_p] * 8 + tail
        lib.ff_flash_decode_int8.argtypes = [ctypes.c_void_p] * 10 + tail
        lib.ff_flash_decode_chunk_blocks.argtypes = [ctypes.c_int] * 8
        for fn in (lib.ff_flash_decode, lib.ff_flash_decode_int8,
                   lib.ff_flash_decode_chunk_blocks):
            fn.restype = ctypes.c_int
    return lib


# chunk blocks by launch shape (a pure function of host-known values)
_chunks = {}


def chunk_blocks(lib, n_slots: int, heads: int, hd: int, vd: int, bs: int,
                 mb: int, int8: bool, dtype_code: int) -> int:
    """Blocks of one key chunk a CTA takes (``csrc/flash_decode.cu``
    ``chunk_blocks_for``): from the launch's shape and the SM count only,
    never from the key counts."""
    key = (n_slots, heads, hd, vd, bs, mb, int8, dtype_code)
    cb = _chunks.get(key)
    if cb is None:
        cb = lib.ff_flash_decode_chunk_blocks(n_slots, heads, hd, vd, bs, mb,
                                              int(int8), dtype_code)
        if cb < 1:
            raise ValueError(f"flash_decode: no chunking for shape {key}")
        _chunks[key] = cb
    return cb


def _check_cuda_inputs(q, kpool, vpool, block_tables, n_keys, kscale=None,
                       vscale=None) -> None:
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
    _dtype_code(q.dtype)
    scales = []
    if kscale is not None:
        if kpool.dtype != torch.int8 or vpool.dtype != torch.int8:
            raise TypeError(f"flash_decode: int8 pools take both K and V as "
                            f"int8, got {kpool.dtype}/{vpool.dtype}")
        for t in (kscale, vscale):
            if t.dtype != torch.float32 or tuple(t.shape) != tuple(
                    kpool.shape[:3]):
                raise TypeError(
                    f"flash_decode: scales must be float32 "
                    f"{tuple(kpool.shape[:3])}, got {t.dtype} "
                    f"{tuple(t.shape)}")
        scales = [("kscale", kscale), ("vscale", vscale)]
    elif not (kpool.dtype == vpool.dtype == q.dtype):
        raise TypeError(f"flash_decode: q {q.dtype} and pools {kpool.dtype}/"
                        f"{vpool.dtype} must share one dtype")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool),
                    ("block_tables", block_tables), ("n_keys", n_keys),
                    *scales):
        if t.device != q.device:
            raise ValueError(f"flash_decode: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")


def flash_decode(q, kpool, vpool, block_tables, n_keys, *,
                 sm_scale: Optional[float] = None, kscale=None, vscale=None):
    """Single-token paged attention: ``(n_slots, heads, vd)`` in q's dtype.

    Shapes as in :func:`flash_decode_plain` (the JAX package's signature).
    On CUDA tensors this launches ``csrc/flash_decode.cu`` and raises on
    what it does not take: q in fp32, bf16 or fp16; pools of q's dtype, or
    int8 with f32 ``kscale``/``vscale``; head dims <= 256; int32 tables
    and counts; everything contiguous. An int8 pool without scales raises.
    CPU tensors take :func:`flash_decode_plain`."""
    import torch

    int8 = _check_scales(kpool, kscale, vscale)
    if q.device.type == "cpu":
        return flash_decode_plain(q, kpool, vpool, block_tables, n_keys,
                                  sm_scale=sm_scale, kscale=kscale,
                                  vscale=vscale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    _check_cuda_inputs(q, kpool, vpool, block_tables, n_keys, kscale,
                       vscale)
    from .build import check
    from .tickets import ticket_buffer

    lib = _library()
    n_slots, heads, hd = q.shape
    vd = vpool.shape[3]
    bs, mb = kpool.shape[2], block_tables.shape[1]
    code = _dtype_code(q.dtype)
    cb = chunk_blocks(lib, n_slots, heads, hd, vd, bs, mb, int8, code)
    chunks = -(-mb // cb)
    out = torch.empty((n_slots, heads, vd), dtype=q.dtype, device=q.device)
    tickets = ticket_buffer("flash_decode", q.device, n_slots * heads)
    # the chunks' (m, l, acc) partials; read only when a slot has several
    # live chunks
    part = (torch.empty(n_slots * heads * chunks * (vd + 2),
                        dtype=torch.float32, device=q.device)
            if chunks > 1 else out)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scales = [kscale.data_ptr(), vscale.data_ptr()] if int8 else []
    fn = lib.ff_flash_decode_int8 if int8 else lib.ff_flash_decode
    err = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), *scales,
             block_tables.data_ptr(), n_keys.data_ptr(), out.data_ptr(),
             part.data_ptr(), tickets.data_ptr(), n_slots, heads, hd, vd, bs,
             mb, cb, _scale(hd, sm_scale), code, stream)
    name = "flash_decode_int8" if int8 else "flash_decode"
    check(lib, err, f"{name} launch")
    _launches[name] += 1
    return out
