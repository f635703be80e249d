"""Flash attention, forward and backward: the training and eval attention
core of ``MultiHeadAttentionOp`` and ``SDPAOp``.

Port of ``flexflow_tpu/kernels/flash_attention.py`` (the Pallas kernels
``_flash_fwd_kernel``, ``_flash_bwd_fused_kernel``, ``_flash_bwd_dkv_kernel``
and ``_flash_bwd_dq_kernel``). The CUDA kernels are in
``csrc/flash_attention.cu``; its header says what bounds them and how the
design follows. Beside them:

* :func:`flash_forward_plain` / :func:`flash_backward_plain` — the same
  functions in plain PyTorch, walking the same ``(block_q, block_k)`` tiles
  with the same online-softmax recurrence, causal tile skipping, ``l == 0``
  guard and roundings as the TPU kernels. The CPU path and the tests use
  them; on the card they are the reference the kernels are held against.
* :func:`dropout_keep_scale_plain` — the counter-hash dropout mask
  (``dropout_keep_scale_nd``) bit for bit, so one seed gives one mask in
  both packages and in every kernel. A seed is a uint32 int or a 0-d
  integer tensor (its low 32 bits); the kernels read it from device
  memory, so a captured step feeds a fresh seed to every replay
  (``execution/graphs.py``).
* :func:`flash_attention` — the entry point, a ``torch.autograd.Function``
  whose forward saves (q, k, v, O, lse) and whose backward runs the fused
  one-pass schedule or the two-pass one by the JAX package's rule
  (``seq_q * d * 10 <= FUSED_BWD_RESIDENT_BUDGET``), so both packages run
  the same schedule at a given shape; ``_flash_backward(..., fused=)``
  runs either on demand. CPU tensors take the plain versions; CUDA tensors
  launch the kernels or raise. Nothing falls back.
* :func:`launch_count` — launches of each kernel since the last
  :func:`reset_launch_count`.

The kernels pick their own tiles, whatever ``block_q`` and ``block_k``
say: those are the TPU's VMEM tiling, honoured by the plain versions (they
change only the order of the fp32 sums). The 16-bit kernels (wgmma and
TMA) take 64 q rows by 128-key tiles (forward; dQ at head dim 64, 64-key
tiles at 128) and 128 keys by 64-row q tiles (fused backward, dK/dV), and
the fp32 forward, fused and two-pass backward keep 128 rows resident at
head dim 64 (64 at 128) and stream 64-row tiles, each masking the ragged
end of a sequence that is a multiple of 64 only. Every block the
attention router picks is a multiple of 64. The fused backward adds each
CTA's dQ partial into an fp32 buffer by reduce-adds in no fixed order, so
its dQ is not bitwise repeatable; the two-pass kernels write each output
once and are.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .counts import LaunchCounts

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
# The JAX package's fused-backward residency rule, kept so that both
# packages pick the same schedule at a given shape (a TPU VMEM budget; the
# CUDA kernels do not depend on it).
FUSED_BWD_RESIDENT_BUDGET = 5 * 2 ** 20
NEG_INF = -1e30
#: rows of a CUDA tile; both sequences must be multiples of it
KERNEL_TILE = 64
#: head dims the CUDA kernels are built for
KERNEL_HEAD_DIMS = (64, 128)

KERNELS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dkv", "flash_bwd_dq")
_launches = LaunchCounts("flash_attention", KERNELS)
_U32 = 0xFFFFFFFF


def launch_count(kernel: str) -> int:
    """CUDA launches of ``kernel`` (one of :data:`KERNELS`) since the last
    reset."""
    return _launches[kernel]


def reset_launch_count() -> None:
    for name in KERNELS:
        _launches[name] = 0


# ------------------------------------------------------------------ dropout
def _mul_u32(x, c: int):
    """(x * c) mod 2**32 for int64 tensors x in [0, 2**32): the product is
    split at 16 bits of ``c`` so no intermediate leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def dropout_threshold(rate: float) -> int:
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def dropout_scale(rate: float) -> float:
    """1/(1-rate) as the JAX package computes it: fp32 one over fp32."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _seed_u32(seed):
    """The seed's low 32 bits: an int, or an int64 tensor for a tensor
    seed (any integer dtype; int32 bits read as unsigned)."""
    import torch

    if torch.is_tensor(seed):
        return seed.to(torch.int64) & _U32
    return int(seed) & _U32


def counter_hash_u32(seed, bh, q_pos, k_pos):
    """The dropout mask's counter hash (``dropout_keep_scale_nd``,
    flexflow_tpu/kernels/flash_attention.py:96-113) in int64 arithmetic
    masked to 32 bits: a uint32 in an int64 tensor for broadcastable
    integer tensors of three coordinates and a seed (an int or a 0-d or
    broadcastable integer tensor). The serving sampler draws from it
    too."""
    import torch

    def u32(t):
        return torch.as_tensor(t).to(torch.int64) & _U32

    x = (_mul_u32(u32(q_pos), 0x9E3779B1) + _mul_u32(u32(k_pos), 0x85EBCA77)
         + _mul_u32(u32(bh), 0xC2B2AE3D) + _seed_u32(seed)) & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_keep_scale_plain(seed, bh, q_pos, k_pos, rate: float):
    """``dropout_keep_scale_nd`` (flexflow_tpu/kernels/flash_attention.py
    :96-113) in int64 arithmetic masked to 32 bits: {0, 1/(1-rate)} as fp32
    for broadcastable integer tensors of GLOBAL (batch*head, q, k)
    coordinates. ``seed``: an int or a 0-d integer tensor."""
    import torch

    keep = counter_hash_u32(seed, bh, q_pos, k_pos) >= \
        dropout_threshold(rate)
    return keep.to(torch.float32) * dropout_scale(rate)


def global_bh(b: int, h: int, shard, device):
    """The (b, h, 1, 1) GLOBAL batch*head coordinates the dropout hash keys
    on: ``b * H + h`` for an unsharded call, and for a shard (``shard =
    (batch offset, head offset, global heads)``, a data- or tensor-parallel
    rank's slice of the batch and heads) the coordinates of the same
    elements in the whole tensor, so every rank draws the single-device
    mask's slice."""
    import torch

    if shard is None:
        return torch.arange(b * h, device=device).view(b, h, 1, 1)
    b_off, h_off, heads = shard
    rows = torch.arange(b, device=device) + b_off
    cols = torch.arange(h, device=device) + h_off
    return (rows[:, None] * heads + cols[None, :]).view(b, h, 1, 1)


def _tile_keep(seed, b, h, q0, bq, k0, bk, rate, device, shard=None):
    """The (b, h, bq, bk) mask of one score tile."""
    import torch

    bh = global_bh(b, h, shard, device)
    qp = torch.arange(q0, q0 + bq, device=device).view(1, 1, bq, 1)
    kp = torch.arange(k0, k0 + bk, device=device).view(1, 1, 1, bk)
    return dropout_keep_scale_plain(seed, bh, qp, kp, rate)


# ----------------------------------------------------------- plain versions
def _prescale(q):
    """q * (1/sqrt(d)) in fp32, rounded back to q's dtype: the TPU kernels'
    caller does this outside the kernel (flash_attention.py:291). One
    launch: PyTorch multiplies 16-bit tensors by a scalar in fp32 and rounds
    the product once."""
    return q * _sm_scale(q.shape[-1])


def _blocks(seq_q: int, seq_k: int, block_q: int, block_k: int):
    bq, bk = min(block_q, seq_q), min(block_k, seq_k)
    if seq_q % bq or seq_k % bk:
        raise ValueError(f"flash_attention: blocks ({bq}, {bk}) do not "
                         f"divide the sequences ({seq_q}, {seq_k})")
    return bq, bk


def _tile_contributes(q0: int, bq: int, k0: int, offset: int) -> bool:
    """Does tile (q0.., k0..) reach the causal band? (its last row + offset
    reaches its first key; _tile_contributes / _first_contributing_qb)."""
    return q0 + bq - 1 + offset >= k0


def _causal_mask(q0, bq, k0, bk, offset, device):
    import torch

    qp = torch.arange(q0, q0 + bq, device=device)[:, None]
    kp = torch.arange(k0, k0 + bk, device=device)[None, :]
    return qp + offset >= kp


def _rounded(x, dtype):
    """x rounded to ``dtype`` and back to fp32 (the kernels' ``astype``)."""
    return x.to(dtype).float()


def flash_forward_plain(q, k, v, causal: bool = False,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K,
                        dropout: float = 0.0, seed=0, shard=None):
    """Plain-PyTorch flash forward, tile for tile the TPU kernel.

    q (b, h, sq, d), k/v (b, h, sk, d) of one float dtype. q is pre-scaled
    here. For each q tile, the k tiles inside the causal band update
    (m, l, acc) in fp32; l sums the undropped probabilities and the dropout
    mask multiplies them before the PV product (at the global coordinates of
    ``shard``, see :func:`global_bh`). Returns (O in q's dtype, lse (b, h,
    sq) fp32)."""
    import torch

    b, h, sq, d = q.shape
    sk = k.shape[2]
    bq, bk = _blocks(sq, sk, block_q, block_k)
    offset = sk - sq
    qf = _prescale(q).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, bq):
        m = torch.full((b, h, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, h, bq, 1), device=q.device)
        acc = torch.zeros((b, h, bq, d), device=q.device)
        for k0 in range(0, sk, bk):
            if causal and not _tile_contributes(q0, bq, k0, offset):
                continue
            s = qf[:, :, q0:q0 + bq] @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
            if causal:
                s = torch.where(_causal_mask(q0, bq, k0, bk, offset,
                                             q.device), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            m = m_new
            if dropout > 0.0:
                p = p * _tile_keep(seed, b, h, q0, bq, k0, bk, dropout,
                                   q.device, shard)
            acc = acc * alpha + _rounded(p, v.dtype) @ vf[:, :, k0:k0 + bk]
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, :, q0:q0 + bq] = acc / l_safe
        lse[:, :, q0:q0 + bq] = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def _bwd_tile(qs, k, v, dor, lse, delta, q0, bq, k0, bk, causal, offset,
              dropout, seed, shard=None):
    """One (q, k) tile of the backward: (pd, ds) in fp32, each rounded to
    the dtype of the operand it multiplies, as the TPU kernels round."""
    import torch

    b, h = qs.shape[:2]
    qt = qs[:, :, q0:q0 + bq].float()
    kt = k[:, :, k0:k0 + bk].float()
    s = qt @ kt.transpose(-1, -2)
    if causal:
        s = torch.where(_causal_mask(q0, bq, k0, bk, offset, qs.device), s,
                        NEG_INF)
    p = torch.exp(s - lse[:, :, q0:q0 + bq, None])
    dp = dor[:, :, q0:q0 + bq].float() @ \
        v[:, :, k0:k0 + bk].float().transpose(-1, -2)
    pd = p
    if dropout > 0.0:
        keep = _tile_keep(seed, b, h, q0, bq, k0, bk, dropout, qs.device,
                          shard)
        pd = p * keep
        dp = dp * keep
    ds = p * (dp - delta[:, :, q0:q0 + bq, None])
    return _rounded(pd, dor.dtype), ds


def _bwd_operands(q, do):
    """(q pre-scaled, dO in q's dtype): what every backward kernel reads;
    the fused CUDA kernel computes delta itself and needs nothing more."""
    return _prescale(q), do.to(q.dtype)


def _bwd_inputs(q, out, do, fused: bool):
    """(q pre-scaled, dO in q's dtype, delta = rowsum(dO * O) in fp32):
    the fused schedule takes delta from dO cast to q's dtype (in-kernel),
    the two-pass one from dO as given (outside the kernels)."""
    qs, dor = _bwd_operands(q, do)
    delta = ((dor if fused else do).float() * out.float()).sum(dim=-1)
    return qs, dor, delta


def _tiles(sq, sk, bq, bk, causal, outer_is_k: bool):
    """(q0, k0) of the tiles inside the causal band, k tiles outer (the
    dK/dV walks) or q tiles outer (the dQ walk)."""
    offset = sk - sq
    outer = range(0, sk, bk) if outer_is_k else range(0, sq, bq)
    for o in outer:
        for i in (range(0, sq, bq) if outer_is_k else range(0, sk, bk)):
            q0, k0 = (i, o) if outer_is_k else (o, i)
            if not causal or _tile_contributes(q0, bq, k0, offset):
                yield q0, k0


def flash_bwd_kv_plain(qs, k, v, dor, lse, delta, causal: bool,
                       block_q: int, block_k: int, dropout: float = 0.0,
                       seed=0, with_dq: bool = False, shard=None):
    """The walk over k tiles (B3, or B2 with ``with_dq``): for each k tile
    its q tiles in order. Returns fp32 (dk, dv, dq unscaled or None)."""
    import torch

    b, h, sq, d = qs.shape
    sk = k.shape[2]
    bq, bk = _blocks(sq, sk, block_q, block_k)
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=qs.device)
    dv = torch.zeros_like(dk)
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=qs.device) \
        if with_dq else None
    for q0, k0 in _tiles(sq, sk, bq, bk, causal, outer_is_k=True):
        pd, ds = _bwd_tile(qs, k, v, dor, lse, delta, q0, bq, k0, bk, causal,
                           sk - sq, dropout, seed, shard)
        ks, qsl = slice(k0, k0 + bk), slice(q0, q0 + bq)
        dv[:, :, ks] += pd.transpose(-1, -2) @ dor[:, :, qsl].float()
        dk[:, :, ks] += _rounded(ds, qs.dtype).transpose(-1, -2) \
            @ qs[:, :, qsl].float()
        if with_dq:
            dq[:, :, qsl] += _rounded(ds, k.dtype) @ k[:, :, ks].float()
    return dk, dv, dq


def flash_bwd_q_plain(qs, k, v, dor, lse, delta, causal: bool,
                      block_q: int, block_k: int, dropout: float = 0.0,
                      seed=0, shard=None):
    """The walk over q tiles (B4): for each q tile its k tiles in order.
    Returns dq in fp32, not yet scaled by 1/sqrt(d)."""
    import torch

    b, h, sq, d = qs.shape
    sk = k.shape[2]
    bq, bk = _blocks(sq, sk, block_q, block_k)
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=qs.device)
    for q0, k0 in _tiles(sq, sk, bq, bk, causal, outer_is_k=False):
        _pd, ds = _bwd_tile(qs, k, v, dor, lse, delta, q0, bq, k0, bk,
                            causal, sk - sq, dropout, seed, shard)
        dq[:, :, q0:q0 + bq] += _rounded(ds, k.dtype) \
            @ k[:, :, k0:k0 + bk].float()
    return dq


def flash_backward_plain(q, k, v, out, lse, do, causal: bool = False,
                         block_q: int = DEFAULT_BLOCK_Q,
                         block_k: int = DEFAULT_BLOCK_K,
                         dropout: float = 0.0, seed=0,
                         fused: Optional[bool] = None, shard=None):
    """Plain-PyTorch flash backward: (dq, dk, dv) in the inputs' dtypes.

    ``fused`` (None: the JAX package's residency rule) picks the schedule:
    the one-pass walk over k tiles, or the two-pass dK/dV then dQ walks.
    Probabilities are exp(s - lse); dS = P * (D * dP - delta); dK uses the
    pre-scaled q, dQ is scaled by 1/sqrt(d) once at the end."""
    if fused is None:
        fused = use_fused_backward(q.shape[2], q.shape[3])
    qs, dor, delta = _bwd_inputs(q, out, do, fused)
    args = (qs, k, v, dor, lse, delta, causal, block_q, block_k, dropout,
            seed)
    dk, dv, dq = flash_bwd_kv_plain(*args, with_dq=fused, shard=shard)
    if not fused:
        dq = flash_bwd_q_plain(*args, shard=shard)
    return ((dq * _sm_scale(q.shape[3])).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _sm_scale(d: int) -> float:
    return float(np.float32(1.0 / np.sqrt(d)))


def use_fused_backward(seq_q: int, head_dim: int) -> bool:
    """The JAX package's schedule rule (flash_attention.py:574-575)."""
    return seq_q * head_dim * 10 <= FUSED_BWD_RESIDENT_BUDGET


# ------------------------------------------------------------- CUDA kernels
def _dtype_code(dtype) -> int:
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise TypeError(f"flash_attention: unsupported dtype {dtype} (the "
                        "kernels take float32, bfloat16 and float16)")
    return codes[dtype]


def _library():
    from .build import load

    lib = load("flash_attention")
    if lib.ff_flash_fwd.argtypes is None:
        p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_float)
        # dropout_on, seed address, threshold, scale, and the shard's
        # local heads, global heads and batch*head offset
        drop = [i, p, u, f, i, i, i]
        lib.ff_flash_fwd.argtypes = [p] * 5 + [i] * 5 + drop + [i, p]
        lib.ff_flash_bwd_kv.argtypes = [p] * 10 + [i] * 6 + drop + [i, p]
        lib.ff_flash_bwd_q.argtypes = [p] * 7 + [f] + [i] * 5 + drop \
            + [i, p]
        for fn in (lib.ff_flash_fwd, lib.ff_flash_bwd_kv, lib.ff_flash_bwd_q):
            fn.restype = ctypes.c_int
        lib.ff_flash_smem_bytes.argtypes = [i, i]
        lib.ff_flash_smem_bytes.restype = ctypes.c_int
        lib.ff_flash_tensor_map_us.argtypes = [p] + [i] * 4
        lib.ff_flash_tensor_map_us.restype = ctypes.c_double
    return lib


def tensor_map_us(t, iters: int = 1000) -> float:
    """Host microseconds to encode one TMA descriptor of the (b, h, s, d)
    16-bit CUDA tensor ``t``, the mean over ``iters`` encodings: the 16-bit
    forward encodes 3 a launch, the fused backward 5, the dK/dV and dQ
    kernels 4 each."""
    b, h, s, d = t.shape
    us = _library().ff_flash_tensor_map_us(t.data_ptr(), b * h, s, d, iters)
    if us < 0:
        raise RuntimeError("flash_attention: TMA descriptor encoding failed")
    return us


#: kernels whose dynamic shared memory :func:`smem_bytes` reports: the
#: 16-bit forward and fused backward, the fp32 dK/dV, dQ, forward and fused
#: backward, the 16-bit dK/dV and dQ
SMEM_KERNELS = ("flash_fwd_sm90", "flash_bwd_fused_sm90", "flash_bwd_dkv_f32",
                "flash_bwd_dq_f32", "flash_fwd_f32", "flash_bwd_fused_f32",
                "flash_bwd_dkv_sm90", "flash_bwd_dq_sm90")


def smem_bytes(kernel: str, head_dim: int) -> int:
    """Dynamic shared memory a launch of ``kernel`` (one of
    :data:`SMEM_KERNELS`) takes at ``head_dim``."""
    return _library().ff_flash_smem_bytes(SMEM_KERNELS.index(kernel),
                                          head_dim)


def _check_cuda_inputs(what: str, q, k, v, *more) -> None:
    b, h, sq, d = q.shape
    if k.dim() != 4 or tuple(k.shape[:2]) != (b, h) or k.shape[3] != d \
            or k.shape != v.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} must be (b, h, s, d) with "
                         "k and v alike")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} has no kernel (built for "
                         f"{KERNEL_HEAD_DIMS})")
    for s in (sq, k.shape[2]):
        if s % KERNEL_TILE:
            raise ValueError(f"{what}: sequence length {s} is not a "
                             f"multiple of the kernel tile {KERNEL_TILE}")
    if not 1 <= b * h <= 65535:
        raise ValueError(f"{what}: batch * heads = {b * h} (1..65535)")
    for t in (k, v, *more):
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: inputs mix {q.dtype} and {t.dtype}")
    for t in (q, k, v, *more):
        if t.device != q.device:
            raise ValueError(f"{what}: inputs on {q.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must start on a 16-byte "
                             "boundary (the kernels load tiles by TMA, "
                             "cp.async and 16-byte loads)")


def seed_on_device(seed, device):
    """The dropout seed as an integer tensor on ``device`` whose first
    element's low 32 bits the kernels read: a 0-d int32/int64 tensor there
    passes through, an int becomes a 0-d int32 tensor (one fill)."""
    import torch

    if torch.is_tensor(seed):
        if seed.device != device or seed.numel() != 1 or \
                seed.dtype not in (torch.int32, torch.int64):
            raise ValueError(
                f"flash_attention: a seed tensor must be one int32 or int64 "
                f"element on {device}, got {seed.dtype} {tuple(seed.shape)} "
                f"on {seed.device}")
        return seed
    bits = int(seed) & _U32
    return torch.full((), bits - (bits >> 31 << 32), dtype=torch.int32,
                      device=device)


def _dropout_args(dropout: float, seed, heads: int, shard=None):
    """The kernels' dropout arguments; ``seed`` is a device tensor from
    :func:`seed_on_device` (the caller keeps it alive past the launch).
    ``heads`` is the call's own head count; ``shard`` (:func:`global_bh`)
    makes the kernels hash the global batch*head coordinate
    ``(bh / heads) * H + bh % heads + (b_off * H + h_off)``."""
    if dropout <= 0.0:
        return [0, None, 0, 0.0, 1, 1, 0]
    b_off, h_off, hg = shard if shard is not None else (0, 0, heads)
    return [1, seed.data_ptr(), dropout_threshold(dropout),
            dropout_scale(dropout), heads, hg, b_off * hg + h_off]


def _launch_fwd(qs, k, v, out, lse, causal, dropout, seed, shard=None):
    """One launch of the forward kernel (B1) into preallocated ``out`` (q's
    dtype) and ``lse`` (fp32); ``qs`` is q pre-scaled."""
    import torch

    from .build import check

    b, h, sq, d = qs.shape
    lib = _library()
    seed = seed_on_device(seed, qs.device) if dropout > 0.0 else None
    code = lib.ff_flash_fwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b * h, sq, k.shape[2], d, int(causal),
        *_dropout_args(dropout, seed, h, shard), _dtype_code(qs.dtype),
        torch.cuda.current_stream(qs.device).cuda_stream)
    check(lib, code, "flash_attention forward launch")
    _launches["flash_fwd"] += 1


def _forward_cuda(q, k, v, causal, dropout, seed, shard=None):
    import torch

    _check_cuda_inputs("flash_attention forward", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch_fwd(_prescale(q), k, v, out, lse, causal, dropout, seed, shard)
    return out, lse


def _launch_bwd_kv(qs, k, v, out, dor, lse, delta, dk, dv, dq_acc,
                   causal, dropout, seed, shard=None):
    """One launch of the k-tile backward kernel into preallocated dk, dv:
    B2 (fused: delta in-kernel, dQ added into the zeroed fp32 ``dq_acc``)
    when ``dq_acc`` is given, else B3 (``delta`` precomputed)."""
    import torch

    from .build import check

    fused = dq_acc is not None
    b, h, sq, d = qs.shape
    lib = _library()
    seed = seed_on_device(seed, qs.device) if dropout > 0.0 else None
    code = lib.ff_flash_bwd_kv(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dor.data_ptr(), lse.data_ptr(), None if fused else delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr() if fused else None,
        int(fused), b * h, sq, k.shape[2], d, int(causal),
        *_dropout_args(dropout, seed, h, shard), _dtype_code(qs.dtype),
        torch.cuda.current_stream(qs.device).cuda_stream)
    check(lib, code, "flash_attention dK/dV backward launch")
    _launches["flash_bwd_fused" if fused else "flash_bwd_dkv"] += 1


def _launch_bwd_q(qs, k, v, dor, lse, delta, dq, causal, dropout, seed,
                  shard=None):
    """One launch of the q-tile backward kernel (B4) into preallocated
    ``dq`` (q's dtype, scaled by 1/sqrt(d) in-kernel)."""
    import torch

    from .build import check

    b, h, sq, d = qs.shape
    lib = _library()
    seed = seed_on_device(seed, qs.device) if dropout > 0.0 else None
    code = lib.ff_flash_bwd_q(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), dor.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _sm_scale(d),
        b * h, sq, k.shape[2], d, int(causal),
        *_dropout_args(dropout, seed, h, shard), _dtype_code(qs.dtype),
        torch.cuda.current_stream(qs.device).cuda_stream)
    check(lib, code, "flash_attention dQ backward launch")
    _launches["flash_bwd_dq"] += 1


def _backward_cuda(q, k, v, out, lse, do, causal, dropout, seed, fused,
                   shard=None):
    import torch

    # the fused kernel computes delta itself: no host-side delta for it
    if fused:
        qs, dor = _bwd_operands(q, do)
    else:
        qs, dor, delta = _bwd_inputs(q, out, do, fused=False)
        delta = delta.contiguous()
    dor, lse = dor.contiguous(), lse.contiguous()
    _check_cuda_inputs("flash_attention backward", q, k, v, out, dor)
    if lse.data_ptr() % 16:
        raise ValueError("flash_attention backward: lse must start on a "
                         "16-byte boundary")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if fused:
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        _launch_bwd_kv(qs, k, v, out, dor, lse, None, dk, dv, dq_acc,
                       causal, dropout, seed, shard)
        return (dq_acc * _sm_scale(q.shape[3])).to(q.dtype), dk, dv
    dq = torch.empty_like(q)
    _launch_bwd_kv(qs, k, v, out, dor, lse, delta, dk, dv, None, causal,
                   dropout, seed, shard)
    _launch_bwd_q(qs, k, v, dor, lse, delta, dq, causal, dropout, seed,
                  shard)
    return dq, dk, dv


# ----------------------------------------------------------------- wrappers
def _flash_forward(q, k, v, causal: bool, block_q: int, block_k: int,
                   dropout: float = 0.0, seed=0, shard=None):
    """(O, lse): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, block_q, block_k,
                                   dropout, seed, shard)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _forward_cuda(q, k, v, causal, dropout, seed, shard)


def _flash_backward(q, k, v, out, lse, do, causal: bool, block_q: int,
                    block_k: int, dropout: float = 0.0, seed=0,
                    fused: Optional[bool] = None, shard=None):
    """(dq, dk, dv) by the fused schedule (``fused=True``: B2) or the
    two-pass one (``False``: B3 then B4); None picks by the JAX package's
    rule. CUDA tensors launch the kernels, CPU tensors take the plain
    version."""
    if fused is None:
        fused = use_fused_backward(q.shape[2], q.shape[3])
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, out, lse, do, causal, block_q,
                                    block_k, dropout, seed, fused, shard)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _backward_cuda(q, k, v, out, lse, do, causal, dropout, seed,
                          fused, shard)


def _function():
    import torch

    class FlashAttentionFn(torch.autograd.Function):
        """Saves (q, k, v, O, lse) and the seed; the backward recomputes
        the probabilities from lse and regenerates the dropout mask."""

        @staticmethod
        def forward(ctx, q, k, v, causal, block_q, block_k, dropout, seed,
                    shard):
            out, lse = _flash_forward(q, k, v, causal, block_q, block_k,
                                      dropout, seed, shard)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.cfg = (causal, block_q, block_k, dropout, seed)
            ctx.shard = shard
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = _flash_backward(q, k, v, out, lse, do.contiguous(),
                                         *ctx.cfg, shard=ctx.shard)
            return dq, dk, dv, None, None, None, None, None, None

    return FlashAttentionFn


_FN = None


def flash_attention(q, k, v, causal: bool = False,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    dropout: float = 0.0, seed: Optional[int] = None,
                    shard=None):
    """q, k, v (batch, heads, seq, head_dim) -> (batch, heads, seq_q,
    head_dim) in q's dtype, differentiable.

    As the JAX package's ``flash_attention``: the sequences must be
    multiples of the blocks, causal needs seq_q <= seq_k, and ``dropout``
    needs a ``seed``: a uint32 int (the same seed gives the same mask in
    both packages) or a 0-d integer tensor holding it in its low 32 bits,
    which on CUDA the kernels read from device memory. ``shard`` = (batch
    offset, head offset, global heads) when q/k/v are a rank's slice of a
    larger batch and head set: the dropout mask is then the whole call's
    mask at these elements (:func:`global_bh`)."""
    global _FN
    dropout = float(dropout)
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"flash_attention dropout must be in [0, 1), got "
                         f"{dropout}")
    if dropout > 0.0 and seed is None:
        raise ValueError("flash_attention dropout requires a seed")
    if causal and q.shape[-2] > k.shape[-2]:
        raise ValueError(
            f"flash_attention causal requires seq_q <= seq_k, got "
            f"{q.shape[-2]} > {k.shape[-2]}; use the einsum core instead")
    _blocks(q.shape[-2], k.shape[-2], block_q, block_k)
    if _FN is None:
        _FN = _function()
    if dropout == 0.0:
        seed = 0
    elif q.device.type == "cuda":
        # one device seed for the forward and the backward launches
        seed = seed_on_device(seed, q.device)
    else:
        seed = _seed_u32(seed)
    return _FN.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                     bool(causal), int(block_q), int(block_k), dropout,
                     seed, None if shard is None else tuple(
                         int(x) for x in shard))
