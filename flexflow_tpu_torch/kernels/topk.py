"""Row top-k for small k: the serving sampler's top-k and the opt-in
``TopKOp``.

Port of ``flexflow_tpu/kernels/topk.py`` (the Pallas ``_topk_kernel``: k
unrolled argmax sweeps, ties to the lowest index, -inf clamped to -FLT_MAX
in the selection key and the original value returned). The CUDA kernel is
``csrc/topk.cu``; its header says what bounds it (bytes: one read of the
row) and how the design follows from that: a row is cut into chunks across
CTAs (the chunk from the launch's shape and the SM count), and the CTA that
takes a row's last ticket merges the chunks' candidates in the same launch.
Beside it:

* :func:`topk_plain` — the same function in plain PyTorch: k unrolled
  ``torch.argmax`` sweeps (``torch.argmax`` returns the first maximum;
  ``torch.topk``'s order among ties is not specified, so it cannot be the
  plain version). The CPU path and the tests use it; on the card it is the
  reference the kernel is held against.
* :func:`topk` — the entry point, a ``torch.autograd.Function`` whose
  backward scatters the value cotangent to the selected positions (the
  indices carry none), as ``lax.top_k``'s vjp. CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise. Nothing falls back.
  The wrapper allocates the outputs and the chunks' scratch with
  ``torch.empty`` on every call, so a launch captures into a CUDA graph;
  the per-row ticket counters (``tickets.py``) are made zeroed on the first
  eager call of a device and left zero by every launch, so launches that
  share them run on one stream.
* :func:`topk_kernel_shape` / :func:`should_use_topk_kernel` — the JAX
  package's routing gate (``should_use_pallas_topk``), with "on CUDA" in
  the place of "on TPU".
* :func:`launch_count` — kernel launches since the last
  :func:`reset_launch_count`.
"""
from __future__ import annotations

import ctypes

import numpy as np

#: the unrolled-sweep formulation only pays off for small k
MAX_KERNEL_K = 8
FLT_MAX = float(np.finfo(np.float32).max)

_launches = {"topk": 0}


def launch_count() -> int:
    """CUDA launches of the top-k kernel since the last reset."""
    return _launches["topk"]


def reset_launch_count() -> None:
    _launches["topk"] = 0


def topk_plain(x, k: int):
    """``(values, indices)`` of the k largest entries over the last dim of
    ``x``, by k argmax sweeps over an fp32 key: values in x's dtype sorted
    descending, int32 indices, ties to the lowest index, -inf entries
    selectable (k distinct indices even where fewer than k are finite)."""
    import torch

    x32 = x.float()
    key = torch.clamp(x32, min=-FLT_MAX)
    vals, idx = [], []
    for _ in range(int(k)):  # unrolled: k is small
        i = torch.argmax(key, dim=-1, keepdim=True)
        vals.append(torch.gather(x32, -1, i))
        idx.append(i)
        key = key.scatter(-1, i, float("-inf"))
    return (torch.cat(vals, dim=-1).to(x.dtype),
            torch.cat(idx, dim=-1).to(torch.int32))


def _dtype_code(dtype) -> int:
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise TypeError(f"topk: unsupported dtype {dtype} (the kernel takes "
                        "float32, bfloat16 and float16)")
    return codes[dtype]


def topk_kernel_shape(x, k: int) -> bool:
    """The shape and dtype half of the gate: 1 <= k <= 8, at least two
    dims, a last dim that is a multiple of 128 (and at least 128), and a
    float dtype the kernel takes (fp32, bf16, fp16; the JAX gate's "float
    of at most 4 bytes" without the fp8 types, which the kernel does not
    read)."""
    import torch

    if not 1 <= int(k) <= MAX_KERNEL_K:
        return False
    if x.dim() < 2 or x.shape[-1] < 128 or x.shape[-1] % 128 != 0:
        return False
    return x.dtype in (torch.float32, torch.bfloat16, torch.float16)


def should_use_topk_kernel(x, k: int, opt_in: bool = False) -> bool:
    """The JAX package's ``should_use_pallas_topk``: opt-in only, a shape
    :func:`topk_kernel_shape` takes, and on CUDA (the TPU there)."""
    return bool(opt_in) and topk_kernel_shape(x, k) \
        and x.device.type == "cuda"


def _library():
    from .build import load

    lib = load("topk")
    if lib.ff_topk.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ff_topk.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.ff_topk_chunk_elems.argtypes = [i] * 4
        lib.ff_topk_list_len.argtypes = [i]
        for fn in (lib.ff_topk, lib.ff_topk_chunk_elems,
                   lib.ff_topk_list_len):
            fn.restype = ctypes.c_int
    return lib


# (chunk elements, chunks, list length) by launch shape: a pure function of
# host-known values
_chunks = {}


def chunking(rows: int, dim: int, k: int, dtype_code: int):
    """(elements of a chunk, chunks a row, candidates a chunk keeps) of a
    launch (``csrc/topk.cu`` ``chunk_elems_for``): from the launch's shape
    and the SM count only, never from the data."""
    key = (rows, dim, k, dtype_code)
    got = _chunks.get(key)
    if got is None:
        lib = _library()
        ce = lib.ff_topk_chunk_elems(rows, dim, k, dtype_code)
        if ce < 1:
            raise ValueError(f"topk: no chunking for shape {key}")
        got = _chunks[key] = (ce, -(-dim // ce), lib.ff_topk_list_len(k))
    return got


def _topk_cuda(x, k: int):
    import torch

    from .build import check
    from .tickets import ticket_buffer

    dim = x.shape[-1]
    rows = x.numel() // max(dim, 1)
    if not 1 <= k <= min(MAX_KERNEL_K, dim):
        raise ValueError(f"topk: k = {k} must be in [1, min(8, dim = {dim})]")
    if rows < 1 or rows >= 2 ** 31 or dim >= 2 ** 30:
        raise ValueError(f"topk: {rows} rows of {dim} is outside the "
                         "kernel's range")
    code_dtype = _dtype_code(x.dtype)
    xr = x.reshape(rows, dim).contiguous()
    vals = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    chunk, chunks, kp = chunking(rows, dim, k, code_dtype)
    # the chunks' lists of 64-bit candidates; read only with several
    part = (torch.empty(rows * chunks * kp * 2, dtype=torch.int32,
                        device=x.device) if chunks > 1 else idx)
    tickets = ticket_buffer("topk", x.device, rows)
    lib = _library()
    code = lib.ff_topk(xr.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                       part.data_ptr(), tickets.data_ptr(), rows, dim, k,
                       chunk, code_dtype,
                       torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, code, "topk launch")
    _launches["topk"] += 1
    shape = tuple(x.shape[:-1]) + (k,)
    return vals.reshape(shape), idx.reshape(shape)


def _topk_forward(x, k: int):
    """(values, int32 indices): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk: no kernel for device {x.device}")
    return _topk_cuda(x, int(k))


def _function():
    import torch

    class TopKFn(torch.autograd.Function):
        """Saves the indices; the backward is the one-hot scatter of the
        value cotangent (``lax.top_k``'s vjp)."""

        @staticmethod
        def forward(ctx, x, k):
            vals, idx = _topk_forward(x, k)
            ctx.mark_non_differentiable(idx)
            ctx.save_for_backward(idx)
            ctx.dim = x.shape[-1]
            return vals, idx

        @staticmethod
        def backward(ctx, g_vals, _g_idx):
            (idx,) = ctx.saved_tensors
            shape = tuple(g_vals.shape[:-1]) + (ctx.dim,)
            dx = torch.zeros(shape, dtype=g_vals.dtype,
                             device=g_vals.device)
            return dx.scatter(-1, idx.long(), g_vals), None

    return TopKFn


_FN = None


def topk(x, k: int):
    """Top-k over the last dim of an array of any rank: ``(values in x's
    dtype sorted descending, int32 indices)`` — the ``lax.top_k``
    contract, differentiable in the values."""
    global _FN
    if _FN is None:
        _FN = _function()
    return _FN.apply(x, int(k))
