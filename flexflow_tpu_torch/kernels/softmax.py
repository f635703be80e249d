"""Row softmax with its backward: the opt-in kernel route of ``SoftmaxOp``.

Port of ``flexflow_tpu/kernels/softmax.py`` (the Pallas
``_softmax_fwd_kernel`` and ``_softmax_bwd_kernel``: softmax over the last
dim in fp32, and p * (g - sum(p * g))). The CUDA kernels are
``csrc/softmax.cu``; its header says what bounds them (bytes: one read of
each input, one write of the output) and how the design follows from that.
Beside them:

* :func:`softmax_plain` / :func:`softmax_bwd_plain` — the same functions in
  plain PyTorch, in fp32 with the result cast once. The CPU path and the
  tests use them; on the card they are the reference the kernels are held
  against.
* :func:`softmax` — the entry point, a ``torch.autograd.Function`` whose
  forward saves its output p and whose backward reads p and the cotangent
  (the JAX package's ``custom_vjp``). CPU tensors take the plain versions;
  CUDA tensors launch the kernels or raise. Nothing falls back.
* :func:`should_use_softmax_kernel` — the JAX package's routing gate
  (``should_use_pallas_softmax``), with "on CUDA" in the place of "on TPU".
* :func:`launch_count` — launches of each kernel since the last
  :func:`reset_launch_count`.
"""
from __future__ import annotations

import ctypes

from .counts import LaunchCounts

KERNELS = ("softmax_fwd", "softmax_bwd")
_launches = LaunchCounts("softmax", KERNELS)


def launch_count(kernel: str) -> int:
    """CUDA launches of ``kernel`` (one of :data:`KERNELS`) since the last
    reset."""
    return _launches[kernel]


def reset_launch_count() -> None:
    for name in KERNELS:
        _launches[name] = 0


def softmax_plain(x):
    """Softmax over the last dim in fp32, cast to x's dtype."""
    import torch

    xf = x.float()
    p = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (p / p.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_bwd_plain(p, g):
    """The input cotangent ``p * (g - sum(p * g))`` over the last dim in
    fp32, cast to g's dtype."""
    pf, gf = p.float(), g.float()
    inner = (pf * gf).sum(dim=-1, keepdim=True)
    return (pf * (gf - inner)).to(g.dtype)


def should_use_softmax_kernel(x, axis: int, opt_in: bool = False) -> bool:
    """Opt-in only; a last-axis softmax over rows of at least 1024 that are
    a multiple of 128, at least one row, on CUDA (the JAX gate's TPU)."""
    if not opt_in:
        return False
    if axis not in (-1, x.dim() - 1):
        return False
    if x.shape[-1] < 1024 or x.shape[-1] % 128 != 0 or x.numel() == 0:
        return False
    return x.device.type == "cuda"


def _dtype_code(dtype) -> int:
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise TypeError(f"softmax: unsupported dtype {dtype} (the kernels "
                        "take float32, bfloat16 and float16)")
    return codes[dtype]


def _library():
    from .build import load

    lib = load("softmax")
    if lib.ff_softmax_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ff_softmax_fwd.argtypes = [p, p, i, i, i, p]
        lib.ff_softmax_bwd.argtypes = [p, p, p, i, i, i, p]
        for fn in (lib.ff_softmax_fwd, lib.ff_softmax_bwd):
            fn.restype = ctypes.c_int
    return lib


def _rows(x):
    dim = x.shape[-1]
    rows = x.numel() // dim
    if dim < 1 or rows < 1 or rows >= 2 ** 31 or dim >= 2 ** 31:
        raise ValueError(f"softmax: {rows} rows of {dim} is outside the "
                         "kernels' range")
    return rows, dim


def _check_device(x) -> bool:
    """True for CUDA tensors (launch), False for CPU ones (plain)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"softmax: no kernel for device {x.device}")
    return x.device.type == "cuda"


def _forward(x):
    """p = softmax(x) over the last dim: the kernel for a CUDA tensor, the
    plain version for a CPU one."""
    import torch

    from .build import check

    if not _check_device(x):
        return softmax_plain(x)
    rows, dim = _rows(x)
    code_dtype = _dtype_code(x.dtype)
    x = x.contiguous()
    y = torch.empty_like(x)
    lib = _library()
    code = lib.ff_softmax_fwd(x.data_ptr(), y.data_ptr(), rows, dim,
                              code_dtype,
                              torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, code, "softmax forward launch")
    _launches["softmax_fwd"] += 1
    return y


def _backward(p, g):
    """dx = p * (g - sum(p * g)): the kernel for CUDA tensors, the plain
    version for CPU ones."""
    import torch

    from .build import check

    if not _check_device(g):
        return softmax_bwd_plain(p, g)
    if p.shape != g.shape or p.dtype != g.dtype or p.device != g.device:
        raise TypeError(f"softmax backward: p {p.dtype} {tuple(p.shape)} "
                        f"and g {g.dtype} {tuple(g.shape)} must match")
    rows, dim = _rows(g)
    code_dtype = _dtype_code(g.dtype)
    p, g = p.contiguous(), g.contiguous()
    dx = torch.empty_like(g)
    lib = _library()
    code = lib.ff_softmax_bwd(p.data_ptr(), g.data_ptr(), dx.data_ptr(), rows,
                              dim, code_dtype,
                              torch.cuda.current_stream(g.device).cuda_stream)
    check(lib, code, "softmax backward launch")
    _launches["softmax_bwd"] += 1
    return dx


def _function():
    import torch

    class SoftmaxFn(torch.autograd.Function):
        """Saves the output p; the backward is the row kernel on (p, g)."""

        @staticmethod
        def forward(ctx, x):
            p = _forward(x)
            ctx.save_for_backward(p)
            return p

        @staticmethod
        def backward(ctx, g):
            (p,) = ctx.saved_tensors
            return _backward(p, g.to(p.dtype))

    return SoftmaxFn


_FN = None


def softmax(x):
    """Softmax over the last dim of an array of any rank, differentiable;
    the output has x's dtype."""
    global _FN
    if _FN is None:
        _FN = _function()
    return _FN.apply(x)
