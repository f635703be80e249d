"""Batch preflight of fit / eval / predict: a local copy of
``flexflow_tpu.resilience.preflight.validate_batch`` (the rest of the
preflight module comes with the search slice). A mis-shaped or mis-typed
batch raises a ``ValueError`` naming the tensor and the axis, before any
step runs."""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from ..ffconst import LossType, dtype_to_torch

_KIND_NAMES = {"f": "floating", "i": "integer", "u": "integer",
               "b": "boolean", "c": "complex"}


def _kind(dt) -> str:
    k = np.dtype(dt).kind
    if k in ("f", "V"):  # bfloat16 surfaces as a void-kind numpy dtype
        return "f"
    if k in ("i", "u"):
        return "i"
    return k


def _numpy_dtype(dt):
    import torch

    t = dtype_to_torch(dt)
    if t == torch.bfloat16:
        return np.dtype("V2")
    return torch.empty((), dtype=t).numpy().dtype


def validate_batch(ffmodel, xs: Sequence[Any], y: Optional[Any] = None,
                   phase: str = "fit") -> None:
    """Validate fit/eval/predict arrays against the compiled signature."""
    input_nodes = ffmodel.pcg.input_nodes()
    if len(xs) != len(input_nodes):
        names = [n.name for n in input_nodes]
        raise ValueError(
            f"{phase}: model has {len(input_nodes)} input tensor(s) "
            f"{names} but got {len(xs)} array(s)")
    n0 = None
    first_name = None
    for node, a in zip(input_nodes, xs):
        a = np.asarray(a)
        want = tuple(node.out_shapes[0])
        got = tuple(a.shape)
        if len(got) != len(want):
            raise ValueError(
                f"{phase}: batch for input '{node.name}' has rank "
                f"{len(got)} (shape {got}) but the compiled signature "
                f"expects rank {len(want)} (declared shape {want}, leading "
                "axis = batch)")
        for ax in range(1, len(want)):
            if got[ax] != int(want[ax]):
                raise ValueError(
                    f"{phase}: batch for input '{node.name}' mismatches "
                    f"the compiled signature on axis {ax}: got {got[ax]} "
                    f"(shape {got}), expected {want[ax]} (declared shape "
                    f"{want})")
        want_dt = _numpy_dtype(node.out_dtypes[0])
        if _kind(a.dtype) != _kind(want_dt):
            raise ValueError(
                f"{phase}: batch for input '{node.name}' has "
                f"{_KIND_NAMES.get(_kind(a.dtype), _kind(a.dtype))} dtype "
                f"{a.dtype} but the compiled signature expects a "
                f"{_KIND_NAMES.get(_kind(want_dt), _kind(want_dt))} tensor "
                f"({node.out_dtypes[0].name}); cast the array before "
                f"{phase}")
        if n0 is None:
            n0, first_name = got[0], node.name
        elif got[0] != n0:
            raise ValueError(
                f"{phase}: input '{node.name}' has {got[0]} samples but "
                f"'{first_name}' has {n0}; all inputs must share the "
                "leading batch axis")
    if y is None:
        return
    y = np.asarray(y)
    if n0 is not None and y.shape[0] != n0:
        raise ValueError(
            f"{phase}: label batch has {y.shape[0]} samples but the "
            f"inputs have {n0}; labels must share the leading batch axis")
    lt = getattr(ffmodel, "label_tensor", None)
    sparse = (getattr(ffmodel, "loss_type", None) ==
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    if lt is not None and not sparse and \
            not getattr(ffmodel.executor, "repl_labels", False):
        want_tail = tuple(d for d in tuple(lt.dims)[1:] if d != 1)
        got_tail = tuple(d for d in y.shape[1:] if d != 1)
        if got_tail != want_tail:
            raise ValueError(
                f"{phase}: label batch shape {tuple(y.shape)} mismatches "
                f"the compiled label signature {tuple(lt.dims)} (trailing "
                f"dims {got_tail} != {want_tail}); check the loss target "
                "shape")
