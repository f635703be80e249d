"""User-facing tensor of the layer graph.

Analog of the reference's ``TensorBase`` (include/flexflow/tensor.h) built by the
``FFModel`` op-builder API before ``compile``. Shapes are numpy-ordered (batch
first), unlike the reference's Legion dim ordering.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple, TYPE_CHECKING

import numpy as np

from .ffconst import DataType

if TYPE_CHECKING:
    from .layer import Layer
    from .model import FFModel

_guid_counter = itertools.count(1000)


class Tensor:
    """A node edge in the user layer graph (pre-compile, unsharded)."""

    def __init__(
        self,
        shape: Sequence[int],
        dtype: DataType = DataType.DT_FLOAT,
        owner_layer: Optional["Layer"] = None,
        owner_idx: int = 0,
        create_grad: bool = True,
        name: str = "",
        model: Optional["FFModel"] = None,
    ):
        self.guid: int = next(_guid_counter)
        self.dims: Tuple[int, ...] = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.owner_layer = owner_layer
        self.owner_idx = owner_idx
        self.create_grad = create_grad
        self.name = name or f"tensor_{self.guid}"
        self.model = model

    # -- reference-parity accessors (tensor.h / flexflow_cffi.py:572-881) -------
    @property
    def num_dims(self) -> int:
        return len(self.dims)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.dims

    def get_volume(self) -> int:
        return int(np.prod(self.dims)) if self.dims else 0

    def get_dims(self) -> Tuple[int, ...]:
        return self.dims

    # weight access is resolved through the owning model after compile
    # (reference: ParallelTensorBase::get_tensor/set_tensor,
    #  src/runtime/parallel_tensor.cc:650,698). The manual-phase staging
    # calls (set_tensor/get_tensor/attach_numpy_array) come with the
    # training slice.
    def get_weights(self, ff_model: Optional["FFModel"] = None) -> np.ndarray:
        model = ff_model or self.model
        if model is None:
            raise RuntimeError("tensor is not attached to a model")
        return model._get_weight_by_tensor(self)

    def set_weights(self, ff_model, np_array: np.ndarray) -> None:
        model = ff_model or self.model
        model._set_weight_by_tensor(self, np_array)

    def __repr__(self) -> str:
        return f"Tensor(name={self.name}, dims={self.dims}, dtype={self.dtype.name})"
