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
    #  src/runtime/parallel_tensor.cc:650,698)
    def get_weights(self, ff_model: Optional["FFModel"] = None) -> np.ndarray:
        model = ff_model or self.model
        if model is None:
            raise RuntimeError("tensor is not attached to a model")
        return model._get_weight_by_tensor(self)

    def set_weights(self, ff_model, np_array: np.ndarray) -> None:
        model = ff_model or self.model
        model._set_weight_by_tensor(self, np_array)

    # -- host staging for the manual-loop API (flexflow_cffi.py:660,682
    #    set_tensor/get_tensor; the attach-style examples drive batches this
    #    way: mnist_mlp_attach.py next_batch -> set_tensor -> forward) -------
    def set_tensor(self, ff_model, np_array: np.ndarray) -> None:
        """Stage a model input or the label tensor for the next forward /
        backward, or write a weight."""
        model = ff_model or self.model
        if self.owner_layer is None or self is model.label_tensor:
            model._stage_tensor_value(self, np_array)
        elif self.owner_idx < 0:
            model._set_weight_by_tensor(self, np_array)
        else:
            raise ValueError(
                f"{self.name} is an activation output of layer "
                f"'{self.owner_layer.name}'; set_tensor accepts model "
                "inputs, the label tensor, or weight tensors")

    def get_tensor(self, ff_model=None, comm_type=None) -> np.ndarray:
        """A staged input or label, a weight, or an activation of the bound
        batch (its layer's output in an inference forward)."""
        model = ff_model or self.model
        if self.owner_layer is None or self is model.label_tensor:
            return model._staged_tensor_value(self)
        if self.owner_idx < 0:
            return model._get_weight_by_tensor(self)
        return model._activation_value(self)

    def attach_numpy_array(self, ff_model, ff_config=None,
                           np_array: Optional[np.ndarray] = None) -> None:
        """reference: Tensor.attach_numpy_array (flexflow_cffi.py): a
        zero-copy region attach there, host staging here. Takes the
        reference's (ffmodel, ffconfig, array) or the short (ffmodel,
        array)."""
        if np_array is None:  # short form attach(ffmodel, array)
            np_array, ff_config = ff_config, None
        self.set_tensor(ff_model, np_array)

    def detach_numpy_array(self, ff_config=None) -> None:
        return None

    # inline mapping has nothing to map here: host access is a copy; kept
    # for the reference's API (flexflow_cffi.py:601-658)
    def inline_map(self, ff_model=None, ff_config=None) -> None:
        return None

    def inline_unmap(self, ff_model=None, ff_config=None) -> None:
        return None

    def get_array(self, ff_model=None, ff_config=None) -> np.ndarray:
        return self.get_tensor(ff_model)

    def __repr__(self) -> str:
        return f"Tensor(name={self.name}, dims={self.dims}, dtype={self.dtype.name})"
