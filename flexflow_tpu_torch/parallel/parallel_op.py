"""Parallel operators — the parallelism vocabulary of the PCG.

Port of ``flexflow_tpu.parallel.parallel_op`` (reference: src/parallel_ops/
— Repartition/Combine/Replicate/Reduction/FusedParallelOp are first-class
graph nodes inserted by the search; each realizes data movement via a
Legion partition + copy kernel, e.g. combine_kernels.cu:27,
reduction_kernels.cu:24-34).

A parallel op is a **resharding node** of the search: the JAX package pins
its output to the layout of its target ``ParallelTensorShape``
(``target_pts``) with ``with_sharding_constraint``. The port is
multi-controller, each rank holding its local shard: the node's op is the
identity on that shard, and the SPMD plan (``parallel.spmd.plan_spmd``)
makes ``target_pts.partition_spec()`` the node's output layout, so the
executor redistributes the value there (``parallel.spmd.redistribute``,
whose gradient moves it back). The search's ``insert_parallel_ops`` sets
``target_pts`` on every node of a state transition. A node without one
passes any layout through. ``comm_bytes`` prices the movement for the
search, as in the JAX package.

attrs (all): ``dim`` (tensor dim), ``degree``, ``axes`` (mesh axes involved).
"""
from __future__ import annotations

from typing import Optional

from ..ffconst import OperatorType
from ..ops.base import Op, OpContext, register_op
from ..parallel_tensor import ParallelTensorShape


class ParallelOpBase(Op):
    """Common base (reference: include/flexflow/parallel_ops/parallel_op.h)."""

    is_parallel_op = True

    def __init__(self, name, attrs, dtype, num_inputs=1):
        super().__init__(name, attrs, dtype, num_inputs)
        self.target_pts: Optional[ParallelTensorShape] = None

    def infer_output_shapes(self, input_shapes):
        # parallel ops never change the *global* logical shape
        return [input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        return [inputs[0]]

    # comm-volume hook for the simulator: bytes moved per device
    def comm_bytes(self, input_shape, dtype_size: int, num_devices: int) -> int:
        raise NotImplementedError


@register_op(OperatorType.OP_REPARTITION)
class RepartitionOp(ParallelOpBase):
    """Split dim ``dim`` into ``degree`` parts (reference: partition.cc).
    Fwd comm: a local slice of the input."""

    def comm_bytes(self, input_shape, dtype_size, num_devices):
        import numpy as np

        # worst case: every element moves once
        return int(np.prod(input_shape)) * dtype_size // max(num_devices, 1)


@register_op(OperatorType.OP_COMBINE)
class CombineOp(ParallelOpBase):
    """Merge shards of dim ``dim`` back, degree /= k (reference: combine.cc).
    Fwd comm: all-gather of the dim."""

    def comm_bytes(self, input_shape, dtype_size, num_devices):
        import numpy as np

        deg = self.attrs.get("degree", 1)
        return int(np.prod(input_shape)) * dtype_size * (deg - 1) // max(deg, 1)


@register_op(OperatorType.OP_REPLICATE)
class ReplicateOp(ParallelOpBase):
    """Add/grow a replica dim — broadcast fwd, grad-sum bwd
    (reference: replicate.cc): an all-reduce of the grads backward."""

    def comm_bytes(self, input_shape, dtype_size, num_devices):
        import numpy as np

        deg = self.attrs.get("degree", 1)
        return int(np.prod(input_shape)) * dtype_size * (deg - 1) // max(deg, 1)


@register_op(OperatorType.OP_REDUCTION)
class ReductionOp(ParallelOpBase):
    """Sum over a replica dim, e.g. after a row-parallel linear
    (reference: reduction.cc); the node pins the reduced output layout."""

    def comm_bytes(self, input_shape, dtype_size, num_devices):
        import numpy as np

        deg = self.attrs.get("degree", 1)
        return int(np.prod(input_shape)) * dtype_size * (deg - 1) // max(deg, 1)


@register_op(OperatorType.OP_FUSED_PARALLEL)
class FusedParallelOp(ParallelOpBase):
    """A pipeline of parallel ops collapsed into one resharding
    (reference: fused_parallel_op.cc; built by fuse_parallel_ops,
    graph.h:285-290). attrs: ``ops`` = list of (OperatorType, dim, degree).
    One redistribute to the final layout subsumes the chain."""

    def comm_bytes(self, input_shape, dtype_size, num_devices):
        import numpy as np

        return int(np.prod(input_shape)) * dtype_size


@register_op(OperatorType.OP_ALLTOALL)
class AllToAllOp(ParallelOpBase):
    """The JAX package's extension: explicit all-to-all resharding for
    expert/sequence parallelism (no reference analog). Swaps the sharded
    dim: attrs ``src_dim`` -> ``dst_dim``."""

    def comm_bytes(self, input_shape, dtype_size, num_devices):
        import numpy as np

        return int(np.prod(input_shape)) * dtype_size
