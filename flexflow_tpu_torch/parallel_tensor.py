"""Parallel (sharded) tensor metadata.

A copy of ``flexflow_tpu.parallel_tensor`` (reference: ``ParallelDim`` /
``ParallelTensorShape``, include/flexflow/parallel_tensor.h:36-126). Each
tensor dim carries ``{size, degree, is_replica_dim}`` as in the reference,
plus the mesh axis names the dim is sharded over. A replica dim's "size" is
its replication degree; replica dims do not exist in the materialized
tensor: their mesh axes hold the tensor replicated.
``ParallelTensorShape.partition_spec()`` gives the per-dim entries the
strategies write, and ``placements(axis_names)`` the ``torch.distributed``
placements per mesh dim that the port's executor works in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

from .ffconst import DataType


@dataclasses.dataclass(frozen=True)
class ParallelDim:
    """One dim of a ParallelTensorShape (reference: parallel_tensor.h:36-70)."""

    size: int  # global extent (for replica dims: the replication degree)
    degree: int = 1  # number of shards along this dim
    parallel_idx: int = -1  # kept for strategy-serialization parity
    is_replica_dim: bool = False
    mesh_axes: Tuple[str, ...] = ()  # mesh axes realizing the sharding

    def __post_init__(self):
        object.__setattr__(self, "mesh_axes", tuple(self.mesh_axes))
        if self.is_replica_dim:
            assert self.degree == self.size, "replica dim degree == size"

    @property
    def is_sharded(self) -> bool:
        return self.degree > 1


@dataclasses.dataclass(frozen=True)
class ParallelTensorShape:
    """Sharded shape (reference: parallel_tensor.h:76)."""

    dims: Tuple[ParallelDim, ...]
    dtype: DataType = DataType.DT_FLOAT

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(self.dims))

    # -- constructors -----------------------------------------------------------
    @staticmethod
    def unsharded(shape: Sequence[int], dtype: DataType = DataType.DT_FLOAT
                  ) -> "ParallelTensorShape":
        return ParallelTensorShape(
            tuple(ParallelDim(size=int(s)) for s in shape), dtype)

    # -- views ------------------------------------------------------------------
    @property
    def array_dims(self) -> Tuple[ParallelDim, ...]:
        """Dims that exist in the materialized array (replica dims dropped)."""
        return tuple(d for d in self.dims if not d.is_replica_dim)

    @property
    def array_shape(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.array_dims)

    @property
    def replica_dims(self) -> Tuple[ParallelDim, ...]:
        return tuple(d for d in self.dims if d.is_replica_dim)

    @property
    def num_replica_axes(self) -> Tuple[str, ...]:
        axes: Tuple[str, ...] = ()
        for d in self.replica_dims:
            axes += d.mesh_axes
        return axes

    def total_degree(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.degree
        return n

    def get_piece_shape(self) -> Tuple[int, ...]:
        """Per-shard extent of the materialized array."""
        return tuple(d.size // max(d.degree, 1) for d in self.array_dims)

    def get_piece_num_elements(self) -> int:
        n = 1
        for s in self.get_piece_shape():
            n *= s
        return n

    def num_elements(self) -> int:
        n = 1
        for s in self.array_shape:
            n *= s
        return n

    # -- lowering to the mesh ----------------------------------------------
    def partition_spec(self) -> Tuple[Any, ...]:
        """Per-dim spec entries over the materialized dims (None, an axis
        name, or a tuple of names), trailing Nones trimmed: the JAX
        package's ``PartitionSpec`` as a tuple. Mesh axes attached to
        replica dims are absent, so the tensor is replicated over them."""
        entries = []
        for d in self.array_dims:
            if not d.mesh_axes:
                entries.append(None)
            elif len(d.mesh_axes) == 1:
                entries.append(d.mesh_axes[0])
            else:
                entries.append(tuple(d.mesh_axes))
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def placements(self, axis_names: Sequence[str]) -> Tuple[Any, ...]:
        """The ``torch.distributed.tensor`` placement of this tensor on
        each mesh dim (``axis_names`` in mesh order): ``Shard(d)`` where a
        materialized dim d is sharded over that axis, else
        ``Replicate()`` (the counterpart of :meth:`partition_spec`)."""
        from .parallel.spmd import spec_placements

        return spec_placements(self.partition_spec(), axis_names)

    def with_dim_sharded(self, dim_idx: int, axes: Tuple[str, ...], degree: int
                         ) -> "ParallelTensorShape":
        dims = list(self.dims)
        d = dims[dim_idx]
        dims[dim_idx] = dataclasses.replace(d, degree=degree, mesh_axes=axes)
        return ParallelTensorShape(tuple(dims), self.dtype)

    def __str__(self) -> str:
        parts = []
        for d in self.dims:
            tag = "R" if d.is_replica_dim else ""
            parts.append(f"{d.size}{tag}/{d.degree}{list(d.mesh_axes)}")
        return f"PTS[{', '.join(parts)}:{self.dtype.name}]"
