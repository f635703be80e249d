"""The per-tensor placement lattice ShardLint's abstract interpreter runs on.

Every tensor in a parallelized PCG is, per mesh axis, in exactly one of
three placement states — the same vocabulary the reference's parallel-op IR
encodes operationally (Replicate/Repartition/Combine/Reduction nodes,
src/parallel_ops/) and the Unity DP encodes as its {R, S, Q, H} sharding
states (search/unity.node_options):

* **replicated** — every device along the axis holds the full value;
* **sharded(axis, dim)** — tensor dim ``dim`` is split over mesh axis
  ``axis`` (covers the DP batch split, tp column outputs, sequence and
  spatial shards alike);
* **partial_sum(axis)** — every device holds an *unreduced partial term*
  of a contraction over a dim that was sharded on ``axis`` (the output of
  a row-parallel Linear before its psum; ``parallel/parallel_op.py``
  ReductionOp semantics, ``parallel/strategies.py`` row-parallel
  comments). A partial value is NOT the tensor: consuming it as if it
  were — or reducing it twice — is the silent-wrong-gradient defect class
  the dynamic audit (resilience/audit.py) can only catch by running a
  probe step. Here it is a lattice state, decidable without hardware.

A :class:`Placement` carries both facets at once: ``dims[d]`` names the
mesh axes tensor dim ``d`` is sharded over (None = not sharded), and
``partial`` is the set of mesh axes the value is an unreduced partial sum
over. ``replicated`` is the bottom element (no sharded dims, no partials).
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional, Sequence, Tuple, Union

# one per-dim entry: None, one axis name, or a tuple of axis names (the
# PartitionSpec convention Strategy.weight_specs/output_spec already uses)
DimEntry = Union[None, str, Tuple[str, ...]]


def entry_axes(entry: DimEntry) -> Tuple[str, ...]:
    """Mesh axes named by one per-dim spec entry."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(a for a in entry if a is not None)
    return (entry,)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Abstract placement of one tensor over the strategy's mesh."""

    dims: Tuple[DimEntry, ...] = ()
    partial: FrozenSet[str] = frozenset()

    # ------------------------------------------------------------ factories
    @staticmethod
    def replicated(ndim: int) -> "Placement":
        return Placement(dims=(None,) * ndim)

    @staticmethod
    def from_spec(spec: Optional[Sequence[DimEntry]],
                  ndim: int) -> "Placement":
        """Placement pinned by a declared PartitionSpec (output_spec /
        weight_specs entry). A declared spec never carries partial sums:
        lowering it to ``with_sharding_constraint`` forces XLA to
        materialize the reduction that discharges any pending partial."""
        if spec is None:
            return Placement.replicated(ndim)
        entries = tuple(spec)[:ndim]
        entries = entries + (None,) * (ndim - len(entries))
        return Placement(dims=entries)

    # -------------------------------------------------------------- queries
    def sharded_axes(self) -> Tuple[str, ...]:
        out = []
        for e in self.dims:
            out.extend(entry_axes(e))
        return tuple(out)

    def axes_of_dim(self, dim: int) -> Tuple[str, ...]:
        if 0 <= dim < len(self.dims):
            return entry_axes(self.dims[dim])
        return ()

    @property
    def is_partial(self) -> bool:
        return bool(self.partial)

    # ---------------------------------------------------------- transitions
    def with_partial(self, axes: Sequence[str]) -> "Placement":
        return dataclasses.replace(
            self, partial=self.partial | frozenset(axes))

    def reduce_over(self, axes: Sequence[str]) -> "Placement":
        """Discharge a partial sum over ``axes`` (a Reduction node / an
        output constraint)."""
        return dataclasses.replace(
            self, partial=self.partial - frozenset(axes))

    def describe(self) -> str:
        bits = []
        for d, e in enumerate(self.dims):
            for a in entry_axes(e):
                bits.append(f"sharded({a}@dim{d})")
        for a in sorted(self.partial):
            bits.append(f"partial_sum({a})")
        return " + ".join(bits) if bits else "replicated"
