"""MachineView: device-grid assignment of an op.

A copy of ``flexflow_tpu.machine_view`` (reference: ``MachineView``,
include/flexflow/machine_view.h:14-35, and ``MachineResource``, :51). A view
names a sub-grid of the ranks of the ``torch.distributed`` device mesh:
``dim[i]`` counts ranks along the i-th view axis. ``start_device_id`` and
``stride`` are kept so strategies serialize to the JAX package's text; every
op runs on the whole mesh, and a view smaller than the mesh means the op is
replicated over the remaining axes.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MachineView:
    device_type: str = "TPU"  # the JAX package's value, kept for the strategy text
    start_device_id: int = 0
    dim: Tuple[int, ...] = (1,)
    stride: Tuple[int, ...] = (1,)

    def __post_init__(self):
        object.__setattr__(self, "dim", tuple(int(d) for d in self.dim))
        object.__setattr__(self, "stride", tuple(int(s) for s in self.stride))
        assert len(self.dim) == len(self.stride)

    @property
    def ndims(self) -> int:
        return len(self.dim)

    def num_parts(self) -> int:
        n = 1
        for d in self.dim:
            n *= d
        return n

    def get_device_id(self, point: Sequence[int]) -> int:
        """Device for a grid point (reference: mapper.cc:452-470)."""
        assert len(point) == self.ndims
        dev = self.start_device_id
        for p, s in zip(point, self.stride):
            dev += p * s
        return dev

    def device_ids(self) -> Tuple[int, ...]:
        ids = []

        def rec(axis, base):
            if axis == self.ndims:
                ids.append(base)
                return
            for p in range(self.dim[axis]):
                rec(axis + 1, base + p * self.stride[axis])

        rec(0, self.start_device_id)
        return tuple(ids)

    def hash(self) -> int:
        return hash((self.device_type, self.start_device_id, self.dim, self.stride))

    @staticmethod
    def data_parallel(num_devices: int) -> "MachineView":
        """The reference's default 1-D strategy (config.h:95-100)."""
        return MachineView(dim=(num_devices,), stride=(1,))


@dataclasses.dataclass(frozen=True)
class MachineResource:
    """Available resources for the search (reference: machine_view.h:51)."""

    num_nodes: int = 1
    all_tpus_per_node: int = 1
    available_tpus_per_node: int = 1
    all_cpus_per_node: int = 1
    available_cpus_per_node: int = 1
    start_tpu_id: int = 0
    start_cpu_id: int = 0

    def num_devices(self) -> int:
        return self.num_nodes * self.available_tpus_per_node
