"""Device mesh construction over ``torch.distributed``.

Port of ``flexflow_tpu.parallel.mesh``. The JAX package builds one
``jax.sharding.Mesh`` over every device of a single controller; the port
runs one process per GPU, so the mesh is a ``DeviceMesh`` over the ranks
of the default process group (``init_device_mesh``), with the same axis
names and defaults: ``data`` (batch), ``model`` (tensor / attribute
parallel), and ``expert`` or ``seq`` for the expert- and long-context
strategies. Ranks fill the mesh in row-major order. :class:`Mesh` wraps the
``DeviceMesh`` with what the executor reads on every node: each axis's
size, this rank's coordinate on it and its process group.

A pipeline strategy runs on a (pp, dp) grid of ranks instead
(:func:`build_pipeline_grid`): rank ``d * dp + j`` of the grid is pipe
device ``d``, data index ``j``, as the JAX package lays the first pp*dp
devices out in a (pipe, data) array; each pipe device's dp ranks form the
stage's data group, a one-axis :class:`Mesh` the SPMD plan runs a stage on.

``initialize_multihost`` becomes ``init_process_group``: it reads
``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` or takes them as
arguments, and picks NCCL for CUDA and gloo for the CPU. A process
started without ``torchrun`` joins a group of one.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Mesh:
    """A ``DeviceMesh`` and, per axis in mesh order, its size, this rank's
    coordinate and its process group."""

    device_mesh: Any
    axis_names: Tuple[str, ...]
    sizes: List[int]
    coords: List[int]
    groups: List[Any]
    device: Any

    @property
    def shape(self):
        """{axis name: size}, as ``jax.sharding.Mesh.shape`` reads."""
        return dict(zip(self.axis_names, self.sizes))

    def size(self, axis: str) -> int:
        return self.sizes[self.axis_names.index(axis)]

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    @property
    def numel(self) -> int:
        return int(np.prod(self.sizes))


def world() -> Tuple[int, int, int]:
    """(rank, world size, local rank) of this process: the default process
    group's when one is initialized, else ``torchrun``'s environment, else
    a group of one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return (dist.get_rank(), dist.get_world_size(),
                int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         backend: Optional[str] = None,
                         device_type: str = "cuda") -> int:
    """Join the process group (the counterpart of
    ``jax.distributed.initialize``): ``torchrun``'s ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``) or the
    explicit arguments. A process with neither joins a group of one
    through a ``file://`` store in the temporary directory. Backend NCCL
    for ``device_type="cuda"``, gloo for ``"cpu"``. Returns the rank.

    Only "already initialized" is benign: any other failure (an
    unreachable store, a bad world size) propagates, since independent
    single-process runs would quietly replace one job."""
    import tempfile

    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    env = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"]) if env else 1
    if rank is None:
        rank = int(os.environ["RANK"]) if env else 0
    if init_method is None:
        if env and "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            fd, path = tempfile.mkstemp(prefix="ff_pg_")
            os.close(fd)
            os.unlink(path)
            init_method = f"file://{path}"
        else:
            raise ValueError(
                f"initialize_multihost: world size {world_size} needs an "
                "init_method (tcp://host:port or file://path) or torchrun's "
                "MASTER_ADDR/MASTER_PORT")
    kwargs = {}
    if backend == "nccl":
        import torch

        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank, **kwargs)
    except (RuntimeError, ValueError) as e:
        if "already initialized" not in str(e).lower():
            raise
    return dist.get_rank()


def mesh_device(device_type: str):
    """This rank's device: the GPU this process is bound to
    (``initialize_multihost`` binds ``cuda:LOCAL_RANK``), the CPU for a
    gloo mesh."""
    import torch

    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def build_mesh(config=None, mesh_shape: Optional[Sequence[int]] = None,
               axis_names: Optional[Sequence[str]] = None,
               device_type: str = "cuda") -> Mesh:
    """The global mesh over the process group's ranks (joined first if
    need be). Defaults to a 1-D data-parallel mesh over every rank (the
    reference's default DataParallelism strategy, config.h:95-100); axis
    names default to the config's (``data``, ``model``) and are padded
    with ``ax<i>`` when the mesh has more dims. The mesh must cover the
    world: a multi-controller job has no idle ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    initialize_multihost(device_type=device_type)
    n = dist.get_world_size()
    if mesh_shape is None and config is not None:
        mesh_shape = config.mesh_shape
    if axis_names is None:
        axis_names = (config.mesh_axis_names if config is not None
                      else ("data", "model"))
    if mesh_shape is None:
        mesh_shape = (n, 1) if len(axis_names) == 2 else (n,) + (1,) * (
            len(axis_names) - 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    total = int(np.prod(mesh_shape))
    if total != n:
        raise ValueError(
            f"mesh {mesh_shape} needs {total} ranks and the process group "
            f"has {n}; launch with torchrun --nproc-per-node {total} (one "
            "process per GPU) or pass a mesh of the world's size")
    axis_names = tuple(axis_names)[:len(mesh_shape)]
    if len(axis_names) < len(mesh_shape):
        axis_names = axis_names + tuple(
            f"ax{i}" for i in range(len(axis_names), len(mesh_shape)))
    dm = init_device_mesh(device_type, mesh_shape,
                          mesh_dim_names=axis_names)
    coords = list(dm.get_coordinate())
    groups = [dm.get_group(a) for a in axis_names]
    return Mesh(dm, axis_names, list(mesh_shape), coords, groups,
                mesh_device(device_type))


def mesh_for_strategy(config, strategy, device_type: str = "cuda") -> Mesh:
    """The mesh a Strategy calls for: the hybrid ICI x DCN layout when the
    search placed an axis factor across hosts, the plain mesh otherwise."""
    if getattr(strategy, "hybrid", None):
        return build_hybrid_mesh(strategy.hybrid[0], strategy.hybrid[1],
                                 strategy.axis_names,
                                 device_type=device_type)
    return build_mesh(config, mesh_shape=strategy.mesh_shape,
                      axis_names=strategy.axis_names,
                      device_type=device_type)


def mesh_axis_size(mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.shape else 1


def hybrid_rank_grid(ici_shape: Sequence[int],
                     dcn_shape: Sequence[int]) -> np.ndarray:
    """The ranks of a hybrid mesh laid out node-major: axis i has size
    ``ici[i] * dcn[i]``, its outer ``dcn[i]`` factor steps across nodes and
    its inner ``ici[i]`` factor stays inside one node (ranks of one node
    are consecutive, as ``torchrun`` numbers them). So no node's ring is
    split by a DCN factor (the rule of ``create_hybrid_device_mesh``)."""
    ici = tuple(int(i) for i in ici_shape)
    dcn = tuple(int(d) for d in dcn_shape)
    k = len(ici)
    per_node = int(np.prod(ici))
    ranks = np.arange(int(np.prod(dcn)) * per_node).reshape(dcn + ici)
    # (dcn_0..dcn_k-1, ici_0..ici_k-1) -> (dcn_0, ici_0, dcn_1, ici_1, ...)
    order = [a for i in range(k) for a in (i, k + i)]
    return ranks.transpose(order).reshape(
        tuple(i * d for i, d in zip(ici, dcn)))


def build_hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                      axis_names: Sequence[str],
                      device_type: str = "cuda") -> Mesh:
    """A multi-node mesh: ``ici_shape`` and ``dcn_shape`` have EQUAL rank
    and axis i has size ``ici_shape[i] * dcn_shape[i]``, with ranks laid
    out by :func:`hybrid_rank_grid` so an axis's DCN factor never splits a
    node. Put the DCN factor on data-parallel axes and keep tensor or
    sequence axes inside a node."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ici_shape = tuple(ici_shape)
    dcn_shape = tuple(dcn_shape)
    if len(ici_shape) != len(dcn_shape):
        raise ValueError(
            f"ici_shape {ici_shape} and dcn_shape {dcn_shape} must have "
            f"equal rank (axis i spans ici*dcn)")
    if len(tuple(axis_names)) != len(ici_shape):
        raise ValueError(
            f"need exactly {len(ici_shape)} axis names, got {axis_names}")
    initialize_multihost(device_type=device_type)
    grid = hybrid_rank_grid(ici_shape, dcn_shape)
    if grid.size != dist.get_world_size():
        raise ValueError(
            f"hybrid mesh {grid.shape} needs {grid.size} ranks and the "
            f"process group has {dist.get_world_size()}")
    import torch

    dm = DeviceMesh(device_type, torch.as_tensor(grid),
                    mesh_dim_names=tuple(axis_names))
    names = tuple(axis_names)
    return Mesh(dm, names, list(grid.shape), list(dm.get_coordinate()),
                [dm.get_group(a) for a in names], mesh_device(device_type))


@dataclasses.dataclass
class PipelineGrid:
    """A (pp, dp) grid over ``ranks`` (global ranks, grid-major: entry
    ``d * dp + j`` is pipe device ``d``, data index ``j``). ``coord`` is
    this rank's (d, j), or None for a rank past the grid (it holds no
    stage); ``data_mesh`` its stage's data group as a one-axis ``data``
    mesh, None past the grid."""

    pp: int
    dp: int
    ranks: List[int]
    coord: Optional[Tuple[int, int]]
    data_mesh: Optional[Mesh]

    def rank_of(self, d: int, j: int) -> int:
        """The global rank of pipe device ``d``, data index ``j``."""
        return self.ranks[d * self.dp + j]

    def peer(self, d: int) -> int:
        """The global rank of pipe device ``d`` at this rank's data index:
        the point-to-point peer of every boundary tensor between this
        rank's stages and device ``d``'s."""
        return self.rank_of(d, self.coord[1])


def build_pipeline_grid(pp: int, dp: int, device,
                        ranks: Optional[Sequence[int]] = None
                        ) -> PipelineGrid:
    """The (pp, dp) grid over the first pp*dp of ``ranks`` (default: every
    rank of the default process group, joined first if need be). Every
    rank of the group calls this: each pipe device's data group is made
    by ``new_group``, which the whole group enters in the same order."""
    import torch.distributed as dist

    initialize_multihost(device_type=device.type)
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) < pp * dp:
        raise ValueError(
            f"pipeline grid pp={pp} x dp={dp} needs {pp * dp} ranks and "
            f"{len(ranks)} are given (world size {world}); launch with "
            f"torchrun --nproc-per-node {pp * dp} or shrink the grid")
    grid = ranks[:pp * dp]
    me = dist.get_rank()
    coord = None
    data_mesh = None
    for d in range(pp):
        members = grid[d * dp:(d + 1) * dp]
        group = dist.new_group(ranks=members)
        if me in members:
            coord = (d, members.index(me))
            data_mesh = Mesh(None, ("data",), [dp], [coord[1]], [group],
                             device)
    return PipelineGrid(pp, dp, grid, coord, data_mesh)


# ------------------------------------------------------------ coordination
def coordination_group():
    """The process group the ranks agree on host values through (a
    rollback target, a resume path, a preemption flag, a checkpoint's
    staging name), made once at compile by every rank. Under NCCL it is a
    gloo group of its own, so the host's small agreements never share a
    communicator with the train step's collectives; under gloo or a test
    harness's group it is the default group. None in a world of one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return None
    if dist.get_backend() == "nccl":
        return dist.new_group(backend="gloo")
    return dist.group.WORLD


def agree(value, group):
    """Rank 0's ``value`` (any picklable object) on every rank of
    ``group``; ``value`` itself when ``group`` is None."""
    import torch.distributed as dist

    if group is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def any_rank(flag: bool, group) -> bool:
    """Is ``flag`` set on any rank of ``group``? (one host all-reduce;
    ``flag`` itself when ``group`` is None)."""
    import torch
    import torch.distributed as dist

    if group is None:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, group=group)
    return bool(int(t[0]))
