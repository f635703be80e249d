"""Elastic restart: resume a checkpoint on a degraded (or grown) world
(port of ``flexflow_tpu.resilience.elastic``).

A lost host changes the device count; the checkpoint on disk was sharded
for the old topology and its strategy may not even be expressible on the
survivors. ``elastic_restore`` re-plans for the live machine, reshards and
continues: when the target device count differs from the checkpoint's it
re-runs the Unity search (``FFModel.compile`` with the device-count
override; pass ``sim=`` to reuse a warm Simulator's memoized tables),
rebuilds mesh and executor for the winner, and restores the checkpoint
host-staged (``restore_checkpoint``: each tensor assembled whole from the
saved pieces, then this rank's slice kept), then the train cursor.

The port runs one process a rank, so the surviving devices are the live
process group: a job restarted with fewer ranks (``torchrun
--nproc-per-node 2`` after a world of 4) calls it on every rank. A target
below the world's size raises ``ValueError`` naming ``n_dev``: the port's
mesh covers every rank of the group.
"""
from __future__ import annotations

import time
from typing import Optional

from ..execution.checkpoint import (read_meta, restore_checkpoint,
                                    restore_train_cursor)


def elastic_restore(ffmodel, path: str, n_dev: Optional[int] = None,
                    sim=None, verify: bool = True) -> int:
    """Restore ``path`` onto the current (possibly degraded) topology.

    ``n_dev`` defaults to the live world size (one device without a
    process group). ``sim`` is an optional warm
    ``search.simulator.Simulator`` whose memoized cost tables the
    re-search reuses. Returns the checkpoint's step; the model's
    ``_rng_counter`` is restored from ``train_state.json`` when present,
    so a following fit continues exactly. On a mesh every rank calls
    it."""
    import numpy as np

    from ..parallel.mesh import world

    meta = read_meta(path)
    live = world()[1]
    n_dev = int(n_dev if n_dev is not None else live)
    if n_dev != live:
        raise ValueError(
            f"elastic_restore onto n_dev={n_dev} devices: the port's mesh "
            f"covers every rank of the process group ({live}), so the "
            f"surviving devices are the live group; restart the job with "
            f"{n_dev} ranks (torchrun --nproc-per-node {n_dev}) and call "
            "elastic_restore there")
    saved_ndev = int(meta.get("n_devices")
                     or np.prod(meta.get("mesh_shape", [1])))
    cur_shape = (list(ffmodel.strategy.mesh_shape)
                 if ffmodel.mesh is not None else [1])
    if n_dev == saved_ndev and cur_shape == list(meta.get("mesh_shape",
                                                          [])):
        step = restore_checkpoint(ffmodel, path, verify=verify)
        restore_train_cursor(ffmodel, path)
        return step

    # topology changed: re-plan on the surviving devices, then reshard
    tracer = ffmodel._obs_tracer()
    t0 = time.perf_counter()
    ffmodel._search_sim = sim
    ffmodel._elastic_n_dev = n_dev
    try:
        ffmodel.compile(
            optimizer=ffmodel.optimizer, loss_type=ffmodel.loss_type,
            metrics=(ffmodel.metrics_obj.measures
                     if ffmodel.metrics_obj else None))
    finally:
        ffmodel._elastic_n_dev = None
    step = restore_checkpoint(ffmodel, path, verify=verify)
    restore_train_cursor(ffmodel, path)
    tracer.complete(
        "recovery", time.perf_counter() - t0, kind="elastic_restart",
        step=step, saved_devices=saved_ndev, new_devices=n_dev,
        new_mesh=(list(ffmodel.strategy.mesh_shape)
                  if ffmodel.mesh is not None else [1]))
    return step
