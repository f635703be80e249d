"""Preemption-safe checkpoints: atomic commit, checksums, async save,
retention, exact resume (port of ``flexflow_tpu.execution.checkpoint``).

The protocol is the JAX package's (flexflow_tpu/execution/checkpoint.py:
118-180), byte for byte in its metadata:

* **Atomic commit**: a checkpoint is staged in ``step_N.tmp.<pid>``, its
  payloads fsynced, ``meta.json`` written with a crc32 per payload file,
  then the ``COMMIT`` marker (the crc of ``meta.json``), then the staging
  directory is renamed to ``step_N`` and the parent fsynced. A killed
  writer leaves only a ``.tmp`` directory, which ``latest_checkpoint``
  never selects.
* **Checksums**: ``restore_checkpoint`` verifies every payload's crc32
  before touching the model and raises ``CheckpointCorruptError`` on a
  mismatch.
* **Exact resume**: ``train_state.json`` carries the data cursor (step,
  epoch, batch_in_epoch, rng_counter).
* **Retention**: ``prune_checkpoints`` keeps the newest N committed
  checkpoints and sweeps dead writers' staging directories.

The payload is not orbax's. On one device each tree (``params``,
``opt_state``) is one ``torch.save`` file of CPU tensors (``params.pt``,
``opt_state.pt``), read back with ``torch.load(weights_only=True)``, and
``strategy.json`` / ``meta.json`` record that layout (``mesh_shape [1]``).

On a mesh (``FFModel.mesh``, every rank calling) the checkpoint is
sharded. Each distinct shard of a tree is written once, by the lowest rank
that holds it (a replica's coordinate 0 on every axis it is not split
over): rank r writes ``params.r<r>.pt`` and ``opt_state.r<r>.pt`` (a list
of tensors) and ``index.r<r>.json`` (each piece's tree, path, global
shape and offset). ``strategy.json`` is ``Strategy.to_json(pcg)`` and
``meta.json`` keeps the JAX keys with the real ``mesh_shape``,
``axis_names`` and ``n_devices``, its checksums covering every rank's
files. The commit is rank 0's: the staging name is agreed on the main
thread (rank 0's choice, through ``parallel/mesh.coordination_group``), so
the ranks stage into one directory; each rank fsyncs its files and leaves
its checksums in a ``done.r<r>.json`` marker; rank 0 waits for every
marker, writes ``meta.json`` and ``COMMIT`` and renames; the others wait
until the staging directory is gone and the commit is visible. The
handshake goes through the files alone, so the async writer's thread
issues no collective (no second thread on the train step's communicator).

Restore reads the pieces this rank holds: on the topology the checkpoint
was written on, each live tensor's own piece; on another one (several
ranks to one device, one device to a mesh, dp 2 to dp 2 x tp 2) it is
host-staged, as ``flexflow_tpu``'s ``_host_staged_restore``: the whole
tensor assembled from the pieces that cover it, then this rank's slice
kept (``Executor.shard_param``'s rule).

``restore_checkpoint`` copies the saved values INTO the model's live
tensors (``Tensor.copy_``, the 0-d int32 step counter included): a
captured step program keys on its argument tensors (``execution/
graphs.py``), so a resume or a rollback into the same model replays the
graphs it has instead of capturing new ones.

``CheckpointManager`` takes the snapshot as device clones on the current
stream right after a step's in-place update, copies them into pinned host
buffers on a side stream behind an event, and serializes them on a worker
thread; its bounded queue blocks ``save_async`` when the writer falls
behind (backpressure), and it records each save's bytes and seconds and
the time the caller blocked.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from queue import Queue
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..utils.durable_io import (STALE_TMP_AGE_S,  # noqa: F401
                                crc_file as _crc_file,
                                fsync_path as _fsync_path,
                                write_json as _write_json)

COMMIT_MARKER = "COMMIT"
_STEP_RE = re.compile(r"^step_(\d+)$")
_FORMAT_VERSION = 1
TREES = ("params", "opt_state")
# the one-device layout the port trains on
MESH_SHAPE = [1]
AXIS_NAMES = ["data"]


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed commit-marker or checksum validation."""


def _payload_files(root: str) -> List[str]:
    """Relative paths of every checksummed file under a staged checkpoint
    (all but ``meta.json`` and the marker, which carry the checksums)."""
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            rel = os.path.relpath(os.path.join(dirpath, fn), root)
            if rel in ("meta.json", COMMIT_MARKER):
                continue
            out.append(rel)
    return sorted(out)


def _dir_checksums(root: str) -> Dict[str, List[int]]:
    return {rel: list(_crc_file(os.path.join(root, rel)))
            for rel in _payload_files(root)}


def _tree_map(fn, tree):
    """``fn`` over the tensors of a tree of dicts (params, opt_state)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_bytes(tree) -> int:
    from .graphs import _tensors_of

    return sum(t.numel() * t.element_size() for t in _tensors_of(tree))


# -------------------------------------------------------------------- layout
def _flatten(tree, path=()):
    """[(path, tensor)] of a tree of dicts, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, path + (k,))]
    return [(path, tree)]


def _on_mesh(ffmodel) -> bool:
    return getattr(ffmodel, "executor", None) is not None and \
        ffmodel.executor.mesh is not None


def _leaf_layout(ffmodel, tree: str, path, t):
    """The placements of a tree leaf on the model's mesh: a param's stored
    layout, and the same for an optimizer moment of a param (its path ends
    in the param's node and weight, at the param's local shape); the step
    counter and anything else is replicated."""
    from ..parallel.spmd import replicated

    ex = ffmodel.executor
    params = ffmodel.params
    if len(path) >= 2 and path[-2] in params and \
            path[-1] in params[path[-2]] and (
                tree == "params" or tuple(t.shape) == tuple(
                    params[path[-2]][path[-1]].shape)):
        return ex.stored_placement(path[-2], path[-1])
    return replicated(len(ex.mesh.sizes))


def _global_of(shape, pl, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            out[p.dim] *= mesh.sizes[i]
    return tuple(out)


def _writes(pl, mesh) -> bool:
    """Is this rank the lowest holder of its shard (coordinate 0 on every
    mesh dim the tensor is not split over)?"""
    return all(mesh.coords[i] == 0 for i, p in enumerate(pl)
               if not p.is_shard())


def _mesh_meta(ffmodel) -> Tuple[List[int], List[str], int]:
    s = ffmodel.strategy
    shape = [int(x) for x in s.mesh_shape]
    return shape, list(s.axis_names), int(np.prod(shape))


def _ranks() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Staging(NamedTuple):
    """One sharded save's agreed staging suffix, with the rank and world
    size of the thread that agreed it (the writer thread may not see the
    process group: ranks that are threads of one process)."""

    name: str
    rank: int
    world: int


def staging_name(ffmodel) -> Staging:
    """A fresh staging suffix, rank 0's choice on every rank (call it on
    the main thread of every rank, in the same order)."""
    from ..parallel.mesh import agree

    rank, world = _ranks()
    return Staging(str(agree(f"{os.getpid()}-{time.time_ns()}",
                             getattr(ffmodel, "coordination", None))),
                   rank, world)


def written_bytes(ffmodel, trees: Dict[str, Any]) -> int:
    """The bytes of ``trees`` this rank writes: all of them on one device,
    the shards it is the lowest holder of on a mesh."""
    if not _on_mesh(ffmodel):
        return tree_bytes(list(trees.values()))
    mesh = ffmodel.executor.mesh
    return sum(t.numel() * t.element_size()
               for name, tree in trees.items()
               for path, t in _flatten(tree)
               if _writes(_leaf_layout(ffmodel, name, path, t), mesh))


def _agreed(ffmodel, value):
    """Rank 0's ``value`` on every rank of the model's mesh."""
    from ..parallel.mesh import agree

    return agree(value, getattr(ffmodel, "coordination", None))


# -------------------------------------------------------------------- saving
def save_checkpoint(ffmodel, directory: str, step: int = 0,
                    train_state: Optional[Dict[str, Any]] = None,
                    params=None, opt_state=None,
                    staging: Optional[Staging] = None) -> str:
    """Atomically save params + optimizer state + layout + metadata (the
    protocol of the module doc). ``params`` / ``opt_state`` default to the
    model's live trees (copied to the host here); the async manager passes
    its host snapshots. ``train_state`` is the exact-resume cursor. On a
    mesh every rank calls it; ``staging`` is the agreed staging suffix
    (agreed here when None, so call it on every rank's main thread)."""
    trees = {"params": ffmodel.params if params is None else params,
             "opt_state": ffmodel.opt_state if opt_state is None
             else opt_state}
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{int(step)}")
    if _on_mesh(ffmodel):
        if staging is None:
            staging = staging_name(ffmodel)
        return _save_sharded(ffmodel, directory, final, int(step), trees,
                             train_state, staging)
    return _save_one_device(ffmodel, directory, final, int(step), trees,
                            train_state)


def _commit(tmp: str, final: str, directory: str, meta) -> None:
    """meta.json, the marker, fsyncs and the rename (rank 0's, or the one
    device's, half of the protocol)."""
    _write_json(os.path.join(tmp, "meta.json"), meta)
    meta_crc, _ = _crc_file(os.path.join(tmp, "meta.json"))
    _write_json(os.path.join(tmp, COMMIT_MARKER), {"meta_crc32": meta_crc})
    _fsync_path(tmp)
    if os.path.isdir(final):  # overwrite semantics (re-save of a step)
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_path(directory)


def _save_one_device(ffmodel, directory, final, step, trees,
                     train_state) -> str:
    import torch

    tmp = f"{final}.tmp.{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        for name, tree in trees.items():
            torch.save(_tree_map(lambda t: t.detach().cpu(), tree),
                       os.path.join(tmp, f"{name}.pt"))
        _write_json(os.path.join(tmp, "strategy.json"),
                    {"mesh_shape": MESH_SHAPE, "axis_names": AXIS_NAMES,
                     "devices": [str(ffmodel.device)]}, fsync=False)
        if train_state is not None:
            _write_json(os.path.join(tmp, "train_state.json"),
                        train_state, fsync=False)
        for rel in _payload_files(tmp):
            _fsync_path(os.path.join(tmp, rel))
        _commit(tmp, final, directory, {
            "format_version": _FORMAT_VERSION,
            "step": int(step),
            "mesh_shape": MESH_SHAPE,
            "axis_names": AXIS_NAMES,
            "n_devices": 1,
            "checksums": _dir_checksums(tmp),
        })
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


# how long a rank waits for the others' files or for the commit
HANDSHAKE_TIMEOUT_S = 600.0


def _wait_for(cond, what: str, timeout: float = HANDSHAKE_TIMEOUT_S):
    t0 = time.perf_counter()
    delay = 1e-4
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"checkpoint: waited {timeout:.0f} s for "
                               f"{what}")
        time.sleep(delay)
        delay = min(delay * 2, 0.05)


def _save_sharded(ffmodel, directory, final, step, trees, train_state,
                  staging) -> str:
    """This rank's pieces into the agreed staging directory; rank 0
    commits once every rank's files are fsynced (module doc)."""
    import torch

    rank, world = staging.rank, staging.world
    mesh = ffmodel.executor.mesh
    tmp = f"{final}.tmp.{staging.name}"
    failed = os.path.join(tmp, "FAILED")
    os.makedirs(tmp, exist_ok=True)
    try:
        index, mine = [], []
        for name, tree in trees.items():
            pieces = []
            for path, t in _flatten(tree):
                pl = _leaf_layout(ffmodel, name, path, t)
                if not _writes(pl, mesh):
                    continue
                t = t.detach().cpu()
                if t.untyped_storage().nbytes() != \
                        t.numel() * t.element_size():
                    t = t.clone()  # a view saves its whole storage
                index.append({
                    "tree": name, "path": list(path),
                    "shape": list(_global_of(t.shape, pl, mesh)),
                    "offset": list(_offsets(t.shape, pl, mesh)),
                    "file": f"{name}.r{rank}.pt", "index": len(pieces)})
                pieces.append(t)
            fp = os.path.join(tmp, f"{name}.r{rank}.pt")
            torch.save(pieces, fp)
            mine.append(fp)
        fp = os.path.join(tmp, f"index.r{rank}.json")
        _write_json(fp, index, fsync=False)
        mine.append(fp)
        if rank == 0:
            _write_json(os.path.join(tmp, "strategy.json"),
                        json.loads(ffmodel.strategy.to_json(ffmodel.pcg)),
                        fsync=False)
            mine.append(os.path.join(tmp, "strategy.json"))
            if train_state is not None:
                fp = os.path.join(tmp, "train_state.json")
                _write_json(fp, train_state, fsync=False)
                mine.append(fp)
        for fp in mine:
            _fsync_path(fp)
        sums = {os.path.basename(fp): list(_crc_file(fp)) for fp in mine}
        _write_json(os.path.join(tmp, f"done.r{rank}.json"), sums)
        if rank != 0:
            _wait_for(lambda: not os.path.isdir(tmp) or
                      os.path.exists(failed),
                      f"rank 0 to commit {final}")
            if not is_committed(final):
                raise RuntimeError(f"{final}: rank 0 did not commit the "
                                   "checkpoint (see its error)")
            return final
        marks = [os.path.join(tmp, f"done.r{r}.json") for r in range(world)]
        _wait_for(lambda: all(os.path.exists(m) for m in marks) or any(
            os.path.exists(f"{failed}.r{r}") for r in range(world)),
            f"every rank's files of {final}")
        if not all(os.path.exists(m) for m in marks):
            raise RuntimeError(f"{final}: a rank failed to write its "
                               "files (see its error)")
        checksums = {}
        for m in marks:
            with open(m) as f:
                checksums.update(json.load(f))
            os.remove(m)
        shape, names, n_dev = _mesh_meta(ffmodel)
        _commit(tmp, final, directory, {
            "format_version": _FORMAT_VERSION,
            "step": int(step),
            "mesh_shape": shape,
            "axis_names": names,
            "n_devices": n_dev,
            "ranks": world,
            "checksums": dict(sorted(checksums.items())),
        })
    except BaseException:
        # the others stop waiting; the sweep removes the directory
        try:
            with open(failed if rank == 0 else f"{failed}.r{rank}",
                      "w") as f:
                f.write(f"rank {rank} failed\n")
        except OSError:
            pass
        raise
    return final


def _offsets(shape, pl, mesh) -> Tuple[int, ...]:
    from ..parallel.spmd import shard_offsets

    return shard_offsets(_global_of(shape, pl, mesh), pl, mesh)


# ----------------------------------------------------------------- inspection
def read_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def read_train_state(path: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(path, "train_state.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def restore_train_cursor(ffmodel, path: str) -> Dict[str, Any]:
    """Apply the exact-resume cursor of ``train_state.json`` to the model
    (the rng counter, so dropout seeds replay) and return it ({} when the
    checkpoint has none). Resume and rollback both go through here."""
    ts = read_train_state(path) or {}
    if "rng_counter" in ts:
        ffmodel._rng_counter = int(ts["rng_counter"])
    return ts


def is_committed(path: str) -> bool:
    """The marker exists and its crc matches the on-disk ``meta.json``.
    A checkpoint of the pre-marker format (no marker, and a meta without
    ``format_version`` but with ``step``) counts as committed; a meta that
    declares ``format_version`` requires its marker."""
    marker = os.path.join(path, COMMIT_MARKER)
    meta = os.path.join(path, "meta.json")
    if not os.path.isfile(meta):
        return False
    if not os.path.isfile(marker):
        try:
            with open(meta) as f:
                m = json.load(f)
            return "format_version" not in m and "step" in m
        except (OSError, ValueError):
            return False
    try:
        with open(marker) as f:
            want = json.load(f)["meta_crc32"]
        got, _ = _crc_file(meta)
        return int(want) == got
    except (OSError, ValueError, KeyError):
        return False


def verify_checkpoint(path: str) -> List[str]:
    """Re-checksum every payload file against ``meta.json``; returns the
    bad entries (missing, size or crc mismatch), empty when intact."""
    try:
        sums = read_meta(path).get("checksums", {})
    except (OSError, ValueError):
        return ["meta.json"]
    bad = []
    for rel, (crc, size) in sums.items():
        fp = os.path.join(path, rel)
        if not os.path.isfile(fp):
            bad.append(rel)
            continue
        got_crc, got_size = _crc_file(fp)
        if got_crc != int(crc) or got_size != int(size):
            bad.append(rel)
    return bad


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """Committed checkpoints as sorted [(step, path)]; staging, partial and
    stray directories are skipped."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if not m:
            continue
        path = os.path.join(directory, d)
        if os.path.isdir(path) and is_committed(path):
            out.append((int(m.group(1)), path))
    return sorted(out)


def latest_checkpoint(directory: str, verify: bool = False
                      ) -> Optional[str]:
    """Newest committed checkpoint, or None; with ``verify`` its checksums
    must hold too, so a corrupt newest one falls back to the one before."""
    for _step, path in reversed(list_checkpoints(directory)):
        if verify and verify_checkpoint(path):
            continue
        return path
    return None


def prune_checkpoints(directory: str, keep: int) -> List[str]:
    """Delete all but the newest ``keep`` committed checkpoints and sweep
    dead writers' staging directories; returns the removed paths."""
    from ..utils.durable_io import sweep_stale_tmp

    removed = []
    if keep <= 0 or not os.path.isdir(directory):
        return removed
    commits = list_checkpoints(directory)
    for _step, path in commits[:-keep] if len(commits) > keep else []:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    removed.extend(sweep_stale_tmp(directory))
    return removed


# ------------------------------------------------------------------ restoring
def _saved_pieces(path: str, meta) -> Dict[Tuple[str, Tuple], List[Any]]:
    """{(tree, path): [(file, index or None, offset, global shape)]} of a
    checkpoint: the sharded layout's index files, or the one-device
    layout's whole trees (index None: the file holds the tree)."""
    import torch

    out: Dict[Tuple[str, Tuple], List[Any]] = {}
    idx_files = sorted(f for f in os.listdir(path)
                       if f.startswith("index.r") and f.endswith(".json"))
    if idx_files:
        for fn in idx_files:
            with open(os.path.join(path, fn)) as f:
                for e in json.load(f):
                    out.setdefault((e["tree"], tuple(e["path"])), []).append(
                        (e["file"], e["index"], tuple(e["offset"]),
                         tuple(e["shape"])))
        return out
    for name in TREES:
        fp = os.path.join(path, f"{name}.pt")
        if not os.path.isfile(fp):
            raise CheckpointCorruptError(
                f"{path}: no {name}.pt — not a checkpoint of this package")
        tree = torch.load(fp, map_location="cpu", weights_only=True)
        for p, t in _flatten(tree):
            if not torch.is_tensor(t):
                raise CheckpointCorruptError(
                    f"{path}: {name}/{'/'.join(map(str, p))} is not a "
                    "tensor")
            out[(name, p)] = [(t, None, (0,) * t.dim(), tuple(t.shape))]
    return out


class _Reader:
    """The pieces of one checkpoint, each file loaded (memory-mapped)
    once."""

    def __init__(self, path: str):
        self.path = path
        self._files: Dict[str, Any] = {}

    def piece(self, src, index):
        import torch

        if index is None:
            return src  # a one-device checkpoint's tensor itself
        if src not in self._files:
            self._files[src] = torch.load(
                os.path.join(self.path, src), map_location="cpu",
                weights_only=True, mmap=True)
        return self._files[src][index]

    def whole(self, pieces):
        """The global tensor assembled from ``pieces`` (each written once:
        together they tile it)."""
        import torch

        shape = pieces[0][3]
        first = self.piece(pieces[0][0], pieces[0][1])
        out = torch.empty(shape, dtype=first.dtype)
        covered = 0
        for src, index, off, _shape in pieces:
            t = self.piece(src, index)
            view = out
            for d, (o, n) in enumerate(zip(off, t.shape)):
                view = view.narrow(d, o, n)
            view.copy_(t)
            covered += t.numel()
        if covered != out.numel():
            raise CheckpointCorruptError(
                f"{self.path}: the pieces cover {covered} of "
                f"{out.numel()} elements of a {tuple(shape)} tensor")
        return out


def _live_layout(ffmodel, name, p, t):
    """(offset, global shape, placements or None) of a live leaf."""
    if not _on_mesh(ffmodel):
        return (0,) * t.dim(), tuple(t.shape), None
    mesh = ffmodel.executor.mesh
    pl = _leaf_layout(ffmodel, name, p, t)
    return _offsets(t.shape, pl, mesh), _global_of(t.shape, pl, mesh), pl


def _topology(ffmodel) -> Tuple[int, Any]:
    if not _on_mesh(ffmodel):
        return 1, MESH_SHAPE
    shape, _names, n = _mesh_meta(ffmodel)
    return n, shape


def restore_checkpoint(ffmodel, path: str, verify: bool = True) -> int:
    """Restore a checkpoint into a compiled model, in place (module doc);
    returns its step. The commit marker and (with ``verify``) every
    checksum are checked, and every value is read and checked against the
    model's keys, shapes and dtypes, before any model state is touched.
    On a mesh every rank calls it; a checkpoint written on another
    topology is restored host-staged, and one that still does not fit
    raises, naming both topologies."""
    import torch

    path = os.path.abspath(path)
    if not is_committed(path):
        raise CheckpointCorruptError(
            f"{path}: no valid commit marker (partial write or not a "
            "checkpoint) — refusing to restore")
    if verify:
        bad = verify_checkpoint(path)
        if bad:
            raise CheckpointCorruptError(
                f"{path}: checksum mismatch in {bad} — checkpoint is "
                "corrupt; restore from an earlier committed step")
    meta = read_meta(path)
    saved = _saved_pieces(path, meta)
    reader = _Reader(path)
    staged = []
    try:
        for name in TREES:
            live = _flatten(getattr(ffmodel, name))
            want = {p for p, _t in live}
            got = {p for (tr, p) in saved if tr == name}
            if want != got:
                raise CheckpointCorruptError(
                    f"{name}: saved keys {sorted(map(list, got))[:4]} do "
                    f"not match the model's {sorted(map(list, want))[:4]}")
            for p, t in live:
                where = f"{name}/{'/'.join(map(str, p))}"
                pieces = saved[(name, p)]
                off, shape, pl = _live_layout(ffmodel, name, p, t)
                if pieces[0][3] != shape:
                    raise CheckpointCorruptError(
                        f"{where}: saved shape {pieces[0][3]} does not "
                        f"match the model's {shape}")
                own = [q for q in pieces if q[2] == off and tuple(
                    reader.piece(q[0], q[1]).shape) == tuple(t.shape)]
                if own:
                    val = reader.piece(own[0][0], own[0][1])
                else:  # another topology: host-staged
                    from ..parallel.spmd import local_slice

                    val = reader.whole(pieces)
                    if pl is not None:
                        val = local_slice(val, pl, ffmodel.executor.mesh)
                if val.dtype != t.dtype or \
                        tuple(val.shape) != tuple(t.shape):
                    raise CheckpointCorruptError(
                        f"{where}: saved {(tuple(val.shape), val.dtype)} "
                        "does not match the model's "
                        f"{(tuple(t.shape), t.dtype)}")
                staged.append((t, val))
    except (CheckpointCorruptError, OSError, RuntimeError, KeyError,
            IndexError, ValueError) as e:
        n_live, live_mesh = _topology(ffmodel)
        saved_n = int(meta.get("n_devices") or 1)
        if saved_n == n_live and list(meta.get("mesh_shape", MESH_SHAPE)) \
                == list(live_mesh):
            raise
        raise RuntimeError(
            f"{path}: restore failed while resharding a checkpoint saved "
            f"on {saved_n} device(s) (mesh {meta.get('mesh_shape', '?')}) "
            f"onto the live {n_live}-device topology (mesh {live_mesh}): "
            f"{type(e).__name__}: {e}") from e
    with torch.no_grad():
        for t, val in staged:
            t.copy_(val)
    return int(meta["step"])


# ------------------------------------------------------------- async manager
class _Snapshot:
    """One checkpoint's state on its way to the host: device clones taken
    on the current stream, copied into pinned host buffers on ``stream``
    after an event (on the CPU the clones are the host copy)."""

    def __init__(self, trees: Dict[str, Any], stream):
        import torch

        clones = {n: _tree_map(lambda t: t.detach().clone(), tr)
                  for n, tr in trees.items()}
        self.done = None
        self._clones = clones
        if stream is None:
            self.host = clones
            return
        taken = torch.cuda.Event()
        taken.record()
        stream.wait_event(taken)

        def to_host(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t.record_stream(stream)
            return h

        with torch.cuda.stream(stream):
            self.host = {n: _tree_map(to_host, tr)
                         for n, tr in clones.items()}
        self.done = torch.cuda.Event()
        self.done.record(stream)

    def wait(self) -> Dict[str, Any]:
        """The host trees, once their copies have landed (the device clones
        are dropped then)."""
        if self.done is not None:
            self.done.synchronize()
        self._clones = None
        return self.host


class CheckpointManager:
    """Background checkpoint writer with bounded-queue backpressure.

    ``save_async`` snapshots the live trees (:class:`_Snapshot`) and
    enqueues them for the worker thread, which serializes, commits and
    prunes. At most ``queue_depth`` snapshots wait; past that,
    ``save_async`` blocks until the writer frees a slot, bounding snapshot
    memory at ``queue_depth + 1`` copies of the state. A worker failure
    does not stop training: it lands in ``errors`` and a warning, and the
    previous committed checkpoint stays the restore target.

    ``saves`` records (step, bytes, seconds) per commit of the worker;
    ``blocked_s`` the seconds each ``save_async`` waited for a slot."""

    def __init__(self, ffmodel, directory: str, keep: int = 3,
                 queue_depth: int = 2):
        self.ffmodel = ffmodel
        # this rank, read on the main thread (the writer's may not see the
        # process group); only rank 0 prunes and sweeps
        self._rank = _ranks()[0]
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(int(keep), 1)
        self.saved = 0
        self.errors: List[str] = []
        self.saves: List[Tuple[int, int, float]] = []
        self.blocked_s: List[float] = []
        # on a mesh rank 0's view of the directory, agreed by every rank
        self.last_committed_path: Optional[str] = _agreed(
            ffmodel, latest_checkpoint(self.directory))
        self.last_committed_step: Optional[int] = None
        if self.last_committed_path is not None:
            try:
                self.last_committed_step = int(
                    read_meta(self.last_committed_path)["step"])
            except (OSError, ValueError, KeyError):
                self.last_committed_path = None
        self._stream = None
        if ffmodel.device.type == "cuda":
            import torch

            self._stream = torch.cuda.Stream(ffmodel.device)
        self._q: Queue = Queue(maxsize=max(int(queue_depth), 1))
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-writer")
        self._worker.start()

    # -- producer side -----------------------------------------------------
    def save_async(self, step: int,
                   train_state: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot and enqueue; blocks only when the writer is
        ``queue_depth`` checkpoints behind (backpressure)."""
        snap = _Snapshot({n: getattr(self.ffmodel, n) for n in TREES},
                         self._stream)
        staging = staging_name(self.ffmodel) if _on_mesh(self.ffmodel) \
            else None
        t0 = time.perf_counter()
        self._q.put((int(step), snap, train_state, staging))
        self.blocked_s.append(time.perf_counter() - t0)

    def save_sync(self, step: int,
                  train_state: Optional[Dict[str, Any]] = None
                  ) -> Optional[str]:
        """Drain pending async saves, then write ``step`` in the calling
        thread (the preemption flush); skipped when ``step`` is already the
        last committed one."""
        self.flush()
        if self.last_committed_step == int(step):
            return self.last_committed_path
        t0 = time.perf_counter()
        try:
            path = save_checkpoint(self.ffmodel, self.directory, step=step,
                                   train_state=train_state)
        except OSError as e:  # disk full and the like
            self._note_error(step, e)
            return None
        self._committed(step, path, written_bytes(
            self.ffmodel, {n: getattr(self.ffmodel, n) for n in TREES}),
            time.perf_counter() - t0)
        return path

    def flush(self) -> None:
        """Block until every enqueued snapshot is committed (or failed)."""
        self._q.join()

    def close(self) -> None:
        self.flush()
        self._q.put(None)
        self._worker.join(timeout=60.0)

    # -- worker side -------------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, snap, train_state, staging = item
            try:
                t0 = time.perf_counter()
                host = snap.wait()
                path = save_checkpoint(self.ffmodel, self.directory,
                                       step=step, train_state=train_state,
                                       staging=staging, **host)
                self._committed(step, path,
                                written_bytes(self.ffmodel, host),
                                time.perf_counter() - t0)
            except Exception as e:  # the writer outlives a failed save
                self._note_error(step, e)
            finally:
                self._q.task_done()

    def _committed(self, step: int, path: str, nbytes: int,
                   secs: float) -> None:
        """``nbytes`` is what this rank wrote (its pieces, on a mesh)."""
        self.saved += 1
        self.saves.append((int(step), int(nbytes), float(secs)))
        self.last_committed_step = int(step)
        self.last_committed_path = path
        if self._rank == 0:  # one rank prunes and sweeps
            prune_checkpoints(self.directory, self.keep)

    def _note_error(self, step: int, e: Exception) -> None:
        import warnings

        msg = f"checkpoint step {step} failed: {type(e).__name__}: {e}"
        self.errors.append(msg)
        warnings.warn(msg)
