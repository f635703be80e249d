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

The payload is not orbax's: each tree (``params``, ``opt_state``) is one
``torch.save`` file of CPU tensors (``params.pt``, ``opt_state.pt``), read
back with ``torch.load(weights_only=True)``. The port runs on one device,
so ``strategy.json`` and ``meta.json`` record that layout (``mesh_shape
[1]``).

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
from typing import Any, Dict, List, Optional, Tuple

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


# -------------------------------------------------------------------- saving
def save_checkpoint(ffmodel, directory: str, step: int = 0,
                    train_state: Optional[Dict[str, Any]] = None,
                    params=None, opt_state=None) -> str:
    """Atomically save params + optimizer state + layout + metadata (the
    protocol of the module doc). ``params`` / ``opt_state`` default to the
    model's live trees (copied to the host here); the async manager passes
    its host snapshots. ``train_state`` is the exact-resume cursor."""
    import torch

    trees = {"params": ffmodel.params if params is None else params,
             "opt_state": ffmodel.opt_state if opt_state is None
             else opt_state}
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{int(step)}")
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
        meta = {
            "format_version": _FORMAT_VERSION,
            "step": int(step),
            "mesh_shape": MESH_SHAPE,
            "axis_names": AXIS_NAMES,
            "n_devices": 1,
            "checksums": _dir_checksums(tmp),
        }
        _write_json(os.path.join(tmp, "meta.json"), meta)
        meta_crc, _ = _crc_file(os.path.join(tmp, "meta.json"))
        _write_json(os.path.join(tmp, COMMIT_MARKER),
                    {"meta_crc32": meta_crc})
        _fsync_path(tmp)
        if os.path.isdir(final):  # overwrite semantics (re-save of a step)
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_path(directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


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
def _copy_into(live, saved, where: str) -> None:
    """Copy the saved tree into the live one in place, after checking that
    both have the same keys, shapes and dtypes."""
    import torch

    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            got = sorted(saved) if isinstance(saved, dict) \
                else type(saved).__name__
            raise CheckpointCorruptError(
                f"{where}: saved keys {got} do not match the model's "
                f"{sorted(live)}")
        for k in live:
            _copy_into(live[k], saved[k], f"{where}/{k}")
        return
    if not torch.is_tensor(saved) or tuple(saved.shape) != \
            tuple(live.shape) or saved.dtype != live.dtype:
        got = (tuple(saved.shape), saved.dtype) if torch.is_tensor(saved) \
            else type(saved).__name__
        raise CheckpointCorruptError(
            f"{where}: saved {got} does not match the model's "
            f"{(tuple(live.shape), live.dtype)}")
    with torch.no_grad():
        live.copy_(saved)


def restore_checkpoint(ffmodel, path: str, verify: bool = True) -> int:
    """Restore a checkpoint into a compiled model, in place (module doc);
    returns its step. The commit marker and (with ``verify``) every
    checksum are checked before any model state is touched; a checkpoint
    saved on another layout than one device raises."""
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
    if list(meta.get("mesh_shape", MESH_SHAPE)) != MESH_SHAPE:
        raise RuntimeError(
            f"{path}: saved on mesh {meta.get('mesh_shape')}; restoring "
            "onto another topology than one device is ported in a later "
            "slice")
    trees = {}
    for name in TREES:
        fp = os.path.join(path, f"{name}.pt")
        if not os.path.isfile(fp):
            raise CheckpointCorruptError(
                f"{path}: no {name}.pt — not a checkpoint of this package")
        trees[name] = torch.load(fp, map_location="cpu", weights_only=True)
    for name in TREES:
        _copy_into(getattr(ffmodel, name), trees[name], name)
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
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(int(keep), 1)
        self.saved = 0
        self.errors: List[str] = []
        self.saves: List[Tuple[int, int, float]] = []
        self.blocked_s: List[float] = []
        self.last_committed_path: Optional[str] = latest_checkpoint(
            self.directory)
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
        t0 = time.perf_counter()
        self._q.put((int(step), snap, train_state))
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
        self._committed(step, path, tree_bytes(
            [getattr(self.ffmodel, n) for n in TREES]),
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
            step, snap, train_state = item
            try:
                t0 = time.perf_counter()
                host = snap.wait()
                path = save_checkpoint(self.ffmodel, self.directory,
                                       step=step, train_state=train_state,
                                       **host)
                self._committed(step, path, tree_bytes(list(host.values())),
                                time.perf_counter() - t0)
            except Exception as e:  # the writer outlives a failed save
                self._note_error(step, e)
            finally:
                self._q.task_done()

    def _committed(self, step: int, path: str, nbytes: int,
                   secs: float) -> None:
        self.saved += 1
        self.saves.append((int(step), int(nbytes), float(secs)))
        self.last_committed_step = int(step)
        self.last_committed_path = path
        prune_checkpoints(self.directory, self.keep)

    def _note_error(self, step: int, e: Exception) -> None:
        import warnings

        msg = f"checkpoint step {step} failed: {type(e).__name__}: {e}"
        self.errors.append(msg)
        warnings.warn(msg)
