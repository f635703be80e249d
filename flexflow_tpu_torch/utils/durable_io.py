"""Atomic-write / checksum / stale-staging idioms (a copy of
``flexflow_tpu.utils.durable_io``; the port keeps its own).

The durable-commit recipe of the training checkpoints
(``execution/checkpoint.py``): stage, fsync the payloads AND the parent
directory, checksum with crc32, and sweep dead writers' ``.tmp``
leftovers only after a grace window. Plain-POSIX host code usable from
any layer.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import List, Tuple

#: a foreign .tmp staging path is only swept once it has sat untouched
#: this long — a replacement process resuming during its predecessor's
#: SIGTERM grace window must not race a LIVE writer's staging out from
#: under it
STALE_TMP_AGE_S = 15 * 60


def fsync_path(path: str) -> None:
    """fsync a file or directory; directory fsync persists the entry names
    (the rename-based commit is only durable once the parent dir is)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse dir fsync; commit still atomic
    finally:
        os.close(fd)


def write_json(path: str, obj, fsync: bool = True) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
        if fsync:
            f.flush()
            os.fsync(f.fileno())


def crc_file(path: str, chunk: int = 1 << 20) -> Tuple[int, int]:
    """(crc32, size) of a file, streamed in ``chunk``-byte reads."""
    crc, size = 0, 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
            size += len(buf)
    return crc & 0xFFFFFFFF, size


def crc_bytes(data: bytes) -> int:
    """crc32 of an in-memory record (the sibling of :func:`crc_file`)."""
    return zlib.crc32(data) & 0xFFFFFFFF


def sweep_stale_tmp(directory: str, age_s: float = STALE_TMP_AGE_S
                    ) -> List[str]:
    """Sweep ``.tmp.<pid>`` staging entries from DEAD writers: other
    pids only, untouched for ``age_s``. A vanished entry mid-sweep means
    its writer is live — leave it alone. Returns removed paths."""
    import time

    removed: List[str] = []
    if not os.path.isdir(directory):
        return removed
    now = time.time()
    for d in os.listdir(directory):
        if ".tmp." in d and not d.endswith(f".tmp.{os.getpid()}"):
            p = os.path.join(directory, d)
            try:
                stale = now - os.path.getmtime(p) > age_s
            except OSError:
                continue  # vanished: its writer is live, leave it alone
            if not stale:
                continue
            if os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)
                removed.append(p)
            else:
                try:
                    os.remove(p)
                    removed.append(p)
                except OSError:
                    pass
    return removed
