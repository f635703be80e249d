"""Persistent, shareable simulator calibration (a copy of
``flexflow_tpu.search.calibration``; the tables key on the machine's
generation, so an H100 table never mixes with another card's).

The Simulator's per-key measured/analytical ratios (``_key_calibration``,
``_key_bwd_ratio``) are process-local; this module gives them a durable
home so a fleet of heterogeneous pods shares measurements instead of each
re-deriving them: one JSON table per **(chip generation, compute dtype)**
under ``--calibration-dir``, entries keyed by the op signature
(``repr(Simulator._op_key(node, in_shapes))`` — the same join key the
op-cost cache and ``--profile-ops`` records use, docs/calibration.md).

Design constraints the tests pin down (test_housekeeping_r10):

* **round-trip fidelity** — a table written by one Simulator loads
  bit-identically on a fresh one (sorted-key JSON, atomic writes);
* **forward compatibility** — unknown top-level fields AND unknown
  per-entry fields written by a future version survive a load+merge+save
  cycle untouched, so the schema can grow without breaking old readers;
* **merge, don't clobber** — ``store_persistent_calibration`` merges into
  the existing table (sample counts accumulate), so concurrent runs on
  different models extend one shared store.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Optional

FORMAT_VERSION = 1


@contextlib.contextmanager
def _table_lock(path: str):
    """Serialize load-merge-save cycles on one table: without it, two
    runs sharing a --calibration-dir both read the same base, each add
    their keys, and the second ``os.replace`` silently drops the first
    run's entries (last-writer-wins over the whole table). Advisory
    ``fcntl`` lock on a sidecar file; on platforms without fcntl the
    atomic replace still guarantees an uncorrupted (if last-writer-wins)
    table."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(f"{path}.lock", "w") as lf:
        try:
            import fcntl

            fcntl.flock(lf, fcntl.LOCK_EX)
        except ImportError:  # pragma: no cover — non-POSIX best effort
            pass
        yield


def dtype_label(config) -> str:
    """Short compute-dtype tag for the table filename ("bf16", "f32",
    ...): calibration measured under bf16 matmuls must never price an f32
    run (different tensor-core paths, different ratios)."""
    from ..ffconst import DataType

    cd = getattr(config, "compute_dtype", None)
    if cd is None or cd == DataType.DT_NONE:
        return "f32"
    name = getattr(cd, "name", str(cd)).lower()
    return name.replace("dt_", "").replace("float", "f").replace(
        "bfloat", "bf").replace("half", "f16")


def table_path(calibration_dir: str, generation: str, dtype: str) -> str:
    return os.path.join(calibration_dir,
                        f"calibration_{generation or 'unknown'}_"
                        f"{dtype or 'f32'}.json")


def load_table(path: str) -> Dict[str, Any]:
    """Read a calibration table, tolerating unknown future fields (they
    are preserved verbatim for the next save). Returns an empty skeleton
    when the file is missing or unreadable — a corrupt table must never
    take calibration down with it."""
    try:
        with open(path) as f:
            d = json.load(f)
        if not isinstance(d, dict):
            return {"format_version": FORMAT_VERSION, "entries": {}}
        d.setdefault("format_version", FORMAT_VERSION)
        if not isinstance(d.get("entries"), dict):
            d["entries"] = {}
        return d
    except (OSError, ValueError):
        return {"format_version": FORMAT_VERSION, "entries": {}}


def save_table(path: str, table: Dict[str, Any]) -> str:
    """Atomic, deterministic (sorted keys) write — byte-identical for
    identical content, so round-trip tests and dedup tooling can diff
    tables textually."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, sort_keys=True, indent=1, default=str)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_persistent_calibration(sim) -> int:
    """Fill ``sim._persisted_calibration`` from the (generation, dtype)
    table under ``sim.calibration_dir``; entries are adopted lazily per
    key on the uncached op-cost path. Returns the entry count."""
    if not sim.calibration_dir:
        return 0
    path = table_path(sim.calibration_dir,
                      getattr(sim.machine, "generation", "") or "unknown",
                      sim.dtype_label)
    table = load_table(path)
    entries = {k: v for k, v in table.get("entries", {}).items()
               if isinstance(v, dict)}
    sim._persisted_calibration = entries
    sim._persist_checked = set()
    return len(entries)


def store_persistent_calibration(sim) -> Optional[str]:
    """Merge the simulator's in-memory per-key calibration into the
    persistent table and write it back. Existing entries for the same key
    are updated (the newest measurement wins; ``samples`` accumulates);
    entries for OTHER keys — other models measured by other runs — and
    any unknown fields are preserved."""
    if not sim.calibration_dir:
        return None
    gen = getattr(sim.machine, "generation", "") or "unknown"
    path = table_path(sim.calibration_dir, gen, sim.dtype_label)
    with _table_lock(path):
        table = load_table(path)
        table["generation"] = gen
        table["dtype"] = sim.dtype_label
        entries = table["entries"]
        for key, cal in sim._key_calibration.items():
            krepr = repr(key)
            ent = entries.get(krepr)
            if not isinstance(ent, dict):
                ent = entries[krepr] = {}
            ent["calibration"] = float(cal)
            b = sim._key_bwd_ratio.get(key)
            if b is not None:
                ent["bwd_ratio"] = float(b)
            ent["samples"] = int(ent.get("samples", 0)) + 1
        save_table(path, table)
    # the just-written state IS the persisted state: refresh the lazy-
    # adoption view so a later invalidation re-adopts current values
    sim._persisted_calibration = {k: dict(v) for k, v in entries.items()
                                  if isinstance(v, dict)}
    return path


def calibrate_sim_from_trace(sim, pcg, path: str,
                             min_rel_change: float = 0.05
                             ) -> Dict[str, Any]:
    """``--calibrate-from-trace`` entry point: replay a ``--profile-ops``
    JSONL into ``Simulator.calibrate_from_profile`` against ``pcg``. The
    file must exist (parse-time validation enforces it for the flag; a
    programmatic call gets the same error)."""
    from ..obs.profile import OpProfile

    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"--calibrate-from-trace {path!r}: no such profile file "
            "(produce one with --profile-ops)")
    profile = OpProfile.read_jsonl(path)
    return sim.calibrate_from_profile(profile, pcg,
                                      min_rel_change=min_rel_change)
