"""Crash-durable serving: the fleet-door write-ahead request journal
(port of ``flexflow_tpu.serving.journal``; the on-disk format is the JAX
package's byte for byte, so each package scans a journal the other
wrote).

Every resilience layer below it protects requests only while the host
process lives; a hard crash (OOM kill, SIGKILL, a host reboot) would lose
the door queue, every in-flight stream and every ledger.
:class:`RequestJournal` is the durability layer under the
:class:`~.fleet.ServingFleet` door, built on the atomic-commit idioms of
the training checkpoints (``utils/durable_io.py``):

* **Write-ahead**: a ``submit`` record (rid, tenant, prompt ids, sampling
  params, deadline) is journaled before the request is admitted; an
  ``outcome`` record lands at the exactly-one-outcome terminal; an
  optional ``progress`` record persists each request's committed-token
  deltas every ``--journal-commit-every`` tokens.
* **Segmented, append-only, checksummed**: records are framed as
  ``crc32 <space> json\\n`` lines in ``journal_<seq>.log`` segments. On
  open, the live segment's torn tail — a crash mid-append — is truncated
  back to the longest valid record prefix; corruption in a sealed segment
  raises :class:`JournalCorruptError` (history that later records depend
  on cannot be dropped silently).
* **Group commit**: appends buffer in-process and are flushed and fsynced
  at most once per ``--journal-sync-ms`` window (0 = every record). The
  unsynced window is the durability gap: a crash loses at most that
  window, and a request lost from it was never durably accepted.
* **Compaction**: a sealed segment whose every referenced rid has an
  outcome record is dropped, oldest first (prefix order keeps a pending
  rid's submit and progress chain intact).
* **Exactly-once replay**: ``ServingFleet.recover()`` replays every rid
  with a submit but no outcome through the real door — WFQ, tenancy,
  quota and shed policies intact — with rid-keyed dedupe against client
  retries, and journaled progress resuming through the re-prefill path.

Journal off (the default) is :data:`NOOP_JOURNAL`: one shared, slotted,
allocation-free no-op that the fleet's hot path guards with ``if
journal.enabled:``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Set

import numpy as np

from ..utils.durable_io import crc_bytes, fsync_path
from .resilience import OUTCOMES
from .scheduler import Request, now_ms

#: record kinds a journal segment may carry
RECORD_KINDS = ("run", "submit", "progress", "outcome")

#: segment file name format: journal_<8-digit seq>.log
SEGMENT_PREFIX = "journal_"
SEGMENT_SUFFIX = ".log"


class JournalCorruptError(RuntimeError):
    """A sealed journal segment failed record-frame validation.

    Only SEALED segments raise: the live segment's torn tail is the
    expected signature of a crash mid-append and is truncated back to
    the longest valid record prefix instead."""


class NoopJournal:
    """The journal-off singleton: one shared,
    slotted instance; every method a no-op; ``enabled`` is a class
    attribute so the fleet hot path's ``if journal.enabled:`` guard
    costs one attribute read and allocates nothing."""

    __slots__ = ()
    enabled = False
    commit_every = 0

    def log_run(self, **kw) -> None:
        return None

    def log_submit(self, req) -> bool:
        return True

    def log_progress(self, req) -> None:
        return None

    def log_outcome(self, req, outcome=None) -> bool:
        return False

    def maybe_sync(self) -> None:
        return None

    def sync(self) -> None:
        return None

    def compact(self) -> None:
        return None

    def close(self) -> None:
        return None


#: the shared journal-off instance — ``ServingFleet`` without
#: ``--request-journal`` holds exactly this object
NOOP_JOURNAL = NoopJournal()


def _encode(payload: Dict[str, Any]) -> bytes:
    data = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    return b"%08x " % crc_bytes(data) + data + b"\n"


class RequestJournal:
    """Segmented append-only write-ahead journal at the fleet door
    (module docstring)."""

    enabled = True

    def __init__(self, root: str, sync_ms: float = 0.0,
                 commit_every: int = 0, segment_bytes: int = 1 << 18,
                 clock=None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.sync_ms = float(sync_ms)
        self.commit_every = int(commit_every)
        self.segment_bytes = max(int(segment_bytes), 1 << 10)
        self.clock = clock if clock is not None else now_ms
        # telemetry counters (the StepTelemetry ``serving_journal`` block)
        self.appended = 0
        self.syncs = 0
        self.replayed = 0
        self.dedupe_hits = 0
        self.compacted_segments = 0
        self.truncated_records = 0
        self.recovery_wall_s = 0.0
        # replay state rebuilt by the open scan
        self._pending: Dict[int, Dict[str, Any]] = {}
        self._outcomes: Set[int] = set()
        self._progress_mark: Dict[int, int] = {}
        self._seg_rids: Dict[str, Set[int]] = {}
        self.run_args: Optional[Dict[str, Any]] = None
        # live segment + group-commit buffer: records wait here until
        # the sync window closes — an in-process hard crash drops the
        # buffer, exactly like SIGKILL drops a real process's un-fsynced
        # tail
        self._buf: List[bytes] = []
        self._buf_rids: List[Optional[int]] = []
        self._f = None
        self._seg_path: Optional[str] = None
        self._seg_seq = 0
        self._seg_size = 0
        self._last_sync_ms: Optional[float] = None
        self._crashed = False
        self._closed = False
        self._scan()

    # ----------------------------------------------------------------- scan
    def _segments(self) -> List[str]:
        out = []
        for fn in os.listdir(self.root):
            if fn.startswith(SEGMENT_PREFIX) and \
                    fn.endswith(SEGMENT_SUFFIX):
                out.append(os.path.join(self.root, fn))
        return sorted(out)

    def _scan(self) -> None:
        """Rebuild (pending, outcomes, progress) from every segment on
        disk, truncating the live segment's torn tail; appends then go
        to a FRESH segment (never into a file a dead writer tore)."""
        segs = self._segments()
        for i, seg in enumerate(segs):
            self._scan_segment(seg, last=(i == len(segs) - 1))
        if segs:
            base = os.path.basename(segs[-1])
            self._seg_seq = int(
                base[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]) + 1

    def _scan_segment(self, seg: str, last: bool) -> None:
        name = os.path.basename(seg)
        try:
            with open(seg, "rb") as f:
                data = f.read()
        except OSError as e:
            raise JournalCorruptError(
                f"journal segment {name}: unreadable ({e})")
        rids = self._seg_rids.setdefault(seg, set())
        off = good = 0
        while off < len(data):
            nl = data.find(b"\n", off)
            payload = None
            if nl >= 0:
                line = data[off:nl]
                try:
                    crc_hex, body = line.split(b" ", 1)
                    if int(crc_hex, 16) == crc_bytes(body):
                        payload = json.loads(body.decode("utf-8"))
                        if not isinstance(payload, dict) or \
                                payload.get("k") not in RECORD_KINDS:
                            payload = None
                except (ValueError, UnicodeDecodeError):
                    payload = None
            if payload is None:
                # torn/corrupt record: everything from here on is
                # untrusted — the longest VALID RECORD PREFIX survives
                lost = max(data.count(b"\n", off), 1)
                if not last:
                    raise JournalCorruptError(
                        f"journal segment {name}: corrupt record at "
                        f"byte {off} in a sealed segment ({lost} "
                        "record(s) unrecoverable)")
                self.truncated_records += lost
                break
            self._apply(payload, rids)
            good = off = nl + 1
        if good < len(data):
            with open(seg, "r+b") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())
            fsync_path(self.root)

    def _apply(self, p: Dict[str, Any], rids: Set[int]) -> None:
        kind = p["k"]
        if kind == "run":
            self.run_args = {k: v for k, v in p.items() if k != "k"}
            return
        rid = int(p.get("rid", -1))
        rids.add(rid)
        if kind == "submit":
            if rid in self._outcomes or rid in self._pending:
                return  # duplicate submit record: first one wins
            p = dict(p)
            p["gen"] = []
            self._pending[rid] = p
            self._progress_mark[rid] = 0
        elif kind == "progress":
            ent = self._pending.get(rid)
            if ent is not None:
                ent["gen"].extend(int(t) for t in p.get("toks", ()))
                self._progress_mark[rid] = len(ent["gen"])
        elif kind == "outcome":
            self._outcomes.add(rid)
            self._pending.pop(rid, None)
            self._progress_mark.pop(rid, None)

    # --------------------------------------------------------------- append
    def _record(self, payload: Dict[str, Any],
                rid: Optional[int]) -> None:
        if self._crashed or self._closed:
            return
        self._buf.append(_encode(payload))
        self._buf_rids.append(rid)
        self.appended += 1
        self.maybe_sync()

    def _rotate(self) -> None:
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
        self._seg_path = os.path.join(
            self.root,
            f"{SEGMENT_PREFIX}{self._seg_seq:08d}{SEGMENT_SUFFIX}")
        self._seg_rids.setdefault(self._seg_path, set())
        self._seg_seq += 1
        self._seg_size = 0
        self._f = open(self._seg_path, "ab")
        fsync_path(self.root)

    def maybe_sync(self) -> None:
        """Group commit: flush+fsync when the ``--journal-sync-ms``
        window has closed (0 = every record is its own commit)."""
        if not self._buf:
            return
        now = float(self.clock())
        if self._last_sync_ms is None:
            self._last_sync_ms = now
        if self.sync_ms <= 0 or \
                (now - self._last_sync_ms) >= self.sync_ms:
            self.sync()

    def sync(self) -> None:
        """Make every buffered record durable: one write + one fsync
        for the whole group (the group-commit payoff)."""
        if self._crashed or self._closed or not self._buf:
            return
        if self._f is None or self._seg_size >= self.segment_bytes:
            self._rotate()
        assert self._f is not None and self._seg_path is not None
        blob = b"".join(self._buf)
        self._f.write(blob)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._seg_size += len(blob)
        seg_rids = self._seg_rids.setdefault(self._seg_path, set())
        seg_rids.update(r for r in self._buf_rids if r is not None)
        self._buf.clear()
        self._buf_rids.clear()
        self.syncs += 1
        self._last_sync_ms = float(self.clock())

    # ------------------------------------------------------------ WAL hooks
    def log_run(self, **serve_args) -> None:
        """Journal the serve-loop arguments (temperature, top_k, seed)
        so a recovery can rerun the exact sampling configuration."""
        payload = {"k": "run"}
        payload.update(serve_args)
        if self.run_args != serve_args:
            self.run_args = dict(serve_args)
            self._record(payload, None)

    def log_submit(self, req: Request) -> bool:
        """Write-ahead the door admission. Returns False — and counts a
        dedupe hit — when the rid is already journaled (a client retry
        of a submitted-or-finished request must not double-admit)."""
        rid = int(req.rid)
        if rid in self._outcomes or rid in self._pending:
            self.dedupe_hits += 1
            return False
        payload: Dict[str, Any] = {
            "k": "submit", "rid": rid,
            "p": [int(t) for t in req.prompt],
            "m": int(req.max_new_tokens)}
        if req.tenant:
            payload["t"] = req.tenant
        if req.deadline_ms is not None:
            payload["d"] = float(req.deadline_ms)
        if req.rng_tag is not None:
            payload["g"] = int(req.rng_tag)
        if req.eos_id is not None:
            payload["e"] = int(req.eos_id)
        ent = dict(payload)
        ent["gen"] = []
        self._pending[rid] = ent
        self._progress_mark[rid] = len(req.generated)
        self._record(payload, rid)
        return True

    def log_progress(self, req: Request) -> None:
        """Persist the committed-token delta once it reaches
        ``--journal-commit-every`` tokens: the scheduler's
        ``on_commit`` hook calls this at THE commit point, so a
        journaled prefix is always a prefix of the real stream."""
        if self.commit_every <= 0:
            return
        rid = int(req.rid)
        mark = self._progress_mark.get(rid)
        if mark is None:  # unknown rid (hedge twin) or already terminal
            return
        n = len(req.generated)
        if n - mark < self.commit_every:
            return
        toks = [int(t) for t in req.generated[mark:n]]
        self._progress_mark[rid] = n
        ent = self._pending.get(rid)
        if ent is not None:
            ent["gen"].extend(toks)
        self._record({"k": "progress", "rid": rid, "toks": toks,
                      "n": n}, rid)

    def log_outcome(self, req: Request,
                    outcome: Optional[str] = None) -> bool:
        """The exactly-one-outcome terminal: first call per rid wins,
        repeats and unknown rids (hedge twins) are dropped."""
        rid = int(req.rid)
        if rid in self._outcomes or rid not in self._pending:
            return False
        out = outcome or req.outcome or ("ok" if req.done else
                                         "preempted")
        if out not in OUTCOMES:   # the ledger vocabulary is closed
            raise ValueError(f"unknown outcome {out!r} for rid {rid} "
                             f"(expected one of {OUTCOMES})")
        self._outcomes.add(rid)
        self._pending.pop(rid, None)
        self._progress_mark.pop(rid, None)
        self._record({"k": "outcome", "rid": rid, "o": out,
                      "n": len(req.generated)}, rid)
        return True

    # --------------------------------------------------------------- replay
    def pending_rids(self) -> List[int]:
        return sorted(self._pending)

    def max_rid(self) -> int:
        return max(list(self._pending) + list(self._outcomes),
                   default=0)

    def pending_requests(self) -> List[Request]:
        """Reconstruct every journaled-but-unfinished request, in rid
        order: prompt + sampling params from the submit record, the
        committed-token prefix from its progress records (the re-prefill
        path resumes it where it stopped). The
        deadline budget restarts at re-submission — monotonic clocks do
        not survive a process, so the pre-crash wait cannot be
        charged."""
        out = []
        for rid in self.pending_rids():
            p = self._pending[rid]
            out.append(Request(
                prompt=np.asarray(p["p"], dtype=np.int32),
                max_new_tokens=int(p["m"]),
                rid=rid,
                eos_id=p.get("e"),
                generated=list(p.get("gen", [])),
                rng_tag=p.get("g"),
                deadline_ms=p.get("d"),
                tenant=p.get("t")))
        return out

    # ----------------------------------------------------------- compaction
    def compact(self) -> int:
        """Drop sealed segments whose every referenced rid has an
        outcome — oldest first, stopping at the first segment still
        holding a pending rid's history (prefix order keeps every
        pending submit/progress chain intact). Returns segments
        dropped."""
        dropped = 0
        for seg in self._segments():
            if seg == self._seg_path:
                break  # never the live segment
            rids = self._seg_rids.get(seg)
            if rids is None or not rids <= self._outcomes:
                break
            try:
                os.remove(seg)
            except OSError:
                break
            self._seg_rids.pop(seg, None)
            dropped += 1
        if dropped:
            fsync_path(self.root)
            self.compacted_segments += dropped
        return dropped

    # -------------------------------------------------------------- lifecycle
    def crash(self) -> None:
        """In-process hard stop (``FleetChaosPlan.crash_at`` ``"hard"``
        mode): drop the un-group-committed buffer and abandon the file
        — exactly what SIGKILL does to a real process's un-fsynced
        tail. The journal object is dead afterwards; recovery goes
        through a fresh ``RequestJournal`` on the same directory."""
        self._buf.clear()
        self._buf_rids.clear()
        self._crashed = True
        if self._f is not None:
            try:
                os.close(self._f.fileno())  # bypass buffered flush
            except OSError:
                pass
            self._f = None

    def close(self) -> None:
        """Graceful close: group-commit the tail, compact, release the
        segment handle. Idempotent."""
        if self._crashed or self._closed:
            return
        self.sync()
        self.compact()
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None
        self._closed = True


def journal_from_config(config, clock=None):
    """The one construction point the fleet and ``recover()`` share:
    ``--request-journal DIR`` (+ ``--journal-sync-ms`` /
    ``--journal-commit-every``) -> a live :class:`RequestJournal`;
    unset -> the shared :data:`NOOP_JOURNAL` singleton (allocation-free
    serve hot path)."""
    root = getattr(config, "request_journal", "") or ""
    if not root:
        return NOOP_JOURNAL
    return RequestJournal(
        root,
        sync_ms=float(getattr(config, "journal_sync_ms", 0.0) or 0.0),
        commit_every=int(getattr(config, "journal_commit_every", 0)
                         or 0),
        clock=clock)
