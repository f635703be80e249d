"""The request journal in the port (``flexflow_tpu_torch/serving/
journal.py``, ``ServingFleet.recover``) against the JAX package
(``tests/test_request_journal.py``, its 12 cases): the record round trip
and dedupe, the torn-tail property (hypothesis), sealed-segment
corruption, compaction, ``reserve_rids``, the off-contract, the in-process
crash and its recovery, client-retry dedupe across the lifecycle, the
drain before a crash, a child process killed by a real SIGKILL mid-serve,
the flags and their preflight, and the telemetry block.

It adds the cross-scan: the two packages write the same bytes for the same
records, and each scans a journal the other wrote to the same backlog.
Fleet scenarios run through both packages on the same tiny GPT-2 weights
(``tests/torch_fleet_pairs.py``).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import flexflow_tpu as fj
import flexflow_tpu.resilience.preflight as jpre
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.resilience.preflight as tpre
from torch_fleet_pairs import baseline, fleet_view, make_fleet
from torch_serving_pairs import both, pkgs, prompts  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def req(p, prompt, rid=None, **kw):
    kw.setdefault("max_new_tokens", 4)
    r = p.Request(prompt=np.asarray(prompt, dtype=np.int32), **kw)
    if rid is not None:
        r.rid = rid
    return r


def set_journal(p, jdir, sync_ms=0.0, commit_every=0):
    c = p.ff.config
    c.request_journal = str(jdir) if jdir else ""
    c.journal_sync_ms = sync_ms
    c.journal_commit_every = commit_every


def segments(root):
    return sorted(f for f in os.listdir(root) if f.startswith("journal_"))


def log_script(p, root, commit_every=2):
    """The first JAX case's records: two submits, a retry, progress, an
    outcome and a first-wins repeat."""
    jr = p.RequestJournal(str(root), sync_ms=0.0, commit_every=commit_every)
    a = req(p, [1, 2, 3], rid=501, rng_tag=7, tenant="interactive",
            deadline_ms=250.0)
    b = req(p, [4, 5], rid=502)
    out = [jr.log_submit(a), jr.log_submit(b), jr.log_submit(a),
           jr.dedupe_hits]
    a.generated.extend([11, 12])
    jr.log_progress(a)
    a.generated.extend([13])
    jr.log_progress(a)
    b.outcome, b.done = "ok", True
    out += [jr.log_outcome(b), jr.log_outcome(b)]
    with pytest.raises(ValueError, match="unknown outcome"):
        jr.log_outcome(a, outcome="vanished")
    jr.close()
    return out


def scan(p, root, **kw):
    """What a reopened journal holds."""
    jr = p.RequestJournal(str(root), **kw)
    return (jr.pending_rids(), jr.max_rid(),
            [(r.rid, [int(t) for t in r.prompt], list(r.generated),
              r.rng_tag, r.tenant, r.deadline_ms, r.max_new_tokens)
             for r in jr.pending_requests()], jr.truncated_records)


# ------------------------------------------------------------ journal unit
def test_journal_roundtrip_dedupe_and_reopen(pkgs, tmp_path):
    def run(p):
        root = tmp_path / f"j_{p.name}"
        return log_script(p, root), scan(p, root)

    j, t = both(pkgs, run)
    assert t == j
    logged, (pending, max_rid, recs, torn) = t
    assert logged == [True, True, False, 1, True, False]
    assert pending == [501] and max_rid == 502 and torn == 0
    assert recs == [(501, [1, 2, 3], [11, 12], 7, "interactive", 250.0, 4)]


def test_journal_cross_scan_both_ways_byte_for_byte(pkgs, tmp_path):
    """The same records make the same bytes in both packages, and each
    scans the other's journal to the same backlog."""
    roots = {}
    for name, p in pkgs.items():
        roots[name] = tmp_path / f"x_{name}"
        log_script(p, roots[name])
    segs = {n: segments(r) for n, r in roots.items()}
    assert segs["jax"] == segs["torch"] and segs["jax"]
    for seg in segs["jax"]:
        assert (roots["jax"] / seg).read_bytes() == \
            (roots["torch"] / seg).read_bytes()
    jax_of_torch = scan(pkgs["jax"], roots["torch"])
    torch_of_jax = scan(pkgs["torch"], roots["jax"])
    assert jax_of_torch == torch_of_jax == scan(pkgs["torch"],
                                                roots["torch"])
    assert jax_of_torch[0] == [501]


def _fold(data: bytes, keep: int):
    pending = {}
    for line in data[:keep].splitlines():
        rec = json.loads(line.split(b" ", 1)[1])
        if rec["k"] == "submit":
            pending.setdefault(rec["rid"], [])
        elif rec["k"] == "progress" and rec["rid"] in pending:
            pending[rec["rid"]].extend(rec["toks"])
        elif rec["k"] == "outcome":
            pending.pop(rec["rid"], None)
    return pending


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(n=st.integers(2, 8), done=st.integers(0, 8), cut=st.floats(0, 1),
       truncated=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_torn_tail_truncation_property(pkgs, tmp_path_factory, n, done,
                                       cut, truncated, seed):
    """A tear of the live segment anywhere — truncated mid-record or a
    flipped byte — leaves the longest valid record prefix: both packages'
    reopened journals equal a fold of the records wholly before the tear,
    the file is cut to that prefix, the tear is counted only when torn
    bytes were seen, and the journal takes appends after the surgery."""
    rng = np.random.default_rng(seed)
    tokens = [[int(x) for x in rng.integers(0, 50, size=3)]
              for _ in range(n)]
    out = {}
    for name, p in pkgs.items():
        root = tmp_path_factory.mktemp(f"t_{name}")
        jr = p.RequestJournal(str(root), sync_ms=0.0, commit_every=1)
        reqs = [req(p, tok, rid=1000 + i) for i, tok in enumerate(tokens)]
        for r in reqs:
            jr.log_submit(r)
        for r in reqs[:min(done, n - 1)]:
            r.generated.append(5)
            jr.log_progress(r)
            r.outcome, r.done = "ok", True
            jr.log_outcome(r)
        jr.crash()
        (seg,) = [root / f for f in os.listdir(root)]
        data = seg.read_bytes()
        at = 1 + int(cut * (len(data) - 2))
        if truncated:
            seg.write_bytes(data[:at])
        else:
            torn = bytearray(data)
            torn[at] ^= 0xFF
            seg.write_bytes(bytes(torn))
        keep = data.rfind(b"\n", 0, at) + 1
        jr2 = p.RequestJournal(str(root))
        got = {r.rid: list(r.generated) for r in jr2.pending_requests()}
        assert got == _fold(data, keep)
        assert seg.read_bytes() == data[:keep]
        file_len = at if truncated else len(data)
        assert (jr2.truncated_records >= 1) == (keep < file_len)
        jr2.log_submit(req(p, [9], rid=4000))
        jr2.close()
        assert 4000 in p.RequestJournal(str(root)).pending_rids()
        out[name] = (got, jr2.truncated_records, data)
    assert out["jax"] == out["torch"]


def test_sealed_segment_corruption_raises(pkgs, tmp_path):
    def run(p):
        root = tmp_path / f"sealed_{p.name}"
        jr = p.RequestJournal(str(root), sync_ms=0.0, segment_bytes=1 << 10)
        for i in range(40):
            jr.log_submit(req(p, [1, 2, 3], rid=100 + i))
        jr.close()
        segs = segments(root)
        first = root / segs[0]
        blob = bytearray(first.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        first.write_bytes(bytes(blob))
        with pytest.raises(p.JournalCorruptError, match=segs[0]):
            p.RequestJournal(str(root))
        return len(segs)

    j, t = both(pkgs, run)
    assert t == j and t >= 2


def test_compaction_drops_settled_segments_only(pkgs, tmp_path):
    def run(p):
        root = tmp_path / f"c_{p.name}"
        jr = p.RequestJournal(str(root), sync_ms=0.0, segment_bytes=1 << 10)
        reqs = [req(p, [1, 2, 3], rid=200 + i) for i in range(40)]
        for r in reqs:
            jr.log_submit(r)
        for r in reqs:
            r.outcome, r.done = "ok", True
            jr.log_outcome(r)
        n_before = len(os.listdir(root))
        dropped = jr.compact()
        out = [dropped, jr.compacted_segments,
               len(os.listdir(root)) == n_before - dropped,
               p.RequestJournal(str(root)).pending_rids()]
        root2 = tmp_path / f"c2_{p.name}"
        jr2 = p.RequestJournal(str(root2), sync_ms=0.0,
                               segment_bytes=1 << 10)
        jr2.log_submit(req(p, [7], rid=9000))
        for i in range(40):
            r = req(p, [1, 2, 3], rid=300 + i)
            jr2.log_submit(r)
            r.outcome, r.done = "ok", True
            jr2.log_outcome(r)
        return out + [len(os.listdir(root2)) >= 2, jr2.compact()]

    j, t = both(pkgs, run)
    assert t == j
    assert t[0] >= 1 and t[1] == t[0] and t[2] and t[3] == []
    assert t[4] and t[5] == 0


def test_reserve_rids_monotone(pkgs):
    def run(p):
        r1 = req(p, [1])
        p.scheduler.reserve_rids(r1.rid + 100)
        r2 = req(p, [1])
        p.scheduler.reserve_rids(0)
        return r2.rid - r1.rid, req(p, [1]).rid > r2.rid

    j, t = both(pkgs, run)
    assert t == j == (101, True)


# ----------------------------------------------------------- off-contract
def test_journal_off_is_noop_singleton_bitwise(pkgs):
    ps = prompts(6, seed=3)

    def run(p):
        pkg = fj if p.name == "jax" else ft
        assert p.NoopJournal.__slots__ == ()
        assert p.journal_from_config(pkg.FFConfig()) is p.NOOP_JOURNAL
        fleet = make_fleet(p)
        return (fleet.journal is p.NOOP_JOURNAL,
                fleet.journal.log_submit(None), baseline(p, ps, 5),
                fleet.generate(ps, max_new_tokens=5), fleet_view(fleet))

    j, t = both(pkgs, run)
    assert t == j
    off, door, base, outs, v = t
    assert off and door is True and outs == base
    assert v["outcomes"] == {"ok": 6}


# -------------------------------------------------- crash -> recover loop
def test_crash_recover_exactly_one_outcome_bitwise(pkgs, tmp_path):
    """The in-process crash drops the unsynced buffer and skips every
    flush; ``recover`` replays the backlog through the door, and after the
    recovery run every journaled rid has exactly one outcome on disk, the
    recovered streams equal to an undisturbed engine's."""
    ps = prompts(8, seed=4)

    def run(p):
        jdir = tmp_path / f"wal_{p.name}"
        set_journal(p, jdir, sync_ms=0.0, commit_every=1)
        try:
            fleet = make_fleet(p)
            for i, pr in enumerate(ps):
                fleet.submit(req(p, pr, max_new_tokens=6, rng_tag=i))
            chaos = p.FleetChaosPlan(crash_at={6: "hard"})
            with pytest.raises(p.FleetCrashed, match="tick 6"):
                fleet.run(chaos=chaos)
            scan_ = p.RequestJournal(str(jdir), commit_every=1)
            backlog = scan_.pending_requests()
            census = (len(backlog), len(scan_._outcomes),
                      sorted(len(r.generated) for r in backlog))
            fleet2 = p.ServingFleet.recover(p.ff, n_replicas=2, n_slots=2,
                                            max_decode_len=16,
                                            exact_decode=True)
            for rep in fleet2.replicas:
                rep.engine.admission.force_token_cost_ms = 1.0
            jr = fleet2.journal
            replayed, wall = jr.replayed, jr.recovery_wall_s
            fleet2.run()
            rec = {r.rng_tag: list(r.generated) for r in fleet2._requests}
            outcomes = dict(fleet2.stats.outcomes)
            jr.close()
            left = p.RequestJournal(str(jdir)).pending_rids()
        finally:
            set_journal(p, None)
        return (chaos.crashes_fired, census, replayed, wall > 0, outcomes,
                rec, baseline(p, ps, 6), left)

    j, t = both(pkgs, run)
    assert t[:2] == j[:2] and t[4:] == j[4:]
    fired, (n_backlog, n_done, gens), replayed, walled, outcomes, rec, \
        base, left = t
    assert fired == ["hard"] and n_backlog + n_done == 8 and n_backlog
    assert any(gens), "the crash never reached mid-stream decode"
    assert replayed == n_backlog and walled
    assert outcomes == {"ok": n_backlog}
    assert rec == {i: base[i] for i in rec}
    assert left == []


def test_recover_dedupes_client_retries(pkgs, tmp_path):
    pr = prompts(1, seed=5)[0]

    def run(p):
        set_journal(p, tmp_path / f"d_{p.name}")
        try:
            fleet = make_fleet(p)
            first = req(p, pr, max_new_tokens=4, rng_tag=0)
            fleet.submit(first)
            fleet.submit(req(p, list(first.prompt), rid=first.rid,
                             max_new_tokens=4, rng_tag=0))
            hits = [fleet.journal.dedupe_hits]
            fleet.run()
            led = dict(fleet.stats.outcomes)
            fleet.submit(req(p, list(first.prompt), rid=first.rid,
                             max_new_tokens=4, rng_tag=0))
            hits.append(fleet.journal.dedupe_hits)
            n = len(fleet._requests)
            fleet.journal.close()
        finally:
            set_journal(p, None)
        return hits, led, n

    j, t = both(pkgs, run)
    assert t == j == ([1, 2], {"ok": 1}, 1)


def test_drain_crash_recover_exactly_once(pkgs, tmp_path):
    ps = prompts(3, seed=6)

    def run(p):
        set_journal(p, tmp_path / f"drain_{p.name}")
        try:
            fleet = make_fleet(p)
            for rep in fleet.replicas:
                rep.engine.max_queue = 0
            outs = fleet.generate(ps, max_new_tokens=4,
                                  chaos=p.FleetChaosPlan(
                                      preempt_serving_at=1))
            out = (dict(fleet.stats.outcomes), outs,
                   len(fleet.drained_requests))
            fleet2 = p.ServingFleet.recover(p.ff, n_replicas=2, n_slots=2,
                                            max_decode_len=16,
                                            exact_decode=True)
            out += (fleet2.journal.replayed, fleet2.journal.pending_rids())
            fleet2.journal.close()
        finally:
            set_journal(p, None)
        return out

    j, t = both(pkgs, run)
    assert t == j == ({"preempted": 3}, [[], [], []], 3, 0, [])


CHILD = """
import numpy as np
import torch
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.resilience import FleetChaosPlan
from flexflow_tpu_torch.serving import Request, ServingFleet

torch.set_num_threads(1)
cfg = GPT2Config.tiny(batch_size=8)
config = ft.FFConfig()
config.batch_size = cfg.batch_size
config.request_journal = {jdir!r}
config.journal_commit_every = 1
ff = ft.FFModel(config, device="cpu")
build_gpt2(ff, cfg)
ff.compile()
ff.set_params_numpy(dict(np.load({weights!r}, allow_pickle=True)["w"]
                         .item()))
rng = np.random.default_rng(6)
fleet = ServingFleet(ff, n_replicas=2, n_slots=2,
                     max_decode_len=cfg.seq_len, exact_decode=True)
for i in range(6):
    p = rng.integers(0, 100, size=int(rng.integers(3, 6)))
    fleet.submit(Request(prompt=p.astype(np.int32), max_new_tokens=6,
                         rng_tag=i))
fleet.run(chaos=FleetChaosPlan(crash_at={{6: "sigkill"}}))
raise SystemExit("still alive after the SIGKILL tick")
"""


def test_crash_sigkill_child_process_recovers(pkgs, tmp_path):
    """A child process serving through the port's fleet with the journal
    on dies by a real SIGKILL mid-serve; the parent recovers its backlog to
    exactly one outcome each, in the port and, from the same journal, in
    the JAX package, and the recovered streams agree."""
    jdir = tmp_path / "kill"
    weights = tmp_path / "w.npz"
    tp = pkgs["torch"]
    np.savez(weights, w=np.array(tp.ff.get_params_numpy(), dtype=object))
    script = tmp_path / "serve_and_die.py"
    script.write_text(CHILD.format(jdir=str(jdir), weights=str(weights)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        x for x in (REPO, os.environ.get("PYTHONPATH")) if x))
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -9, (proc.returncode, proc.stderr[-2000:])
    # the same dead journal, recovered by either package from a copy
    import shutil

    roots = {"torch": jdir, "jax": tmp_path / "kill_jax"}
    shutil.copytree(jdir, roots["jax"])

    def run(p):
        set_journal(p, roots[p.name], commit_every=1)
        try:
            fleet = p.ServingFleet.recover(p.ff, n_replicas=2, n_slots=2,
                                           max_decode_len=16,
                                           exact_decode=True)
            replayed = fleet.journal.replayed
            fleet.run()
            out = (replayed, dict(fleet.stats.outcomes),
                   {r.rng_tag: list(r.generated) for r in fleet._requests})
            fleet.journal.close()
            left = p.RequestJournal(str(roots[p.name])).pending_rids()
        finally:
            set_journal(p, None)
        return out + (left,)

    j, t = both(pkgs, run)
    assert t == j
    replayed, outcomes, streams, left = t
    assert replayed >= 1 and set(outcomes) == {"ok"} and left == []
    assert sum(outcomes.values()) == replayed == len(streams)


# -------------------------------------------------- flags + observability
def test_journal_flags_parse_and_preflight(pkgs, tmp_path):
    mods = {"jax": (fj, jpre), "torch": (ft, tpre)}

    def run(p):
        pkg, pre = mods[p.name]
        cfg = pkg.FFConfig()
        out = [cfg.request_journal, cfg.journal_sync_ms,
               cfg.journal_commit_every]
        cfg.parse_args(["--request-journal", str(tmp_path / "j"),
                        "--journal-sync-ms", "5",
                        "--journal-commit-every", "8"])
        out += [cfg.request_journal == str(tmp_path / "j"),
                cfg.journal_sync_ms, cfg.journal_commit_every]
        pre.preflight_config(cfg)
        for argv, match in (
                (["--request-journal", "x", "--journal-sync-ms", "-1"],
                 ">= 0"),
                (["--request-journal", "x", "--journal-commit-every", "-2"],
                 ">= 0"),
                (["--journal-sync-ms", "5"], "request-journal"),
                (["--journal-commit-every", "4"], "request-journal"),
                (["--request-journal", ""], "directory")):
            with pytest.raises(ValueError, match=match):
                pkg.FFConfig().parse_args(argv)
        bad = pkg.FFConfig()
        bad.request_journal = "x"
        bad.journal_sync_ms = -3.0
        with pytest.raises(pre.PreflightError, match=">= 0"):
            pre.preflight_config(bad)
        tuner = pkg.FFConfig()
        tuner.journal_commit_every = 4
        with pytest.raises(pre.PreflightError, match="request-journal"):
            pre.preflight_config(tuner)
        orphan = pkg.FFConfig()
        orphan.request_journal = str(tmp_path / "no" / "such" / "parent")
        with pytest.raises(pre.PreflightError, match="parent"):
            pre.preflight_config(orphan)
        return out

    j, t = both(pkgs, run)
    assert t == j == ["", 0.0, 0, True, 5.0, 8]


def test_journal_telemetry_block_and_trace_digest(pkgs, tmp_path, capsys):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import trace_summary

    ps, ps2 = prompts(4, seed=7), prompts(2, seed=8)

    def run(p):
        tel = tmp_path / f"tel_{p.name}.json"
        p.ff.config.telemetry_file = str(tel)
        set_journal(p, tmp_path / f"wal_{p.name}", commit_every=1)
        try:
            fleet = make_fleet(p)
            fleet.generate(ps, max_new_tokens=4)
            fleet.journal.close()
        finally:
            p.ff.config.telemetry_file = ""
            set_journal(p, None)
        blk = json.loads(tel.read_text())["serving_journal"]
        capsys.readouterr()
        trace_summary.main([str(tel)])
        printed = "request journal:" in capsys.readouterr().out
        tel2 = tmp_path / f"tel2_{p.name}.json"
        p.ff.config.telemetry_file = str(tel2)
        try:
            make_fleet(p).generate(ps2, max_new_tokens=3)
        finally:
            p.ff.config.telemetry_file = ""
        absent = "serving_journal" not in json.loads(tel2.read_text())
        return ({k: blk[k] for k in ("appended", "syncs", "replayed",
                                     "truncated_records")},
                printed, absent)

    j, t = both(pkgs, run)
    assert t == j
    blk, printed, absent = t
    assert blk["appended"] > 0 and blk["syncs"] >= 1
    assert blk["replayed"] == 0 and blk["truncated_records"] == 0
    assert printed and absent
