"""Serving under failure in the port, part two: the decode poison with its
per-slot quarantine, the SIGTERM drain and the end-to-end chaos run,
against the JAX package (``tests/test_serving_resilience.py`` :199-306,
:418-462) on the same weights, prompts and ``ChaosPlan`` script, through
the sync and the async serve loop of each package:

* a NaN-poisoned decode slot (``poison_decode_at``, an in-place write into
  the pools the decode program reads) is quarantined alone by the guarded
  program's verdict: the neighbours' streams are unchanged, the request is
  retried on a fresh slot and, under exact decode, its stream is the clean
  run's; a second poison of the retry spends the budget (``decode_fault``),
  and a budget of 0 aborts at once;
* a SIGTERM mid-serve (``preempt_serving_at``, a real signal through the
  handler ``serve`` installs and restores) stops admission: the in-flight
  request finishes, queued ones come back in ``drained_requests`` and
  complete when resubmitted; with no grace the in-flight one is evicted as
  ``preempted``;
* one serve with a poison, a queue storm through ``--shed-policy queue``
  and a SIGTERM ledgers every request under exactly one outcome;
* with ``--telemetry-file`` and ``--trace-file`` the run publishes the
  JAX package's ``serving_resilience`` block and tracer events.

The device-loss cases of the JAX file (:309, :328, :407) come with the
serving engine's device-loss failover (ROADMAP A.8).
"""
import signal

import pytest

from torch_serving_pairs import (both, engine, ledger, pkgs,  # noqa: F401
                                 prompts, set_config)

LOOPS = ["sync", "async"]


def _sync_ledger(stats):
    out = ledger(stats)
    out["decode_steps"] = stats.decode_steps
    return out


@pytest.mark.parametrize("loop", LOOPS)
def test_decode_poison_quarantined_retried_neighbors_bitwise(pkgs, loop):
    ps = prompts(4, seed=3)

    def run(p):
        base = engine(p, exact_decode=True).generate(ps, max_new_tokens=5)
        eng = engine(p, exact_decode=True, serve_loop=loop)
        chaos = p.ChaosPlan(poison_decode_at={2: 0})
        outs = eng.generate(ps, max_new_tokens=5, chaos=chaos)
        return (base, outs, chaos.poisoned_decode_steps, eng._last_guard,
                ledger(eng.stats))

    j, t = both(pkgs, run)
    assert t == j
    base, outs, steps, guard, led = t
    assert steps == [2] and guard is True
    assert outs == base, "retried or neighbour streams diverged"
    assert led["quarantines"] == 1 and led["decode_retries"] == 1
    assert led["outcomes"] == {"ok": 4}


@pytest.mark.parametrize("loop", LOOPS)
def test_repeated_poison_aborts_decode_fault(pkgs, loop):
    ps = prompts(2, seed=4)

    def run(p):
        base = engine(p, exact_decode=True).generate(ps, max_new_tokens=6)
        eng = engine(p, exact_decode=True, serve_loop=loop)
        chaos = p.ChaosPlan(poison_decode_at={1: 0, 3: 0})
        outs = eng.generate(ps, max_new_tokens=6, chaos=chaos)
        return base, outs, ledger(eng.stats)

    j, t = both(pkgs, run)
    assert t == j
    base, outs, led = t
    assert led["outcomes"] == {"ok": 1, "decode_fault": 1}
    assert led["quarantines"] == 2 and led["decode_retries"] == 1
    faulted = [i for i in range(2) if len(outs[i]) < 6]
    assert len(faulted) == 1
    assert outs[1 - faulted[0]] == base[1 - faulted[0]]


def test_decode_retry_budget_zero_aborts_immediately(pkgs):
    old = set_config(pkgs, decode_retry_budget=0)
    try:
        def run(p):
            eng = engine(p)
            eng.generate(prompts(1, seed=5), max_new_tokens=6,
                         chaos=p.ChaosPlan(poison_decode_at={1: 0}))
            return _sync_ledger(eng.stats)

        j, t = both(pkgs, run)
        assert t == j
        assert t["outcomes"] == {"decode_fault": 1}
        assert t["quarantines"] == 1 and t["decode_retries"] == 0
    finally:
        set_config(pkgs, **old)


@pytest.mark.parametrize("loop", LOOPS)
def test_sigterm_drain_returns_queued_and_finishes_inflight(pkgs, loop):
    ps = prompts(3, seed=6)

    def run(p):
        prev = signal.getsignal(signal.SIGTERM)
        eng = engine(p, n_slots=1, serve_loop=loop)
        chaos = p.ChaosPlan(preempt_serving_at=1)
        outs = eng.generate(ps, max_new_tokens=4, chaos=chaos)
        restored = signal.getsignal(signal.SIGTERM) is prev
        drained = eng.drained_requests
        first = (outs, restored, chaos.serving_preempted_at,
                 [r.rng_tag for r in drained],
                 [r.outcome for r in drained], ledger(eng.stats))
        res = eng._make_resilience(None)
        sched = p.ContinuousBatchScheduler(n_slots=1, max_queue=8,
                                           max_len=eng.max_decode_len,
                                           clock=res.clock)
        for r in drained:
            r.outcome = None
            res.admit(sched, r)
        eng.serve(sched, resilience=res)
        return first + ([(list(r.generated), r.outcome) for r in drained],)

    j, t = both(pkgs, run)
    assert t == j
    outs, restored, at, tags, outcomes, led, resubmitted = t
    assert restored and at == 1
    assert len(outs[0]) == 4 and outs[1] == outs[2] == []
    assert tags == [1, 2] and outcomes == ["preempted"] * 2
    assert led["drains"] == 1 and led["drained_returned"] == 2
    assert led["outcomes"] == {"ok": 1, "preempted": 2}
    assert all(len(g) == 4 and o == "ok" for g, o in resubmitted)


def test_drain_grace_zero_evicts_inflight_as_preempted(pkgs):
    old = set_config(pkgs, drain_grace_s=0.0)
    try:
        def run(p):
            eng = engine(p, n_slots=1)
            outs = eng.generate(prompts(2, seed=7), max_new_tokens=6,
                                chaos=p.ChaosPlan(preempt_serving_at=1))
            return outs, _sync_ledger(eng.stats)

        j, t = both(pkgs, run)
        assert t == j
        outs, led = t
        assert led["outcomes"] == {"preempted": 2}
        assert 0 < len(outs[0]) < 6 and led["drained_returned"] == 1
    finally:
        set_config(pkgs, **old)


@pytest.mark.parametrize("loop", LOOPS)
def test_chaos_end_to_end_every_request_accounted(pkgs, loop):
    ps = prompts(4, seed=9)
    old = set_config(pkgs, shed_policy="queue")
    try:
        def run(p):
            base = engine(p, exact_decode=True).generate(ps,
                                                         max_new_tokens=6)
            eng = engine(p, exact_decode=True, max_queue=8, serve_loop=loop)
            chaos = p.ChaosPlan(poison_decode_at={3: 1},
                                storm_queue={4: [[7, 8, 9]] * 6},
                                storm_max_new_tokens=3,
                                preempt_serving_at=5)
            outs = eng.generate(ps, max_new_tokens=6, chaos=chaos)
            return (base, outs, ledger(eng.stats),
                    [(r.rng_tag, r.outcome) for r in eng.drained_requests])

        j, t = both(pkgs, run)
        assert t == j
        base, outs, led, drained = t
        assert sum(led["outcomes"].values()) == 10
        assert set(led["outcomes"]) <= {"ok", "deadline_exceeded", "shed",
                                        "decode_fault", "preempted"}
        assert led["quarantines"] >= 1 and led["sheds"] >= 1
        assert led["drains"] == 1
        for o, b in zip(outs, base):
            if len(o) == 6:
                assert o == b
        assert any(len(o) == 6 for o in outs)
        assert led["drained_returned"] == len(drained)
        assert all(o == "preempted" for _tag, o in drained)
    finally:
        set_config(pkgs, **old)


def test_resilience_telemetry_block_and_trace_events(pkgs, tmp_path):
    """With ``--telemetry-file`` and ``--trace-file``, a poisoned and
    drained serve publishes the JAX package's ``serving_resilience`` block
    and its tracer events (``decode_poison``, ``decode_quarantine``,
    ``serving_drain``; ``deadline_exceeded`` in a deadline run)."""
    import json

    import flexflow_tpu.obs as jobs
    import flexflow_tpu_torch.obs as tobs

    events = {"decode_poison", "decode_quarantine", "decode_fault",
              "serving_drain", "deadline_exceeded"}

    def run(p):
        cfg = p.ff.config
        tel, tr = tmp_path / f"{p.name}.json", tmp_path / f"{p.name}.tr"
        old = (cfg.telemetry_file, cfg.trace_file)
        cfg.telemetry_file, cfg.trace_file = str(tel), str(tr)
        try:
            eng = engine(p, exact_decode=True, n_slots=1)
            eng.generate(prompts(3, seed=12), max_new_tokens=6,
                         chaos=p.ChaosPlan(poison_decode_at={1: 0},
                                           preempt_serving_at=3))
            with open(tel) as f:
                block = json.load(f)["serving_resilience"]
            eng.resilience_clock = _Clock()
            eng.generate(prompts(2, seed=13), max_new_tokens=6,
                         deadline_ms=1.0)
            with open(tr) as f:
                names = {e["name"] for e in json.load(f)["traceEvents"]}
        finally:
            cfg.telemetry_file, cfg.trace_file = old
            (jobs if p.name == "jax" else tobs).disable()
        return block, sorted(names & events)

    j, t = both(pkgs, run)
    assert t == j
    block, names = t
    assert block["quarantines"] == 1 and block["drains"] == 1
    assert block["outcomes"] == {"ok": 1, "preempted": 2}
    assert names == sorted(events - {"decode_fault"})


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 5.0
        return self.t
