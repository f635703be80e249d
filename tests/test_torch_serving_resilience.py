"""Serving under failure in the port (``flexflow_tpu_torch/serving/
resilience.py`` and the engine's loop), part one: deadlines, load shedding
and admission, against the JAX package (``tests/test_serving_resilience.py``
:59-197, :365-404, :465-571) on the same weights, prompts and scripted
clock. Each scenario runs through both packages and must give the same
streams, outcomes, counters and shed patterns:

* a request whose deadline expires mid-decode is evicted
  (``deadline_exceeded``), its slot recycled, its neighbours' streams
  unchanged; one expired while queued never costs a prefill; a deadline on
  a request submitted straight to the scheduler, or stamped by ``admit``
  before the serve, arms the sweeps;
* ``--shed-policy queue`` sheds at ``max_queue // 2`` with a typed
  ``OverloadError``, the same pattern run after run; ``deadline`` sheds on
  the completion estimate, with its ``retry_after_ms``; the queue wall
  names the policy, and a request refused there is still ledgered ``shed``
  — also one refused before a serve handed another policy object;
* the completion estimate counts the in-flight backlog; a quarantine
  retry resubmitted to a narrower scheduler is refused at submit;
* a plain serve runs the unguarded program with no resilience counts;
* the scheduler's edges (``quarantine``, ``evict``, ``drop_queued``,
  ``remove_finished``, ``pop_queued`` under ``draining``, the allocator's
  ``in_use`` and ``reset``) and the request records a poisoned, drained
  serve leaves (the ``quarantine`` hop, the terminal notes) match;
* the per-token latency window holds the last 8192 walls
  (``TOKEN_WALL_WINDOW``), as the JAX package's does.

Part two (poison, quarantine, drain, chaos) is
``tests/test_torch_serving_chaos.py``.
"""
import numpy as np
import pytest

from torch_serving_pairs import (ScriptedClock, both, engine, ledger,
                                 pkgs, prompts, set_config)  # noqa: F401

import flexflow_tpu.serving.engine as jeng
import flexflow_tpu_torch.serving.engine as teng


# ----------------------------------------------------------------- deadlines
def test_deadline_eviction_recycles_slot_neighbors_bitwise(pkgs):
    ps = prompts(3, seed=1)

    def run(p):
        base = engine(p).generate(ps, max_new_tokens=8)
        eng = engine(p)
        eng.resilience_clock = ScriptedClock(step_ms=5.0)
        res = eng._make_resilience(None)
        sched = p.ContinuousBatchScheduler(n_slots=2, max_queue=8,
                                           buckets=eng.buckets,
                                           max_len=eng.max_decode_len,
                                           clock=res.clock)
        reqs = []
        for i, pr in enumerate(ps):
            r = p.Request(prompt=np.asarray(pr, np.int32), max_new_tokens=8,
                          rng_tag=i, deadline_ms=60.0 if i == 0 else None)
            res.admit(sched, r)
            reqs.append(r)
        eng.serve(sched, resilience=res)
        return (base, [list(r.generated) for r in reqs],
                [r.outcome for r in reqs], ledger(eng.stats), sched.evicted)

    j, t = both(pkgs, run)
    assert t == j
    base, outs, outcomes, led, evicted = t
    assert outcomes == ["deadline_exceeded", "ok", "ok"]
    assert 0 < len(outs[0]) < 8
    assert outs[1:] == base[1:] and len(outs[2]) == 8
    assert led["deadline_misses"] == 1 and led["requests_served"] == 2
    assert led["outcomes"] == {"ok": 2, "deadline_exceeded": 1}
    assert evicted == 1


def test_deadline_expired_in_queue_never_costs_a_prefill(pkgs):
    def run(p):
        eng = engine(p, n_slots=1)
        eng.resilience_clock = ScriptedClock(step_ms=5.0)
        outs = eng.generate(prompts(4, seed=2), max_new_tokens=4,
                            deadline_ms=1.0)
        return outs, ledger(eng.stats)

    j, t = both(pkgs, run)
    assert t == j
    outs, led = t
    assert all(o == [] for o in outs)
    assert led["outcomes"] == {"deadline_exceeded": 4}
    assert led["prefills"] == 0


def test_direct_scheduler_submit_deadline_enforced(pkgs):
    def run(p):
        eng = engine(p, n_slots=1)
        sched = p.ContinuousBatchScheduler(n_slots=1, max_queue=8,
                                           max_len=eng.max_decode_len,
                                           clock=ScriptedClock(step_ms=5.0))
        doomed = p.Request(prompt=np.asarray([1, 2, 3], np.int32),
                           max_new_tokens=8, rng_tag=0, deadline_ms=20.0)
        easy = p.Request(prompt=np.asarray([4, 5, 6], np.int32),
                         max_new_tokens=3, rng_tag=1)
        sched.submit(doomed)
        sched.submit(easy)
        eng.serve(sched)
        return (eng._last_guard, doomed.outcome, list(doomed.generated),
                easy.outcome, list(easy.generated))

    j, t = both(pkgs, run)
    assert t == j
    assert t[0] is True and t[1] == "deadline_exceeded"
    assert t[3] == "ok" and len(t[4]) == 3


def test_engine_admit_state_survives_into_serve(pkgs):
    def run(p):
        eng = engine(p, n_slots=1)
        sched = p.ContinuousBatchScheduler(n_slots=1, max_queue=8,
                                           max_len=eng.max_decode_len)
        reqs = [p.Request(prompt=np.asarray([1, 2, 3], np.int32),
                          max_new_tokens=4, rng_tag=i,
                          deadline_ms=1e-9 if i else None)
                for i in range(2)]
        for r in reqs:
            eng.admit(sched, r)
        armed = eng._pending_resilience.deadlines_armed
        eng.serve(sched)
        return (armed, eng._pending_resilience is None, eng._last_guard,
                [r.outcome for r in reqs], [list(r.generated) for r in reqs],
                eng.stats.outcomes)

    j, t = both(pkgs, run)
    assert t == j
    assert t[:3] == (True, True, True)
    assert t[3] == ["ok", "deadline_exceeded"] and len(t[4][0]) == 4
    assert t[5] == {"ok": 1, "deadline_exceeded": 1}


# ------------------------------------------------------------------ shedding
def test_shed_policy_queue_deterministic_and_rejection_base(pkgs):
    old = set_config(pkgs, shed_policy="queue")
    try:
        def storm(p):
            eng = engine(p, n_slots=1)
            res = eng._make_resilience(None)
            sched = p.ContinuousBatchScheduler(n_slots=1, max_queue=4,
                                               max_len=eng.max_decode_len,
                                               clock=res.clock)
            sched.shed_policy = res.shed_policy
            pat = []
            for i in range(8):
                r = p.Request(prompt=np.asarray([1, 2, 3], np.int32),
                              max_new_tokens=2, rng_tag=i)
                try:
                    res.admit(sched, r)
                    pat.append("accept")
                except p.ServingRejection as e:  # one clause, both types
                    pat.append(type(e).__name__)
                    assert e.queued >= 0 and e.active >= 0
                    assert e.retry_after_ms >= 0.0
                    assert r.outcome == "shed"
            return pat, res.sheds

        j, t = both(pkgs, storm)
        assert t == j == both(pkgs, storm)[1], "shed pattern differs"
        pat, sheds = t
        assert pat[:2] == ["accept", "accept"]
        assert set(pat[2:]) == {"OverloadError"} and sheds == 6
    finally:
        set_config(pkgs, **old)


def test_shed_policy_deadline_uses_completion_estimate(pkgs):
    old = set_config(pkgs, shed_policy="deadline")
    try:
        def run(p):
            eng = engine(p, n_slots=1)
            eng.admission.force_token_cost_ms = 10.0
            res = eng._make_resilience(None)
            sched = p.ContinuousBatchScheduler(n_slots=1, max_queue=16,
                                               max_len=eng.max_decode_len,
                                               clock=res.clock)
            res.admit(sched, p.Request(prompt=np.asarray([1, 2], np.int32),
                                       max_new_tokens=4, deadline_ms=100.0))
            tight = p.Request(prompt=np.asarray([1, 2], np.int32),
                              max_new_tokens=4, deadline_ms=50.0)
            with pytest.raises(p.OverloadError) as ei:
                res.admit(sched, tight)  # est 10 * (4 / 1 + 4) = 80 > 50
            res.admit(sched, p.Request(prompt=np.asarray([1, 2], np.int32),
                                       max_new_tokens=4))
            return (ei.value.retry_after_ms, "deadline" in str(ei.value),
                    sched.queued, res.sheds)

        j, t = both(pkgs, run)
        assert t == j
        assert t[0] == pytest.approx(40.0)
        assert t[1:] == (True, 2, 1)
    finally:
        set_config(pkgs, **old)


def test_queue_full_error_names_shed_policy(pkgs):
    def run(p):
        sched = p.ContinuousBatchScheduler(n_slots=1, max_queue=1,
                                           max_len=32)
        sched.shed_policy = "deadline"
        sched.submit(p.Request(prompt=np.zeros(4, np.int32),
                               max_new_tokens=4))
        with pytest.raises(p.QueueFullError,
                           match="shed policy 'deadline'") as ei:
            sched.submit(p.Request(prompt=np.zeros(4, np.int32),
                                   max_new_tokens=4))
        return isinstance(ei.value, p.ServingRejection), ei.value.queued

    j, t = both(pkgs, run)
    assert t == j == (True, 1)


def test_queue_full_policy_off_still_ledgered_as_shed(pkgs):
    def run(p):
        eng = engine(p, n_slots=1)
        res = eng._make_resilience(None)
        sched = p.ContinuousBatchScheduler(n_slots=1, max_queue=2,
                                           max_len=eng.max_decode_len,
                                           clock=res.clock)
        sched.shed_policy = res.shed_policy
        reqs = [p.Request(prompt=np.asarray([1, 2, 3], np.int32),
                          max_new_tokens=2, rng_tag=i) for i in range(6)]
        rejected = []
        for r in reqs:
            try:
                res.admit(sched, r)
            except p.QueueFullError:
                rejected.append(r.rng_tag)
        eng.serve(sched, resilience=res)
        return (res.shed_policy, rejected, [r.outcome for r in reqs],
                [list(r.generated) for r in reqs], ledger(eng.stats))

    j, t = both(pkgs, run)
    assert t == j
    policy, rejected, outcomes, _outs, led = t
    assert policy == "off" and rejected
    assert all(outcomes[i] == "shed" for i in rejected)
    assert sum(led["outcomes"].values()) == 6
    assert led["outcomes"]["shed"] == len(rejected) == led["sheds"]


def test_pending_admit_sheds_merge_into_explicit_resilience(pkgs):
    def run(p):
        eng = engine(p, n_slots=1)
        sched = p.ContinuousBatchScheduler(n_slots=1, max_queue=1,
                                           max_len=eng.max_decode_len)
        ok_req = p.Request(prompt=np.asarray([1, 2, 3], np.int32),
                           max_new_tokens=2, rng_tag=0)
        eng.admit(sched, ok_req)
        with pytest.raises(p.ServingRejection):
            eng.admit(sched, p.Request(prompt=np.asarray([4, 5, 6],
                                                         np.int32),
                                       max_new_tokens=2, rng_tag=1))
        pending_sheds = eng._pending_resilience.sheds
        res = eng._make_resilience(None)
        eng.serve(sched, resilience=res)
        return (pending_sheds, eng._pending_resilience is None, res.sheds,
                eng.stats.outcomes, list(ok_req.generated))

    j, t = both(pkgs, run)
    assert t == j
    assert t[:4] == (1, True, 1, {"ok": 1, "shed": 1})


def test_completion_estimate_counts_inflight_backlog(pkgs):
    def run(p):
        ctrl = p.AdmissionController()
        ctrl.force_token_cost_ms = 10.0
        sched = p.ContinuousBatchScheduler(n_slots=1, max_queue=8,
                                           buckets=(8,), max_len=64)
        sched.slots[0] = p.Request(prompt=np.zeros(4, np.int32),
                                   max_new_tokens=100)
        req = p.Request(prompt=np.zeros(4, np.int32), max_new_tokens=4)
        return (ctrl.estimate_completion_ms(req, sched),
                ctrl.retry_after_ms(sched))

    j, t = both(pkgs, run)
    assert t == j
    assert t[0] == pytest.approx(10.0 * (100 + 4))
    assert t[1] == pytest.approx(1000.0)


def test_retry_resubmitted_to_narrow_scheduler_refused_at_submit(pkgs):
    def run(p):
        narrow = p.ContinuousBatchScheduler(n_slots=1, max_queue=8,
                                            buckets=(4,), max_len=32)
        retry = p.Request(prompt=np.zeros(3, np.int32), max_new_tokens=6,
                          generated=[5, 6, 7])
        with pytest.raises(ValueError, match="largest prefill bucket"):
            narrow.submit(retry)
        return narrow.queued, narrow.active, narrow.next_action()

    j, t = both(pkgs, run)
    assert t == j == (0, 0, None)


def test_plain_serve_stays_unguarded_and_rejection_free(pkgs):
    def run(p):
        eng = engine(p)
        outs = eng.generate(prompts(2, seed=10), max_new_tokens=3)
        return outs, eng._last_guard, ledger(eng.stats)

    j, t = both(pkgs, run)
    assert t == j
    outs, guard, led = t
    assert all(len(o) == 3 for o in outs) and guard is False
    assert led["outcomes"] == {"ok": 2}
    assert led["quarantines"] == led["sheds"] == led["drains"] == 0


# ------------------------------------------------------- latency window
def test_token_wall_window_is_bounded_like_the_jax_one():
    """8200 walls in: both windows keep the last 8192, and p50/p99 read
    them (the port's list grew without bound before)."""
    assert teng.TOKEN_WALL_WINDOW == jeng.TOKEN_WALL_WINDOW == 8192
    walls = np.random.default_rng(0).exponential(0.01, 8200).tolist()
    sj, st = jeng.ServingStats(), teng.ServingStats()
    for w in walls:
        sj.record_token(w)
        st.record_token(w)
    assert len(st.token_walls_s) == st.token_walls_s.maxlen == 8192
    assert list(st.token_walls_s) == walls[-8192:]
    assert st.p50_token_ms() == sj.p50_token_ms()
    assert st.p99_token_ms() == sj.p99_token_ms()
    assert st.p50_token_ms() == float(np.percentile(walls[-8192:], 50) * 1e3)
    st.count_outcome("ok", 3)
    st.count_outcome("shed", 0)
    assert st.outcomes == {"ok": 3}


def test_scheduler_resilience_edges_match_jax(pkgs):
    """The scheduler's resilience edges on a pool of 4 usable blocks, in
    both packages: ``quarantine`` (slot to the back of the free list,
    request to the front of the queue, blocks released), ``evict``,
    ``drop_queued``, ``remove_finished``, ``pop_queued`` under
    ``draining``, and the allocator's ``in_use`` and ``reset``."""
    from flexflow_tpu.serving import BlockAllocator as JaxAllocator
    from flexflow_tpu_torch.serving import BlockAllocator

    def run(p):
        alc = (JaxAllocator if p.name == "jax" else BlockAllocator)(5, 8)
        sched = p.ContinuousBatchScheduler(n_slots=2, max_queue=8,
                                           buckets=(8, 16), max_len=16)
        sched.allocator = alc
        reqs = [p.Request(prompt=np.arange(1, 4, dtype=np.int32),
                          max_new_tokens=4, rng_tag=i) for i in range(4)]
        for r in reqs:
            sched.submit(r)
        acts = [sched.next_action()[:3:2] for _ in range(2)]
        for slot in (0, 1):
            sched.commit_token(slot, 7)
        trail = [(acts[0][1], acts[1][1]), alc.in_use]
        q = sched.quarantine(0)
        trail += [q.rng_tag, [r.rng_tag for r in sched.queue],
                  list(sched._free), sched.slot_epoch[:], alc.in_use,
                  q.kv_blocks]
        ev = sched.evict(1, "deadline_exceeded")
        trail += [ev.outcome, sched.evicted, alc.in_use]
        sched.drop_queued(reqs[3], "deadline_exceeded")
        trail += [reqs[3].outcome, [r.rng_tag for r in sched.finished]]
        trail.append(sched.remove_finished(reqs[3]))
        trail.append(sched.remove_finished(reqs[3]))
        sched.draining = True
        trail.append(sched.next_action())
        back = sched.pop_queued()
        trail += [[(r.rng_tag, r.outcome) for r in back], sched.queued]
        alc.reset()
        trail += [alc.in_use, alc.leaked()]
        return trail

    j, t = both(pkgs, run)
    assert t == j
    assert t[2] == 0 and t[3] == [0, 2, 3]  # the retry leads the queue
    assert t[-2:] == [0, []]


def test_request_records_of_a_poisoned_drained_serve_match_jax(pkgs):
    """Request tracing on a scripted clock, one slot: the poisoned first
    request's record carries its ``quarantine`` hop and ends ``ok``, the
    second expires in the queue (``deadline_exceeded``), the third is in
    flight at the SIGTERM and finishes, the fourth is drained
    (``preempted``) — in both packages alike, to the stamps."""
    import flexflow_tpu.obs as jobs
    import flexflow_tpu_torch.obs as tobs

    def run(p):
        obs = jobs if p.name == "jax" else tobs
        rt = obs.enable_reqtrace()
        try:
            eng = engine(p, n_slots=1, exact_decode=True)
            eng.resilience_clock = ScriptedClock(step_ms=5.0)
            res = eng._make_resilience(
                p.ChaosPlan(poison_decode_at={1: 0}, preempt_serving_at=4))
            sched = p.ContinuousBatchScheduler(n_slots=1, max_queue=8,
                                               max_len=eng.max_decode_len,
                                               clock=res.clock)
            for i, pr in enumerate(prompts(4, seed=14)):
                res.admit(sched, p.Request(
                    prompt=np.asarray(pr, np.int32), max_new_tokens=5,
                    rng_tag=i, deadline_ms=70.0 if i == 1 else None))
            eng.serve(sched, resilience=res)
            recs = sorted(rt.records(), key=lambda r: r["rid"])
        finally:
            obs.disable_reqtrace()
        return [(r["outcome"], r["new_tokens"], r["decode_ticks"],
                 [h.get("kind") for h in r["hops"]], r["finish_ms"])
                for r in recs]

    j, t = both(pkgs, run)
    assert t == j
    assert [r[0] for r in t] == ["ok", "deadline_exceeded", "ok",
                                 "preempted"]
    assert t[0][3] == ["quarantine"] and t[0][1] == t[2][1] == 5
    assert t[1][1] == t[3][1] == 0  # expired and drained while queued
