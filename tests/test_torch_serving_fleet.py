"""The serving fleet in the port (``flexflow_tpu_torch/serving/fleet.py``)
against the JAX package's (``tests/test_serving_fleet.py``, its 25 cases):
routing, failover and migration, circuit breakers and probes, partitions,
hedges, the door's shedding and hints, drain and rejoin, the per-replica
plan lint, ``plan_replicas``, the scheduler's cancel hooks, the chaos
ledger and the telemetry block.

Each scenario runs through both packages on the same tiny GPT-2 weights
(``tests/torch_serving_pairs.py``), with the per-token cost pinned
(``force_token_cost_ms``) and a clock that reads the fleet's tick
(``tests/torch_fleet_pairs.py``), so both
routers price and time every decision alike. They must agree on the greedy
streams, the outcome ledger, the per-replica dispatch split, migrations,
failovers and health transitions. Where the JAX law is bitwise across a
re-prefill (a migrated stream against an undisturbed engine), the port's
is greedy identity: its exact decode is not bitwise its prefill (ROADMAP
C), and these streams have no near-tie.
"""
import json
import os
import sys

import numpy as np
import pytest

from torch_fleet_pairs import baseline, fleet_view, make_fleet, set_both
from torch_serving_pairs import both, pkgs, prompts  # noqa: F401

# ------------------------------------------------------------- clean routing
def test_clean_fleet_matches_single_replica_bitwise(pkgs):
    ps = prompts(8, seed=1)

    def run(p):
        fleet = make_fleet(p)
        return baseline(p, ps, 6), fleet.generate(ps, max_new_tokens=6), \
            fleet_view(fleet)

    j, t = both(pkgs, run)
    assert t == j
    base, outs, view = t
    assert outs == base
    assert view["outcomes"] == {"ok": 8}
    assert all(d > 0 for d in view["dispatches"])
    assert sum(view["dispatches"]) == 8


# ------------------------------------------------- failover + migration
def test_kill_replica_migrates_bitwise_ledger_and_recovery(pkgs):
    ps = prompts(10, seed=2)

    def run(p):
        fleet = make_fleet(p)
        chaos = p.FleetChaosPlan(kill_replica_at={4: 0})
        outs = fleet.generate(ps, max_new_tokens=8, chaos=chaos)
        st = fleet.stats
        rec = st.recovery_ticks(st.kill_ticks[0], frac=0.5)
        return (baseline(p, ps, 8), outs, fleet_view(fleet),
                chaos.replicas_killed, fleet.replicas[0].health, rec,
                fleet.health_probe_every)

    j, t = both(pkgs, run)
    assert t == j
    base, outs, v, killed, health, rec, every = t
    assert killed == [0] and outs == base
    assert v["outcomes"] == {"ok": 10}
    assert v["migrations"] >= 1 and v["failovers"] == 1
    assert health == "dead"
    assert sum(v["dispatches"]) == 10 + v["migrations"] + v["requeued"]
    assert v["dispatches"][1] >= v["migrations"]
    assert rec is not None and rec <= every


def test_replica_fatal_error_migrates_instead_of_crashing(pkgs):
    ps = prompts(6, seed=3)

    def run(p):
        fleet = make_fleet(p)
        eng = fleet.replicas[0].engine
        orig = eng._dispatch_decode
        fired = []

        def boom(*a, **kw):
            if not fired and fleet.replicas[0].loop.stats.decode_steps >= 2:
                fired.append(True)
                raise RuntimeError("replica mesh fell off the network")
            return orig(*a, **kw)

        eng._dispatch_decode = boom
        outs = fleet.generate(ps, max_new_tokens=6)
        return (baseline(p, ps, 6), outs, fleet_view(fleet), fired,
                fleet.replicas[0].health)

    j, t = both(pkgs, run)
    assert t == j
    base, outs, v, fired, health = t
    assert fired and outs == base
    assert v["outcomes"] == {"ok": 6} and v["failovers"] == 1
    assert health == "dead"


# ------------------------------------------------------- circuit breaker
def test_circuit_open_zero_dispatch_until_probe_passes(pkgs):
    ps = prompts(8, seed=4)

    def run(p):
        fleet = make_fleet(p)
        sick = fleet.replicas[1]
        sick.circuit.state = "open"
        sick.circuit.opens = 1
        sick.circuit.half_open_at = 6
        sick.health = "quarantined"
        outs = fleet.generate(ps, max_new_tokens=6)
        return outs, fleet_view(fleet), sick.circuit.state

    j, t = both(pkgs, run)
    assert t == j
    outs, v, state = t
    assert all(len(o) == 6 for o in outs) and state == "closed"
    passes = [h for h in v["health"] if h[1] == 1 and h[4] == "probe_pass"]
    assert passes and passes[0][3] == "healthy" and passes[0][0] >= 6
    assert v["dispatches"][0] >= v["dispatches"][1] and v["probes"] >= 1


def test_degraded_replica_quarantined_queue_rescued(pkgs):
    ps = prompts(10, seed=5)

    def run(p):
        fleet = make_fleet(p)
        chaos = p.FleetChaosPlan(degrade_replica_at={3: 1},
                                 degrade_poison_every=1)
        outs = fleet.generate(ps, max_new_tokens=8, chaos=chaos)
        return baseline(p, ps, 8), outs, fleet_view(fleet), p.OUTCOMES

    j, t = both(pkgs, run)
    assert t[:3] == j[:3]
    base, outs, v, outcomes = t
    assert v["degrade_poisons"] >= 1 and v["circuit_opens"] >= 1
    assert any(h[1] == 1 and h[3] == "quarantined" for h in v["health"])
    assert v["requeued"] >= 1
    assert sum(v["outcomes"].values()) == 10
    assert set(v["outcomes"]) <= set(outcomes)
    done = [i for i, o in enumerate(outs) if len(o) == 8]
    assert done and all(outs[i] == base[i] for i in done)


def test_partition_heals_through_half_open_probe(pkgs):
    ps = prompts(8, seed=6)

    def run(p):
        fleet = make_fleet(p)
        chaos = p.FleetChaosPlan(partition_at={3: 0}, partition_ticks=6)
        outs = fleet.generate(ps, max_new_tokens=8, chaos=chaos)
        return baseline(p, ps, 8), outs, fleet_view(fleet)

    j, t = both(pkgs, run)
    assert t == j
    base, outs, v = t
    assert outs == base and v["outcomes"] == {"ok": 8}
    trail = [(h[3], h[4]) for h in v["health"] if h[1] == 0]
    assert ("quarantined", "partition_timeout") in trail
    assert ("healthy", "probe_pass") in trail


# ----------------------------------------------------------------- hedging
def test_hedge_twin_wins_no_double_count_bitwise(pkgs):
    ps = prompts(4, seed=7)
    old = set_both(pkgs, hedge_after_pctl=10.0)
    try:
        def run(p):
            fleet = make_fleet(p, cost=1e-6)
            chaos = p.FleetChaosPlan(partition_at={3: 0},
                                     partition_ticks=30)
            outs = fleet.generate(ps, max_new_tokens=6, chaos=chaos)
            stamps = all(r.first_token_ms > 0 and
                         r.finish_ms >= r.first_token_ms
                         for r in fleet._requests)
            return baseline(p, ps, 6), outs, fleet_view(fleet), stamps

        j, t = both(pkgs, run)
    finally:
        set_both(pkgs, **old)
    assert t == j
    base, outs, v, stamps = t
    assert v["hedges"] >= 1 and v["hedge_twin_wins"] >= 1
    assert v["hedges_cancelled"] >= 1
    assert v["outcomes"] == {"ok": 4} and outs == base and stamps


def test_hedge_adoption_mirrors_latency_stamps(pkgs):
    def run(p):
        fleet = make_fleet(p)
        Hedge = p.fleet._Hedge
        z = np.zeros(3, np.int32)
        pr = p.Request(prompt=z, max_new_tokens=4, rng_tag=0)
        tw = p.Request(prompt=z, max_new_tokens=4, rng_tag=0,
                       generated=[1, 2, 3, 4])
        tw.done, tw.outcome, tw.finish_reason = True, "ok", "length"
        tw.first_token_ms, tw.finish_ms = 123.0, 456.0
        fleet._adopted.append(Hedge(primary=pr, twin=tw, fork=0,
                                    primary_replica=0, twin_replica=1))
        fleet._mirror_adopted()
        p2 = p.Request(prompt=z, max_new_tokens=4, rng_tag=1, generated=[9])
        p2.first_token_ms = 50.0
        t2 = p.Request(prompt=z, max_new_tokens=4, rng_tag=1,
                       generated=[9, 10])
        t2.done, t2.outcome, t2.finish_reason = True, "ok", "length"
        t2.first_token_ms, t2.finish_ms = 50.0, 99.0
        fleet._adopted.append(Hedge(primary=p2, twin=t2, fork=1,
                                    primary_replica=0, twin_replica=1))
        fleet._mirror_adopted()
        return (pr.generated, pr.first_token_ms, pr.finish_ms,
                p2.first_token_ms, p2.finish_ms)

    j, t = both(pkgs, run)
    assert t == j == ([1, 2, 3, 4], 123.0, 456.0, 50.0, 99.0)


def test_hedge_cap_and_idle_target_only(pkgs):
    ps = prompts(8, seed=8)
    old = set_both(pkgs, hedge_after_pctl=1.0)
    try:
        def run(p):
            fleet = make_fleet(p, cost=1e-6, n_slots=1)
            outs = fleet.generate(ps, max_new_tokens=6)
            return fleet.hedge_cap, outs, fleet_view(fleet)

        j, t = both(pkgs, run)
    finally:
        set_both(pkgs, **old)
    assert t == j
    cap, outs, v = t
    assert cap == 1 and v["outcomes"] == {"ok": 8}
    assert all(len(o) == 6 for o in outs)


def test_partition_stranded_streams_survive_to_heal(pkgs):
    ps = prompts(1, seed=15)

    def run(p):
        fleet = make_fleet(p)
        chaos = p.FleetChaosPlan(partition_at={2: 0}, partition_ticks=5)
        outs = fleet.generate(ps, max_new_tokens=6, chaos=chaos)
        return baseline(p, ps, 6), outs, fleet_view(fleet)

    j, t = both(pkgs, run)
    assert t == j
    assert t[1] == t[0] and t[2]["outcomes"] == {"ok": 1}


def test_rejoin_rescues_alive_replicas_work(pkgs):
    ps = prompts(8, seed=16)

    def run(p):
        fleet = make_fleet(p)
        chaos = p.FleetChaosPlan(degrade_replica_at={3: 1},
                                 degrade_poison_every=1, rejoin_at={7: 1})
        outs = fleet.generate(ps, max_new_tokens=10, chaos=chaos)
        # white-box: a rejoin of a replica holding work harvests it
        fleet2 = make_fleet(p)
        fleet2._start(0.0, 0, 0)
        rep = fleet2.replicas[1]
        z = np.zeros(3, np.int32)
        stuck = p.Request(prompt=z, max_new_tokens=4, rng_tag=0)
        queued = p.Request(prompt=z, max_new_tokens=4, rng_tag=1)
        rep.sched.slots[0] = stuck
        rep.sched._free.remove(0)
        rep.sched.queue.append(queued)
        fleet2.rejoin(1)
        order = list(fleet2.queue)
        white = (order[0] is stuck, order[1] is queued,
                 fleet2.stats.migrations, fleet2.stats.requeued,
                 rep.sched.active, rep.sched.queued)
        return baseline(p, ps, 10), outs, fleet_view(fleet), white

    j, t = both(pkgs, run)
    assert t == j
    base, outs, v, white = t
    assert v["rejoins"] == 1 and sum(v["outcomes"].values()) == 8
    done = [i for i, o in enumerate(outs) if len(o) == 10]
    assert done and all(outs[i] == base[i] for i in done)
    assert v["outcomes"].get("ok", 0) == len(done)
    assert white == (True, True, 1, 1, 0, 0)


def test_door_queue_wait_burns_the_deadline_budget(pkgs):
    ps = prompts(2, seed=17)

    def run(p):
        fleet = make_fleet(p)
        for rep in fleet.replicas:
            rep.engine.max_queue = 0  # nothing can dispatch
            rep.circuit.state = "open"
            rep.circuit.half_open_at = None
        outs = fleet.generate(ps, max_new_tokens=4, deadline_ms=1e-6)
        return outs, fleet_view(fleet)

    j, t = both(pkgs, run)
    assert t == j
    assert t[1]["outcomes"] == {"deadline_exceeded": 2}
    assert all(o == [] for o in t[0])


def test_hedge_rescues_failed_primary(pkgs):
    def run(p):
        fleet = make_fleet(p)
        fleet._start(0.0, 0, 0)
        z = np.zeros(3, np.int32)
        pr = p.Request(prompt=z, max_new_tokens=4, rng_tag=0)
        tw = p.Request(prompt=z, max_new_tokens=4, rng_tag=0)
        pr.done = True
        pr.outcome = pr.finish_reason = "deadline_exceeded"
        fleet.replicas[0].sched.finished.append(pr)
        fleet.replicas[1].sched.submit(tw)
        fleet._hedges.append(p.fleet._Hedge(
            primary=pr, twin=tw, fork=0, primary_replica=0,
            twin_replica=1))
        fleet._hedged_ids.add(id(pr))
        fleet._resolve_hedges()
        h = fleet._adopted[-1]
        return (h.winner is tw, len(fleet.replicas[0].sched.finished),
                pr.outcome, pr.done, fleet.replicas[1].sched.queued)

    j, t = both(pkgs, run)
    assert t == j == (True, 0, None, False, 1)


def test_passive_success_cannot_close_open_circuit(pkgs):
    def run(p):
        fleet = make_fleet(p)
        rep = fleet.replicas[0]
        rep.circuit.state = "open"
        rep.circuit.opens = 1
        rep.circuit.half_open_at = 99
        rep.health = "quarantined"
        fleet._circuit_success(rep)
        return rep.circuit.state, rep.health

    j, t = both(pkgs, run)
    assert t == j == ("open", "quarantined")


def test_fleet_sigterm_hands_back_door_queue(pkgs):
    ps = prompts(3, seed=14)

    def run(p):
        fleet = make_fleet(p)
        for rep in fleet.replicas:
            rep.engine.max_queue = 0
        chaos = p.FleetChaosPlan(preempt_serving_at=1)
        outs = fleet.generate(ps, max_new_tokens=4, chaos=chaos)
        return (outs, fleet_view(fleet),
                [r.rng_tag for r in fleet.drained_requests])

    j, t = both(pkgs, run)
    assert t == j
    outs, v, tags = t
    assert v["outcomes"] == {"preempted": 3} and tags == [0, 1, 2]
    assert all(o == [] for o in outs) and v["drains"] == 1


def test_migration_preserves_deadline_budget(pkgs):
    def run(p):
        fleet = make_fleet(p, clock=lambda: 1300.0)
        fleet._start(0.0, 0, 0)
        z = np.zeros(3, np.int32)
        migrated = p.Request(prompt=z, max_new_tokens=4, deadline_ms=100.0)
        migrated.submit_ms = 1234.5
        fresh = p.Request(prompt=z, max_new_tokens=4)
        fleet.queue.extend([migrated, fresh])
        fleet._requests.extend([migrated, fresh])
        fleet._dispatch()
        placed = [r for rep in fleet.replicas if rep.sched is not None
                  for r in rep.sched.queue]
        return (any(r is migrated for r in placed),
                any(r is fresh for r in placed), migrated.submit_ms,
                fresh.submit_ms)

    j, t = both(pkgs, run)
    assert t == j == (True, True, 1234.5, 1300.0)


# --------------------------------------------------- fleet door shedding
def test_fleet_door_queue_shed_ledgered_and_hinted(pkgs):
    ps = prompts(8, seed=9)
    old = set_both(pkgs, shed_policy="queue")
    try:
        def run(p):
            fleet = make_fleet(p, max_queue=4)
            pat, hints = [], []
            for i, pr in enumerate(ps):
                r = p.Request(prompt=np.asarray(pr, np.int32),
                              max_new_tokens=4, rng_tag=i)
                try:
                    fleet.submit(r)
                    pat.append("accept")
                except p.ServingRejection as e:
                    pat.append(type(e).__name__)
                    hints.append(e.retry_after_ms >= 0.0 and
                                 r.outcome == "shed")
            fleet.run()
            return pat, all(hints), fleet_view(fleet)

        j, t = both(pkgs, run)
    finally:
        set_both(pkgs, **old)
    assert t == j
    pat, hints, v = t
    assert pat[:2] == ["accept", "accept"] and hints
    assert set(pat[2:]) == {"OverloadError"}
    assert v["outcomes"] == {"shed": 6, "ok": 2}


def test_retry_after_ms_floored_while_fleet_degraded(pkgs):
    def run(p):
        fleet = make_fleet(p, cost=None)
        out = [fleet.retry_after_ms()]
        fleet.replicas[1].circuit.state = "open"
        out.append(fleet.retry_after_ms())
        fleet.replicas[1].circuit.state = "closed"
        fleet.replicas[0].health = "draining"
        out.append(fleet.retry_after_ms())
        fleet.replicas[0].health = "healthy"
        for rep in fleet.replicas:
            fleet._make_loop(rep)
            rep.engine.admission.force_token_cost_ms = 10.0
        busy = p.Request(prompt=np.zeros(4, np.int32), max_new_tokens=50)
        fleet.replicas[0].sched.slots[0] = busy
        out.append(fleet.retry_after_ms())
        other = p.Request(prompt=np.zeros(4, np.int32), max_new_tokens=10)
        fleet.replicas[1].sched.slots[0] = other
        out.append(fleet.retry_after_ms())
        return out, p.FLEET_MIN_RETRY_AFTER_MS

    j, t = both(pkgs, run)
    assert t == j
    out, floor = t
    assert out[0] == 0.0 and out[1] >= floor > 0 and out[2] >= floor
    assert out[3] == 0.0 and out[4] == pytest.approx(50.0)


# --------------------------------------------------------- drain / rejoin
def test_rolling_drain_and_rejoin_zero_downtime(pkgs):
    ps = prompts(10, seed=10)

    def run(p):
        fleet = make_fleet(p)
        chaos = p.FleetChaosPlan(drain_replica_at={2: 0}, rejoin_at={12: 0})
        outs = fleet.generate(ps, max_new_tokens=8, chaos=chaos)
        return baseline(p, ps, 8), outs, fleet_view(fleet)

    j, t = both(pkgs, run)
    assert t == j
    base, outs, v = t
    assert outs == base and v["outcomes"] == {"ok": 10}
    assert v["drains"] == 1 and v["rejoins"] == 1
    trail = [(h[3], h[4]) for h in v["health"] if h[1] == 0]
    for want in (("draining", "drain_requested"), ("dead", "drained"),
                 ("quarantined", "rejoin_probation"),
                 ("healthy", "probe_pass")):
        assert want in trail


# ----------------------------------------------------------- plan lint
def test_fleet_plan_lint_names_the_bad_replica(pkgs):
    import flexflow_tpu.analysis as janalysis
    import flexflow_tpu.parallel.strategies as jstr
    import flexflow_tpu_torch.analysis as tanalysis
    import flexflow_tpu_torch.parallel.strategies as tstr

    mods = {"jax": (janalysis, jstr), "torch": (tanalysis, tstr)}

    def run(p):
        analysis, strategies = mods[p.name]
        pcg = p.ff.executor.pcg
        bad = strategies.hybrid_data_tensor_strategy(pcg, 2, 4)
        guid = next(g for g, ns in bad.node_strategies.items()
                    if ns.weight_specs)
        ns = bad.node_strategies[guid]
        ns.weight_specs[next(iter(ns.weight_specs))] = (None, "bogus_axis")
        with pytest.raises(analysis.StaticAnalysisError) as ei:
            p.ServingFleet(p.ff, n_replicas=2, n_slots=2,
                           max_decode_len=16, plans=[None, bad])
        msg = str(ei.value)
        ok = p.ServingFleet(
            p.ff, n_replicas=2, n_slots=2, max_decode_len=16,
            plans=[None, strategies.hybrid_data_tensor_strategy(pcg, 2, 1)])
        return ("replica 1" in msg, "FF006" in msg, "replica 0" in msg,
                ok.n_replicas)

    j, t = both(pkgs, run)
    assert t == j == (True, True, False, 2)


def test_plan_replicas_heterogeneous_generations(pkgs):
    """The port prices each replica on its own ``GPUMachineModel``
    (generations are its keys); the plans are fleet inputs that pass the
    per-replica lint."""
    p = pkgs["torch"]
    plans = p.plan_replicas(p.ff.executor.pcg, p.ff.config, [4, 8],
                            generations=["h100-pcie", "h100-sxm"])
    assert len(plans) == 2 and all(pl.sim_tokens_per_s > 0 for pl in plans)
    assert plans[0].sim.machine.generation == "h100-pcie"
    assert plans[1].sim.machine.generation == "h100-sxm"
    fleet = p.ServingFleet(p.ff, n_replicas=2, n_slots=2, max_decode_len=16,
                           plans=plans)
    assert fleet.replicas[0].plan is plans[0]
    assert fleet.replicas[1].engine.plan is plans[1]
    with pytest.raises(ValueError, match="unknown generation"):
        p.plan_replicas(p.ff.executor.pcg, p.ff.config, [4],
                        generations=["v5e"])


# ------------------------------------------------------- scheduler hooks
def test_scheduler_cancel_hooks_leave_no_ledger_entry(pkgs):
    def run(p):
        sched = p.ContinuousBatchScheduler(n_slots=2, max_queue=4,
                                           max_len=32)
        z = np.zeros(3, np.int32)
        a = p.Request(prompt=z, max_new_tokens=4)
        b = p.Request(prompt=z, max_new_tokens=4)
        sched.submit(a)
        sched.submit(b)
        out = [sched.next_action()[0]]
        got = sched.cancel_slot(0)
        out += [got is a, a.outcome, a.done, len(sched.finished),
                sched.active]
        sched.cancel_queued(b)
        out += [sched.queued, len(sched.finished), sched.cancelled]
        with pytest.raises(ValueError):
            sched.cancel_queued(b)
        c = p.Request(prompt=z, max_new_tokens=1)
        sched.submit(c)
        _, _req, slot, _b = sched.next_action()
        sched.commit_token(slot, 7)
        out += [len(sched.finished), c.outcome, sched.remove_finished(c),
                len(sched.finished), sched.remove_finished(c),
                sched.cancelled]
        return out

    j, t = both(pkgs, run)
    assert t == j
    assert t == ["prefill", True, None, False, 0, 0, 0, 0, 2, 1, "ok",
                 True, 0, False, 3]


# ----------------------------------------------------------- end to end
def test_fleet_chaos_end_to_end_ledger_conserved(pkgs):
    ps = prompts(12, seed=11)
    old = set_both(pkgs, shed_policy="queue")
    try:
        def run(p):
            fleet = make_fleet(p, n_replicas=3, max_queue=20)
            chaos = p.FleetChaosPlan(kill_replica_at={4: 0},
                                     degrade_replica_at={6: 1},
                                     degrade_poison_every=1)
            outs = fleet.generate(ps, max_new_tokens=8, chaos=chaos)
            return baseline(p, ps, 8), outs, fleet_view(fleet), p.OUTCOMES

        j, t = both(pkgs, run)
    finally:
        set_both(pkgs, **old)
    assert t[:3] == j[:3]
    base, outs, v, outcomes = t
    assert sum(v["outcomes"].values()) == 12
    assert set(v["outcomes"]) <= set(outcomes)
    assert v["failovers"] == 1 and v["migrations"] >= 1
    assert v["circuit_opens"] >= 1
    done = [i for i, o in enumerate(outs) if len(o) == 8]
    assert done and all(outs[i] == base[i] for i in done)
    assert v["outcomes"].get("ok", 0) == len(done)


def test_fleet_telemetry_block_and_trace_digest(pkgs, tmp_path, capsys):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    import trace_summary

    ps = prompts(6, seed=12)

    def run(p):
        tel = tmp_path / f"fleet_{p.name}.json"
        p.ff.config.telemetry_file = str(tel)
        try:
            fleet = make_fleet(p)
            fleet.generate(ps, max_new_tokens=4,
                           chaos=p.FleetChaosPlan(kill_replica_at={3: 0}))
        finally:
            p.ff.config.telemetry_file = ""
        blk = json.loads(tel.read_text())["fleet"]
        trace_summary.main([str(tel)])
        out = capsys.readouterr().out
        return ({k: blk[k] for k in ("replicas", "outcomes", "failovers",
                                     "dispatches", "migrations")},
                "fleet: 2 replicas" in out, "failovers: 1" in out)

    j, t = both(pkgs, run)
    assert t == j
    blk, named, failed = t
    assert blk["replicas"] == 2 and blk["outcomes"] == {"ok": 6}
    assert blk["failovers"] == 1 and sum(blk["dispatches"]) >= 6
    assert named and failed


def test_plain_chaosplan_fleet_run_is_clean(pkgs):
    ps = prompts(4, seed=13)

    def run(p):
        fleet = make_fleet(p)
        outs = fleet.generate(ps, max_new_tokens=4, chaos=p.ChaosPlan())
        return outs, fleet_view(fleet)

    j, t = both(pkgs, run)
    assert t == j
    assert t[1]["outcomes"] == {"ok": 4}
    assert all(len(o) == 4 for o in t[0])
