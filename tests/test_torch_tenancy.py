"""Tenancy at the serving fleet's door in the port
(``flexflow_tpu_torch/serving/tenancy.py`` and ``fleet.py``) against the
JAX package (``tests/test_multitenant.py``, its 16 cases): the tier spec
and registry, the flags and their preflight, the weighted fair queue's pop
order, the isolation law under a batch flood, quota verdicts and their
hints, the per-tier shed order, the tenant-priced retry hint, the
admission controller's warm start with its per-tenant EWMAs, the
autoscaler up and down, the ledgers under chaos, the tenant rows of the
telemetry and the request trace, and ``scripts/capacity_plan.py`` reading
a request trace the port's fleet wrote.

Scenarios run through both packages on the same tiny GPT-2 weights with
the per-token cost pinned and the fleet's tick as its clock
(``tests/torch_fleet_pairs.py``); the routers must agree on streams,
ledgers and dispatch.
"""
import json
import os
import sys

import numpy as np
import pytest

import flexflow_tpu as fj
import flexflow_tpu.obs.reqtrace as jrt
import flexflow_tpu.resilience.preflight as jpre
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.obs.reqtrace as trt
import flexflow_tpu_torch.resilience.preflight as tpre
from torch_fleet_pairs import COST_MS, fleet_view, make_fleet, set_both
from torch_serving_pairs import both, pkgs, prompts  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

PRE = {"jax": (fj, jpre), "torch": (ft, tpre)}


@pytest.fixture(autouse=True)
def _reset_reqtrace():
    yield
    jrt.disable_reqtrace()
    trt.disable_reqtrace()


def req(p, pr, i, tenant=None, max_new=6, **kw):
    return p.Request(prompt=np.asarray(pr, np.int32), max_new_tokens=max_new,
                     rng_tag=i, tenant=tenant, **kw)


def submit_all(p, fleet, reqs):
    for r in reqs:
        try:
            fleet.submit(r)
        except p.ServingRejection:
            pass


def tenant_view(st):
    return dict(requests=dict(st.tenant_requests),
                outcomes={t: dict(v) for t, v in st.tenant_outcomes.items()},
                tokens=dict(st.tenant_tokens), quota_sheds=st.quota_sheds,
                storm=st.storm_requests, ups=st.autoscale_ups,
                downs=st.autoscale_downs,
                events=[tuple(e) for e in st.autoscale_events])


def pin_scale_ups(fleet):
    """A replica the autoscaler adds gets the pinned cost too, so both
    routers keep pricing alike after a scale-up."""
    orig = fleet._scale_up

    def scale_up():
        orig()
        fleet.replicas[-1].engine.admission.force_token_cost_ms = COST_MS

    fleet._scale_up = scale_up


# ----------------------------------------------------------- tier registry
def test_parse_tenant_tiers_and_registry(pkgs):
    def run(p):
        pols = p.parse_tenant_tiers("gold:8:500:1000,bronze:1")
        out = [(pol.weight, pol.deadline_ms, pol.quota_tokens_per_s,
                pol.shed_priority) for pol in pols.values()]
        for bad in ("gold", "gold:0", "gold:-1", "gold:2:x", "a:1,a:2",
                    "gold:1:2:3:4", ":1"):
            with pytest.raises(ValueError):
                p.parse_tenant_tiers(bad)
        reg = p.TenantRegistry()
        std, unknown = reg.policy(None), reg.policy("acme")
        return (out, p.parse_tenant_tiers(""), std.name, unknown.name,
                unknown.weight == std.weight,
                reg.policy("interactive").weight > std.weight >
                reg.policy("batch").weight, reg.max_shed_priority())

    j, t = both(pkgs, run)
    assert t == j
    assert t[0] == [(8.0, 500.0, 1000.0, 1), (1.0, 0.0, 0.0, 1)]
    assert t[1:] == ({}, "standard", "acme", True, True, 2)


def test_tier_flags_parse_and_preflight_mirror(pkgs):
    def run(p):
        pkg, pre = PRE[p.name]
        config = pkg.FFConfig()
        config.parse_args(["--tenant-tiers", "gold:8:500", "--autoscale",
                           "on", "--min-replicas", "1",
                           "--max-replicas", "4"])
        pre.preflight_config(config)
        out = [config.tenant_tiers, config.autoscale]
        for argv in (["--tenant-tiers", "gold:0"],
                     ["--autoscale", "sometimes"], ["--min-replicas", "2"],
                     ["--autoscale", "on", "--min-replicas", "4",
                      "--max-replicas", "2"]):
            with pytest.raises(ValueError):
                pkg.FFConfig().parse_args(argv)
        bad = pkg.FFConfig()
        bad.tenant_tiers = "gold:-3"
        with pytest.raises(pre.PreflightError):
            pre.preflight_config(bad)
        bad2 = pkg.FFConfig()
        bad2.min_replicas = 2
        with pytest.raises(pre.PreflightError):
            pre.preflight_config(bad2)
        return out

    j, t = both(pkgs, run)
    assert t == j == ["gold:8:500", "on"]


# ------------------------------------------------------------- WFQ laws
def test_wfq_fifo_degeneration_single_tenant(pkgs):
    def run(p):
        q = p.WeightedFairQueue(p.TenantRegistry())
        reqs = [req(p, [1], i, max_new=3 + (i % 5)) for i in range(12)]
        for r in reqs:
            q.append(r)
        return [q.popleft() is r for r in reqs]

    j, t = both(pkgs, run)
    assert t == j == [True] * 12


def test_wfq_weighted_share_no_starvation(pkgs):
    def run(p):
        q = p.WeightedFairQueue(p.TenantRegistry())
        for i in range(24):
            q.append(req(p, [1], i, tenant="batch", max_new=4))
        for i in range(8):
            q.append(req(p, [1], 100 + i, tenant="interactive", max_new=4))
        return [(r.tenant, r.rng_tag) for r in
                (q.popleft() for _ in range(len(q)))]

    j, t = both(pkgs, run)
    assert t == j
    order = [tenant for tenant, _ in t]
    assert order[:12].count("interactive") == 8 and "batch" in order[:12]
    assert order.count("batch") == 24


def test_wfq_deque_compat_rescue_lane_first(pkgs):
    def run(p):
        q = p.WeightedFairQueue(p.TenantRegistry())
        a, b = req(p, [1], 0, tenant="batch"), req(p, [1], 1, tenant="batch")
        q.extend([a, b])
        rescued = req(p, [1], 2, tenant="interactive")
        q.appendleft(rescued)
        out = [list(q)[0] is rescued, len(q)]
        del q[1]
        out += [q.popleft() is rescued, q.popleft() is b, bool(q),
                q.queued_by_tenant()]
        return out

    j, t = both(pkgs, run)
    assert t == j == [True, 3, True, True, False, {}]


# ------------------------------------------------- the isolation law
def test_bitwise_isolation_under_batch_flood(pkgs):
    ps = prompts(5, seed=21)
    flood_ps = prompts(8, seed=22)

    def run(p):
        solo = make_fleet(p)
        solo_reqs = [req(p, pr, i, tenant="interactive")
                     for i, pr in enumerate(ps)]
        submit_all(p, solo, solo_reqs)
        solo.run()
        mixed = make_fleet(p)
        flood = [req(p, pr, 100 + i, tenant="batch", max_new=8)
                 for i, pr in enumerate(flood_ps)]
        mixed_reqs = [req(p, pr, i, tenant="interactive")
                      for i, pr in enumerate(ps)]
        submit_all(p, mixed, flood + mixed_reqs)
        mixed.run()
        return ([list(r.generated) for r in solo_reqs],
                [list(r.generated) for r in mixed_reqs],
                [list(r.generated) for r in flood],
                dict(solo.stats.outcomes), tenant_view(mixed.stats),
                fleet_view(mixed))

    j, t = both(pkgs, run)
    assert t == j
    solo, mixed, _flood, solo_led, tv, _v = t
    assert mixed == solo and solo_led == {"ok": 5}
    assert tv["requests"] == {"batch": 8, "interactive": 5}
    for tenant, n in tv["requests"].items():
        assert sum(tv["outcomes"][tenant].values()) == n
    assert tv["outcomes"]["interactive"] == {"ok": 5}
    assert tv["tokens"]["interactive"] == 5 * 6


# ---------------------------------------------------- quotas + shedding
def test_quota_exceeded_ledgered_with_refill_hint(pkgs):
    old = set_both(pkgs, tenant_tiers="metered:4:0:10")
    try:
        def run(p):
            fleet = make_fleet(p)
            ok = req(p, prompts(1, seed=23)[0], 0, tenant="metered",
                     max_new=8)
            fleet.submit(ok)
            over = req(p, prompts(1, seed=24)[0], 1, tenant="metered",
                       max_new=8)
            with pytest.raises(p.QuotaExceededError) as ei:
                fleet.submit(over)
            hint = ei.value.retry_after_ms
            fleet.run()
            return (hint, over.outcome, tenant_view(fleet.stats),
                    fleet_view(fleet), "quota_exceeded" in p.OUTCOMES)

        j, t = both(pkgs, run)
    finally:
        set_both(pkgs, **old)
    assert t == j
    hint, outcome, tv, v, listed = t
    assert hint > 0.0 and outcome == "quota_exceeded" and listed
    assert tv["quota_sheds"] == 1
    assert tv["outcomes"]["metered"] == {"ok": 1, "quota_exceeded": 1}
    assert sum(v["outcomes"].values()) == 2


def test_shed_priority_tiers_order_the_door(pkgs):
    old = set_both(pkgs, shed_policy="queue")
    try:
        def run(p):
            fleet = make_fleet(p, max_queue=8)
            return [fleet._shed_highwater(fleet.tenants.policy(t))
                    for t in (None, "batch", "interactive")]

        j, t = both(pkgs, run)
    finally:
        set_both(pkgs, **old)
    assert t == j == [4, 2, 8]


def test_retry_after_prices_tenant_queue_position(pkgs):
    ps = prompts(10, seed=25)

    def run(p):
        fleet = make_fleet(p, cost=10.0)
        baseline = fleet.retry_after_ms()
        for i, pr in enumerate(ps):
            fleet.queue.append(req(p, pr, i, tenant="batch", max_new=10))
        return (baseline, fleet.retry_after_ms(),
                fleet.retry_after_ms("batch"),
                fleet.retry_after_ms("interactive"))

    j, t = both(pkgs, run)
    assert t == j
    base, agg, batch, inter = t
    assert agg == base and batch > inter >= 0.0 and batch >= 10.0


# ----------------------------------------- admission EWMA warm carry
def test_admission_warm_start_carries_cost_model(pkgs):
    def run(p):
        warm = p.AdmissionController()
        warm.observe_step(0.010, 2, tenants=["gold"])
        warm.observe_step(0.010, 2, tenants=["gold"])
        cold = p.AdmissionController()
        cold.warm_start(warm)
        busy = p.AdmissionController()
        busy.observe_step(0.050, 1)
        before = busy.token_cost_ms
        busy.warm_start(warm)
        return (warm.observed_steps, cold.observed_steps,
                cold.token_cost_ms, cold.token_cost_ms_for("gold"),
                warm.token_cost_ms_for("gold"), cold.force_token_cost_ms,
                busy.token_cost_ms == before, busy.observed_steps,
                cold.token_cost_ms_for(None), cold.token_cost_ms_for("x"))

    j, t = both(pkgs, run)
    assert t == j
    assert t[:2] == (2, 2) and t[2] == pytest.approx(5.0)
    assert t[3] == t[4] and t[5] is None and t[6] and t[7] == 1
    assert t[8] == t[9] == t[2]


# -------------------------------------------------- autoscaler + chaos
def test_autoscale_up_on_traffic_step_recovery_budget(pkgs):
    ps = prompts(5, seed=26)
    old = set_both(pkgs, autoscale="on", min_replicas=2, max_replicas=3)
    try:
        def run(p):
            fleet = make_fleet(p, max_queue=16)
            pin_scale_ups(fleet)
            chaos = p.FleetChaosPlan(
                traffic_step_at={3: (6, 2)}, storm_tenant="batch",
                fleet_storm_max_new=6, fleet_storm_prompt_tokens=3)
            reqs = [req(p, pr, i, tenant="interactive")
                    for i, pr in enumerate(ps)]
            submit_all(p, fleet, reqs)
            fleet.run(chaos=chaos)
            st = fleet.stats
            return (tenant_view(st), fleet_view(fleet), len(fleet.replicas),
                    st.surge_recovery_ticks(3),
                    [list(r.generated) for r in reqs])

        j, t = both(pkgs, run)
    finally:
        set_both(pkgs, autoscale="off", min_replicas=0, max_replicas=0)
    assert t == j
    tv, v, n_rep, rec, streams = t
    assert tv["storm"] == 12 and tv["ups"] >= 1 and n_rep <= 3
    trail = [(h[3], h[4]) for h in v["health"] if h[1] >= 2]
    assert ("quarantined", "autoscale_probation") in trail
    assert ("healthy", "probe_pass") in trail
    assert rec is not None and rec <= 60
    assert sum(v["outcomes"].values()) == 5 + 12
    for tenant, n in tv["requests"].items():
        assert sum(tv["outcomes"][tenant].values()) == n
    assert tv["outcomes"]["interactive"] == {"ok": 5}
    assert all(len(s) == 6 for s in streams)


def test_scale_down_drains_without_dropping_streams(pkgs):
    ps = prompts(2, seed=27)
    old = set_both(pkgs, autoscale="on", min_replicas=1, max_replicas=3)
    try:
        def run(p):
            fleet = make_fleet(p, n_replicas=3)
            fleet.autoscale_down_after = 2
            reqs = [req(p, pr, i, tenant="standard", max_new=8)
                    for i, pr in enumerate(ps)]
            submit_all(p, fleet, reqs)
            fleet.run()
            return (tenant_view(fleet.stats), fleet_view(fleet),
                    len(fleet._serving_replicas()),
                    [list(r.generated) for r in reqs])

        j, t = both(pkgs, run)
    finally:
        set_both(pkgs, autoscale="off", min_replicas=0, max_replicas=0)
    assert t == j
    tv, v, serving, streams = t
    assert tv["downs"] >= 1 and serving >= 1
    assert v["outcomes"] == {"ok": 2} and all(len(s) == 8 for s in streams)
    assert v["drains"] >= 1
    assert ("draining", "drain_requested") in [(h[3], h[4])
                                               for h in v["health"]]


def test_multitenant_drain_kill_ledger_conserved(pkgs):
    ps = prompts(9, seed=28)
    tenants = ["interactive", "batch", None] * 3

    def run(p):
        solo = make_fleet(p, n_replicas=3)
        solo_reqs = [req(p, pr, i, tenant=tn)
                     for i, (pr, tn) in enumerate(zip(ps, tenants))]
        submit_all(p, solo, solo_reqs)
        solo.run()
        fleet = make_fleet(p, n_replicas=3)
        chaos = p.FleetChaosPlan(drain_replica_at={2: 1}, rejoin_at={14: 1},
                                 kill_replica_at={5: 0})
        reqs = [req(p, pr, i, tenant=tn)
                for i, (pr, tn) in enumerate(zip(ps, tenants))]
        submit_all(p, fleet, reqs)
        fleet.run(chaos=chaos)
        return (tenant_view(fleet.stats), fleet_view(fleet),
                [r.outcome for r in reqs], [list(r.generated) for r in reqs],
                [list(r.generated) for r in solo_reqs], p.OUTCOMES)

    j, t = both(pkgs, run)
    assert t[:5] == j[:5]
    tv, v, outcomes, streams, solo, allowed = t
    assert sum(v["outcomes"].values()) == 9
    assert set(v["outcomes"]) <= set(allowed)
    assert tv["requests"] == {"interactive": 3, "batch": 3}
    for tenant, n in tv["requests"].items():
        assert sum(tv["outcomes"][tenant].values()) == n
    assert sum(sum(o.values()) for o in tv["outcomes"].values()) == 6
    done = [i for i, o in enumerate(outcomes) if o == "ok"]
    assert done and all(streams[i] == solo[i] for i in done)


# ------------------------------------------------ observability surface
def test_tenant_storm_and_telemetry_rows(pkgs, tmp_path):
    ps = prompts(4, seed=29)

    def run(p):
        tel = tmp_path / f"tel_{p.name}.json"
        p.ff.config.telemetry_file = str(tel)
        try:
            fleet = make_fleet(p)
            chaos = p.FleetChaosPlan(tenant_storm_at={2: ("batch", 3)},
                                     fleet_storm_max_new=4,
                                     fleet_storm_prompt_tokens=3)
            fleet.generate(ps, max_new_tokens=4, chaos=chaos)
        finally:
            p.ff.config.telemetry_file = ""
        blk = json.loads(tel.read_text())["fleet"]
        return tenant_view(fleet.stats), fleet_view(fleet), blk["tenants"]

    j, t = both(pkgs, run)
    assert t == j
    tv, v, rows = t
    assert tv["storm"] == 3 and tv["requests"].get("batch") == 3
    assert sum(v["outcomes"].values()) == 7
    assert rows["batch"]["requests"] == 3
    assert sum(rows["batch"]["outcomes"].values()) == 3


def test_trace_summary_tenant_digest_and_degradation(pkgs, tmp_path,
                                                     capsys):
    import trace_summary

    ps = prompts(4, seed=30)
    rts = {"jax": jrt, "torch": trt}

    def run(p):
        trace = tmp_path / f"req_{p.name}.jsonl"
        rts[p.name].enable_reqtrace(jsonl_file=str(trace))
        try:
            fleet = make_fleet(p)
            reqs = [req(p, pr, i,
                        tenant=("interactive" if i % 2 else "batch"))
                    for i, pr in enumerate(ps)]
            submit_all(p, fleet, reqs)
            fleet.run()
        finally:
            rts[p.name].disable_reqtrace()
        capsys.readouterr()
        trace_summary.main([str(trace)])
        out = capsys.readouterr().out
        old = tmp_path / f"old_{p.name}.jsonl"
        with open(trace) as f, open(old, "w") as g:
            for line in f:
                rec = json.loads(line)
                rec.pop("tenant", None)
                g.write(json.dumps(rec) + "\n")
        trace_summary.main([str(old)])
        out2 = capsys.readouterr().out
        recs = [json.loads(line) for line in open(trace)
                if json.loads(line).get("kind") == "request"]
        return ("interactive" in out and "batch" in out,
                "request trace: 4 requests" in out2,
                sorted((r["tenant"], r["outcome"], r["new_tokens"])
                       for r in recs))

    j, t = both(pkgs, run)
    assert t == j
    assert t[0] and t[1] and len(t[2]) == 4


def test_capacity_plan_replay_smoke(pkgs, tmp_path, capsys):
    """The offline planner answers on a synthetic trace, degrades to a note
    on a foreign file, and reads a request trace the port's fleet wrote as
    it reads the JAX fleet's."""
    import capacity_plan

    trace = tmp_path / "cap.jsonl"
    with open(trace, "w") as f:
        for i in range(16):
            f.write(json.dumps({
                "kind": "request", "arrival_ms": 1000.0 + 4.0 * i,
                "max_new_tokens": 6, "new_tokens": 6,
                "decode_ticks": 6, "decode_ms": 12.0,
                "tenant": ("interactive" if i % 2 else "batch")}) + "\n")
    rc = capacity_plan.main([str(trace), "--target-p99-ms", "200",
                             "--max-replicas", "3", "--slots", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and "interactive" in out and "batch" in out
    assert "answer:" in out
    empty = tmp_path / "empty.jsonl"
    empty.write_text("{\"kind\": \"span\"}\n")
    assert capacity_plan.main([str(empty)]) == 0
    assert "nothing to replay" in capsys.readouterr().out

    ps = prompts(6, seed=31)
    rts = {"jax": jrt, "torch": trt}

    def run(p):
        path = tmp_path / f"fleet_{p.name}.jsonl"
        rts[p.name].enable_reqtrace(jsonl_file=str(path))
        try:
            fleet = make_fleet(p)
            submit_all(p, fleet, [
                req(p, pr, i, tenant=("interactive" if i % 2 else "batch"))
                for i, pr in enumerate(ps)])
            fleet.run()
        finally:
            rts[p.name].disable_reqtrace()
        capsys.readouterr()
        rc = capacity_plan.main([str(path), "--target-p99-ms", "500",
                                 "--max-replicas", "3", "--slots", "2",
                                 "--token-cost-ms", "2.0"])
        out = capsys.readouterr().out
        return rc, "interactive" in out and "batch" in out, \
            "answer:" in out, "nothing to replay" in out

    j, t = both(pkgs, run)
    assert t == (0, True, True, False)
    assert j == t
