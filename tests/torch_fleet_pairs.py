"""Shared harness of the port's fleet parity tests
(tests/test_torch_serving_fleet.py, test_torch_tenancy.py,
test_torch_request_journal.py): a fleet built alike in either package with
the per-token cost pinned on every replica and a clock that reads the
router's tick, so both routers price and time every decision alike, and
the views of a run both must agree on.
"""
from torch_serving_pairs import engine

COST_MS = 1.0


class TickClock:
    """A fleet clock that reads the router's tick (ms): decisions keyed on
    time then depend on the tick sequence only, not on how often either
    package reads its clock."""

    def __init__(self, step_ms=10.0, base=1000.0):
        self.fleet = None
        self.step_ms = step_ms
        self.base = base

    def __call__(self):
        tick = self.fleet.tick_no if self.fleet is not None else 0
        return self.base + tick * self.step_ms


def make_fleet(p, cost=COST_MS, **kw):
    """The JAX file's fleet: 2 replicas of 2 slots, exact decode; the cost
    pinned on every replica and the tick clock."""
    kw.setdefault("n_replicas", 2)
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_decode_len", 16)
    kw.setdefault("exact_decode", True)
    clock = kw.pop("clock", None) or TickClock()
    fleet = p.ServingFleet(p.ff, clock=clock, **kw)
    if isinstance(clock, TickClock):
        clock.fleet = fleet
    if cost is not None:
        for rep in fleet.replicas:
            rep.engine.admission.force_token_cost_ms = cost
    return fleet


def baseline(p, ps, max_new):
    return engine(p, exact_decode=True).generate(ps, max_new_tokens=max_new)


def fleet_view(fleet):
    """What both routers must agree on."""
    st = fleet.stats
    return dict(outcomes=dict(st.outcomes), dispatches=list(st.dispatches),
                migrations=st.migrations, requeued=st.requeued,
                failovers=st.failovers, hedges=st.hedges,
                hedge_twin_wins=st.hedge_twin_wins,
                hedges_cancelled=st.hedges_cancelled,
                circuit_opens=st.circuit_opens, probes=st.probes,
                probe_failures=st.probe_failures, drains=st.drains,
                rejoins=st.rejoins, degrade_poisons=st.degrade_poisons,
                affinity_hits=st.affinity_hits, ticks=st.ticks,
                health=[tuple(t) for t in st.health_transitions],
                kill_ticks=list(st.kill_ticks))


def set_both(pkgs, **fields):
    old = {k: getattr(pkgs["jax"].ff.config, k) for k in fields}
    for p in pkgs.values():
        for k, v in fields.items():
            setattr(p.ff.config, k, v)
    return old
