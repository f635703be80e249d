"""Per-op measured profiling (a copy of ``flexflow_tpu.obs.profile``).

``Executor.profile_ops`` (the ProfiledStep mode) times every distinct op
shape of the live graph on the card (CUDA events around a captured graph
of the node, as ``Simulator.measure_operator_cost`` times an op) and this
module turns those raw timings into :class:`OpRecord`\\ s keyed by the SAME
``(op params, in-shapes, OpSharding, dcn)`` signature the Simulator's
op-cost cache uses (``Simulator.op_cost``'s key, docs/search.md), so
measured and predicted costs join on one key with no fuzzy matching.

Records flow three ways (docs/calibration.md):

* the process tracer — one retroactive Perfetto span per profiled op;
* a JSONL profile file (``--profile-ops PATH``) — the artifact
  ``--calibrate-from-trace`` replays into ``calibrate_from_profile``;
* the drift sentinel (``obs.drift``, ROADMAP A.6 part 2).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class OpRecord:
    """One profiled op shape. ``key`` is ``repr(Simulator._op_key(node,
    in_shapes))`` — the string form of the per-key calibration index, and
    the join column between a JSONL profile and a live graph's cost
    model. ``sharding``/``dcn`` complete the op-cost cache signature the
    measurement was taken under."""

    name: str
    op_type: str
    key: str
    in_shapes: List[List[int]]
    sharding: Dict[str, Any]
    dcn: Tuple[int, int]
    measured_fwd_s: float
    predicted_fwd_s: Optional[float] = None
    count: int = 1  # nodes sharing this key (BERT's 24 layers -> 1 record)
    step: int = 0
    generation: str = ""
    dtype: str = ""

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["event"] = "op_profile"
        d["dcn"] = list(self.dcn)
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "OpRecord":
        fields = {f.name for f in dataclasses.fields(OpRecord)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw["dcn"] = tuple(kw.get("dcn") or (1, 1))
        kw["in_shapes"] = [list(s) for s in kw.get("in_shapes", [])]
        return OpRecord(**kw)


class OpProfile:
    """A set of :class:`OpRecord`\\ s — what ``calibrate_from_profile``
    consumes and what ``--profile-ops`` streams as JSONL (one record per
    line, append mode: successive profiled passes of one run land in one
    file, distinguished by ``step``)."""

    def __init__(self, records: Optional[List[OpRecord]] = None):
        self.records: List[OpRecord] = list(records or [])

    def __len__(self) -> int:
        return len(self.records)

    def latest_by_key(self) -> Dict[str, OpRecord]:
        """Last-written record per join key — later profiled passes
        supersede earlier ones when a file holds several."""
        out: Dict[str, OpRecord] = {}
        for r in self.records:
            out[r.key] = r
        return out

    def write_jsonl(self, path: str, append: bool = True) -> str:
        with open(path, "a" if append else "w") as f:
            for r in self.records:
                f.write(json.dumps(r.to_json(), default=str) + "\n")
        return path

    @staticmethod
    def read_jsonl(path: str) -> "OpProfile":
        """Load a profile file; unknown event kinds and malformed lines
        are skipped (the tracer's JSONL sink interleaves other events)."""
        records = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if d.get("event") not in (None, "op_profile") or \
                        "measured_fwd_s" not in d or "key" not in d:
                    continue
                try:
                    records.append(OpRecord.from_json(d))
                except (TypeError, ValueError):
                    # valid JSON but not a complete record (hand-edited,
                    # foreign writer): skipped like any malformed line
                    continue
        return OpProfile(records)


def live_assignment(model) -> Tuple[Dict[int, Any], Tuple[int, int]]:
    """Per-node ``OpSharding`` of the LIVE plan plus its dcn placement —
    what keys this model's measured costs against the simulator's.

    A searched compile keeps the winner's exact per-op assignment on
    ``model._search_result`` (unity_search adopts the rewritten graph into
    the model's PCG in place, so the guids align); a data-parallel or
    imported strategy falls back to ``OpSharding(dp=<data-axis size>)``
    with the resolved remat level — the same sharding the dp baseline is
    priced under."""
    from ..search.simulator import OpSharding

    pcg = model.pcg
    plan = getattr(model.executor, "remat_plan", None)
    if plan is not None:
        remat = plan.level
    else:
        remat = (getattr(model.strategy, "remat", "") or "none")
    res = getattr(model, "_search_result", None)
    if res is not None and res.assignment:
        a = {g: sh for g, sh in res.assignment.items() if g in pcg.nodes}
        if a:
            out = {n.guid: a.get(n.guid, OpSharding(remat=remat))
                   for n in pcg.compute_nodes()}
            return out, tuple(res.dcn)
    dp = 1
    if model.mesh is not None and model.strategy is not None:
        try:
            dp = int(model.mesh.shape[model.strategy.data_axis])
        except (KeyError, TypeError):
            dp = 1
    return ({n.guid: OpSharding(dp=dp, remat=remat)
             for n in pcg.compute_nodes()}, (1, 1))


def profile_model(model, device_xs, iters: int = 3, step: int = 0,
                  sim=None) -> List[OpRecord]:
    """Run one ProfiledStep pass over the model's graph and assemble
    join-keyed :class:`OpRecord`\\ s. ``device_xs`` is one input batch at
    the compiled batch size (device-put with the executor's shardings).
    When ``sim`` is given each record also carries the simulator's
    predicted forward time under the live sharding — the profile file is
    then self-contained for post-hoc drift analysis."""
    from ..search.simulator import Simulator

    raw = model.executor.profile_ops(model.params, device_xs, iters=iters)
    assignment, dcn = live_assignment(model)
    generation = ""
    dtype = ""
    if sim is not None:
        generation = getattr(sim.machine, "generation", "") or ""
        dtype = getattr(sim, "dtype_label", "") or ""
    records: List[OpRecord] = []
    for r in raw:
        node = model.pcg.nodes[r["guid"]]
        sh = assignment.get(r["guid"])
        if sh is None:
            continue
        predicted = None
        if sim is not None:
            old = (sim.dp_dcn, sim.tp_dcn)
            sim.set_axis_topology(*dcn)
            try:
                predicted = sim.op_cost(node, r["in_shapes"],
                                        sh).forward_time
            finally:
                sim.set_axis_topology(*old)
        records.append(OpRecord(
            name=r["name"], op_type=r["op_type"],
            key=repr(Simulator._op_key(node, r["in_shapes"])),
            in_shapes=[list(s) for s in r["in_shapes"]],
            sharding=dataclasses.asdict(sh), dcn=tuple(dcn),
            measured_fwd_s=r["measured_fwd_s"],
            predicted_fwd_s=predicted, count=r["count"], step=step,
            generation=generation, dtype=dtype))
    return records
