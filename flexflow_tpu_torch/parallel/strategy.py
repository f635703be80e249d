"""Parallelization strategy: per-op sharding assignments over the mesh.

A copy of ``flexflow_tpu.parallel.strategy`` — the reference's search
output, the map ``op -> MachineView`` (``optimal_views``,
graph.cc:2163-2320), plus the parallel-op placements. A ``Strategy``
assigns every PCG node:

* ``view``: a MachineView (kept for parity/serialization),
* per-weight spec entries (one per tensor dim: None, a mesh axis name or
  a tuple of names),
* an optional output spec (what parallel ops pin).

Strategies serialize to JSON for ``--export-strategy`` /
``--import-strategy`` (reference: config.h:143-144, README.md:84-86): the
same text the JAX package writes for the same PCG, so a file moves
between the packages either way. The port's executor applies a strategy
over a ``torch.distributed`` device mesh (``parallel/spmd.py``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Sequence, Tuple

from ..machine_view import MachineView
from .pcg import PCG

# A spec entry is None or a mesh-axis name or tuple of names, one per tensor dim
SpecT = Tuple[Optional[Any], ...]


@dataclasses.dataclass
class NodeStrategy:
    view: MachineView = dataclasses.field(
        default_factory=lambda: MachineView(dim=(1,)))
    weight_specs: Dict[str, SpecT] = dataclasses.field(default_factory=dict)
    output_spec: Optional[SpecT] = None  # constraint on output 0
    # op-level overrides applied at lowering (e.g. sequence_parallel_axis for
    # ring attention); merged into the op's attrs by the Executor
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Strategy:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    node_strategies: Dict[int, NodeStrategy] = dataclasses.field(
        default_factory=dict)
    # input batch sharding axis (the data-parallel dim)
    data_axis: str = "data"
    # GPipe pipeline selected by the search: (pp, dp, n_micro); None =
    # pure SPMD. A grid trains through parallel/pipeline.PipelineTrainer.
    pipeline: Optional[Tuple[int, int, int]] = None
    # pipeline schedule the search chose: gpipe | 1f1b |
    # interleaved, or "" = unset (strategy predates the schedule axis /
    # was not searched — the trainer then runs the classic gpipe
    # fill-drain). Only meaningful when ``pipeline`` is set; ``--schedule``
    # overrides either way.
    schedule: str = ""
    # virtual stage chunks per pipeline device for the interleaved
    # schedule (Megatron interleaved-1F1B's v); 1 for gpipe/1f1b
    virtual_stages: int = 1
    # activation-rematerialization level the search chose:
    # none | selective | full, or "" = unset (strategy predates the remat
    # axis / was not searched). The distinction matters: an explicit
    # "none" is a searched decision, while "" lets the execution defaults
    # apply — Executor blocks default to none, PipelineTrainer stages to
    # the classic GPipe full remat. ``--remat`` overrides either way.
    remat: str = ""
    # multi-host placement: (ici_shape, dcn_shape) with
    # ici[i] * dcn[i] == mesh_shape[i]; the mesh is then built with
    # build_hybrid_mesh so an axis's DCN factor never splits an ICI ring
    # (reference: inter- vs intra-node placement, simulator.h:212-606)
    hybrid: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None
    # pod-level assignment from the hierarchical multi-pod search
    # (docs/multipod.md): (pod count, mode, grad accumulation factor)
    # where mode is "dp" (FSDP-style cross-pod data parallel) or
    # "pipeline" (pods as pipeline stages — the grid itself rides
    # ``pipeline``/``schedule``). None = single-pod / flat-searched.
    pods: Optional[Tuple[int, str, int]] = None

    def for_node(self, guid: int) -> NodeStrategy:
        return self.node_strategies.setdefault(guid, NodeStrategy())

    def describe(self) -> str:
        """Compact human-readable plan id ("mesh=(4, 2) remat=selective"),
        used by strategy-fallback telemetry/obs events and error diagnoses
        (resilience/fallback.py, docs/strategy_safety.md)."""
        bits = [f"mesh={tuple(self.mesh_shape)}"]
        if self.pipeline:
            bits.append(f"pipeline={tuple(self.pipeline)}")
            from .pipeline import describe_schedule

            sched = describe_schedule(self.schedule, self.virtual_stages)
            if sched:
                bits.append(f"schedule={sched}")
        if self.remat and self.remat != "none":
            bits.append(f"remat={self.remat}")
        if self.hybrid:
            bits.append(f"dcn={tuple(self.hybrid[1])}")
        if self.pods:
            bits.append(describe_pods(self.pods))
        return " ".join(bits)

    # -- serialization (reference: export_strategy_file) ------------------------
    def to_json(self, pcg: PCG) -> str:
        out = {
            "mesh_shape": list(self.mesh_shape),
            "axis_names": list(self.axis_names),
            "data_axis": self.data_axis,
            "pipeline": list(self.pipeline) if self.pipeline else None,
            "schedule": self.schedule,
            "virtual_stages": self.virtual_stages,
            "remat": self.remat,
            "hybrid": [list(self.hybrid[0]), list(self.hybrid[1])]
            if self.hybrid else None,
            "pods": list(self.pods) if self.pods else None,
            "nodes": {},
        }
        for guid, ns in self.node_strategies.items():
            if guid not in pcg.nodes:
                continue
            name = pcg.nodes[guid].name
            out["nodes"][name] = {
                "view": {"dim": list(ns.view.dim),
                         "stride": list(ns.view.stride),
                         "start": ns.view.start_device_id},
                "weight_specs": {k: list(v) for k, v in ns.weight_specs.items()},
                "output_spec": list(ns.output_spec) if ns.output_spec else None,
                "extra": {k: v for k, v in ns.extra.items()
                          if isinstance(v, (str, int, float, bool))},
            }
        return json.dumps(out, indent=2)

    @staticmethod
    def from_json(text: str, pcg: PCG) -> "Strategy":
        d = json.loads(text)
        s = Strategy(mesh_shape=tuple(d["mesh_shape"]),
                     axis_names=tuple(d["axis_names"]),
                     data_axis=d.get("data_axis", "data"),
                     pipeline=tuple(d["pipeline"])
                     if d.get("pipeline") else None,
                     schedule=d.get("schedule", "") or "",
                     virtual_stages=int(d.get("virtual_stages", 1) or 1),
                     remat=d.get("remat", "") or "",
                     hybrid=(tuple(d["hybrid"][0]), tuple(d["hybrid"][1]))
                     if d.get("hybrid") else None,
                     pods=(int(d["pods"][0]), str(d["pods"][1]),
                           int(d["pods"][2]))
                     if d.get("pods") else None)
        by_name = {n.name: n.guid for n in pcg.topo_order()}
        for name, nd in d["nodes"].items():
            if name not in by_name:
                continue
            v = nd["view"]
            ns = NodeStrategy(
                view=MachineView(dim=tuple(v["dim"]), stride=tuple(v["stride"]),
                                 start_device_id=v.get("start", 0)),
                weight_specs={k: _despec(x) for k, x in
                              nd.get("weight_specs", {}).items()},
                output_spec=_despec(nd["output_spec"])
                if nd.get("output_spec") else None,
                extra=dict(nd.get("extra", {})))
            s.node_strategies[by_name[name]] = ns
        return s


def _despec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def describe_pods(pods: Tuple[int, str, int]) -> str:
    """Compact pod-plan id ("pods=2:dp" / "pods=2:dp(ga=4)") shared by
    Strategy.describe, RankedCandidate.describe and trace_summary — one
    vocabulary for the pod-level assignment everywhere it prints."""
    n, mode, ga = pods
    s = f"pods={n}:{mode}"
    if int(ga or 1) > 1:
        s += f"(ga={ga})"
    return s


def data_parallel_strategy(pcg: PCG, num_devices: int,
                           axis_names: Sequence[str] = ("data",),
                           ) -> Strategy:
    """The reference's default DataParallelism strategy (config.h:95-100,
    mapper.cc:414-427): batch dim sharded over all devices, weights replicated.
    """
    s = Strategy(mesh_shape=(num_devices,), axis_names=tuple(axis_names)[:1],
                 data_axis=tuple(axis_names)[0])
    view = MachineView.data_parallel(num_devices)
    for node in pcg.topo_order():
        ns = s.for_node(node.guid)
        ns.view = view
    return s
