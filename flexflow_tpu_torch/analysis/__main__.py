"""ShardLint CLI: statically verify a (model, strategy) pair from the shell
(port of ``flexflow_tpu.analysis.__main__``, the same flags and exit
codes).

    python -m flexflow_tpu_torch.analysis --model mlp --strategy hybrid --tp 2
    python -m flexflow_tpu_torch.analysis --model attention --strategy \
        hybrid --inject duplicate        # demo: FF001 doubled reduction
    python -m flexflow_tpu_torch.analysis --model mlp \
        --strategy /path/to/exported_strategy.json

Builds the demo model's PCG (no parameters, no devices, no compile — the
whole point), resolves the strategy (a built-in family or an
``--export-strategy`` JSON file), optionally injects a graph-level
wrong-reshard defect (the ``resilience.chaos`` injection, so the CLI can
demonstrate exactly what the cascade's stage 0 rejects), runs the
analyzer, and prints one diagnostic per line with rule ID and fix hint.
Exit status: 0 clean, 1 diagnostics with errors, 2 usage error.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from . import analyze_strategy
from .report import AnalysisReport


def _build_demo(model: str):
    """A tiny model of the requested family, as (FFModel, PCG), built on
    the CPU (nothing runs: no parameters, no compile)."""
    from .. import FFConfig, FFModel

    cfg = FFConfig()
    ff = FFModel(cfg, device="cpu")
    if model == "mlp":
        # 3 dense layers so hybrid/tp plans have a row-parallel MIDDLE
        # layer — a partial-sum producer with consumers, i.e. an
        # --inject-able reduction site (the last layer's partial sum has
        # no consumers to mis-serve)
        x = ff.create_tensor((8, 16), name="x")
        t = ff.dense(x, 32, name="d1")
        t = ff.relu(t)
        t = ff.dense(t, 32, name="d2")
        t = ff.relu(t)
        t = ff.dense(t, 10, name="d3")
    elif model == "attention":
        x = ff.create_tensor((8, 16, 32), name="x")
        t = ff.multihead_attention(x, x, x, embed_dim=32, num_heads=4,
                                   name="attn")
        t = ff.dense(t, 32, name="proj")
        t = ff.relu(t)
        t = ff.dense(t, 10, name="head")
    else:
        print(f"error: unknown --model {model!r} (mlp|attention)",
              file=sys.stderr)
        raise SystemExit(2)
    return ff, ff.create_pcg()


def _resolve_strategy(pcg, kind: str, dp: int, tp: int):
    from ..parallel.strategies import hybrid_data_tensor_strategy
    from ..parallel.strategy import Strategy, data_parallel_strategy

    if kind.endswith(".json"):
        try:
            with open(kind) as f:
                return Strategy.from_json(f.read(), pcg)
        except Exception as e:
            print(f"error: cannot load strategy from {kind!r}: {e}",
                  file=sys.stderr)
            raise SystemExit(2)
    if kind == "dp":
        return data_parallel_strategy(pcg, dp)
    if kind in ("tp", "hybrid"):
        return hybrid_data_tensor_strategy(pcg, dp if kind == "hybrid"
                                           else 1, tp)
    if kind == "pipeline":
        s = data_parallel_strategy(pcg, dp)
        s.pipeline = (2, max(dp // 2, 1), 2)
        return s
    if kind == "remat":
        s = data_parallel_strategy(pcg, dp)
        s.remat = "selective"
        return s
    print(f"error: unknown --strategy {kind!r} "
          "(dp|tp|hybrid|pipeline|remat|*.json)", file=sys.stderr)
    raise SystemExit(2)


def _print_report(report: AnalysisReport, as_json: bool,
                  header: str) -> None:
    if as_json:
        print(json.dumps({
            "strategy": report.strategy_desc,
            "checked": list(report.checked),
            "diagnostics": [{
                "rule": d.rule_id, "node": d.node, "severity": d.severity,
                "message": d.message, "fix": d.fix_hint,
            } for d in report.diagnostics],
            **report.telemetry_block(),
        }, indent=2))
        return
    print(header)
    for d in report.diagnostics:
        print("  " + d.format_line())
    n_err = len(report.errors)
    verdict = "FAIL" if n_err else "clean"
    print(f"  {len(report.diagnostics)} diagnostic(s), {n_err} error(s) "
          f"-- {verdict} (rules checked: {', '.join(report.checked)})")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.analysis",
        description="ShardLint: static sharding/dataflow verification of "
                    "a parallel plan")
    ap.add_argument("--model", default="mlp",
                    help="demo model family: mlp | attention")
    ap.add_argument("--strategy", default="hybrid",
                    help="dp | tp | hybrid | pipeline | remat, or a "
                         "--export-strategy JSON file")
    ap.add_argument("--dp", type=int, default=4,
                    help="data-parallel degree of the built-in strategies")
    ap.add_argument("--tp", type=int, default=2,
                    help="tensor-parallel degree of tp/hybrid strategies")
    ap.add_argument("--inject", default="none",
                    choices=("none", "drop", "duplicate"),
                    help="inject a graph-level wrong-reshard defect "
                         "before analyzing (FF001 demo)")
    ap.add_argument("--serving", action="store_true",
                    help="also run the serving-state reachability check "
                         "(FF005)")
    ap.add_argument("--placements", action="store_true",
                    help="dump the per-tensor placement lattice")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    _ff, pcg = _build_demo(args.model)
    strategy = _resolve_strategy(pcg, args.strategy, args.dp, args.tp)
    injected = ""
    if args.inject != "none":
        from ..resilience.chaos import inject_wrong_reshard

        try:
            injected = inject_wrong_reshard(pcg, strategy,
                                            mode=args.inject)
        except ValueError as e:
            print(f"error: cannot --inject {args.inject}: {e}",
                  file=sys.stderr)
            return 2
    report = analyze_strategy(pcg, strategy, serving=args.serving)
    header = (f"ShardLint: model={args.model} "
              f"strategy='{strategy.describe()}' nodes={len(pcg)}")
    if injected:
        header += f" [injected: {injected}]"
    _print_report(report, args.as_json, header)
    if args.placements and not args.as_json:
        from .interp import interpret

        for (guid, idx), place in sorted(
                interpret(pcg, strategy).values.items()):
            node = pcg.nodes.get(guid)
            if node is not None:
                print(f"  {node.name}[{idx}]: {place.describe()}")
    return 1 if report.errors else 0


if __name__ == "__main__":
    sys.exit(main())
