"""Preflight: the strategy audit and the batch check, before any step
runs (port of ``flexflow_tpu.resilience.preflight``).

* ``preflight_strategy`` — strategy-vs-machine divisibility: mesh size vs
  ranks, batch vs data-parallel degree, every spec axis exists in the
  mesh, sharded weight and output dims divide their axis size, hybrid
  ICI x DCN factors multiply out, pipeline grid sanity, remat level.
  ``FFModel.compile`` runs it on explicit and imported strategies (the
  untrusted inputs). The per-node spec half is the JAX package's FF006
  checker (``analysis/rules.check_shapes``), copied here privately; the
  rest of the static analyzer comes with the search.
* ``preflight_config`` — flag-combination sanity that needs the assembled
  config (``--resume auto`` without a checkpoint dir, non-positive
  ``--audit-tol``, retention that would delete the checkpoint resume
  needs, the serving, fleet, tenancy and journal flags), run first by
  ``FFModel.compile``.
* ``validate_batch`` — fit / eval / predict arrays against the compiled
  signature: a mis-shaped or mis-typed batch raises a ``ValueError``
  naming the tensor and the axis.

Strategy failures raise :class:`PreflightError` (a ``ValueError``) whose
message says what to change, in the JAX package's words.
"""
from __future__ import annotations

import os
from typing import Any, Optional, Sequence

import numpy as np

from ..ffconst import LossType, dtype_to_torch


class PreflightError(ValueError):
    """A strategy / flag / batch combination that cannot run; the message
    is actionable (names the offending piece and what to change)."""


# ----------------------------------------------------------------- config
def preflight_config(config) -> None:
    """Flag-combination sanity on the assembled config
    (flexflow_tpu/resilience/preflight.py:45-212): everything here would
    otherwise fail mid-run with a far less helpful error. ``compile`` runs
    it first, so a value set as an attribute is judged like a parsed one.
    A ``--calibrate-from-trace`` naming a missing file raises
    :class:`PreflightError` (the JAX copy's function-local ``import os``
    makes that read raise ``UnboundLocalError`` instead)."""
    fb = (getattr(config, "strategy_fallback", "on") or "on")
    if fb not in ("on", "off"):
        raise PreflightError(
            f"--strategy-fallback expects on|off, got {fb!r}")
    tol = getattr(config, "audit_tol", 0.05)
    if tol is not None and float(tol) <= 0:
        raise PreflightError(
            f"--audit-tol must be > 0 (got {tol}): the audit compares "
            "relative loss/grad-norm error against it")
    if int(getattr(config, "memory_budget_mb", 0) or 0) < 0:
        raise PreflightError(
            "--memory-budget-mb must be >= 0 (0 disables the compile-time "
            "OOM check)")
    if getattr(config, "checkpoint_dir", "") and \
            int(getattr(config, "keep_checkpoints", 3) or 0) < 1:
        raise PreflightError(
            "--keep-checkpoints must keep at least 1 committed checkpoint; "
            "retention 0 would delete the checkpoint --resume and the "
            "divergence sentinel roll back to")
    if (getattr(config, "resume", "") or "").strip() == "auto" and \
            not getattr(config, "checkpoint_dir", ""):
        raise PreflightError(
            "--resume auto needs --checkpoint-dir to know where committed "
            "checkpoints live; pass --checkpoint-dir DIR or give --resume "
            "an explicit step_N checkpoint path")
    remat = (getattr(config, "remat", "") or "")
    if remat and remat not in ("none", "selective", "full"):
        raise PreflightError(
            f"--remat expects none|selective|full, got {remat!r}")
    sched = (getattr(config, "schedule", "") or "")
    if sched and sched not in ("gpipe", "1f1b", "interleaved"):
        raise PreflightError(
            f"--schedule expects gpipe|1f1b|interleaved, got {sched!r}")
    vstages = int(getattr(config, "pipeline_virtual_stages", 0) or 0)
    if vstages and vstages < 2:
        raise PreflightError(
            f"--virtual-stages must be >= 2 (got {vstages}): v=1 IS the "
            "1f1b schedule — use --schedule 1f1b instead")
    if vstages and sched and sched != "interleaved":
        raise PreflightError(
            "--virtual-stages only applies to the interleaved schedule; "
            "use --schedule interleaved or drop --virtual-stages")
    co = (getattr(config, "collective_overlap", "off") or "off")
    if co not in ("on", "off"):
        raise PreflightError(
            f"--collective-overlap expects on|off, got {co!r}")
    sa = (getattr(config, "static_analysis", "on") or "on")
    if sa not in ("on", "off", "strict"):
        raise PreflightError(
            f"--static-analysis expects on|off|strict, got {sa!r}")
    dt = getattr(config, "drift_tolerance", 0.25)
    if dt is not None and float(dt) <= 0:
        raise PreflightError(
            f"--drift-tolerance must be > 0 (got {dt}): it is the "
            "half-width of the sim-vs-measured band the drift sentinel "
            "alerts on")
    if getattr(config, "auto_recalibrate", False) and \
            not getattr(config, "profile_ops", ""):
        raise PreflightError(
            "--auto-recalibrate needs --profile-ops PATH: the closed loop "
            "repairs calibration from the profiled pass's measurements")
    trace = (getattr(config, "calibrate_from_trace", "") or "")
    if trace and not os.path.isfile(trace):
        raise PreflightError(
            f"--calibrate-from-trace {trace!r}: no such profile file "
            "(produce one with --profile-ops)")
    pods = int(getattr(config, "num_pods", 0) or 0)
    if pods < 0:
        raise PreflightError(
            f"--pods must be >= 0 (got {pods}); 0 keeps the detected "
            "topology, N >= 1 splits the machine into N DCN-connected "
            "pods")
    gbps = float(getattr(config, "dcn_gbps", 0.0) or 0.0)
    if gbps < 0:
        raise PreflightError(
            f"--dcn-gbps must be >= 0 (got {gbps}); 0 keeps the "
            "generation default, > 0 overrides the per-pod DCN "
            "bandwidth in GB/s")
    if gbps > 0 and pods < 2 and \
            not getattr(config, "machine_model_file", ""):
        raise PreflightError(
            "--dcn-gbps needs a multi-pod topology to apply to: set "
            "--pods N >= 2 (or a --machine-model-file with num_pods)")
    hs = (getattr(config, "search_hierarchical", "auto") or "auto")
    if hs not in ("auto", "on", "off"):
        raise PreflightError(
            f"--hierarchical-search expects auto|on|off, got {hs!r}")
    sl = (getattr(config, "serve_loop", "sync") or "sync")
    if sl not in ("sync", "async"):
        raise PreflightError(
            f"--serve-loop expects sync|async, got {sl!r}: sync is the "
            "blocking reference loop, async the double-buffered runtime "
            "(bitwise-identical streams under exact decode)")
    raw_ss = getattr(config, "seq_shards", 1)
    ss = int(raw_ss if raw_ss is not None else 1)
    if ss < 1:
        raise PreflightError(
            f"--seq-shards must be >= 1 (got {ss}): it is the number of "
            "contiguous block-table shards a decode step scores across "
            "(1 = unsharded)")
    if ss > 1 and getattr(config, "kv_cache", "paged") == "ring":
        raise PreflightError(
            "--seq-shards > 1 requires --kv-cache paged: the ring "
            "layout has no block tables to partition into per-shard "
            "contiguous runs")
    cb = getattr(config, "context_buckets", "") or ""
    if cb:
        from ..serving.kvcache import parse_context_buckets

        try:
            parse_context_buckets(cb)
        except ValueError as e:
            raise PreflightError(str(e))
        if getattr(config, "kv_cache", "paged") == "ring":
            raise PreflightError(
                "--context-buckets requires --kv-cache paged: buckets "
                "route requests to sequence-sharded block-table "
                "partitions")
    asc = (getattr(config, "autoscale", "off") or "off")
    if asc not in ("on", "off"):
        raise PreflightError(
            f"--autoscale expects on|off, got {asc!r}")
    mn = int(getattr(config, "min_replicas", 0) or 0)
    mx = int(getattr(config, "max_replicas", 0) or 0)
    if mn < 0 or mx < 0:
        raise PreflightError(
            f"--min-replicas/--max-replicas must be >= 0 (got {mn}/{mx}); "
            "0 defaults to the initial fleet size / twice it")
    if (mn or mx) and asc != "on":
        raise PreflightError(
            "--min-replicas/--max-replicas bound the autoscaler's pool "
            "and are only meaningful with --autoscale on")
    if mn and mx and mx < mn:
        raise PreflightError(
            f"--max-replicas ({mx}) must be >= --min-replicas ({mn})")
    tiers = getattr(config, "tenant_tiers", "") or ""
    if tiers:
        from ..serving.tenancy import parse_tenant_tiers

        try:
            parse_tenant_tiers(tiers)
        except ValueError as e:
            raise PreflightError(str(e))
    jdir = getattr(config, "request_journal", "") or ""
    jsync = float(getattr(config, "journal_sync_ms", 0.0) or 0.0)
    jevery = int(getattr(config, "journal_commit_every", 0) or 0)
    if jsync < 0 or jevery < 0:
        raise PreflightError(
            f"--journal-sync-ms/--journal-commit-every must be >= 0 "
            f"(got {jsync:g}/{jevery})")
    if (jsync or jevery) and not jdir:
        raise PreflightError(
            "--journal-sync-ms/--journal-commit-every tune the "
            "write-ahead request journal and are only meaningful with "
            "--request-journal DIR (docs/durability.md)")
    if jdir:
        parent = os.path.dirname(os.path.abspath(jdir))
        if not os.path.isdir(parent):
            raise PreflightError(
                f"--request-journal parent directory does not exist: "
                f"{parent} — the journal cannot be made durable on a "
                "path that cannot be created")


# --------------------------------------------------------------- strategy
def preflight_strategy(pcg, strategy, n_dev: int, batch_size: int,
                       spec_checks: bool = True) -> None:
    """Static divisibility audit of a Strategy against the machine it is
    about to compile for. Raises :class:`PreflightError` with the offending
    node / axis named; a passing strategy may still fail XLA (that is what
    the fallback cascade's compile check is for) but cannot fail on any of
    the arithmetic checked here."""
    ms = tuple(int(s) for s in strategy.mesh_shape)
    axes = tuple(strategy.axis_names)
    if len(axes) != len(ms):
        raise PreflightError(
            f"strategy mesh {ms} has {len(ms)} dims but axis_names {axes} "
            f"names {len(axes)}; every mesh dim needs exactly one axis name")
    if len(set(axes)) != len(axes):
        raise PreflightError(f"strategy axis_names {axes} contain "
                             "duplicates; mesh axes must be distinct")
    need = int(np.prod(ms)) if ms else 1
    if need > n_dev:
        raise PreflightError(
            f"strategy needs {need} devices (mesh {ms}) but only {n_dev} "
            "are visible; re-run the search on this machine, pass a "
            "smaller --mesh-shape, or restore a checkpointed run via "
            "resilience.elastic_restore (re-plans for the surviving "
            "devices)")
    if strategy.data_axis not in axes:
        raise PreflightError(
            f"strategy data_axis {strategy.data_axis!r} is not one of the "
            f"mesh axes {axes}")
    dp = ms[axes.index(strategy.data_axis)]
    if dp and batch_size % dp:
        raise PreflightError(
            f"batch size {batch_size} is not divisible by the "
            f"data-parallel degree {dp} of mesh {ms}; use a batch that is "
            f"a multiple of {dp} or a strategy whose dp divides the batch")
    if strategy.hybrid:
        ici, dcn = strategy.hybrid
        if len(ici) != len(ms) or len(dcn) != len(ms) or any(
                int(i) * int(d) != m for i, d, m in zip(ici, dcn, ms)):
            raise PreflightError(
                f"hybrid layout ici={tuple(ici)} x dcn={tuple(dcn)} does "
                f"not factor the mesh {ms}: each axis needs "
                "ici[i] * dcn[i] == mesh_shape[i]")
    if strategy.remat and strategy.remat not in ("none", "selective",
                                                 "full"):
        raise PreflightError(
            f"strategy remat level {strategy.remat!r} is not one of "
            "none|selective|full")
    sched = (getattr(strategy, "schedule", "") or "")
    vstages = int(getattr(strategy, "virtual_stages", 1) or 1)
    if sched and sched not in ("gpipe", "1f1b", "interleaved"):
        raise PreflightError(
            f"strategy schedule {sched!r} is not one of "
            "gpipe|1f1b|interleaved")
    if sched and not strategy.pipeline:
        raise PreflightError(
            f"strategy sets schedule={sched!r} without a pipeline grid: "
            "the schedule knob orders pipeline microbatches — add "
            "pipeline=(pp, dp, n_micro) or drop the schedule")
    if strategy.pipeline:
        pp, pdp, micro = (int(v) for v in strategy.pipeline)
        if pp < 2:
            raise PreflightError(
                f"pipeline grid {strategy.pipeline}: pp must be >= 2 "
                "(pp=1 is plain SPMD — drop the pipeline field)")
        if pp * pdp > n_dev:
            raise PreflightError(
                f"pipeline grid pp={pp} x dp={pdp} needs {pp * pdp} "
                f"devices but only {n_dev} are visible")
        if micro < 1 or batch_size % micro or (batch_size // micro) % \
                max(pdp, 1):
            raise PreflightError(
                f"pipeline grid {strategy.pipeline}: batch {batch_size} "
                f"must split into {micro} microbatches each divisible by "
                f"dp={pdp}")
        # (schedule, pp, n_micro, v) combos (docs/pipeline.md):
        # each failure names the knob to change
        if sched == "interleaved":
            if vstages < 2:
                raise PreflightError(
                    f"interleaved schedule needs virtual_stages >= 2 "
                    f"(got {vstages}); virtual_stages=1 IS the 1f1b "
                    "schedule — set schedule='1f1b' or raise "
                    "virtual_stages")
            if micro % pp:
                raise PreflightError(
                    f"interleaved schedule: n_micro={micro} must be a "
                    f"multiple of pp={pp} (microbatches advance in "
                    "rounds of pp through the virtual chunks) — change "
                    "n_micro or use schedule='1f1b'")
        elif vstages != 1:
            raise PreflightError(
                f"virtual_stages={vstages} only applies to the "
                f"interleaved schedule (got schedule="
                f"{sched or 'gpipe'!r}); set virtual_stages=1")
        n_chunks = pp * (vstages if sched == "interleaved" else 1)
        n_nodes = len(pcg.compute_nodes())
        if n_chunks > n_nodes:
            raise PreflightError(
                f"schedule {sched or 'gpipe'!r} needs pp*v = {pp}*"
                f"{vstages if sched == 'interleaved' else 1} = "
                f"{n_chunks} stage chunks but the graph has only "
                f"{n_nodes} compute nodes; lower virtual_stages (v) or "
                "the pipeline depth pp")

    # per-node spec dataflow (axis exists, sharded dims divide): the JAX
    # package's ShardLint FF006 checker, copied privately below, with its
    # messages and first-failure semantics. ``spec_checks=False`` lets a
    # caller that already ran that walk skip it.
    if not spec_checks:
        return
    msgs = _spec_errors(pcg, strategy)
    if msgs:
        raise PreflightError(msgs[0])


_FF006_HINT = ("use a mesh whose axis sizes divide the sharded dims, or "
               "drop the offending spec entry")


def _spec_errors(pcg, strategy):
    """The FF006 walk (flexflow_tpu/analysis/rules.py:279-328): a message
    per spec entry naming an axis the mesh lacks or a dim its axis size
    does not divide, in node order."""
    from ..parallel.spmd import entry_axes

    axes = tuple(strategy.axis_names)
    axis_size = dict(zip(axes, (int(s) for s in strategy.mesh_shape)))
    out = []

    def check_spec(where: str, spec, shape) -> None:
        for dim, e in enumerate(spec or ()):
            for a in entry_axes(e):
                if a not in axis_size:
                    out.append(f"{where}: PartitionSpec names mesh axis "
                               f"{a!r} (dim {dim}) but the strategy's "
                               f"mesh axes are {axes}")
                    continue
                sz = axis_size[a]
                if shape is not None and dim < len(shape) and sz > 1 and \
                        shape[dim] % sz:
                    out.append(f"{where}: dim {dim} has size "
                               f"{shape[dim]}, not divisible by mesh "
                               f"axis {a!r} (size {sz}); the plan "
                               "cannot shard it evenly")

    for guid, ns in strategy.node_strategies.items():
        node = pcg.nodes.get(guid) if pcg is not None else None
        name = node.name if node is not None else f"node guid {guid}"
        wshapes = {}
        if node is not None and ns.weight_specs:
            in_shapes = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
            wshapes = {w: tuple(s) for w, (s, _d, _i) in
                       node.op.weight_specs(in_shapes).items()}
        for wname, spec in (ns.weight_specs or {}).items():
            check_spec(f"{name}.{wname}", spec, wshapes.get(wname))
        if ns.output_spec:
            oshape = (tuple(node.out_shapes[0])
                      if node is not None and node.out_shapes else None)
            check_spec(f"{name} output", ns.output_spec, oshape)
    return out


# ------------------------------------------------------------------ batch

_KIND_NAMES = {"f": "floating", "i": "integer", "u": "integer",
               "b": "boolean", "c": "complex"}


def _kind(dt) -> str:
    k = np.dtype(dt).kind
    if k in ("f", "V"):  # bfloat16 surfaces as a void-kind numpy dtype
        return "f"
    if k in ("i", "u"):
        return "i"
    return k


def _numpy_dtype(dt):
    import torch

    t = dtype_to_torch(dt)
    if t == torch.bfloat16:
        return np.dtype("V2")
    return torch.empty((), dtype=t).numpy().dtype


def validate_batch(ffmodel, xs: Sequence[Any], y: Optional[Any] = None,
                   phase: str = "fit") -> None:
    """Validate fit/eval/predict arrays against the compiled signature."""
    input_nodes = ffmodel.pcg.input_nodes()
    if len(xs) != len(input_nodes):
        names = [n.name for n in input_nodes]
        raise ValueError(
            f"{phase}: model has {len(input_nodes)} input tensor(s) "
            f"{names} but got {len(xs)} array(s)")
    n0 = None
    first_name = None
    for node, a in zip(input_nodes, xs):
        a = np.asarray(a)
        want = tuple(node.out_shapes[0])
        got = tuple(a.shape)
        if len(got) != len(want):
            raise ValueError(
                f"{phase}: batch for input '{node.name}' has rank "
                f"{len(got)} (shape {got}) but the compiled signature "
                f"expects rank {len(want)} (declared shape {want}, leading "
                "axis = batch)")
        for ax in range(1, len(want)):
            if got[ax] != int(want[ax]):
                raise ValueError(
                    f"{phase}: batch for input '{node.name}' mismatches "
                    f"the compiled signature on axis {ax}: got {got[ax]} "
                    f"(shape {got}), expected {want[ax]} (declared shape "
                    f"{want})")
        want_dt = _numpy_dtype(node.out_dtypes[0])
        if _kind(a.dtype) != _kind(want_dt):
            raise ValueError(
                f"{phase}: batch for input '{node.name}' has "
                f"{_KIND_NAMES.get(_kind(a.dtype), _kind(a.dtype))} dtype "
                f"{a.dtype} but the compiled signature expects a "
                f"{_KIND_NAMES.get(_kind(want_dt), _kind(want_dt))} tensor "
                f"({node.out_dtypes[0].name}); cast the array before "
                f"{phase}")
        if n0 is None:
            n0, first_name = got[0], node.name
        elif got[0] != n0:
            raise ValueError(
                f"{phase}: input '{node.name}' has {got[0]} samples but "
                f"'{first_name}' has {n0}; all inputs must share the "
                "leading batch axis")
    if y is None:
        return
    y = np.asarray(y)
    if n0 is not None and y.shape[0] != n0:
        raise ValueError(
            f"{phase}: label batch has {y.shape[0]} samples but the "
            f"inputs have {n0}; labels must share the leading batch axis")
    lt = getattr(ffmodel, "label_tensor", None)
    sparse = (getattr(ffmodel, "loss_type", None) ==
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    if lt is not None and not sparse and \
            not getattr(ffmodel.executor, "repl_labels", False):
        want_tail = tuple(d for d in tuple(lt.dims)[1:] if d != 1)
        got_tail = tuple(d for d in y.shape[1:] if d != 1)
        if got_tail != want_tail:
            raise ValueError(
                f"{phase}: label batch shape {tuple(y.shape)} mismatches "
                f"the compiled label signature {tuple(lt.dims)} (trailing "
                f"dims {got_tail} != {want_tail}); check the loss target "
                "shape")
