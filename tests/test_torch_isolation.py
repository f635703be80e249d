"""The PyTorch port stands alone and refuses what it has not ported.

* Importing ``flexflow_tpu_torch`` and every module in it loads neither
  ``jax`` nor ``flexflow_tpu`` (checked in a fresh interpreter, since this
  test process has JAX loaded through ``tests/conftest.py``), and no source
  file of the package names either in an import.
* Entry points run on CUDA unless asked for the CPU: without a GPU,
  ``FFModel`` with no ``device`` (or ``device="cuda"``) raises.
* Every serving option outside this slice raises ``NotImplementedError``
  naming its flag and ROADMAP A.8, whether it comes as an engine argument
  or through ``FFConfig``; none falls back quietly. The ring KV layout,
  serving chaos and the serving-resilience flags, refused before their
  slice, serve. So does every training option
  outside this slice, at ``fit``, every flag that ``compile`` or the
  serving engine would otherwise parse and ignore. An LSTM graph serves,
  and the engine refuses its prefix cache and chunked prefill by name.
  ``obs.start_server`` and ``--debug-nans`` refuse, naming themselves;
  ``--profile-ops``, ``FFModel.profile_operators``, ``--compgraph``,
  ``--search-num-*`` and ``--static-analysis strict``, refused before the
  search's slice, act. The recurrent and MoE
  builders and ``FFModel.cache``, which refused by name before their
  slices, build the JAX package's ops; the observability flags
  (``--telemetry-file``, ``--trace-file``, ``--profiler-trace-dir``) and
  ``fit(recompile_state=)``, refused before theirs, act. Every public
  method of the JAX package's ``FFModel`` and ``Tensor`` exists on the
  port's (ported, or refusing by name), so none raises ``AttributeError``.
"""
import ast
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving import ServingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "flexflow_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flexflow_tpu")


def _forbidden(module: str) -> bool:
    """True for ``jax``, ``flexflow_tpu`` and their submodules — but not for
    ``flexflow_tpu_torch``, which shares the prefix."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="flexflow_tpu_torch."))


def test_forbidden_matches_exact_names_only():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("flexflow_tpu") and _forbidden("flexflow_tpu.ops")
    assert not _forbidden("flexflow_tpu_torch")
    assert not _forbidden("flexflow_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like")


def test_importing_every_module_loads_neither_jax_nor_flexflow_tpu():
    mods = _all_modules()
    for m in ("kernels.flash_decode", "kernels.flash_attention",
              "kernels.softmax", "kernels.topk",
              "execution.losses", "execution.metrics",
              "execution.optimizers", "data.dataloader",
              "resilience.preflight", "models.bert", "ops.tensor_ops",
              "ops.conv", "ops.elementwise", "models.vision",
              "models.dlrm", "models.misc", "ops.recurrent", "ops.moe_ops",
              "models.nmt", "models.transformer", "utils.durable_io",
              "utils.graph_utils", "obs.trace", "execution.checkpoint",
              "execution.remat", "resilience.chaos", "resilience.sentinel",
              "resilience.session", "obs.telemetry", "obs.reqtrace",
              "ops.fused", "execution.recompile", "machine_view",
              "parallel_tensor", "parallel.mesh", "parallel.spmd",
              "parallel.strategy", "parallel.strategies",
              "parallel.parallel_op", "parallel.pipeline",
              "utils.recursive_logger", "native", "search",
              "search.machine_model", "search.simulator",
              "search.calibration", "search.substitution",
              "search.multipod", "search.unity", "analysis",
              "analysis.lattice", "analysis.report", "analysis.rules",
              "analysis.interp", "obs.profile"):
        assert f"flexflow_tpu_torch.{m}" in mods
    script = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    import json

    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert "flexflow_tpu_torch" in loaded
    leaked = [m for m in loaded if _forbidden(m)]
    assert leaked == []


def test_native_helper_builds_from_the_port_source():
    """The search's host helper is built from ``flexflow_tpu_torch``'s own
    ``ffnative.cpp`` into its own build directory; the JAX package's
    committed library is never loaded."""
    from flexflow_tpu_torch import native

    real = os.path.realpath
    assert real(native.SOURCE) == real(
        os.path.join(PKG_DIR, "native", "ffnative.cpp"))
    lib = native.get_lib()
    assert lib._name == native.library_path()
    assert real(lib._name).startswith(
        real(os.path.join(PKG_DIR, "native", "_build")))


def test_no_source_file_imports_jax_or_flexflow_tpu():
    bad = []
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), filename=path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                bad += [(os.path.relpath(path, REPO), n) for n in names
                        if _forbidden(n)]
    assert bad == []


# ------------------------------------------------------------- device rule
def test_ffmodel_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.FFModel(ft.FFConfig())
    with pytest.raises(RuntimeError, match="no GPU"):
        ft.FFModel(ft.FFConfig(), device="cuda")
    assert ft.FFModel(ft.FFConfig(), device="cpu").device.type == "cpu"


def test_ffmodel_default_device_raises_on_this_host():
    if torch.cuda.is_available():
        assert ft.FFModel(ft.FFConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            ft.FFModel(ft.FFConfig())


# ------------------------------------------------------ out-of-slice options
def _tiny_model(vocab=100, **config):
    c = ft.FFConfig()
    c.batch_size, c.seed, c.kv_block_size = 2, 0, 8
    for k, v in config.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device="cpu")
    build_gpt2(ff, GPT2Config(batch_size=2, seq_len=32, hidden=32,
                              num_heads=2, num_layers=1, intermediate=64,
                              vocab_size=vocab))
    ff.compile()
    return ff


@pytest.fixture(scope="module")
def tiny():
    return _tiny_model()


LATER = "ported in a later slice"


@pytest.mark.parametrize("kwargs,flag", [
    (dict(seq_shards=2), "--seq-shards"),
    (dict(context_buckets=(16, 32)), "--context-buckets"),
])
def test_engine_refuses_options_of_later_slices(tiny, kwargs, flag):
    with pytest.raises(NotImplementedError, match=LATER) as e:
        ServingEngine(tiny, max_decode_len=32, **kwargs)
    assert flag in str(e.value) and "A.8" in str(e.value)


@pytest.mark.parametrize("field,value,flag", [
    ("seq_shards", 2, "--seq-shards"),
    ("context_buckets", "16,32", "--context-buckets"),
    ("request_journal", "journal.log", "--request-journal"),
])
def test_generate_refuses_config_flags_of_later_slices(field, value, flag):
    ff = _tiny_model(**{field: value})
    with pytest.raises(NotImplementedError, match=LATER) as e:
        ff.generate([[1, 2, 3]], max_new_tokens=2, max_decode_len=32)
    assert flag in str(e.value) and "A.8" in str(e.value)


@pytest.mark.parametrize("via", ["engine", "config"])
def test_ring_kv_is_served(via):
    """``--kv-cache ring`` is in this slice: it serves, as an engine
    argument or through ``FFConfig``, with no block pool, and its greedy
    streams are the paged layout's."""
    ff = _tiny_model()
    paged = ServingEngine(ff, max_decode_len=32).generate(
        [[1, 2, 3], [4, 5]], max_new_tokens=3)
    if via == "engine":
        eng = ServingEngine(ff, max_decode_len=32, kv_cache="ring")
        out = eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
    else:
        ff = _tiny_model(kv_cache="ring")
        out = ff.generate([[1, 2, 3], [4, 5]], max_new_tokens=3,
                          max_decode_len=32)
        eng = ff._serving_engine
    assert eng.kv_cache == "ring" and eng.block_allocator is None
    assert eng.state.block_tables is None
    assert out == paged


@pytest.mark.parametrize("via", ["engine", "config"])
def test_int8_kv_is_served(via):
    """``--kv-dtype int8`` is in this slice: it serves, whether it comes as
    an engine argument or through ``FFConfig``, on the paged layout."""
    if via == "engine":
        eng = ServingEngine(_tiny_model(), max_decode_len=32,
                            kv_dtype="int8")
        out = eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
        assert eng.kv_dtype == "int8"
    else:
        ff = _tiny_model(kv_dtype="int8")
        out = ff.generate([[1, 2, 3], [4, 5]], max_new_tokens=3,
                          max_decode_len=32)
        assert ff._serving_engine.kv_dtype == "int8"
    assert [len(o) for o in out] == [3, 3]
    assert all(0 <= t < 100 for o in out for t in o)


def test_generate_serves_chaos(tiny):
    """``generate(chaos=...)`` is in this slice: an empty ``ChaosPlan``
    arms the guarded decode program and changes no stream."""
    from flexflow_tpu_torch.resilience import ChaosPlan

    eng = ServingEngine(tiny, max_decode_len=32)
    plain = eng.generate([[1, 2, 3]], max_new_tokens=2)
    assert eng._last_guard is False
    out = eng.generate([[1, 2, 3]], max_new_tokens=2, chaos=ChaosPlan())
    assert eng._last_guard is True and out == plain
    assert eng.stats.outcomes == {"ok": 1}


def test_top_k_refused_only_where_jax_runs_the_pallas_kernel(tiny):
    """vocab % 128 == 0 and 1 <= k <= 8 is the JAX sampler's Pallas top-k
    route, which the row top-k kernel (``kernels/topk.py``) now serves: no
    top_k is refused any more. Any other top_k samples through
    ``torch.topk``."""
    wide = _tiny_model(vocab=128)
    for ff, k, vocab in ((wide, 4, 128), (wide, 9, 128), (tiny, 4, 100)):
        out = ff.generate([[1, 2, 3], [4, 5]], max_new_tokens=3,
                          temperature=1.0, top_k=k, max_decode_len=32)
        assert [len(o) for o in out] == [3, 3]
        assert all(0 <= t < vocab for o in out for t in o)
    # greedy ignores top_k, as in the JAX sampler
    greedy = wide.generate([[1, 2, 3]], max_new_tokens=3, top_k=4,
                           max_decode_len=32)
    assert len(greedy[0]) == 3


def test_temperature_sampling_is_reproducible(tiny):
    prompts = [[1, 2, 3], [7, 8, 9, 10]]
    a = tiny.generate(prompts, max_new_tokens=4, temperature=0.8, seed=3,
                      max_decode_len=32)
    b = tiny.generate(prompts, max_new_tokens=4, temperature=0.8, seed=3,
                      max_decode_len=32)
    assert a == b
    assert all(0 <= t < 100 for o in a for t in o)
    assert np.asarray(a).shape == (2, 4)


@pytest.mark.parametrize("flag,field", [
    ("--drain-grace-s", "drain_grace_s"),
    ("--decode-retry-budget", "decode_retry_budget")])
def test_engine_takes_serving_resilience_flags_given_on_the_command_line(
        flag, field):
    """The serving-resilience flags given on the command line reach the
    serve loop's policy, and the engine serves."""
    ff = _tiny_model()
    ff.config.parse_args([flag, "3"])
    eng = ServingEngine(ff, max_decode_len=32)
    assert getattr(eng._make_resilience(None), field) == 3
    out = eng.generate([[1, 2, 3]], max_new_tokens=2)
    assert len(out[0]) == 2 and eng.stats.outcomes == {"ok": 1}


def test_engine_refuses_an_lstm_graph_by_name():
    """An LSTM graph serves since its slice; what the JAX engine refuses
    for it (the prefix cache by name, chunked prefill) the port refuses
    with the same ``ValueError`` naming the LSTM, and nothing falls back
    quietly."""
    c = ft.FFConfig()
    c.batch_size = 2
    ff = ft.FFModel(c, device="cpu")
    ids = ff.create_tensor((2, 16), dtype=ft.DataType.DT_INT32)
    t, _state = ff.lstm(ff.embedding(ids, 30, 8), 8, name="lm_lstm")
    ff.dense(t, 30)
    ff.compile()
    with pytest.raises(ValueError, match="LSTM recurrence"):
        ServingEngine(ff, max_decode_len=16, prefix_cache="on")
    with pytest.raises(ValueError, match="LSTM recurrence"):
        ServingEngine(ff, max_decode_len=16, kv_block_size=8,
                      prefill_chunk_tokens=8)
    eng = ServingEngine(ff, max_decode_len=16)
    assert eng._prefix is None
    assert len(eng.generate([[1, 2, 3]], max_new_tokens=3)[0]) == 3


# ------------------------------------------------ out-of-slice fit options
def _tiny_mlp(**config):
    c = ft.FFConfig()
    c.batch_size, c.seed = 4, 0
    for k, v in config.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device="cpu")
    ff.softmax(ff.dense(ff.create_tensor((4, 8)), 3))
    ff.compile(loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _xy():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((8, 8)).astype(np.float32),
            rng.integers(0, 3, (8, 1)).astype(np.int32))


@pytest.mark.parametrize("field,value,flag", [
    ("audit_strategy", True, "--audit-strategy"),
    ("memory_budget_mb", 1024, "--memory-budget-mb"),
    ("drift_tolerance", 0.5, "--drift-tolerance"),
])
def test_fit_refuses_config_flags_of_later_slices(field, value, flag):
    ff = _tiny_mlp(**{field: value})
    with pytest.raises(NotImplementedError, match=LATER) as e:
        ff.fit(*_xy())
    assert flag in str(e.value)


@pytest.mark.parametrize("field,value", [
    ("schedule", "1f1b"), ("pipeline_virtual_stages", 2)])
def test_fit_refuses_schedule_flags_without_a_pipeline(field, value):
    """``--schedule`` / ``--virtual-stages`` act on a pipeline strategy
    since its slice; without one they would be parsed and ignored, so
    ``fit`` raises, naming them."""
    ff = _tiny_mlp(**{field: value})
    with pytest.raises(ValueError, match="pipeline") as e:
        ff.fit(*_xy())
    assert "--schedule" in str(e.value)


def test_profile_ops_names_the_simulator_slice(tmp_path):
    """``--profile-ops PATH`` (refused before the search's slice): one
    profiled pass a fit appends a record per distinct op shape to PATH,
    keyed as the simulator's op-cost cache and carrying its prediction."""
    from flexflow_tpu_torch.obs.profile import OpProfile

    path = str(tmp_path / "ops.jsonl")
    ff = _tiny_mlp(profile_ops=path)
    ff.fit(*_xy(), epochs=1)
    recs = OpProfile.read_jsonl(path).records
    assert sorted(r.op_type for r in recs) == ["OP_LINEAR", "OP_SOFTMAX"]
    assert all(r.measured_fwd_s > 0 and r.predicted_fwd_s > 0
               and r.key.startswith("((<OperatorType.") for r in recs)


@pytest.mark.parametrize("field,value", [
    ("profiler_trace_dir", "prof"),
    ("telemetry_file", "tel.json"),
    ("trace_file", "trace.json"),
])
def test_fit_acts_on_observability_flags(field, value, tmp_path):
    """Refused by name before their slice; now ``fit`` writes the file
    (or, for the profiler, one trace into the directory)."""
    from flexflow_tpu_torch import obs

    path = str(tmp_path / value)
    ff = _tiny_mlp(**{field: path})
    try:
        ff.fit(*_xy(), epochs=1)
    finally:
        obs.disable()
    if field == "profiler_trace_dir":
        (name,) = os.listdir(path)
        assert name.endswith(".pt.trace.json")
    else:
        with open(path) as f:
            got = json.load(f)
        assert (got["steps"] == 2 if field == "telemetry_file" else
                "train_step" in {e["name"] for e in got["traceEvents"]})


def test_fit_takes_recompile_state():
    """``recompile_state=`` (refused before its slice): the trigger is
    read after every step and fires a recompile once."""
    from flexflow_tpu_torch.execution.recompile import RecompileState

    ff = _tiny_mlp()
    checks = []
    rs = RecompileState(lambda r: checks.append(1) or len(checks) == 1,
                        lambda r: None)
    old = ff.executor
    ff.fit(*_xy(), epochs=1, recompile_state=rs)
    assert rs.recompilations == 1 and rs.ffmodel is ff
    assert ff.executor is not old and len(checks) == 3  # 1 + the rerun 2


@pytest.mark.parametrize("field,value,flag", [
    ("export_strategy_computation_graph_file", "graph.dot", "--compgraph"),
    ("include_costs_dot_graph", True, "--compgraph"),
    ("search_num_nodes", 2, "--search-num-nodes"),
    ("search_num_workers", 4, "--search-num-workers"),
    ("static_analysis", "strict", "--static-analysis strict"),
    ("debug_nans", True, "--debug-nans"),
])
def test_compile_refuses_config_flags_of_later_slices(field, value, flag,
                                                      tmp_path):
    """Flags the JAX package acts on at compile on one device. Since the
    search's slice only ``--debug-nans`` still raises, naming itself and
    A.6 part 2; the others act: ``--compgraph`` writes the PCG's dot text
    (``include_costs_dot_graph`` is set with it: alone it asks for
    nothing in either package), ``--search-num-*`` for another machine
    without ``--export-strategy`` warns and stays on one device, and
    ``--static-analysis strict`` passes a sound plan."""
    if field == "debug_nans":
        with pytest.raises(NotImplementedError, match=LATER) as e:
            _tiny_mlp(**{field: value})
        assert flag in str(e.value) and "A.6 part 2" in str(e.value)
        return
    extra = {}
    if field in ("export_strategy_computation_graph_file",
                 "include_costs_dot_graph"):
        extra["export_strategy_computation_graph_file"] = \
            str(tmp_path / "graph.dot")
        if field == "export_strategy_computation_graph_file":
            value = extra.pop(field)
    if field.startswith("search_num"):
        with pytest.warns(UserWarning, match="skipping the target search"):
            ff = _tiny_mlp(**{field: value}, **extra)
    else:
        ff = _tiny_mlp(**{field: value}, **extra)
    assert ff.executor is not None and ff.mesh is None
    if "compgraph" in flag:
        with open(tmp_path / "graph.dot") as f:
            assert f.read().startswith("digraph PCG {")


def test_compile_acts_on_the_strategy_flags(tmp_path):
    """``--export-strategy`` and ``--mesh-shape``, refused before their
    slice: the one writes the strategy's JSON, the other compiles on a mesh
    (of one gloo rank here); ``--collective-overlap on`` trains there."""
    import torch.distributed as dist

    path = str(tmp_path / "strategy.json")
    ff = _tiny_mlp(export_strategy_file=path)
    with open(path) as f:
        assert json.load(f)["axis_names"] == ["data"]
    assert ff.mesh is None
    try:
        ff = _tiny_mlp(mesh_shape=(1,), collective_overlap="on")
        assert ff.mesh.shape == {"data": 1}
        perf = ff.fit(*_xy(), epochs=1)
        assert perf.train_all == 8
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_compile_takes_the_in_slice_defaults():
    """``--static-analysis on`` (the default) and -1 search sizes compile:
    JAX runs no analysis and no search on a plain compile either."""
    ff = _tiny_mlp(static_analysis="on", search_num_nodes=-1,
                   search_num_workers=-1)
    assert ff.executor is not None


def test_fit_takes_the_in_slice_defaults():
    ff = _tiny_mlp(remat="none", collective_overlap="off")
    perf = ff.fit(*_xy(), epochs=1)
    assert perf.train_all == 8 and len(ff.fit_history.loss) == 2


def test_softmax_kernel_opt_in_is_refused():
    """The row-softmax kernel's opt-in is in this slice and no longer
    refused: where the kernel gate is closed (dim 128 < 1024, as in the JAX
    op) ``use_pallas`` computes the library softmax."""
    c = ft.FFConfig()
    c.batch_size = 2
    ff = ft.FFModel(c, device="cpu")
    ff.softmax(ff.create_tensor((2, 128)), use_pallas=True)
    ff.compile()
    x = np.random.default_rng(0).standard_normal((2, 128)).astype(
        np.float32)
    got = np.asarray(ff.predict(x))
    np.testing.assert_allclose(
        got, torch.softmax(torch.tensor(x), -1).numpy(), rtol=0, atol=0)


# ------------------------------------------------ the cache op's builder
def test_cache_builder_builds_the_jax_op():
    """``FFModel.cache`` (refused by name before its slice) builds the JAX
    package's cache op: the same attributes, shape and dtype."""
    import flexflow_tpu as fj

    got = []
    for pkg in (ft, fj):
        ff = pkg.FFModel(pkg.FFConfig(), **({"device": "cpu"}
                                            if pkg is ft else {}))
        t = ff.cache(ff.create_tensor((4, 8)), 4, name="c")
        layer = ff._layers[-1]
        got.append((layer.op_type.name, layer.attrs["num_batches"],
                    t.dims, t.dtype.name))
    assert got[0] == got[1] == ("OP_CACHE", 4, (4, 8), "DT_FLOAT")


def _build_recurrent_and_moe(builder, ff, pkg):
    """``builder`` of the recurrent and MoE slice called the same way in
    either package; returns its output tensors."""
    x = ff.create_tensor((4, 8))
    ints = pkg.DataType.DT_INT32
    if builder == "lstm":
        return ff.lstm(ff.create_tensor((4, 5, 8)), 6,
                       initial_state=ff.create_tensor((4, 12)))
    if builder == "group_by":
        return ff.group_by(x, ff.create_tensor((4, 2), ints), 2, alpha=1.5)
    if builder in ("aggregate", "aggregate_spec"):
        assign = ff.create_tensor((4, 2), ints)
        exps = [ff.create_tensor((6, 3)) for _ in range(2)]
        return [getattr(ff, builder)(ff.create_tensor((4, 2)), assign,
                                     assign, ff.create_tensor((4, 2)),
                                     exps, 2, lambda_bal=0.1)]
    if builder == "experts":
        return [ff.experts(ff.create_tensor((4, 6, 8)), 5)]
    return [getattr(ff, builder)(x, 4, 2, 8)]


@pytest.mark.parametrize("builder", [
    "lstm", "group_by", "aggregate", "aggregate_spec", "moe", "experts",
    "moe_experts"])
def test_builders_of_this_slice_build_the_jax_shapes(builder):
    """The recurrent and MoE builders, which refused by name before this
    slice (one case each, as there), build the same
    output shapes and dtypes as the JAX package's builders."""
    import flexflow_tpu as fj

    got = _build_recurrent_and_moe(builder, ft.FFModel(ft.FFConfig(),
                                                       device="cpu"), ft)
    want = _build_recurrent_and_moe(builder, fj.FFModel(fj.FFConfig()), fj)
    assert [t.dims for t in got] == [t.dims for t in want]
    assert [t.dtype.name for t in got] == [t.dtype.name for t in want]


def test_every_jax_builder_exists_in_the_port():
    """The port's FFModel has each public builder of the JAX package's
    (flexflow_tpu/model.py:118-470), ported or refusing by name: none
    raises ``AttributeError``."""
    import flexflow_tpu as fj

    builders = ["dense", "conv2d", "pool2d", "batch_norm", "layer_norm",
                "rms_norm", "batch_matmul", "embedding",
                "multihead_attention", "add", "subtract", "multiply",
                "divide", "max", "min", "exp", "log", "sin", "cos", "rsqrt",
                "pow", "scalar_multiply", "scalar_add", "scalar_sub",
                "scalar_true_divide", "relu", "identity", "sigmoid", "tanh",
                "elu", "gelu", "dropout", "flat", "softmax", "reshape",
                "transpose", "reverse", "slice_tensor", "constant", "sdpa",
                "lstm", "concat", "split", "gather", "cast", "mean",
                "reduce_sum", "top_k", "group_by", "aggregate",
                "aggregate_spec", "cache", "moe", "experts", "moe_experts"]
    for name in builders:
        assert callable(getattr(fj.FFModel, name)), name
        assert callable(getattr(ft.FFModel, name)), name


@pytest.mark.parametrize("cls", ["FFModel", "Tensor"])
def test_every_public_jax_method_exists_in_the_port(cls):
    """Each public method of the JAX package's ``FFModel`` and ``Tensor``
    exists on the port's, ported or refusing by name: none raises
    ``AttributeError``. The refusing ones name themselves."""
    import flexflow_tpu as fj

    jcls, tcls = getattr(fj, cls), getattr(ft, cls)
    names = [n for n in dir(jcls) if not n.startswith("_")]
    assert [n for n in names if not hasattr(tcls, n)] == []
    if cls == "FFModel":
        ff = _tiny_mlp()
        ff.profile_operators()  # ported with the search's simulator
        assert [r[1] for r in ff.per_op_profile] == ["OP_LINEAR",
                                                     "OP_SOFTMAX"]
        # ported in their slices: no telemetry without a sink, and a
        # trigger that does not fire recompiles nothing
        from flexflow_tpu_torch.execution.recompile import RecompileState

        assert ff.get_telemetry() is None
        assert not ff.recompile_on_condition(
            RecompileState(lambda r: False, lambda r: None, ff))


def test_obs_start_server_refuses_by_name():
    from flexflow_tpu_torch import obs

    with pytest.raises(NotImplementedError, match="obs.start_server"):
        obs.start_server()
