"""Observability, fusion and the cache op's recompile on the card: the
gates of ``chip_smoke.py`` phase 11 at small depth. Every test here needs
an NVIDIA GPU and skips without one (``test_torch_telemetry.py``,
``test_torch_fusion.py``, ``test_torch_reqtrace.py`` and
``test_torch_cache_recompile.py`` cover the same code on the CPU, where
no step is captured).

* a captured BERT-like fit with ``--telemetry-file`` and ``--trace-file``
  writes the step walls, MFU against the card's peak, the peak memory and
  one ``train_step`` event a step; ``--profiler-trace-dir`` on a fresh
  capture names every node on the eager step and holds the flash kernels
  in the replays;
* the same model under ``--fusion`` launches the same flash kernels a
  step, its first loss bitwise the unfused model's from the same weights;
* traced int8 serving with top-k sampling under ``--serve-loop async``
  streams what the untraced run streams, one ``ok`` record a request, and
  captures nothing after warm-up;
* the cache op's recompile drops the old programs, and the new step
  captures exactly once.

It imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_obs_cuda.py
"""
import json
import os

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
import flexflow_tpu_torch.kernels.flash_attention as fa
from flexflow_tpu_torch import obs
from flexflow_tpu_torch.execution.recompile import RecompileState
from flexflow_tpu_torch.models.bert import BertConfig, build_bert
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

B, LAYERS = 4, 2

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _tracers_off():
    obs.disable()
    obs.disable_reqtrace()
    yield
    obs.disable()
    obs.disable_reqtrace()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs capture on the card "
                    "only)")
    return torch.device("cuda")


def _bert(dev, **config):
    c = ft.FFConfig()
    c.batch_size, c.seed = B, 3
    c.compute_dtype = ft.DataType.DT_BFLOAT16
    for k, v in config.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device=dev)
    build_bert(ff, BertConfig(batch_size=B, seq_len=128, hidden=128,
                              num_heads=2, num_layers=LAYERS,
                              intermediate=256))
    ff.compile(optimizer=ft.AdamOptimizer(ff, alpha=1e-3),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 128, 128)).astype(np.float32),
            rng.integers(0, 2, (n, 1)).astype(np.int32))


def test_fit_telemetry_trace_and_profile(tmp_path):
    dev = _cuda()
    ff = _bert(dev, telemetry_file=str(tmp_path / "tel.json"),
               trace_file=str(tmp_path / "trace.json"))
    x, y = _data(6 * B)
    ff.fit(x, y, epochs=1)
    with open(ff.config.telemetry_file) as f:
        tel = json.load(f)
    assert tel["steps"] == 6 and tel["steady_step_s"] > 0
    assert tel["samples_per_sec"] > 0
    assert tel["model_flops_per_step"] == obs.model_flops_per_step(ff.pcg)
    peak = obs.detect_peak_flops()
    if peak is not None:  # a card the peak table names
        assert tel["peak_flops"] == peak and tel["estimated_mfu"] > 0
    mem = tel["device_memory"]
    assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"] > 0
    with open(ff.config.trace_file) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]]
    assert names.count("train_step") == 6 and names.count("epoch") == 1
    assert names.count("compile") == 1

    prof = str(tmp_path / "prof")
    ff.config.telemetry_file = ff.config.trace_file = ""
    obs.disable()
    ff.executor.invalidate_jit_cache()
    ff.config.profiler_trace_dir = prof
    ff.fit(x[:3 * B], y[:3 * B], epochs=1)  # eager, capture, replay
    (path,) = os.listdir(prof)
    with open(os.path.join(prof, path)) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {n.name for n in ff.pcg.compute_nodes()} <= ranges
    # a replay's kernels carry its cudaGraphLaunch's correlation id (the
    # host's and the card's clocks are aligned only approximately, so a
    # timestamp does not tell whose a kernel is)
    launches = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "GraphLaunch" in e.get("name", "")}
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launches]
    assert launches
    assert sum("flash_fwd_sm90" in k for k in kernels) == \
        LAYERS * len(launches)
    assert sum("flash_bwd_fused_sm90" in k for k in kernels) == \
        LAYERS * len(launches)


def test_fused_step_launches_and_first_loss():
    dev = _cuda()
    x, y = _data(4 * B)
    runs = {}
    for fusion in (False, True):
        ff = _bert(dev, perform_fusion=fusion)
        fa.reset_launch_count()
        ff.fit(x, y, epochs=1)
        runs[fusion] = (ff.fit_history.loss,
                        {k: fa.launch_count(k) for k in fa.KERNELS})
    assert runs[True][1] == runs[False][1]
    assert runs[True][1]["flash_fwd"] == LAYERS * 4
    assert runs[True][0][0] == runs[False][0][0]


def test_traced_int8_async_serving():
    dev = _cuda()
    c = ft.FFConfig()
    c.batch_size, c.seed, c.max_inflight = 4, 0, 4
    c.kv_dtype, c.serve_loop = "int8", "async"
    ff = ft.FFModel(c, device=dev)
    build_gpt2(ff, GPT2Config(batch_size=4, seq_len=128, hidden=128,
                              num_heads=2, num_layers=2, intermediate=256,
                              vocab_size=1024))
    ff.compile()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1024, n).tolist() for n in (20, 33, 9, 40)]
    kw = dict(max_new_tokens=8, max_decode_len=64, temperature=0.8,
              top_k=8, seed=1)
    runs = []
    for traced in (False, True):
        # a fresh engine (an empty prefix cache), warmed on other tokens:
        # the eager calls, then the captures
        ff._serving_engine = None
        for _ in range(2):
            ff.generate([rng.integers(0, 1024, len(p)).tolist()
                         for p in prompts], **kw)
        eng = ff._serving_engine
        before = sum(p.captures for p in eng.programs())
        rt = obs.enable_reqtrace() if traced else None
        try:
            runs.append(ff.generate(prompts, **kw))
            recs = rt.records() if traced else None
        finally:
            obs.disable_reqtrace()
        assert sum(p.captures for p in eng.programs()) == before
    plain, traced = runs
    assert traced == plain
    assert [r["outcome"] for r in recs] == ["ok"] * len(prompts)
    assert sorted(r["decode_ticks"] for r in recs) == \
        sorted(len(t) for t in traced)


def test_cache_recompile_captures_once_more():
    dev = _cuda()
    c = ft.FFConfig()
    c.batch_size = 32
    ff = ft.FFModel(c, device=dev)
    x = ff.create_tensor((32, 64))
    gate = ff.softmax(ff.dense(x, 4))
    vals, assign = ff.top_k(gate, 2)
    assign = ff.cache(assign, num_batches=2,
                      score_fn=lambda a, b: float((a == b).mean()))
    grouped = ff.group_by(x, assign, 4, alpha=2.0)
    experts = [ff.dense(g, 32, activation=ft.ActiMode.AC_MODE_RELU)
               for g in grouped]
    ff.softmax(ff.dense(ff.aggregate(vals, assign, assign, gate, experts,
                                     4, lambda_bal=0.01), 4))
    ff.compile(optimizer=ft.AdamOptimizer(ff, alpha=1e-3),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(32, 64)).astype(np.float32)
    ys = rng.integers(0, 4, (32, 1)).astype(np.int32)
    old = ff.executor.make_train_step().program
    rs = RecompileState(lambda r: r.recompilations == 0 and
                        bool(ff.cache_scores), lambda r: None, ff)
    ff.fit(xs, ys, epochs=6, recompile_state=rs, shuffle=False)
    new = ff.executor.make_train_step().program
    ff.fit(xs, ys, epochs=2, shuffle=False)
    assert rs.recompilations == 1
    assert old.captures == 1 and old._entries == {}
    assert new is not old and new.captures == 1
    assert all(0.0 <= v <= 1.0 for v in ff.cache_scores.values())
