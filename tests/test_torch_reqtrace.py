"""The port's request tracing (``flexflow_tpu_torch/obs/reqtrace.py``, the
scheduler's and the engine's notes) and serving telemetry against the JAX
package's, on the gpt2-tiny fixture of ``tests/test_torch_serving_async``
(greedy, fp32, the JAX weights), the applicable cases of
``tests/test_reqtrace.py``:

* per request, the finished record's kinds and counts (prompt and token
  lengths, outcome and finish reason, decode ticks, prefix-hit tokens,
  chunks, copy-on-write, hops, replicas) equal the JAX engine's on the
  same prompts, under the sync and the async loop; times are excluded,
  and so is the occupancy average, which the async loop's one-step commit
  lag moves. Every request ends in exactly one record, its token notes
  equal to its generated tokens;
* the ``serving`` and ``serving_prefix`` telemetry counts written to
  ``--telemetry-file`` equal the JAX run's;
* tracing off leaves the streams as they are, and the no-op tracer records
  nothing; the record's phase walk is the JAX module's, on a fake clock.

The module itself is a copy (``RequestTrace``, ``FleetTimeSeries``); its
own unit cases run here against the JAX copy on the same notes.
"""
import json

import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as fj
import flexflow_tpu.obs as jobs
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.serving import ServingEngine as JaxServingEngine
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.obs as tobs
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving import ServingEngine

torch.set_num_threads(2)

CFG = dict(batch_size=8, seq_len=64, hidden=64, num_heads=4, num_layers=2,
           intermediate=128, vocab_size=100)
# the record fields compared across the packages: kinds and counts, no
# times (arrival, first token, finish, the phase durations) and no
# occupancy average
RECORD_KEYS = ("v", "kind", "prompt_len", "max_new_tokens", "deadline_ms",
               "tenant", "new_tokens", "outcome", "finish_reason",
               "decode_ticks", "prefix_hit_tokens", "chunks", "cow", "hops",
               "replicas", "hedged", "dropped_notes", "shed")
# the telemetry's counts (the tokens/s, latencies and host share are
# times)
SERVING_COUNTS = ("requests_served", "tokens_generated", "queue_depth_hwm")


@pytest.fixture(autouse=True)
def _tracers_off():
    for m in (tobs, jobs):
        m.disable_reqtrace()
        m.disable()
    yield
    for m in (tobs, jobs):
        m.disable_reqtrace()
        m.disable()


@pytest.fixture(scope="module")
def pair():
    """(JAX FFModel, port FFModel on the CPU) with the JAX weights."""
    jc = fj.FFConfig()
    jc.batch_size, jc.seed = 8, 42
    jff = fj.FFModel(jc)
    jax_build_gpt2(jff, JaxGPT2Config(**CFG))
    jff.compile(optimizer=fj.SGDOptimizer(jff),
                loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    tc = ft.FFConfig()
    tc.batch_size, tc.seed = 8, 42
    tff = ft.FFModel(tc, device="cpu")
    build_gpt2(tff, GPT2Config(**CFG))
    tff.compile()
    tff.set_params_numpy(jax.device_get(jff.params))
    return jff, tff


def _prompts(n, seed=0, lo=3, hi=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 99, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _trace(name):
    """(prompts, engine kwargs) of one traffic shape: co-batched prompts
    over 3 slots, shared-prefix prompts (prefix hits), and a long prompt
    among short ones under chunked prefill."""
    if name == "cobatched":
        return _prompts(6, seed=21), {}
    if name == "prefix":
        sys_p = list(np.random.default_rng(7).integers(1, 99, size=20))
        return [sys_p + [5, 6, 7], sys_p + [8, 9], sys_p + [5, 6, 1, 2]], {}
    rng = np.random.default_rng(9)
    return ([rng.integers(1, 99, size=40).tolist()] + _prompts(3, seed=10),
            {"prefill_chunk_tokens": 16})


def _served(pkg, ff, prompts, kw, tmp_path, loop="sync"):
    """Serve ``prompts`` with request tracing and ``--telemetry-file`` on:
    (streams, records in submission order, the telemetry JSON)."""
    obs = tobs if pkg is ft else jobs
    path = str(tmp_path / f"{pkg.__name__}_{loop}.json")
    ff.config.telemetry_file = path
    rt = obs.enable_reqtrace()
    try:
        if pkg is ft:
            eng = ServingEngine(ff, n_slots=3, max_decode_len=64,
                                kv_block_size=8, serve_loop=loop, **kw)
        else:
            eng = JaxServingEngine(ff, n_slots=3, max_decode_len=64,
                                   kv_block_size=8, **kw)
        outs = eng.generate(prompts, max_new_tokens=8)
    finally:
        ff.config.telemetry_file = ""
        obs.disable_reqtrace()
    assert rt.open_timelines() == []
    records = sorted(rt.records(), key=lambda r: r["rid"])
    with open(path) as f:
        return outs, records, json.load(f)


_JAX_RUNS = {}


@pytest.mark.parametrize("loop", ["sync", "async"])
@pytest.mark.parametrize("trace", ["cobatched", "prefix", "chunked"])
def test_records_and_serving_telemetry_equal_jax(pair, trace, loop,
                                                 tmp_path):
    jff, tff = pair
    prompts, kw = _trace(trace)
    if trace not in _JAX_RUNS:
        _JAX_RUNS[trace] = _served(fj, jff, prompts, kw, tmp_path)
    jouts, jrecs, jtel = _JAX_RUNS[trace]
    outs, recs, tel = _served(ft, tff, prompts, kw, tmp_path, loop)
    assert outs == jouts
    assert len(recs) == len(prompts)
    for rec, out in zip(recs, outs):
        assert rec["outcome"] == "ok"
        assert rec["decode_ticks"] == rec["new_tokens"] == len(out)
    assert [{k: r[k] for k in RECORD_KEYS} for r in recs] == \
        [{k: r[k] for k in RECORD_KEYS} for r in jrecs]
    if trace == "prefix":
        assert any(r["prefix_hit_tokens"] for r in recs)
    if trace == "chunked":
        assert recs[0]["chunks"] == 3  # 40 tokens in 16-token chunks
    for k in SERVING_COUNTS:
        assert tel["serving"][k] == jtel["serving"][k], k
    assert tel["phase"] == jtel["phase"] == "serving"
    assert tel["steps"] == jtel["steps"]
    if "serving_prefix" in jtel:
        assert tel["serving_prefix"] == jtel["serving_prefix"]
    else:
        assert "serving_prefix" not in tel
    assert tel["serving"]["tokens_generated"] == sum(map(len, outs))


def test_tracing_off_streams_unchanged_and_noop_records_nothing(pair):
    _jff, tff = pair
    prompts, kw = _trace("cobatched")
    eng = ServingEngine(tff, n_slots=3, max_decode_len=64, kv_block_size=8)
    assert not eng.model.config.telemetry_file
    plain = eng.generate(prompts, max_new_tokens=8)
    assert tobs.get_reqtrace().records() == []
    rt = tobs.enable_reqtrace()
    traced = ServingEngine(tff, n_slots=3, max_decode_len=64,
                           kv_block_size=8).generate(prompts,
                                                     max_new_tokens=8)
    assert traced == plain and len(rt.records()) == len(prompts)
    assert tobs.enable_reqtrace() is rt  # a second enable composes
    assert tobs.disable_reqtrace() is rt
    assert not tobs.get_reqtrace().enabled


def _notes(rt):
    """One request's lifecycle on a fake clock, the notes the scheduler
    and the engine make, then a second request that is finished from the
    queue."""
    rt.note(1, "submit", 0.0, prompt_len=5, max_new=3, deadline_ms=None)
    rt.note(1, "admit", 2.0, slot=0, hit=4, cow=True)
    rt.note(1, "chunk", 3.0, start=4, tokens=1)
    for t in (5.0, 6.0, 8.0):
        rt.note(1, "token", t, occ=1)
    rt.finish(1, 9.0, "ok", reason="length", new_tokens=3)
    rt.finish(1, 10.0, "ok", reason="eos")  # a second terminal is dropped
    rt.note(2, "submit", 1.0, prompt_len=2, max_new=1, deadline_ms=None)
    rt.finish(2, 4.0, "ok", reason="length", new_tokens=0)


def test_record_phase_walk_and_spans_equal_jax_module():
    """The copied module against the JAX one on the same notes: the
    records and the exported Perfetto spans are equal, phase durations
    included (the fake clock makes them exact)."""
    got = {}
    for obs in (tobs, jobs):
        tracer = obs.Tracer()
        rt = obs.RequestTrace(tracer=tracer)
        _notes(rt)
        with pytest.raises(ValueError, match="unknown request-trace"):
            rt.note(3, "teleport", 0.0)
        spans = [(e["name"], e.get("ts"), e.get("dur"))
                 for e in tracer.events if e["name"].startswith("req")]
        got[obs] = (rt.records(), spans)
    assert got[tobs] == got[jobs]
    rec = got[tobs][0][0]
    assert (rec["queue_ms"], rec["prefill_ms"], rec["decode_ms"]) == \
        (2.0, 3.0, 4.0)
    assert rec["chunks"] == 1 and rec["cow"] and rec["decode_ticks"] == 3


def test_fleet_time_series_equal_jax_module():
    got = []
    for obs in (tobs, jobs):
        ts = obs.FleetTimeSeries(maxlen=3)
        for k in range(5):
            ts.sample(k, queue_depth=k, tokens=2 * k, backlog_ms=10.0 * k,
                      occupancy=(0.5, 0.25 * (k % 2)),
                      health=("healthy", "degraded" if k == 3
                              else "healthy"),
                      tenants={"a": k})
        got.append((ts.summary(), ts.tenant_summary(), len(ts)))
    assert got[0] == got[1]
    assert got[0][2] == 3 and got[0][0]["unhealthy_ticks"] == 1
