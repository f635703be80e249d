"""The serving engine's tracer spans against the JAX engine's
(``flexflow_tpu/serving/engine.py:1571, 1611, 1628, 1809``), on the CPU.

One traced serve (``--trace-file``) through each package, the same weights
(the tiny GPT-2 of ``tests/test_serving_async.py``: hidden 64, 4 heads,
seq 64, vocab 100), the same prompts, engine settings and serve loop
(sync, then async): one slot, the prefix cache on, 8-token blocks,
16-token chunks. The first prompt is short enough for a one-shot prefill;
the second fills the trie in two chunks; the third shares 17 of its
tokens, so its admission maps the second's partial tail block and clones
it on write; the fourth prefills in three chunks. Both packages must
write:

* a ``prefill`` span a one-shot prefill (``rid, bucket, slot,
  prompt_len``), a ``prefill_chunk`` span a chunk (``rid, slot, start,
  tokens, hit, done``) and a ``decode_step`` span a decode step (``step,
  live_slots``), as many as ``stats.prefills`` (one-shot ones),
  ``stats.chunked_prefills`` and ``stats.decode_steps``;
* a ``prefix_cow_clone`` event (``rid, slot, src, dst``) at the clone;
* the same sequence of names and argument values, request ids compared
  by order of appearance (each package numbers requests from its own
  counter).

With the tracer off the engine calls no tracer method for them, and the
streams equal a cold run's (no prefix cache, no chunks); traced, they
equal the JAX engine's.
"""
import json

import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as fj
import flexflow_tpu.obs as jobs
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.obs as tobs
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.serving import ServingEngine as JaxServingEngine
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.obs.trace import NoopTracer
from flexflow_tpu_torch.serving import ServingEngine

torch.set_num_threads(2)

CFG = dict(batch_size=2, seq_len=64, hidden=64, num_heads=4, num_layers=2,
           intermediate=128, vocab_size=100)
SPANS = ("prefill", "prefill_chunk", "decode_step", "prefix_cow_clone")
SYS = [int(t) for t in np.random.default_rng(7).integers(1, 99, size=20)]
PROMPTS = [[3, 1, 4, 1, 5], SYS[:18], SYS[:17] + [91, 92],
           [int(t) for t in np.random.default_rng(9).integers(1, 99,
                                                              size=40)]]
ENGINE = dict(n_slots=1, max_decode_len=64, exact_decode=True,
              kv_block_size=8, prefix_cache="on", prefill_chunk_tokens=16)


@pytest.fixture(scope="module")
def pair():
    jc = fj.FFConfig()
    jc.batch_size, jc.seed = 2, 42
    jff = fj.FFModel(jc)
    jax_build_gpt2(jff, JaxGPT2Config(**CFG))
    jff.compile(optimizer=fj.SGDOptimizer(jff),
                loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    tc = ft.FFConfig()
    tc.batch_size, tc.seed = 2, 42
    tff = ft.FFModel(tc, device="cpu")
    build_gpt2(tff, GPT2Config(**CFG))
    tff.compile()
    tff.set_params_numpy(jax.device_get(jff.params))
    return jff, tff


def _traced(ff, engine_cls, obs, path, loop="sync"):
    """(streams, stats, the serving spans and events of the trace file)."""
    old = ff.config.trace_file
    ff.config.trace_file = str(path)
    try:
        eng = engine_cls(ff, **dict(ENGINE, serve_loop=loop))
        outs = eng.generate(PROMPTS, max_new_tokens=4)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e["name"] in SPANS]
    finally:
        ff.config.trace_file = old
        obs.disable()
    return outs, eng.stats, events


def _canonical(events):
    """(name, phase, args) per event, rids renumbered by first appearance."""
    rids = {}
    out = []
    for e in events:
        args = dict(e["args"])
        if "rid" in args:
            args["rid"] = rids.setdefault(args["rid"], len(rids))
        out.append((e["name"], e["ph"], sorted(args.items())))
    return out


def _count(events, name):
    return sum(e["name"] == name for e in events)


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_serving_spans_match_jax(pair, tmp_path, loop):
    jff, tff = pair
    jouts, _jstats, jev = _traced(jff, JaxServingEngine, jobs,
                                  tmp_path / "jax.json", loop)
    outs, stats, ev = _traced(tff, ServingEngine, tobs,
                              tmp_path / "torch.json", loop)
    assert outs == jouts
    assert _canonical(ev) == _canonical(jev)
    assert _count(ev, "prefix_cow_clone") == 1
    assert _count(ev, "prefill_chunk") == stats.chunked_prefills >= 4
    assert _count(ev, "decode_step") == stats.decode_steps > 0
    # a chunked request's completion counts in stats.prefills too
    done_chunks = sum(e["name"] == "prefill_chunk" and e["args"]["done"]
                      for e in ev)
    assert _count(ev, "prefill") + done_chunks == stats.prefills
    for e in ev:
        assert e["ph"] == ("i" if e["name"] == "prefix_cow_clone" else "X")
    fields = {e["name"]: set(e["args"]) for e in ev}
    assert fields == {
        "prefill": {"rid", "bucket", "slot", "prompt_len"},
        "prefill_chunk": {"rid", "slot", "start", "tokens", "hit", "done"},
        "decode_step": {"step", "live_slots"},
        "prefix_cow_clone": {"rid", "slot", "src", "dst"}}
    steps = [e["args"]["step"] for e in ev if e["name"] == "decode_step"]
    assert steps == list(range(1, stats.decode_steps + 1))


def test_tracer_off_records_nothing(pair, monkeypatch):
    """The tracer off, the serve loop calls no tracer method for its spans,
    and the streams are a cold run's."""
    _jff, tff = pair
    calls = []
    for meth in ("event", "complete", "span"):
        monkeypatch.setattr(
            NoopTracer, meth,
            lambda self, name, *a, _m=meth, **k: calls.append((_m, name)))
    tobs.disable()
    assert not tobs.get_tracer().enabled
    outs = ServingEngine(tff, **ENGINE).generate(PROMPTS, max_new_tokens=4)
    serving_calls = [c for c in calls if c[1] in SPANS]
    assert serving_calls == []
    base = ServingEngine(tff, **dict(ENGINE, prefix_cache="off",
                                     prefill_chunk_tokens=0)).generate(
        PROMPTS, max_new_tokens=4)
    assert outs == base
