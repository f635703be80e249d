"""The serving objective of the search (``serving/search.py``) against the
JAX package's, and the engine's ``elastic_replan``:

* ``search_all(objective="serving")`` on the tiny and the small GPT-2's
  PCG, both packages on the same machine fields (a ``GPUMachineModel``
  built from a JAX machine's), gives the same winner and the same ranked
  chain, every ``sim_*`` field within rel 1e-9, and the same seq_shards a
  context bucket, under ``FLEXFLOW_TPU_SEARCH_SELFCHECK``;
* the JAX package's laws of it: the plan beats naive dp replication
  under an SLO (``tests/test_serving.py:252``), the kv_dtype axis and its
  pin (``tests/test_decode_paged.py:552``), the prefill-reuse pricing
  (``tests/test_prefix_cache.py:509``) and the bucket routing
  (``tests/test_seqpar_decode.py:257``);
* ``elastic_replan`` in the middle of a serve keeps the continuations
  identical, records its plan, reuses the warm simulator and captures
  the serving programs again (``tests/test_serving.py:290``).
"""
import dataclasses
import itertools

import numpy as np
import pytest

import flexflow_tpu as fj
import flexflow_tpu.parallel.pcg as jax_pcg
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.parallel.pcg as torch_pcg
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.search.machine_model import TPUMachineModel
from flexflow_tpu.search.unity import search_all as jax_search_all
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.search.machine_model import GPUMachineModel
from flexflow_tpu_torch.search.unity import search_all
from flexflow_tpu_torch.serving import ServingEngine
from flexflow_tpu_torch.serving.search import ServingPlan, serving_search

REL = 1e-9
SIM_FIELDS = ("sim_decode_ms", "sim_prefill_ms", "sim_p50_ms",
              "sim_p99_ms", "sim_tokens_per_s", "sim_memory")


@pytest.fixture(autouse=True)
def _selfcheck_and_guids(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_SEARCH_SELFCHECK", "1")
    for module in (jax_pcg, torch_pcg):
        monkeypatch.setattr(module, "_node_guid", itertools.count(1))


def _config(pkg, **fields):
    c = pkg.FFConfig()
    c.batch_size, c.max_inflight, c.max_decode_len = 8, 8, 128
    for k, v in fields.items():
        setattr(c, k, v)
    return c


def _pcgs(size, **fields):
    """(JAX pcg and config, port pcg and config) of one GPT-2 graph."""
    jc, tc = _config(fj, **fields), _config(ft, **fields)
    jff = fj.FFModel(jc)
    jax_build_gpt2(jff, JaxGPT2Config.tiny(batch_size=8) if size == "tiny"
                   else JaxGPT2Config())
    tff = ft.FFModel(tc, device="cpu")
    build_gpt2(tff, GPT2Config.tiny(batch_size=8) if size == "tiny"
               else GPT2Config())
    return (jff.create_pcg(), jc), (tff.create_pcg(), tc)


def _machines(gen="v5e", n=8):
    jm = TPUMachineModel.from_generation(gen, n)
    return jm, GPUMachineModel(**dataclasses.asdict(jm))


def _close(a, b):
    assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-300), (a, b)


@pytest.mark.parametrize("size,n,fields", [
    ("tiny", 8, {}),
    ("tiny", 4, dict(kv_dtype="int8", context_buckets="32,128")),
    ("small", 8, dict(slo_p99_ms=50.0, context_buckets="64,128")),
    ("small", 4, dict(kv_cache="ring")),
])
def test_serving_search_equals_the_jax_search(size, n, fields):
    (jp, jc), (tp_, tc) = _pcgs(size, **fields)
    jm, tm = _machines(n=n)
    want = jax_search_all(jp, jc, n, objective="serving", machine=jm)
    got = search_all(tp_, tc, n, objective="serving", machine=tm)
    assert got.describe() == want.describe()
    assert (tuple(got.mesh_shape), got.layout, got.kv_dtype,
            got.feasible) == (tuple(want.mesh_shape), want.layout,
                              want.kv_dtype, want.feasible)
    assert [c.describe() for c in got.ranked] == \
        [c.describe() for c in want.ranked]
    for a, b in zip(got.ranked, want.ranked):
        assert a.feasible == b.feasible
        for f in SIM_FIELDS:
            _close(getattr(a, f), getattr(b, f))
    for f in SIM_FIELDS:
        _close(getattr(got, f), getattr(want, f))
    assert got.context_buckets == want.context_buckets
    assert got.seq_shards_by_bucket == want.seq_shards_by_bucket
    assert {g: (s.tp, s.kind) for g, s in got.assignment.items()} == \
        {g: (s.tp, s.kind) for g, s in want.assignment.items()}


def test_serving_search_beats_naive_dp():
    _j, (pcg, config) = _pcgs("small", slo_p99_ms=50.0)
    _jm, machine = _machines()
    plan = search_all(pcg, config, 8, objective="serving", machine=machine)
    assert plan.feasible
    assert plan.sim_p99_ms <= 50.0
    assert plan.sim_memory <= machine.hbm_capacity
    naive = [c for c in plan.ranked if tuple(c.mesh_shape) == (8, 1)]
    assert naive
    assert plan.sim_tokens_per_s > naive[0].sim_tokens_per_s
    twins = {c.layout: c for c in plan.ranked
             if tuple(c.mesh_shape) == tuple(plan.mesh_shape)}
    if "sharded" in twins and "replicated" in twins:
        assert twins["sharded"].sim_tokens_per_s >= \
            twins["replicated"].sim_tokens_per_s
    with pytest.raises(ValueError, match="objective"):
        search_all(pcg, config, 8, objective="latency")


def test_serving_search_kv_dtype_axis():
    _j, (pcg, config) = _pcgs("tiny")
    _jm, machine = _machines()
    plan = serving_search(pcg, config, 8, machine=machine)
    assert {c.kv_dtype for c in plan.ranked} == {"native", "int8"}
    by_key = {(tuple(c.mesh_shape), c.layout, c.kv_dtype): c
              for c in plan.ranked}
    for (mesh, layout, dt), c in by_key.items():
        twin = by_key.get((mesh, layout, "native"))
        if dt == "int8" and twin is not None:
            assert c.sim_decode_ms <= twin.sim_decode_ms
    config.kv_dtype = "int8"
    pinned = serving_search(pcg, config, 8, machine=machine)
    assert {c.kv_dtype for c in pinned.ranked} == {"int8"}


def test_serving_search_prices_prefill_reuse():
    _j, (pcg, config) = _pcgs("tiny")
    _jm, machine = _machines()
    plan0 = serving_search(pcg, config, 8, machine=machine)
    plan6 = serving_search(pcg, config, 8, machine=machine,
                           prefill_reuse=0.6)
    assert plan0.prefill_reuse == 0.0 and plan6.prefill_reuse == 0.6
    assert plan6.sim_p99_ms < plan0.sim_p99_ms
    assert plan6.sim_decode_ms == plan0.sim_decode_ms
    plan1 = serving_search(pcg, config, 8, machine=machine,
                           prefill_reuse=5.0)
    assert plan1.sim_p99_ms == pytest.approx(plan1.sim_p50_ms)


def test_plan_seq_shards_for_routes_buckets():
    plan = ServingPlan(mesh_shape=(8, 1), layout="paged", slots=8,
                       max_decode_len=32768, slo_p99_ms=0.0,
                       sim_decode_ms=1.0, sim_prefill_ms=1.0,
                       sim_p50_ms=1.0, sim_p99_ms=1.0,
                       sim_tokens_per_s=1.0, sim_memory=0, feasible=True,
                       context_buckets=(1024, 8192, 32768),
                       seq_shards_by_bucket={1024: 1, 8192: 4, 32768: 8})
    assert plan.seq_shards_for(500) == 1
    assert plan.seq_shards_for(1024) == 1
    assert plan.seq_shards_for(2000) == 4
    assert plan.seq_shards_for(32768) == 8
    assert plan.seq_shards_for(50000) == 8
    plan.context_buckets = ()
    assert plan.seq_shards_for(50000) == 1


def test_plan_to_strategy_makes_the_executor_strategy():
    _j, (pcg, config) = _pcgs("tiny")
    _jm, machine = _machines()
    plan = serving_search(pcg, config, 8, machine=machine)
    s = plan.to_strategy(pcg)
    dp, tpar = plan.mesh_shape
    assert int(np.prod(s.mesh_shape)) == dp * tpar


def test_search_all_on_the_cpu_detects_the_fixed_card_entry():
    """With no machine the search detects one; ``device="cpu"`` takes the
    fixed H100 entry (on the CPU a search without it raises, as the
    device rule says)."""
    _j, (pcg, config) = _pcgs("tiny")
    plan = search_all(pcg, config, 4, objective="serving", device="cpu")
    assert plan.ranked and plan.sim is not None


# ---------------------------------------------------------- elastic replan
@pytest.fixture(scope="module")
def gpt2():
    c = ft.FFConfig()
    c.batch_size, c.seed = 2, 0
    ff = ft.FFModel(c, device="cpu")
    cfg = GPT2Config(batch_size=2, seq_len=32, hidden=64, num_heads=4,
                     num_layers=2, intermediate=128, vocab_size=100)
    build_gpt2(ff, cfg)
    ff.compile()
    return ff, cfg


def test_elastic_replan_mid_serve_keeps_answers_identical(gpt2):
    ff, cfg = gpt2
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 100, size=4).tolist() for _ in range(4)]
    base = ServingEngine(ff, n_slots=2, max_decode_len=cfg.seq_len
                         ).generate(prompts, max_new_tokens=5)
    eng = ServingEngine(ff, n_slots=2, max_decode_len=cfg.seq_len)
    first = eng.generate(prompts[:2], max_new_tokens=5)
    plan = eng.elastic_replan(4)
    assert eng.plan is plan
    assert plan.mesh_shape[0] * plan.mesh_shape[1] <= 4
    rest = eng.generate(prompts[2:], max_new_tokens=5)
    assert first == base[:2] and rest == base[2:]
    sim = eng._search_sim
    assert sim is not None
    hits0 = sim.cost_cache_hits
    eng.elastic_replan(2)
    assert eng._search_sim is sim and sim.cost_cache_hits > hits0


def test_elastic_replan_inside_a_serve_keeps_the_stream(gpt2):
    """A replan between two ticks of one serve leaves the decode state
    as it is: the streams are the uninterrupted serve's, the serving
    programs are made again, and the tracer gets a ``serving_replan``
    event."""
    from flexflow_tpu_torch.obs import Tracer, get_tracer, set_tracer
    from flexflow_tpu_torch.serving.scheduler import (
        ContinuousBatchScheduler, Request)

    ff, cfg = gpt2
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 100, size=n).tolist() for n in (5, 9, 3)]
    want = ServingEngine(ff, n_slots=2, max_decode_len=cfg.seq_len
                         ).generate(prompts, max_new_tokens=8)
    eng = ServingEngine(ff, n_slots=2, max_decode_len=cfg.seq_len)
    sched = ContinuousBatchScheduler(n_slots=2, max_queue=8,
                                     buckets=eng.buckets,
                                     max_len=cfg.seq_len)
    reqs = [Request(prompt=np.asarray(p, np.int32), max_new_tokens=8,
                    rng_tag=i) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.admit(sched, r)
    tracer = Tracer()
    old = get_tracer()
    set_tracer(tracer)
    try:
        loop = eng.start_serve(sched)
        ticks = 0
        while loop.tick():
            ticks += 1
            if ticks == 4:
                fns = dict(ff.executor._serving_fns)
                eng.elastic_replan(2)
                assert not any(k[0] == "decode"
                               for k in ff.executor._serving_fns)
                assert fns
        loop.finish()
    finally:
        set_tracer(old)
    assert [list(r.generated) for r in reqs] == want
    assert any(e.get("name") == "serving_replan" for e in tracer.events)
