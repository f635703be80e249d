"""Serving a model compiled under a strategy, on spawned gloo ranks
(``tests/torch_serving_mesh_pairs.py``): a small GPT-2 (2 layers, 4 heads,
32 positions) under dp = 2 and tp = 2 on two ranks and hybrid 2 x 2 on
four, each served with paged native and int8 KV, greedy and top-k, and
chunk prefill over the prefix cache. Held to:

* every rank emits the same tokens (the engine also agrees a digest);
* the streams equal the port's one device (every run) and, under hybrid
  2 x 2, the JAX engine's under the same strategy on its virtual mesh
  (greedy, one-shot and chunked prefill; the sampled draws come from each
  package's own random stream);
* each decode step's logits are within 1e-4 (fp32) of the one device's,
  and the live slots' of the JAX engine's (a free slot reads the garbage
  block, which the packages' chunk prefills fill differently);
* a rank's KV pool holds num_heads / tp heads, and its KV bytes per card
  (``kv_hbm_per_chip_bytes``) and pool bytes are the one device's over
  tp; the data axis leaves them whole, as every rank serves every slot;
* ``FFModel.generate`` on the mesh gives the one device's streams;
* request deadlines and a serving ``ChaosPlan`` are refused by name on
  several ranks.
"""
import numpy as np
import pytest

import jax

import flexflow_tpu as fj
import torch_dist_pairs as tp
import torch_serving_mesh_pairs as sp
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.serving import ServingEngine as JaxServingEngine
from torch_mesh_pairs import jax_strategy

TOL = dict(rtol=1e-4, atol=1e-4)
# strategy -> (world, tp)
STRATEGIES = {"dp:2": (2, 1), "hybrid:1:2": (2, 2), "hybrid:2:2": (4, 2)}
# the JAX engine's runs: hybrid 2 x 2 (both axes), greedy, the one-shot
# and the chunked prefill; dp and tp alone are held to the one device,
# which tests/test_torch_gpt2_serving.py holds to the JAX engine
JAX_CELLS = (("hybrid:2:2", "native"), ("hybrid:2:2", "chunk"))


def jax_serve(strategy, name, weights):
    """The JAX engine's greedy streams, decode logits and live rows (a
    slot whose block table maps a block; a free slot's row reads only the
    garbage block) of run ``name`` under ``strategy``."""
    _n, ekw, gkw = next(r for r in sp.RUNS if r[0] == name)
    c = fj.FFConfig()
    c.batch_size, c.seed, c.kv_block_size = 2, 0, 8
    jff = fj.FFModel(c)
    jax_build_gpt2(jff, JaxGPT2Config(batch_size=2, **sp.GPT2))
    jff.compile(optimizer=fj.SGDOptimizer(jff),
                loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                strategy_fn=jax_strategy(strategy) if strategy else None)
    jff.params = {n: {w: jax.device_put(np.asarray(weights[n][w]),
                                        jff.params[n][w].sharding)
                      for w in ws} for n, ws in jff.params.items()}
    eng = JaxServingEngine(jff, n_slots=2, max_decode_len=sp.SEQ, **ekw)
    seen, live = [], []
    dispatch = eng._dispatch_decode

    def record(*a, **kw):
        live.append(np.asarray(eng.state.block_tables).any(axis=1))
        logits, ok = dispatch(*a, **kw)
        seen.append(np.asarray(logits, np.float32))
        return logits, ok

    eng._dispatch_decode = record
    streams = eng.generate(sp.prompts(), max_new_tokens=sp.NEW_TOKENS,
                           **gkw)
    return streams, np.stack(seen), np.stack(live)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights = sp.build(None).get_params_numpy()
    procs = []
    roots = {}
    for world in (2, 4):
        root = str(tmp_path_factory.mktemp(f"serve_mesh{world}"))
        cases = [(f"serve_{i}", "serve", dict(strategy=s))
                 for i, (s, (w, _t)) in enumerate(STRATEGIES.items())
                 if w == world]
        if world == 4:
            cases.append(("generate", "generate",
                          dict(strategy="hybrid:2:2")))
        else:
            cases.append(("refuse", "refuse", dict(strategy="dp:2")))
        for name, _kind, _args in cases:
            np.savez(f"{root}/{name}_in.npz", **tp.flat("w", weights))
        roots[world] = root
        procs.append((sp.start(world, root, cases), root))
    one = sp.build(None)
    one.set_params_numpy(weights)
    refs = {"one": sp.serve_runs(one)}
    refs["one_generate"] = one.generate(sp.prompts(),
                                        max_new_tokens=sp.NEW_TOKENS,
                                        max_inflight=2,
                                        max_decode_len=sp.SEQ)
    jax_refs = {cell: jax_serve(*cell, weights) for cell in JAX_CELLS}
    for p, root in procs:
        tp.finish(p, root, timeout=240)
    out = {}
    for i, (s, (world, _t)) in enumerate(STRATEGIES.items()):
        out[s] = [tp.load(roots[world], f"serve_{i}", r)
                  for r in range(world)]
    gen = [tp.load(roots[4], "generate", r) for r in range(4)]
    gen.append([tp.load(roots[2], "refuse", r) for r in range(2)])
    return out, refs, jax_refs, gen


CELLS = [(s, name) for s in STRATEGIES for name, _e, _g in sp.RUNS]


@pytest.mark.parametrize("strategy,run", CELLS)
def test_every_rank_emits_the_one_device_streams(runs, strategy, run):
    out, refs, _jax, _gen = runs
    want = refs["one"][f"{run}/streams"]
    for rank, got in enumerate(out[strategy]):
        np.testing.assert_array_equal(got[f"{run}/streams"], want,
                                      err_msg=f"rank {rank}")


@pytest.mark.parametrize("strategy,run", CELLS)
def test_decode_logits_match_the_one_device(runs, strategy, run):
    out, refs, _jax, _gen = runs
    want = refs["one"][f"{run}/logits"]
    for got in out[strategy]:
        np.testing.assert_allclose(got[f"{run}/logits"], want, **TOL)


@pytest.mark.parametrize("strategy,run", JAX_CELLS)
def test_streams_and_logits_match_the_jax_engine(runs, strategy, run):
    out, _refs, jax_refs, _gen = runs
    streams, logits, live = jax_refs[(strategy, run)]
    got = out[strategy][0]
    want = np.array([s + [-1] * (sp.NEW_TOKENS - len(s)) for s in streams])
    np.testing.assert_array_equal(got[f"{run}/streams"], want)
    assert live.any()
    np.testing.assert_allclose(got[f"{run}/logits"][live], logits[live],
                               **TOL)


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_kv_state_holds_the_rank_heads(runs, strategy):
    out, refs, _jax, _gen = runs
    tpar = STRATEGIES[strategy][1]
    one = refs["one"]
    for got in out[strategy]:
        for run in ("native", "int8"):
            assert int(got[f"{run}/pool_heads"]) == \
                sp.GPT2["num_heads"] // tpar
            assert int(got[f"{run}/kv_pool"]) * tpar == \
                int(one[f"{run}/kv_pool"])
            assert int(got[f"{run}/kv_hbm"]) == \
                int(one[f"{run}/kv_hbm"]) // tpar
            assert int(got[f"{run}/kv_hbm"]) > 0


def test_chunk_prefill_hits_the_prefix_cache_on_every_rank(runs):
    out, refs, _jax, _gen = runs
    assert int(refs["one"]["chunk/hits"]) >= 1
    for s in STRATEGIES:
        for got in out[s]:
            assert int(got["chunk/hits"]) == int(refs["one"]["chunk/hits"])


def test_ffmodel_generate_on_the_mesh(runs):
    _out, refs, _jax, gen = runs
    for got in gen[:4]:
        assert got["streams"].tolist() == refs["one_generate"]


@pytest.mark.parametrize("what", ["deadline", "chaos"])
def test_clock_driven_options_are_refused_on_several_ranks(runs, what):
    """Deadlines and serving chaos would let each rank decide on its own
    clock or plan: refused by name on a mesh of several ranks."""
    *_rest, gen = runs
    for got in gen[4]:
        msg = str(got[what])
        assert "later slice" in msg and "several ranks" in msg
        assert ("deadline" in msg) if what == "deadline" else \
            ("ChaosPlan" in msg)
