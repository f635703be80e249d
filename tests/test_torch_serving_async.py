"""The port's ``--serve-loop async`` (``flexflow_tpu_torch/serving/engine.py``
``_AsyncServeLoop``) on the CPU, the applicable cases of
``tests/test_serving_async.py``: the async loop dispatches decode step k+1
while step k's tokens are on their way to the host and commits them at
arrival, one step behind dispatch. The sync loop is the reference:

* async streams equal sync streams — solo greedy, co-batched sampled (native
  and int8 KV), a prefix hit, chunked prefill;
* one blocking token fetch (``host_syncs``) per committed decode step in
  both loops;
* host work done while a step is in flight lands in ``host_overlap_s``, in
  the denominator of ``host_overhead_fraction`` only;
* ``finish`` settles the pending step, through ``admit`` and
  ``start_serve``, and every request ends with outcome "ok";
* an unknown ``serve_loop`` raises ``ValueError`` naming it;
* the port's async greedy streams equal the JAX engine's greedy streams
  from the same weights (``set_params_numpy``).

Speculative decoding (``test_torch_speculative.py``, against both loops)
and serving under failure (``test_torch_serving_resilience*.py``) have
their own files; the fleet comes in a later slice.
"""
import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as fj
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.serving import ServingEngine as JaxServingEngine
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving import (ContinuousBatchScheduler, Request,
                                        ServingEngine)

torch.set_num_threads(2)

# the JAX file's tiny family (hidden 64 / 4 heads) at seq 64, so prompts
# span KV blocks of 8: prefix hits and chunked prefill have room
CFG = dict(batch_size=8, seq_len=64, hidden=64, num_heads=4, num_layers=2,
           intermediate=128, vocab_size=100)


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


@pytest.fixture(scope="module")
def gpt2(pair):
    return pair[1]


def _prompts(n, seed=0, lo=3, hi=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 99, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _shared_prompts():
    sys_p = list(np.random.default_rng(7).integers(1, 99, size=20))
    return [sys_p + [5, 6, 7], sys_p + [8, 9], sys_p + [5, 6, 1, 2]]


def _chunked_prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(1, 99, size=40).tolist()] + _prompts(3, seed=10)


def _engine(ff, loop, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_decode_len", 64)
    kw.setdefault("kv_block_size", 8)
    return ServingEngine(ff, serve_loop=loop, **kw)


def _both(ff, prompts, max_new=6, gen_kw=None, **kw):
    """The same trace through both loops: (sync outs, async outs, sync
    stats, async stats)."""
    outs, stats = {}, {}
    for loop in ("sync", "async"):
        eng = _engine(ff, loop, **kw)
        outs[loop] = eng.generate(prompts, max_new_tokens=max_new,
                                  **(gen_kw or {}))
        stats[loop] = eng.stats
    return outs["sync"], outs["async"], stats["sync"], stats["async"]


# ------------------------------------------------------------ clean parity
def test_async_matches_sync_solo_greedy(gpt2):
    s, a, _, _ = _both(gpt2, _prompts(1, seed=1), n_slots=1)
    assert s == a and all(len(x) == 6 for x in s)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_async_matches_sync_cobatched_sampled(gpt2, kv_dtype):
    """Temperature + top-k sampling, 8 streams through 3 slots: a slot whose
    token is still in flight at dispatch k+1 draws at count + 1, so a
    discarded draw never shifts a stream."""
    s, a, ss, sa = _both(gpt2, _prompts(8, seed=2), max_new=8,
                         gen_kw={"temperature": 0.7, "top_k": 5, "seed": 3},
                         kv_dtype=kv_dtype)
    assert s == a, "sampled streams diverged between loops"
    assert ss.requests_served == sa.requests_served == 8


def test_async_matches_sync_prefix_hit(gpt2):
    """Shared-system-prompt trace with the radix trie on: commit at arrival
    must not disturb the trie's insert and hit order."""
    s, a, ss, sa = _both(gpt2, _shared_prompts(), n_slots=2)
    assert s == a
    assert ss.prefix_hits == sa.prefix_hits and sa.prefix_hits >= 1


def test_async_matches_sync_chunked_prefill(gpt2):
    """A long prompt prefilling in chunks co-scheduled with decode steps:
    chunk ticks and decode commits interleave identically in token
    order."""
    s, a, ss, sa = _both(gpt2, _chunked_prompts(), n_slots=2,
                         prefill_chunk_tokens=16)
    assert s == a
    assert sa.chunked_prefills == ss.chunked_prefills >= 3
    assert ss.requests_served == sa.requests_served == 4


# --------------------------------------------------- white-box contracts
def test_one_blocking_sync_per_committed_step(gpt2):
    """Every blocking token fetch goes through ``_fetch``, exactly once per
    committed decode step, in both loops."""
    _, _, ss, sa = _both(gpt2, _prompts(6, seed=17), max_new=8)
    for st in (ss, sa):
        assert st.decode_steps > 0
        assert st.host_syncs == st.decode_steps, \
            (st.host_syncs, st.decode_steps)
    # the async loop's extra dispatches at stream tails are discarded by
    # the epoch guard; it still never fetches more than once per commit
    assert sa.host_syncs <= sa.decode_steps


def test_overlap_accounting(gpt2):
    """Host work done while a dispatched step is in flight lands in
    ``host_overlap_s``: wall in the denominator only."""
    _, _, ss, sa = _both(gpt2, _prompts(6, seed=18), max_new=8)
    assert ss.host_overlap_s == 0.0
    assert sa.host_overlap_s > 0.0, "async recorded no overlapped host work"
    assert ss.host_ticks > 0 and sa.host_ticks > 0
    num = sa.host_dispatch_s + sa.host_bookkeep_s
    den = num + sa.host_device_s + sa.host_overlap_s
    assert sa.host_overhead_fraction() == pytest.approx(num / den)
    summary = sa.summary()
    assert summary["host_syncs"] == sa.host_syncs
    assert "host_overhead_fraction" in summary


def test_finish_settles_pending(gpt2):
    """``finish`` is a drain point: after it no step is in flight and every
    request ended with outcome "ok" (slot epochs moved on every free)."""
    eng = _engine(gpt2, "async", n_slots=2)
    sched = ContinuousBatchScheduler(n_slots=2, max_queue=8, max_len=64,
                                     buckets=eng.buckets)
    reqs = [Request(prompt=np.asarray(p, np.int32), max_new_tokens=5,
                    rng_tag=i)
            for i, p in enumerate(_prompts(3, seed=19))]
    for r in reqs:
        eng.admit(sched, r)
    loop = eng.start_serve(sched)
    while loop.tick():
        pass
    loop.finish()
    assert loop._pending is None
    assert all(r.outcome == "ok" and len(r.generated) == 5 for r in reqs)
    assert sum(sched.slot_epoch) == 3
    assert eng.stats.requests_served == 3


def test_admit_takes_an_explicit_resilience(gpt2):
    """``admit(resilience=)`` stamps and gates on the caller's policy
    object (a deadline arms it), and the async serve handed the same
    object runs the guarded program and ledgers the request ``ok``."""
    eng = _engine(gpt2, "async")
    res = eng._make_resilience(None)
    sched = ContinuousBatchScheduler(n_slots=3, max_len=64, clock=res.clock)
    req = Request(prompt=np.asarray([1, 2], np.int32), max_new_tokens=2,
                  deadline_ms=1e9)
    eng.admit(sched, req, resilience=res)
    assert eng._pending_resilience is None and res.deadlines_armed
    eng.serve(sched, resilience=res)
    assert eng._last_guard is True
    assert req.outcome == "ok" and len(req.generated) == 2
    assert eng.stats.outcomes == {"ok": 1}


def test_serve_loop_validation(gpt2):
    with pytest.raises(ValueError, match="serve_loop"):
        ServingEngine(gpt2, n_slots=1, max_decode_len=64, serve_loop="turbo")


# --------------------------------------------------------- cross-package
@pytest.mark.parametrize("trace", ["cobatched", "prefix", "chunked"])
def test_async_greedy_streams_equal_jax(pair, trace):
    """The port's async loop against the JAX engine on the same weights:
    greedy streams token-identical, prefix hits and chunk prefills
    included."""
    jff, tff = pair
    prompts, kw = {"cobatched": (_prompts(6, seed=21), {}),
                   "prefix": (_shared_prompts(), {}),
                   "chunked": (_chunked_prompts(),
                               {"prefill_chunk_tokens": 16})}[trace]
    want = JaxServingEngine(jff, n_slots=3, max_decode_len=64,
                            kv_block_size=8, **kw).generate(
        prompts, max_new_tokens=8)
    eng = _engine(tff, "async", **kw)
    assert eng.generate(prompts, max_new_tokens=8) == want
    assert eng.stats.host_syncs == eng.stats.decode_steps
