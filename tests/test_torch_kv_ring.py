"""The ring KV layout (``--kv-cache ring``) and the bitwise laws of the
port's decode, on the CPU, at the exact-decode size band (GPT-2 of hidden
64, 4 heads, 2 layers, seq 64; ``tests/test_decode_paged.py``):

* the port's ring decode against the JAX package's ring decode: greedy
  streams equal, teacher-forced logits within ``RING_TOL``;
* paged-exact decode and ring decode give bitwise-equal logits, token by
  token, and the same streams end to end (with ``max_decode_len`` a
  multiple of the block size, so both read extents of one length);
* exact decode against the whole-sequence forward: the JAX package pins
  it bitwise; the port on the CPU gives the forward's greedy tokens and a
  gap of a few ulp (``EXACT_GAP``), the one-token projections summing in
  another order than the sequence's;
* the ring's constraints raise as the JAX engine's do, and its decode
  reads bill every slot's full ``max_len``;
* a quarantine frees poisoned blocks; the scheduler hands them to the
  engine to zero, so a later request given one of them for its generated
  tokens decodes as on a clean engine (without the scrub its exact read
  weighs the NaN rows by 0 and gets NaN).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.serving import ServingEngine as JaxServingEngine
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.resilience import ChaosPlan
from flexflow_tpu_torch.serving import ServingEngine
from flexflow_tpu_torch.serving.kvcache import SeqShardsError

torch.set_num_threads(2)

CFG = dict(batch_size=2, seq_len=64, hidden=64, num_heads=4, num_layers=2,
           intermediate=128, vocab_size=100)
MAX_LEN = 64
# the port's ring decode against the JAX package's: fp32 with summation
# order differences only
RING_TOL = 1e-4
# exact decode against the whole-sequence forward in the port on the CPU:
# 2.4e-6 measured (test_exact_decode_vs_full_forward), banded at 4x
EXACT_GAP = 1e-5
PROMPTS = [[5, 6, 7, 8, 9], [11, 12, 13], [1] * 9, [3, 1, 4, 1, 5, 9, 2, 6]]


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


def _seq(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG["vocab_size"], size=(1, n)).astype(np.int32)


def _teacher_forced(ff, seq, prompt_len, **engine_kw):
    """Prefill ``seq[:prompt_len]`` into slot 0 of an exact-decode engine
    of the port, then decode steps fed the true next token: the decode
    logits by position."""
    eng = ServingEngine(ff, n_slots=1, max_decode_len=MAX_LEN,
                        exact_decode=True, **engine_kw)
    bucket = next(b for b in eng.buckets if b >= prompt_len)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :prompt_len] = seq[0, :prompt_len]
    _lg, _last, cache = eng._prefill_fn(bucket)(
        ff.params, [torch.tensor(ids)],
        torch.tensor([prompt_len], dtype=torch.int32))
    eng._ensure_state(cache)
    row = None
    if eng._paged:
        blocks = eng.block_allocator.alloc(
            eng.block_allocator.blocks_needed(seq.shape[1]))
        row = np.zeros((eng.max_blocks_per_slot,), np.int32)
        row[:len(blocks)] = blocks
    eng._write_slot(cache, 0, prompt_len, int(seq[0, prompt_len - 1]), row)
    dec = eng._decode_fn()
    state = eng.state
    rows = {}
    for t in range(prompt_len, seq.shape[1]):
        lg, state = dec(ff.params, [torch.tensor(seq[:1, t:t + 1])], state)
        rows[t] = lg[0].numpy().copy()
    return rows


def _jax_teacher_forced_ring(jff, seq, prompt_len):
    eng = JaxServingEngine(jff, n_slots=1, max_decode_len=MAX_LEN,
                           exact_decode=True, kv_cache="ring")
    bucket = next(b for b in eng.buckets if b >= prompt_len)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :prompt_len] = seq[0, :prompt_len]
    _lg, _last, cache = eng._prefill_fn(bucket)(
        jff.params, [jnp.asarray(ids)], jnp.asarray([prompt_len], np.int32))
    eng._ensure_state(cache)
    eng._write_slot(cache, 0, prompt_len, int(seq[0, prompt_len - 1]))
    dec = eng._decode_fn()
    state = eng.state
    rows = {}
    for t in range(prompt_len, seq.shape[1]):
        lg, state = dec(jff.params, [jnp.asarray(seq[:1, t:t + 1])], state)
        rows[t] = np.asarray(jax.device_get(lg))[0]
    return rows


def test_ring_matches_the_jax_ring(pair):
    jff, tff = pair
    seq = _seq(1, 20)
    want = _jax_teacher_forced_ring(jff, seq, 5)
    got = _teacher_forced(tff, seq, 5, kv_cache="ring")
    worst = max(float(np.abs(got[t] - want[t]).max()) for t in want)
    assert worst <= RING_TOL, f"ring logits differ from JAX's by {worst}"
    j = JaxServingEngine(jff, n_slots=2, max_decode_len=MAX_LEN,
                         kv_cache="ring").generate(PROMPTS, max_new_tokens=8)
    eng = ServingEngine(tff, n_slots=2, max_decode_len=MAX_LEN,
                        kv_cache="ring")
    assert eng.generate(PROMPTS, max_new_tokens=8) == j
    # the ring bills every slot's whole max_len a decode step
    row = eng._kv_row_bytes()
    assert eng.stats.kv_bytes_read == \
        eng.stats.decode_steps * 2 * MAX_LEN * row


def test_paged_exact_vs_ring_bitwise(pair):
    """Ring and paged-exact decode give bitwise-equal logits position by
    position, and the same streams."""
    _, tff = pair
    seq = _seq(1, 20)
    ring = _teacher_forced(tff, seq, 5, kv_cache="ring")
    paged = _teacher_forced(tff, seq, 5, kv_cache="paged", kv_block_size=8)
    for t in ring:
        assert np.array_equal(ring[t], paged[t]), f"pos {t} diverged"
    out = {}
    for layout in ("ring", "paged"):
        eng = ServingEngine(tff, n_slots=2, max_decode_len=MAX_LEN,
                            exact_decode=True, kv_cache=layout,
                            kv_block_size=8)
        out[layout] = eng.generate(PROMPTS, max_new_tokens=8)
    assert out["ring"] == out["paged"]


def test_exact_decode_vs_full_forward(pair):
    """The JAX package's exact-decode law (``tests/test_decode_paged.py``
    :112) is bitwise; in the port on the CPU it is not: a decode step
    projects one token (torch's matrix-vector path) where the forward
    projects the sequence (its GEMM), and the sums differ in the last bits.
    So the port holds exact decode, paged and ring alike, to the forward's
    greedy tokens at every position and to ``EXACT_GAP`` (measured at
    most 2.4e-6 on logits of magnitude 3.3 over three sequences)."""
    _, tff = pair
    seq = _seq(0, MAX_LEN)
    full = tff.executor.forward(tff.params, [torch.tensor(seq)])[0].numpy()
    for layout in ("paged", "ring"):
        rows = _teacher_forced(tff, seq, 7, kv_cache=layout, kv_block_size=8)
        for t, row in rows.items():
            assert int(np.argmax(row)) == int(np.argmax(full[t])), \
                f"{layout}: greedy token differs from the forward at {t}"
        gap = max(float(np.abs(row - full[t]).max())
                  for t, row in rows.items())
        assert gap <= EXACT_GAP, f"{layout}: gap {gap} to the forward"


def test_ring_constraints_raise_as_jax(pair):
    _, tff = pair
    for kw, err, match in (
            (dict(kv_dtype="int8"), ValueError, "paged"),
            (dict(prefix_cache="on"), ValueError, "prefix_cache"),
            (dict(prefill_chunk_tokens=16), ValueError,
             "prefill_chunk_tokens"),
            (dict(seq_shards=2), SeqShardsError, "--seq-shards"),
            (dict(context_buckets=(16, 32)), ValueError,
             "--context-buckets")):
        with pytest.raises(err, match=match):
            ServingEngine(tff, max_decode_len=MAX_LEN, kv_cache="ring", **kw)
    eng = ServingEngine(tff, max_decode_len=MAX_LEN, kv_cache="ring")
    assert eng._prefix is None and eng.kv_pool_blocks is None


def test_quarantined_blocks_reach_a_later_request_clean(pair):
    """One slot, a pool of 6 usable blocks of 8, requests of 3 + 20
    tokens (3 blocks; the prefill's bucket of 16 writes the first 2). A is
    poisoned at step 15, when all three of its blocks are occupied, and
    retried on blocks 4-6; B then gets blocks 1-3, the third written only
    by its own decode steps — and read, weighed by 0, by every exact
    decode step before. B's stream and A's must be the clean engine's,
    with one quarantine. (max_decode_len 48: the pool must hold one
    max-context request, ShardLint's FF006 law the engine checks.)"""
    _, tff = pair
    ps = [[5, 6, 7], [11, 12, 13]]
    kw = dict(n_slots=1, max_decode_len=48, exact_decode=True,
              kv_block_size=8, kv_pool_blocks=7, prefix_cache="off")
    clean = ServingEngine(tff, **kw).generate(ps, max_new_tokens=20)
    eng = ServingEngine(tff, **kw)
    chaos = ChaosPlan(poison_decode_at={15: 0})
    out = eng.generate(ps, max_new_tokens=20, chaos=chaos)
    assert chaos.poisoned_decode_steps == [15]
    assert out == clean
    st = eng.stats
    assert st.quarantines == 1 and st.decode_retries == 1
    assert st.outcomes == {"ok": 2}
    assert eng.block_allocator.leaked() == []
    for entry in eng.state.caches.values():
        for pool in entry:
            assert torch.isfinite(pool).all()
