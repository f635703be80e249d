"""Tiny GPT-2 served by the PyTorch port against the JAX package (fp32).

Both packages build the same tiny GPT-2 (hidden 64, 4 heads, 2 layers,
seq 32, vocab 100); the JAX model's initialized params are carried into
the port with ``set_params_numpy`` (``utils/weights.params_from_numpy``),
so both run the same weights. Checked:

* prefill logits and 8 teacher-forced paged decode steps: rtol/atol 1e-4
  (fp32; the paths differ in summation order — the port's decode reads
  through the flash-decode plain version, JAX's CPU path through the
  masked gather);
* greedy ``generate`` streams token-identical, for prompts that share a
  prefix (a prefix-cache hit, so the chunk-prefill step runs) and with
  ``prefill_chunk_tokens=8``.
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
from flexflow_tpu_torch.serving import ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 32
KV_BLOCK = 8


def build_pair(compute_dtype=None, seed=42):
    """(jax FFModel, port FFModel on the CPU) with identical weights."""
    cfg = dict(batch_size=2, seq_len=32, hidden=64, num_heads=4,
               num_layers=2, intermediate=128, vocab_size=100)
    jc = fj.FFConfig()
    jc.batch_size, jc.seed, jc.kv_block_size = 2, seed, KV_BLOCK
    tc = ft.FFConfig()
    tc.batch_size, tc.seed, tc.kv_block_size = 2, seed, KV_BLOCK
    if compute_dtype is not None:
        jc.compute_dtype = compute_dtype
        tc.compute_dtype = ft.DataType(int(compute_dtype))
    jff = fj.FFModel(jc)
    jax_build_gpt2(jff, JaxGPT2Config(**cfg))
    jff.compile(optimizer=fj.SGDOptimizer(jff),
                loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    tff = ft.FFModel(tc, device="cpu")
    build_gpt2(tff, GPT2Config(**cfg))
    tff.compile()
    tff.set_params_numpy(jax.device_get(jff.params))
    return jff, tff


def prompt_set():
    """Four prompts: two share a 16-token prefix (two full KV blocks), so
    the second admission hits the prefix cache and chunk-prefills its
    suffix; plus one long enough to chunk at 8 tokens and one short."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 100, 16).tolist()
    return [shared + [5, 6, 7], shared + [9, 3],
            rng.integers(1, 100, 21).tolist(), [3, 1, 4, 1, 5]]


def prefill_logits(eng, params, ids, lengths, to_numpy):
    """(logits of the real rows, last-row logits) of one prefill."""
    logits, last, _ = eng._prefill_fn(ids.shape[1])(params, [ids], lengths)
    return to_numpy(logits)[0, :int(lengths[0])], to_numpy(last)


def teacher_forced(eng, params, seq, plen, steps, as_ids):
    """Prefill ``seq[:plen]`` into slot 0 through the engine's own
    machinery (allocator, table row, slot write), then ``steps`` decode
    steps fed the true next token. Returns the decode logits (steps, V)."""
    bucket = next(b for b in eng.buckets if b >= plen)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :plen] = seq[:plen]
    _lg, _last, cache = eng._prefill_fn(bucket)(
        params, [as_ids(ids)], as_ids(np.asarray([plen], np.int32)))
    eng._ensure_state(cache)
    blocks = eng.block_allocator.alloc(
        eng.block_allocator.blocks_needed(plen + steps))
    row = np.zeros((eng.max_blocks_per_slot,), np.int32)
    row[:len(blocks)] = blocks
    eng._write_slot(cache, 0, plen, int(seq[plen]), table_row=row)
    out = []
    for s in range(steps):
        logits, eng.state = eng._decode_fn()(params, [eng._last_tokens],
                                             eng.state)[:2]
        out.append(np.asarray(logits, np.float32)[0]
                   if not isinstance(logits, torch.Tensor)
                   else logits.float().numpy()[0])
        eng._last_tokens = as_ids(np.asarray([[seq[plen + s + 1]]],
                                             np.int32))
    return np.stack(out)


def jax_ids(a):
    return jnp.asarray(a)


def port_ids(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def test_params_carry_over_one_to_one(pair):
    jff, tff = pair
    jp = jax.device_get(jff.params)
    tp = tff.get_params_numpy()
    assert sorted(jp) == sorted(tp)
    for node, ws in jp.items():
        assert sorted(ws) == sorted(tp[node])
        for w, arr in ws.items():
            np.testing.assert_array_equal(np.asarray(arr), tp[node][w])


def test_prefill_logits_match(pair):
    jff, tff = pair
    rng = np.random.default_rng(3)
    ids = np.zeros((1, 16), np.int32)
    ids[0, :11] = rng.integers(1, 100, 11)
    lengths = np.asarray([11], np.int32)
    je = JaxServingEngine(jff, n_slots=1, max_decode_len=MAX_LEN)
    te = ServingEngine(tff, n_slots=1, max_decode_len=MAX_LEN)
    jl, jlast = prefill_logits(je, jff.params, jax_ids(ids),
                               jax_ids(lengths), np.asarray)
    tl, tlast = prefill_logits(te, tff.params, port_ids(ids),
                               port_ids(lengths),
                               lambda x: x.float().numpy())
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(tlast, jlast, **TOL)


def test_eight_decode_steps_match(pair):
    jff, tff = pair
    rng = np.random.default_rng(4)
    seq = rng.integers(1, 100, 20).astype(np.int32)
    je = JaxServingEngine(jff, n_slots=1, max_decode_len=MAX_LEN)
    te = ServingEngine(tff, n_slots=1, max_decode_len=MAX_LEN)
    want = teacher_forced(je, jff.params, seq, 9, 8, jax_ids)
    got = teacher_forced(te, tff.params, seq, 9, 8, port_ids)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)


def test_greedy_streams_identical_with_prefix_hit(pair):
    jff, tff = pair
    prompts = prompt_set()
    want = JaxServingEngine(jff, max_decode_len=MAX_LEN).generate(
        prompts, max_new_tokens=8)
    te = ServingEngine(tff, max_decode_len=MAX_LEN)
    got = te.generate(prompts, max_new_tokens=8)
    assert got == want
    assert te.stats.prefix_hits >= 1 and te.stats.chunked_prefills >= 1


def test_greedy_streams_identical_with_chunked_prefill(pair):
    jff, tff = pair
    prompts = prompt_set()
    want = JaxServingEngine(jff, max_decode_len=MAX_LEN,
                            prefill_chunk_tokens=8).generate(
        prompts, max_new_tokens=8)
    te = ServingEngine(tff, max_decode_len=MAX_LEN, prefill_chunk_tokens=8)
    got = te.generate(prompts, max_new_tokens=8)
    assert got == want
    assert te.stats.chunked_prefills >= 3


def test_ffmodel_generate_matches(pair):
    """The user-facing entry point: FFModel.generate in both packages."""
    jff, tff = pair
    prompts = prompt_set()[2:]
    assert tff.generate(prompts, max_new_tokens=6, max_decode_len=MAX_LEN) \
        == jff.generate(prompts, max_new_tokens=6, max_decode_len=MAX_LEN)


# --------------------------------------------------------------- bf16 compute
# --compute-dtype bf16 in both packages (fp32 master weights, bf16
# activations and GEMMs, fp32 layer-norm statistics and attention scores).
# The frameworks round to bf16 at different points, so logits are held to
# a band: 4 bf16 ulps at the largest logit of this model (|logit| < 4, ulp
# 2**-6 there), i.e. 0.0625.
BF16_BAND = 4 * 2.0 ** -6


@pytest.fixture(scope="module")
def pair_bf16():
    return build_pair(fj.DataType.DT_BFLOAT16)


def test_bf16_prefill_and_decode_logits_in_band(pair_bf16):
    jff, tff = pair_bf16
    rng = np.random.default_rng(3)
    ids = np.zeros((1, 16), np.int32)
    ids[0, :11] = rng.integers(1, 100, 11)
    lengths = np.asarray([11], np.int32)
    jl, _ = prefill_logits(
        JaxServingEngine(jff, n_slots=1, max_decode_len=MAX_LEN),
        jff.params, jax_ids(ids), jax_ids(lengths), np.asarray)
    tl, _ = prefill_logits(
        ServingEngine(tff, n_slots=1, max_decode_len=MAX_LEN), tff.params,
        port_ids(ids), port_ids(lengths), lambda x: x.float().numpy())
    assert np.abs(jl).max() < 4
    assert np.abs(tl - jl).max() <= BF16_BAND
    # greedy argmax identity at every row, given the same inputs
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))

    seq = np.random.default_rng(4).integers(1, 100, 20).astype(np.int32)
    want = teacher_forced(
        JaxServingEngine(jff, n_slots=1, max_decode_len=MAX_LEN),
        jff.params, seq, 9, 8, jax_ids)
    got = teacher_forced(
        ServingEngine(tff, n_slots=1, max_decode_len=MAX_LEN), tff.params,
        seq, 9, 8, port_ids)
    assert np.abs(got - want).max() <= BF16_BAND
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_bf16_greedy_streams_keep_the_fp32_tokens(pair, pair_bf16):
    """Free-running greedy streams in bf16 are the fp32 streams on this
    prompt set (prefix hit and chunking included). Compared with fp32,
    not with JAX's bf16 streams: JAX's bf16 roundings turn a near-tie the
    other way on the first prompt's 5th token (ROADMAP §C)."""
    jff, _ = pair
    _, tff16 = pair_bf16
    prompts = prompt_set()
    want = JaxServingEngine(jff, max_decode_len=MAX_LEN).generate(
        prompts, max_new_tokens=8)
    te = ServingEngine(tff16, max_decode_len=MAX_LEN)
    assert te.generate(prompts, max_new_tokens=8) == want
    assert te.stats.prefix_hits >= 1


def test_every_block_returns_to_the_pool(pair):
    """Block accounting: with the prefix cache off every KV block is free
    after the run; with it on, the only blocks still held are the trie's,
    one reference each."""
    _, tff = pair
    te = ServingEngine(tff, max_decode_len=MAX_LEN, prefix_cache="off")
    te.generate(prompt_set(), max_new_tokens=8)
    assert te.block_allocator.leaked() == []
    te = ServingEngine(tff, max_decode_len=MAX_LEN)
    te.generate(prompt_set(), max_new_tokens=8)
    held = te.block_allocator.leaked()
    assert held
    assert all(te.block_allocator.refcount(b) == 1 for b in held)
