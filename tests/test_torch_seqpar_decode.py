"""Sequence-parallel paged decode in the port (``--seq-shards``), case for
case the JAX package's ``tests/test_seqpar_decode.py``, plus the segment
partials against the JAX functions:

* the exact path is BITWISE the port's single-segment exact path at 2 and
  4 segments, solo and co-batched, through a prefix hit and chunked
  prefill (its per-segment score columns are that path's columns);
* the fast path (each segment's partial from the flash-decode kernel's
  segment mode, its plain version here, merged by ``combine_partials``)
  is within 1e-5 of the JAX package's ``_seqpar_decode`` on the same
  pools, native and int8, and greedy ``generate`` gives the JAX engine's
  tokens;
* the segment partial equals the JAX ``decode_shard_partial`` wherever the
  segment holds a key, and is ``(-1e30, 0, 0)`` where it holds none, which
  weighs exactly 0 in the combine, even over NaN blocks;
* the combine algebra, the byte forms, the refusals (ring KV, speculative
  decoding), the FF006 seq-shard laws and the context-bucket routing.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flexflow_tpu as fj
from flexflow_tpu.kernels import seqpar_decode as jsd
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.ops import attention as jatt
from flexflow_tpu.serving import ServingEngine as JaxServingEngine
from flexflow_tpu.serving import kvcache as jkv
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.kernels import seqpar_decode as tsd
from flexflow_tpu_torch.kernels.flash_decode import flash_decode_segment
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.ops import attention as tatt
from flexflow_tpu_torch.serving import ServingEngine
from flexflow_tpu_torch.serving import kvcache as tkv
from flexflow_tpu_torch.serving.kvcache import (SeqShardsError,
                                                parse_context_buckets)

CFG = dict(batch_size=2, seq_len=32, hidden=64, num_heads=4, num_layers=2,
           intermediate=128, vocab_size=100)
PROMPTS = [[5, 6, 7, 8, 9], [11, 12, 13], [3, 1, 4, 1, 5, 9, 2, 6]]


def _build(seed=42, layers=2):
    c = ft.FFConfig()
    c.batch_size, c.seed = 2, seed
    ff = ft.FFModel(c, device="cpu")
    build_gpt2(ff, GPT2Config(**dict(CFG, num_layers=layers)))
    ff.compile()
    return ff


@pytest.fixture(scope="module")
def gpt2():
    return _build()


def _gen(ff, prompts, shards, **kw):
    # kv_block_size 8: a 4-block table at max_decode_len 32, which 1, 2 and
    # 4 segments divide (FF006)
    kw.setdefault("exact_decode", True)
    eng = ServingEngine(ff, n_slots=2, max_decode_len=32, kv_block_size=8,
                        seq_shards=shards, **kw)
    return eng.generate(prompts, max_new_tokens=12), eng


# ----------------------------------------------------- bitwise contract
@pytest.mark.parametrize("shards", [2, 4])
def test_seqpar_exact_decode_bitwise_solo_and_cobatched(gpt2, shards):
    ref_solo, _ = _gen(gpt2, [PROMPTS[0]], 1)
    got_solo, _ = _gen(gpt2, [PROMPTS[0]], shards)
    assert got_solo == ref_solo
    ref_co, _ = _gen(gpt2, PROMPTS, 1)
    got_co, _ = _gen(gpt2, PROMPTS, shards)
    assert got_co == ref_co


@pytest.mark.parametrize("shards", [2, 4])
def test_seqpar_exact_decode_logits_bitwise(gpt2, shards):
    """The exact path's decode logits, step for step, equal the
    single-segment exact path's bit for bit."""
    def logits(s):
        eng = ServingEngine(gpt2, n_slots=2, max_decode_len=32,
                            kv_block_size=8, seq_shards=s,
                            exact_decode=True)
        seen, dispatch = [], eng._dispatch_decode

        def record(params, guard):
            out = dispatch(params, guard)
            seen.append(out[0].clone())
            return out

        eng._dispatch_decode = record
        eng.generate(PROMPTS, max_new_tokens=6)
        return torch.stack(seen)

    assert torch.equal(logits(shards), logits(1))


def test_seqpar_bitwise_through_prefix_hit_path(gpt2):
    shared = [7, 7, 7, 7, 7, 7, 7, 7, 2]
    prompts = [shared + [4], shared + [9]]
    ref, _ = _gen(gpt2, prompts, 1, prefix_cache="on")
    got, eng = _gen(gpt2, prompts, 2, prefix_cache="on")
    assert got == ref
    assert eng.stats.prefix_hits > 0


def test_seqpar_bitwise_through_chunked_prefill_path(gpt2):
    long_prompt = list(range(2, 2 + 17))
    ref, _ = _gen(gpt2, [long_prompt], 1)
    got, _ = _gen(gpt2, [long_prompt], 2, prefill_chunk_tokens=8)
    assert got == ref


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_seqpar_fast_path_tokens_match_the_jax_engine(kv_dtype):
    """The fast path merges per-segment partials; its greedy tokens equal
    the port's single-segment fast path's and the JAX engine's at 2
    segments."""
    jc = fj.FFConfig()
    jc.batch_size, jc.seed = 2, 42
    jff = fj.FFModel(jc)
    jax_build_gpt2(jff, JaxGPT2Config(**CFG))
    jff.compile(optimizer=fj.SGDOptimizer(jff),
                loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    tff = _build()
    import jax

    tff.set_params_numpy(jax.device_get(jff.params))
    want = JaxServingEngine(jff, n_slots=2, max_decode_len=32,
                            kv_block_size=8, seq_shards=2,
                            kv_dtype=kv_dtype).generate(
        PROMPTS, max_new_tokens=12)
    ref, _ = _gen(tff, PROMPTS, 1, exact_decode=False, kv_dtype=kv_dtype)
    got, _ = _gen(tff, PROMPTS, 2, exact_decode=False, kv_dtype=kv_dtype)
    assert got == ref == want


def test_seqpar_kv_per_chip_telemetry(gpt2):
    _, e1 = _gen(gpt2, [PROMPTS[0]], 1)
    _, e2 = _gen(gpt2, [PROMPTS[0]], 2)
    a = e1.stats.kv_hbm_per_chip_bytes
    b = e2.stats.kv_hbm_per_chip_bytes
    assert a > 0 and b > 0
    assert b == a // 2
    assert e2.stats.summary()["kv_hbm_per_chip_bytes"] == b


# --------------------------------------------- the segment partials vs JAX
def _pools(kv_dtype, seed=0, n_slots=3, heads=4, d=16, bs=8, mb=4,
           nblocks=14):
    """Random pools, a block table of distinct blocks and cursors: slot 0
    at 3 keys (segments past its first hold none), slot 1 at a segment
    boundary, slot 2 full."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(nblocks, heads, bs, d)).astype(np.float32)
    v = rng.normal(size=(nblocks, heads, bs, d)).astype(np.float32)
    tables = (1 + np.arange(n_slots * mb).reshape(n_slots, mb)) % nblocks
    positions = np.array([2, 2 * bs - 1, mb * bs - 1][:n_slots], np.int32)
    q = rng.normal(size=(n_slots, heads, 1, d)).astype(np.float32)
    entry = [torch.tensor(k), torch.tensor(v)]
    if kv_dtype == "int8":
        kq, ks = tkv.quantize_kv(entry[0])
        vq, vs = tkv.quantize_kv(entry[1])
        entry = [kq, ks, vq, vs]
    return q, entry, tables.astype(np.int32), positions


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("shards", [2, 4])
def test_fast_seqpar_attention_matches_the_jax_package(kv_dtype, shards):
    q, entry, tables, positions = _pools(kv_dtype)
    scale = 1.0 / np.sqrt(q.shape[-1])
    tsv = tkv.ServingState(mode="decode", max_len=32,
                           positions=torch.tensor(positions),
                           block_tables=torch.tensor(tables), block_size=8,
                           kv_dtype=kv_dtype, seq_shards=shards)
    got = tatt._seqpar_decode(torch.tensor(q), tuple(entry),
                              tsv.block_tables, tsv, scale, torch.float32)
    jentry = [jnp.asarray(t.numpy()) for t in entry]
    jt = jnp.asarray(tables)
    if kv_dtype == "int8":
        kc = jkv.dequantize_kv(jkv.gather_paged_kv(jentry[0], jt),
                               jkv.gather_paged_scales(jentry[1], jt),
                               jnp.float32)
        vc = jkv.dequantize_kv(jkv.gather_paged_kv(jentry[2], jt),
                               jkv.gather_paged_scales(jentry[3], jt),
                               jnp.float32)
    else:
        kc = jkv.gather_paged_kv(jentry[0], jt)
        vc = jkv.gather_paged_kv(jentry[1], jt)
    jsv = jkv.ServingState(mode="decode", max_len=32,
                           positions=jnp.asarray(positions),
                           block_tables=jt, block_size=8,
                           kv_dtype=kv_dtype, seq_shards=shards)
    want = jatt._seqpar_decode(jnp.asarray(q), kc, vc, jsv, scale,
                               kc.shape[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_segment_partials_match_jax_where_a_segment_holds_a_key(kv_dtype):
    q, entry, tables, positions = _pools(kv_dtype)
    scale = 1.0 / np.sqrt(q.shape[-1])
    n_keys = torch.tensor(positions + 1)
    tables_t = torch.tensor(tables)
    scales = dict(kscale=entry[1], vscale=entry[3]) \
        if kv_dtype == "int8" else {}
    pools = (entry[0], entry[2]) if kv_dtype == "int8" else tuple(entry)
    kc, vc = tatt._gathered_kv(tuple(entry), tables_t, kv_dtype,
                               torch.float32)
    bs = 8
    for s in range(4):  # one block a segment
        m, l, acc = flash_decode_segment(
            torch.tensor(q[:, :, 0]), *pools, tables_t, n_keys, s, s + 1,
            sm_scale=scale, **scales)
        mask = (np.arange(s * bs, (s + 1) * bs)[None, :]
                <= positions[:, None])[:, None, None, :]
        jm, jl, jacc = jsd.decode_shard_partial(
            jnp.asarray(q), jnp.asarray(kc[:, :, s * bs:(s + 1) * bs]),
            jnp.asarray(vc[:, :, s * bs:(s + 1) * bs]), jnp.asarray(mask),
            scale)
        has = positions + 1 > s * bs
        for got, want in ((m, jm), (l, jl), (acc, jacc)):
            np.testing.assert_allclose(got.numpy()[has],
                                       np.asarray(want)[has], rtol=1e-5,
                                       atol=1e-5)
        # a segment with no key: the empty partial, whatever its blocks
        assert (m.numpy()[~has] == tsd.MASK_NEG).all()
        assert (l.numpy()[~has] == 0).all() and (acc.numpy()[~has] == 0
                                                 ).all()


def test_keyless_segment_over_nan_blocks_weighs_exactly_zero():
    """Blocks that no key of a slot reaches may hold anything, NaN
    included: a segment of such blocks has the partial (-1e30, 0, 0) and
    the combined output is the live segment's alone."""
    q, entry, tables, positions = _pools("native", n_slots=1)
    positions = np.array([5], np.int32)  # keys in the first block only
    k, v = entry
    for blk in tables[0, 1:]:
        k[blk] = float("nan")
        v[blk] = float("nan")
    n_keys = torch.tensor(positions + 1)
    tq = torch.tensor(q[:, :, 0])
    tt = torch.tensor(tables)
    parts = [flash_decode_segment(tq, k, v, tt, n_keys, s, s + 1)
             for s in range(4)]
    assert torch.isfinite(parts[0][2]).all()
    for m, l, acc in parts[1:]:  # noqa: E741
        assert m.eq(tsd.MASK_NEG).all()
        assert l.eq(0).all() and acc.eq(0).all()
    alone = tsd.combine_partials(parts[:1])
    both = tsd.combine_partials(parts)
    assert torch.equal(alone, both)


# ------------------------------------------------------- combine algebra
def test_combine_partials_matches_monolithic_softmax():
    rng = np.random.default_rng(0)
    b, h, ext, d = 2, 4, 16, 8
    q = torch.tensor(rng.normal(size=(b, h, 1, d)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(b, h, ext, d)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(b, h, ext, d)), dtype=torch.float32)
    mask = torch.ones((b, h, 1, ext), dtype=torch.bool)
    scale = 1.0 / np.sqrt(d)
    seg = tsd.shard_segment(ext, 4)
    parts = [tsd.decode_shard_partial(q, k[:, :, s * seg:(s + 1) * seg],
                                      v[:, :, s * seg:(s + 1) * seg],
                                      mask[..., s * seg:(s + 1) * seg],
                                      scale)
             for s in range(4)]
    out = tsd.combine_partials(parts)
    ref = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) * scale,
                        dim=-1) @ v
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    jparts = [jsd.decode_shard_partial(
        jnp.asarray(q.numpy()), jnp.asarray(k[:, :, s * seg:(s + 1) * seg]
                                            .numpy()),
        jnp.asarray(v[:, :, s * seg:(s + 1) * seg].numpy()),
        jnp.asarray(mask[..., s * seg:(s + 1) * seg].numpy()), scale)
        for s in range(4)]
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jsd.combine_partials(jparts)),
                               rtol=1e-6, atol=1e-6)


def test_combine_fully_masked_shard_contributes_exact_zero():
    rng = np.random.default_rng(1)
    b, h, seg, d = 1, 2, 4, 8
    q = torch.tensor(rng.normal(size=(b, h, 1, d)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(b, h, seg, d)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(b, h, seg, d)), dtype=torch.float32)
    live = torch.ones((b, h, 1, seg), dtype=torch.bool)
    dead = torch.zeros((b, h, 1, seg), dtype=torch.bool)
    scale = 1.0 / np.sqrt(d)
    alone = tsd.combine_partials(
        [tsd.decode_shard_partial(q, k, v, live, scale)])
    with_dead = tsd.combine_partials(
        [tsd.decode_shard_partial(q, k, v, live, scale),
         tsd.decode_shard_partial(q, torch.full_like(k, 9.0),
                                  torch.full_like(v, 9.0), dead, scale)])
    assert torch.equal(alone, with_dead)


def test_shard_segment_and_pricing_forms():
    assert tsd.shard_segment(32, 4) == 8
    with pytest.raises(ValueError):
        tsd.shard_segment(30, 4)
    with pytest.raises(ValueError):
        tsd.shard_segment(32, 0)
    for args in ((4, 8, 2, 2), (4, 8, 2, 1), (12, 64, 8, 4)):
        assert tsd.combine_bytes_per_step(*args) == \
            jsd.combine_bytes_per_step(*args)
    assert tsd.combine_bytes_per_step(4, 8, 2, 2) == 2 * 4 * (2 + 8) * 4
    assert tsd.query_bytes_per_step(4, 8, 2, 2) == \
        jsd.query_bytes_per_step(4, 8, 2, 2) == 2 * 4 * 8 * 2
    assert tsd.MASK_NEG == jsd.MASK_NEG


# -------------------------------------------------------- refusal matrix
def test_ring_kv_refuses_seq_shards(gpt2):
    with pytest.raises(SeqShardsError, match="--seq-shards"):
        ServingEngine(gpt2, n_slots=2, max_decode_len=32, kv_cache="ring",
                      seq_shards=2)


def test_speculative_refuses_seq_sharded_models():
    from flexflow_tpu_torch.serving import SpeculativeDecoder

    target = _build(seed=1)
    drafter = _build(seed=2, layers=1)
    target.config.seq_shards = 2
    with pytest.raises(SeqShardsError, match="--seq-shards"):
        SpeculativeDecoder(target, drafter)
    target.config.seq_shards = 1
    SpeculativeDecoder(target, drafter)


# ------------------------------------------------------------ FF006 laws
def test_ff006_seq_shard_laws(gpt2):
    from flexflow_tpu_torch.analysis.rules import check_paged_kv

    pcg = gpt2.pcg
    base = dict(block_size=8, pool_blocks=17, max_blocks_per_slot=4,
                max_context=32)
    assert check_paged_kv(pcg, **base, seq_shards=4) == []
    bad = check_paged_kv(pcg, **base, seq_shards=3)
    assert any("must divide the block-table width" in d.message
               for d in bad)
    bad = check_paged_kv(pcg, **base, seq_shards=2,
                         context_buckets=(16, 64))
    assert any("bucket" in d.message.lower() for d in bad)
    base6 = dict(base, max_blocks_per_slot=6)
    bad = check_paged_kv(pcg, **base6, seq_shards=3, n_devices=8)
    assert any("mesh" in d.message or "device" in d.message for d in bad)
    bad = check_paged_kv(pcg, **base, seq_shards=4, n_devices=8,
                         kv_layout="sharded", tp=4)
    assert any("tp" in d.message or "shard" in d.message for d in bad)
    assert check_paged_kv(pcg, **base, seq_shards=2, n_devices=8,
                          kv_layout="sharded", tp=4) == []
    bad = check_paged_kv(pcg, **base, seq_shards=0)
    assert any("seq_shards" in d.message for d in bad)


def test_engine_runs_ff006_at_construction(gpt2):
    """The engine lints its paged-KV configuration when it is built, as
    the JAX engine does: a table of 4 blocks does not split into 3
    segments, and a bucket past the table is refused."""
    from flexflow_tpu_torch.analysis import StaticAnalysisError

    with pytest.raises(StaticAnalysisError, match="FF006"):
        ServingEngine(gpt2, n_slots=2, max_decode_len=32, kv_block_size=8,
                      seq_shards=3)
    with pytest.raises(StaticAnalysisError, match="bucket"):
        ServingEngine(gpt2, n_slots=2, max_decode_len=32, kv_block_size=8,
                      context_buckets=(16, 64))


# ------------------------------------------------------- bucket routing
def test_parse_context_buckets_contract():
    assert parse_context_buckets("") == ()
    assert parse_context_buckets("1024, 8192,32768") == (1024, 8192, 32768)
    assert parse_context_buckets((256, 512)) == (256, 512)
    for bad in ("8192,1024", "0,1024", "10,ten"):
        with pytest.raises(ValueError):
            parse_context_buckets(bad)


def test_admission_stamps_context_bucket(gpt2):
    from flexflow_tpu_torch.serving.scheduler import Request

    eng = ServingEngine(gpt2, n_slots=2, max_decode_len=32,
                        kv_block_size=8, exact_decode=True,
                        context_buckets=(8, 16, 32))
    r = Request(prompt=np.asarray([1, 2, 3], np.int32), max_new_tokens=4)
    eng._stamp_context_bucket(r)
    assert r.context_bucket == 8
    r2 = Request(prompt=np.asarray([1] * 20, np.int32), max_new_tokens=10)
    eng._stamp_context_bucket(r2)
    assert r2.context_bucket == 32
    r3 = Request(prompt=np.asarray([1] * 9, np.int32), max_new_tokens=4)
    r3.context_bucket = 8  # stamped by a router upstream: kept
    eng._stamp_context_bucket(r3)
    assert r3.context_bucket == 8
