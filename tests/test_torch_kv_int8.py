"""int8 KV serving in the PyTorch port against the JAX package (fp32).

* ``quantize_kv``: the port's int8 rows and f32 scales equal the JAX
  package's bit for bit (both round half to even), all-zero rows included;
  ``dequantize_kv`` likewise.
* flash decode over int8 pools: the port's plain version (its CPU path)
  against the JAX Pallas kernel in interpret mode with ``kscale`` /
  ``vscale``, over ragged block tables, at JAX's own bound (atol 2e-6).
* the tiny GPT-2 of tests/test_torch_gpt2_serving.py served with
  ``kv_dtype="int8"`` in both packages, same weights: teacher-forced decode
  logits within 1e-4 (the port reads through the flash-decode plain
  version, JAX's CPU path through the gather and dequantize; summation
  order only), greedy streams token-identical with a prefix hit (the COW
  clone copies the scale arrays) and with chunked prefill, the same
  ``kv_bytes_per_token`` as JAX's, and every block back in the pool.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu.kernels.flash_decode import flash_decode as jax_decode
from flexflow_tpu.serving import ServingEngine as JaxServingEngine
from flexflow_tpu.serving.kvcache import dequantize_kv as jax_dequantize
from flexflow_tpu.serving.kvcache import quantize_kv as jax_quantize
import flexflow_tpu_torch.kernels.flash_decode as fd
from flexflow_tpu_torch.serving import ServingEngine
from flexflow_tpu_torch.serving.kvcache import (dequantize_kv,
                                                gather_paged_scales,
                                                kv_token_bytes,
                                                paged_pool_entry,
                                                quantize_kv,
                                                scatter_prefill_paged)
from test_torch_gpt2_serving import (MAX_LEN, build_pair, jax_ids,
                                     port_ids, prompt_set, teacher_forced)

TOL = dict(rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- quantizer
@pytest.mark.parametrize("shape,scale", [((3, 4, 8, 64), 1.0),
                                         ((2, 2, 5, 33), 1e-3),
                                         ((1, 4, 16, 128), 50.0)])
def test_quantize_kv_bit_exact(shape, scale):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: scale 1
    x[-1, -1, -1, :2] = [127.5, -0.5]      # halves round to even
    jq, js = jax_quantize(jnp.asarray(x))
    tq, ts = quantize_kv(torch.tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 0].item() == 1.0 and not tq[0, 0, 0].any()
    np.testing.assert_array_equal(
        dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jax_dequantize(jq, js, jnp.float32)))


def test_quantize_kv_bf16_input_bit_exact():
    x = np.random.default_rng(5).standard_normal((2, 3, 4, 64))
    jq, js = jax_quantize(jnp.asarray(x, jnp.bfloat16))
    tq, ts = quantize_kv(torch.tensor(x, dtype=torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_scatter_prefill_quantizes_rows_into_blocks():
    """The slot write of an int8 pool: block-major quantized rows and their
    scales land at the table row's blocks; the gathered scales read back
    in position order."""
    rng = np.random.default_rng(6)
    leaf = torch.tensor(rng.standard_normal((1, 2, 11, 16)),
                        dtype=torch.float32)
    pool, scales = paged_pool_entry(leaf, 6, 4, "int8")
    table = torch.tensor([3, 1, 5, 0], dtype=torch.int32)
    scatter_prefill_paged(pool, leaf, table, 4, scales=scales)
    q, s = quantize_kv(leaf[0])                          # (h, 11, d)
    for j, blk in enumerate((3, 1, 5)):
        n = min(4, 11 - 4 * j)
        assert torch.equal(pool[blk, :, :n], q[:, 4 * j:4 * j + n])
        assert torch.equal(scales[blk, :, :n], s[:, 4 * j:4 * j + n])
    got = gather_paged_scales(scales, table[None, :3])[0, :, :11]
    assert torch.equal(got, s)


def test_kv_token_bytes():
    assert kv_token_bytes(12, 64, 64, 4) == 12 * 128 * 4
    assert kv_token_bytes(12, 64, 64, 4, "int8") == 12 * (128 + 8)


# ---------------------------------------------------------- int8 decode
S, H, D, BS, MB, N_BLOCKS = 3, 4, 64, 8, 4, 16
N_KEYS_CASES = [(1, 13, 32), (16, 8, 5), (32, 31, 2)]


def _int8_inputs(seed, n_keys):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    k = rng.standard_normal((N_BLOCKS, H, BS, D)).astype(np.float32)
    v = rng.standard_normal((N_BLOCKS, H, BS, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N_BLOCKS))[:S * MB].reshape(
        S, MB).astype(np.int32)
    kq, ks = (np.asarray(a) for a in jax_quantize(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jax_quantize(jnp.asarray(v)))
    return q, kq, vq, ks, vs, tables, np.asarray(n_keys, np.int32)


@pytest.mark.parametrize("n_keys", N_KEYS_CASES)
def test_int8_plain_matches_jax_interpret(n_keys):
    q, kq, vq, ks, vs, tables, nk = _int8_inputs(0, n_keys)
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(tables), jnp.asarray(nk), kscale=jnp.asarray(ks),
        vscale=jnp.asarray(vs), interpret=True))
    t = [torch.tensor(a) for a in (q, kq, vq, tables, nk)]
    got = fd.flash_decode_plain(*t, kscale=torch.tensor(ks),
                                vscale=torch.tensor(vs))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def test_int8_wrapper_on_cpu_takes_the_plain_version_and_needs_scales():
    q, kq, vq, ks, vs, tables, nk = _int8_inputs(1, N_KEYS_CASES[0])
    t = [torch.tensor(a) for a in (q, kq, vq, tables, nk)]
    sc = dict(kscale=torch.tensor(ks), vscale=torch.tensor(vs))
    fd.reset_launch_count()
    out = fd.flash_decode(*t, **sc)
    assert fd.launch_count("flash_decode_int8") == 0
    torch.testing.assert_close(out, fd.flash_decode_plain(*t, **sc),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="kscale"):
        fd.flash_decode(*t)


# ------------------------------------------------------ tiny GPT-2, int8
@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _engines(pair, **kw):
    jff, tff = pair
    return (JaxServingEngine(jff, max_decode_len=MAX_LEN, kv_dtype="int8",
                             **kw),
            ServingEngine(tff, max_decode_len=MAX_LEN, kv_dtype="int8",
                          **kw))


def test_int8_teacher_forced_decode_logits_match(pair):
    jff, tff = pair
    seq = np.random.default_rng(4).integers(1, 100, 20).astype(np.int32)
    je, te = _engines(pair, n_slots=1)
    want = teacher_forced(je, jff.params, seq, 9, 8, jax_ids)
    got = teacher_forced(te, tff.params, seq, 9, 8, port_ids)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("chunk", [0, 8])
def test_int8_greedy_streams_identical(pair, chunk):
    """With the prefix cache on (a hit, so a COW clone and a suffix chunk
    under int8), and with ``chunk`` 8 every prompt prefilled in chunks."""
    je, te = _engines(pair, prefill_chunk_tokens=chunk)
    prompts = prompt_set()
    want = je.generate(prompts, max_new_tokens=8)
    got = te.generate(prompts, max_new_tokens=8)
    assert got == want
    if chunk:
        assert te.stats.chunked_prefills >= 3
    else:
        assert te.stats.prefix_hits >= 1 and te.stats.chunked_prefills >= 1
    assert te.stats.kv_bytes_per_token() == je.stats.kv_bytes_per_token()


def test_int8_kv_bytes_per_token_below_native(pair):
    _, tff = pair
    native = ServingEngine(tff, max_decode_len=MAX_LEN)
    int8 = ServingEngine(tff, max_decode_len=MAX_LEN, kv_dtype="int8")
    for eng in (native, int8):
        eng.generate(prompt_set(), max_new_tokens=8)
    n, q = (e.stats.kv_bytes_per_token() for e in (native, int8))
    # 4 heads x 16 dims: fp32 K+V is 4 * 32 * 4 bytes, int8 4 * (32 + 8)
    assert q / n == pytest.approx((32 + 8) / (32 * 4))
    assert "kv_bytes_per_token" in int8.stats.summary()


def test_int8_every_block_returns_to_the_pool(pair):
    _, tff = pair
    te = ServingEngine(tff, max_decode_len=MAX_LEN, kv_dtype="int8",
                       prefix_cache="off")
    te.generate(prompt_set(), max_new_tokens=8)
    assert te.block_allocator.leaked() == []
    te = ServingEngine(tff, max_decode_len=MAX_LEN, kv_dtype="int8")
    te.generate(prompt_set(), max_new_tokens=8)
    held = te.block_allocator.leaked()
    assert held
    assert all(te.block_allocator.refcount(b) == 1 for b in held)


def test_int8_pool_layout(pair):
    _, tff = pair
    te = ServingEngine(tff, max_decode_len=MAX_LEN, kv_dtype="int8")
    te.generate(prompt_set()[:1], max_new_tokens=2)
    for entry in te.state.caches.values():
        kq, ks, vq, vs = entry
        assert kq.dtype == vq.dtype == torch.int8
        assert ks.dtype == vs.dtype == torch.float32
        assert tuple(ks.shape) == tuple(kq.shape[:3])


def test_int8_needs_the_paged_layout(pair):
    _, tff = pair
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(tff, max_decode_len=MAX_LEN, kv_dtype="int8",
                      kv_cache="ring")
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(tff, max_decode_len=MAX_LEN, kv_dtype="fp8")


def test_jax_params_unchanged_by_serving(pair):
    """Serving reads the params only: the port's stay the JAX package's."""
    jff, tff = pair
    jp = jax.device_get(jff.params)
    tp = tff.get_params_numpy()
    for node, ws in jp.items():
        for w, arr in ws.items():
            np.testing.assert_array_equal(np.asarray(arr), tp[node][w])
