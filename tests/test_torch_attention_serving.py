"""The port's serving attention against the JAX package's.

Paged decode (one token per slot written into the block pool, then read
through flash decode — its plain version on the CPU — or the exact gather
path) and chunk prefill (a chunk of one slot's rows written into its
blocks, attending over the gathered extent) run on the same seeded q/k/v
and pools in both packages: ``flexflow_tpu.ops.attention.
_serving_attention`` and ``flexflow_tpu_torch.ops.attention.
_serving_attention``. fp32, atol/rtol 1e-5 on outputs (the paths differ in
summation order only); the pools must come out bitwise equal (pure
writes).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.ops.attention import _serving_attention as jax_attention
from flexflow_tpu.serving.kvcache import ServingState as JaxServingState
from flexflow_tpu_torch.ops.attention import _serving_attention
from flexflow_tpu_torch.serving.kvcache import GARBAGE_BLOCK, ServingState

H, D, BS, MB = 4, 16, 4, 5
TOL = dict(atol=1e-5, rtol=1e-5)


def _pools(rng, n_blocks):
    k = rng.standard_normal((n_blocks, H, BS, D)).astype(np.float32)
    v = rng.standard_normal((n_blocks, H, BS, D)).astype(np.float32)
    return k, v


def _tables(rng, slots, n_blocks):
    perm = rng.permutation(np.arange(1, n_blocks))[:slots * MB]
    return perm.reshape(slots, MB).astype(np.int32)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("exact", [False, True])
def test_paged_decode_matches_jax(exact):
    rng = np.random.default_rng(0)
    slots, n_blocks = 3, 16
    kp, vp = _pools(rng, n_blocks)
    tables = _tables(rng, slots, n_blocks)
    # positions: the first slot, one mid-block, the last slot of the table
    positions = np.asarray([0, 9, MB * BS - 1], np.int32)
    q, k, v = (rng.standard_normal((slots, H, 1, D)).astype(np.float32)
               for _ in range(3))

    jsv = JaxServingState(mode="decode", max_len=MB * BS,
                          positions=jnp.asarray(positions),
                          cache_in={"att": (jnp.asarray(kp),
                                            jnp.asarray(vp))},
                          exact=exact, block_tables=jnp.asarray(tables),
                          block_size=BS)
    want = np.asarray(jax_attention("att", jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jsv, causal=True))
    want_k, want_v = (np.asarray(p) for p in jsv.cache_out["att"])

    tsv = ServingState(mode="decode", max_len=MB * BS,
                       positions=_t(positions),
                       cache_in={"att": (_t(kp), _t(vp))}, exact=exact,
                       block_tables=_t(tables), block_size=BS)
    got = _serving_attention("att", _t(q), _t(k), _t(v), tsv, causal=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got_k, got_v = tsv.cache_out["att"]
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)


@pytest.mark.parametrize("start,n_new,chunk", [(0, 7, 8), (8, 5, 8),
                                               (6, 6, 6)])
def test_chunk_prefill_matches_jax(start, n_new, chunk):
    """A chunk at position ``start`` over an already-written prefix; pad
    rows (past ``n_new``) go to the garbage block. Real rows' outputs and
    every non-garbage pool block must agree."""
    rng = np.random.default_rng(1)
    n_blocks = 8
    kp, vp = _pools(rng, n_blocks)
    table = _tables(rng, 1, n_blocks)
    q, k, v = (rng.standard_normal((1, H, chunk, D)).astype(np.float32)
               for _ in range(3))

    jsv = JaxServingState(mode="chunk", max_len=MB * BS,
                          positions=jnp.asarray([start], jnp.int32),
                          lengths=jnp.asarray([n_new], jnp.int32),
                          cache_in={"att": (jnp.asarray(kp),
                                            jnp.asarray(vp))},
                          block_tables=jnp.asarray(table), block_size=BS)
    want = np.asarray(jax_attention("att", jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jsv, causal=True))
    want_k, want_v = (np.asarray(p) for p in jsv.cache_out["att"])

    tsv = ServingState(mode="chunk", max_len=MB * BS,
                       positions=_t(np.asarray([start], np.int32)),
                       lengths=_t(np.asarray([n_new], np.int32)),
                       cache_in={"att": (_t(kp), _t(vp))},
                       block_tables=_t(table), block_size=BS)
    got = _serving_attention("att", _t(q), _t(k), _t(v), tsv, causal=True)
    np.testing.assert_allclose(got.numpy()[:, :, :n_new],
                               want[:, :, :n_new], **TOL)
    got_k, got_v = tsv.cache_out["att"]
    live = [b for b in range(n_blocks) if b != GARBAGE_BLOCK]
    np.testing.assert_array_equal(got_k.numpy()[live], want_k[live])
    np.testing.assert_array_equal(got_v.numpy()[live], want_v[live])


def test_prefill_keeps_prompt_rows_and_runs_the_causal_core():
    rng = np.random.default_rng(2)
    L = 6
    q, k, v = (rng.standard_normal((1, H, L, D)).astype(np.float32)
               for _ in range(3))
    jsv = JaxServingState(mode="prefill", max_len=MB * BS,
                          positions=jnp.zeros((1,), jnp.int32),
                          lengths=jnp.asarray([L], jnp.int32))
    want = np.asarray(jax_attention("att", jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jsv, causal=True))
    tsv = ServingState(mode="prefill", max_len=MB * BS,
                       positions=torch.zeros(1, dtype=torch.int32),
                       lengths=torch.tensor([L], dtype=torch.int32))
    got = _serving_attention("att", _t(q), _t(k), _t(v), tsv, causal=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the JAX ring holds the prompt rows at [0, L) of a max_len buffer;
    # the port hands over exactly those rows
    kbuf, vbuf = (np.asarray(b) for b in jsv.cache_out["att"])
    np.testing.assert_array_equal(tsv.cache_out["att"][0].numpy(),
                                  kbuf[:, :, :L])
    np.testing.assert_array_equal(tsv.cache_out["att"][1].numpy(),
                                  vbuf[:, :, :L])
