"""Row top-k in the PyTorch port against the JAX package.

* ``topk_plain`` (the CPU path of the port's kernel wrapper) against the
  JAX Pallas kernel ``pallas_topk`` in interpret mode, k = 1..8, rows of
  128 to 1024, with injected ties and rows with fewer than k finite
  entries, fp32 and bf16: values and indices EQUAL (the sweeps' order is
  total, so there is no tolerance to state).
* the backward (the one-hot scatter of the value cotangent) against
  ``jax.vjp`` of ``pallas_topk``.
* ``FFModel.top_k`` / ``TopKOp`` against the JAX op on its ``lax.top_k``
  path (distinct values), with and without ``use_pallas``.
* the serving sampler: top_k = 1 at a temperature is greedy decoding, the
  top-k is taken before the division by the temperature, and the kernel
  route is taken exactly where the JAX sampler takes its Pallas kernel.
* the routing gate's truth table.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
from flexflow_tpu.kernels.topk import pallas_topk
from flexflow_tpu.ops.base import OpContext as JaxOpContext
from flexflow_tpu.ops.tensor_ops import TopKOp as JaxTopKOp
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.kernels.topk as tk
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.ops.tensor_ops import TopKOp
from flexflow_tpu_torch.serving import ServingEngine


def _rows(seed, rows, dim):
    """fp32 rows with a repeated maximum, a tie across the k-th place, a
    row with two finite entries (the rest -inf) and a row of all -inf."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, dim)).astype(np.float32)
    x[0, [3, 70, dim - 1]] = 9.0
    x[1, [5, 6, 100]] = 7.5
    x[1, [1, 2]] = 8.0
    x[2] = -np.inf
    x[2, [dim // 2, 1]] = [0.5, -3.0]
    x[3] = -np.inf
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,dim", [(1, 128), (2, 256), (3, 512), (4, 1024),
                                   (5, 128), (6, 256), (7, 512), (8, 1024)])
def test_plain_equals_jax_pallas_interpret(k, dim, dtype):
    x = _rows(k * dim, 8, dim)
    jv, ji = pallas_topk(jnp.asarray(x, dtype), k, interpret=True)
    tv, ti = tk.topk_plain(torch.tensor(x).to(getattr(torch, dtype)), k)
    assert ti.dtype == torch.int32 and tv.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv, np.float32))


def test_plain_on_rank_three_input():
    x = np.random.default_rng(1).standard_normal((2, 3, 256)).astype(
        np.float32)
    jv, ji = pallas_topk(jnp.asarray(x), 4, interpret=True)
    tv, ti = tk.topk(torch.tensor(x), 4)
    assert tuple(ti.shape) == (2, 3, 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_backward_matches_jax_vjp():
    x = _rows(2, 8, 256)
    x[2:4] = np.random.default_rng(3).standard_normal((2, 256))
    w = np.random.default_rng(4).standard_normal((8, 5)).astype(np.float32)
    (jv, _ji), vjp = jax.vjp(lambda a: pallas_topk(a, 5, interpret=True),
                             jnp.asarray(x))
    (jgx,) = vjp((jnp.asarray(w), np.zeros((8, 5), jax.dtypes.float0)))
    xt = torch.tensor(x, requires_grad=True)
    tv, _ti = tk.topk(xt, 5)
    (tgx,) = torch.autograd.grad(tv, xt, torch.tensor(w))
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(jgx))


def test_wrapper_takes_plain_path_on_cpu_without_launching():
    x = torch.tensor(_rows(5, 8, 256))
    tk.reset_launch_count()
    v, i = tk.topk(x, 3)
    assert tk.launch_count() == 0
    pv, pi = tk.topk_plain(x, 3)
    assert torch.equal(v, pv) and torch.equal(i, pi)


# ---------------------------------------------------- TopKOp / ff.top_k
@pytest.mark.parametrize("use_pallas", [False, True])
def test_topk_op_matches_jax_op(use_pallas):
    x = np.random.default_rng(6).standard_normal((4, 256)).astype(
        np.float32)  # distinct values
    attrs = {"k": 3, "sorted": True, "use_pallas": use_pallas}
    jv, ji = JaxTopKOp("tk", attrs, fj.DataType.DT_FLOAT).forward(
        {}, [jnp.asarray(x)], JaxOpContext())
    tv, ti = TopKOp("tk", attrs, ft.DataType.DT_FLOAT).forward(
        {}, [torch.tensor(x)], OpContext())
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_ff_top_k_builder_matches_jax():
    outs = {}
    for pkg in (fj, ft):
        config = pkg.FFConfig()
        config.batch_size = 4
        ff = pkg.FFModel(config) if pkg is fj else \
            pkg.FFModel(config, device="cpu")
        x = ff.create_tensor((4, 256), pkg.DataType.DT_FLOAT)
        vals, idx = ff.top_k(x, 5, True, None, use_pallas=True)
        assert vals.dims == idx.dims == (4, 5)
        ff.compile()
        node = ff.pcg.nodes[ff.final_guid]
        assert node.out_dtypes == [pkg.DataType.DT_FLOAT,
                                   pkg.DataType.DT_INT32]
        outs[pkg] = ff.predict(
            np.random.default_rng(7).standard_normal((4, 256)).astype(
                np.float32))
    np.testing.assert_array_equal(outs[ft], np.asarray(outs[fj]))


# -------------------------------------------------------------- sampler
def _tiny(vocab):
    c = ft.FFConfig()
    c.batch_size, c.seed, c.kv_block_size = 2, 0, 8
    ff = ft.FFModel(c, device="cpu")
    build_gpt2(ff, GPT2Config(batch_size=2, seq_len=32, hidden=32,
                              num_heads=2, num_layers=1, intermediate=64,
                              vocab_size=vocab))
    ff.compile()
    return ff


PROMPTS = [[1, 2, 3], [7, 8, 9, 10], [4] * 12]


def test_top_1_sampling_is_greedy_through_the_kernel_route(monkeypatch):
    ff = _tiny(256)
    greedy = ServingEngine(ff, max_decode_len=32).generate(
        PROMPTS, max_new_tokens=6)
    calls = []
    plain = tk.topk_plain
    monkeypatch.setattr(tk, "topk_plain",
                        lambda x, k: calls.append(k) or plain(x, k))
    eng = ServingEngine(ff, max_decode_len=32)
    sampled = eng.generate(PROMPTS, max_new_tokens=6, temperature=0.8,
                           top_k=1, seed=5)
    assert sampled == greedy
    # one top-k per sampler call: every prefill and every decode step
    assert len(calls) == eng.stats.prefills + eng.stats.decode_steps


@pytest.mark.parametrize("vocab,k,kernel", [(256, 8, True), (256, 9, False),
                                            (100, 4, False)])
def test_sampler_routes_top_k_as_jax(monkeypatch, vocab, k, kernel):
    """The kernel route exactly where the JAX sampler takes its Pallas
    kernel (1 <= k <= 8, vocab a multiple of 128), ``torch.topk`` else;
    every token inside the top k of its logits."""
    ff = _tiny(vocab)
    calls = []
    plain = tk.topk_plain
    monkeypatch.setattr(tk, "topk_plain",
                        lambda x, kk: calls.append(kk) or plain(x, kk))
    out = ff.generate(PROMPTS, max_new_tokens=4, temperature=1.0, top_k=k,
                      max_decode_len=32)
    assert [len(o) for o in out] == [4, 4, 4]
    assert all(0 <= t < vocab for o in out for t in o)
    assert bool(calls) == kernel


def test_top_k_is_taken_before_the_temperature_divides():
    """Two logits that differ in fp32 but tie once divided by the
    temperature: the JAX order (top-k of the raw logits, then divide)
    keeps the larger one, whatever index the tie would favour."""
    temp = np.float32(0.8)
    # neighbouring floats in [1, 2) land in [2, 4) once divided, where the
    # spacing doubles: find a pair that merges
    small = next(a for a in np.linspace(1.6, 1.99, 4096, dtype=np.float32)
                 if a / temp == np.nextafter(a, np.float32(2)) / temp)
    big = np.nextafter(small, np.float32(2))
    assert big > small
    logits = torch.full((1, 256), -5.0)
    logits[0, 10] = float(small)     # the lower index wins the tie
    logits[0, 20] = float(big)
    eng = ServingEngine(_tiny(256), max_decode_len=32)
    # (tag, count) rows and the seed are device int32 tensors
    tok = eng._sampler(float(temp), 1)(
        logits, torch.zeros((1, 2), dtype=torch.int32),
        torch.zeros((1,), dtype=torch.int32))
    assert int(tok[0]) == 20


# ------------------------------------------------------------------ gate
def _fake(shape, dtype=torch.float32, device="cuda"):
    """A stand-in with a tensor's shape, dtype and device: the gate reads
    nothing else."""
    return types.SimpleNamespace(shape=tuple(shape), dtype=dtype,
                                 device=torch.device(device),
                                 dim=lambda: len(shape))


@pytest.mark.parametrize("shape,k,dtype,opt_in,device,want", [
    ((8, 50304), 8, torch.float32, True, "cuda", True),
    ((8, 50304), 1, torch.bfloat16, True, "cuda", True),
    ((2, 3, 128), 4, torch.float16, True, "cuda", True),
    ((8, 50304), 8, torch.float32, False, "cuda", False),   # no opt-in
    ((8, 50304), 8, torch.float32, True, "cpu", False),     # not on CUDA
    ((8, 50304), 9, torch.float32, True, "cuda", False),    # k > 8
    ((8, 50304), 0, torch.float32, True, "cuda", False),
    ((8, 50257), 8, torch.float32, True, "cuda", False),    # % 128
    ((8, 64), 4, torch.float32, True, "cuda", False),       # < 128
    ((50304,), 4, torch.float32, True, "cuda", False),      # rank 1
    ((8, 256), 4, torch.float64, True, "cuda", False),      # 8 bytes
    ((8, 256), 4, torch.int32, True, "cuda", False),        # not a float
])
def test_gate_truth_table(shape, k, dtype, opt_in, device, want):
    x = _fake(shape, dtype, device)
    assert tk.should_use_topk_kernel(x, k, opt_in=opt_in) is want
    # the sampler's half is the shape rule alone: opted in, on CUDA
    assert tk.topk_kernel_shape(x, k) is tk.should_use_topk_kernel(
        _fake(shape, dtype), k, opt_in=True)
