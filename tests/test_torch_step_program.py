"""The step programs (``flexflow_tpu_torch/execution/graphs.py``) on the CPU.

On CUDA the train and decode steps are captured as CUDA graphs and
replayed; on the CPU the same programs run their bodies through the same
static input, seed and output buffers, which these tests reach:

* a dropout seed given as a 0-d integer tensor (how a captured step feeds
  the kernels) masks bit for bit as the int seed and JAX's
  ``dropout_keep_scale_nd``;
* the optimizers' device step count and Adam's on-device ``alpha_t``
  against the jitted JAX update over three steps (1e-6);
* ``make_train_step()`` is cached, and ``invalidate_jit_cache`` and
  ``set_params_numpy`` drop it;
* ``fit`` over 3 steps keeps 3 distinct per-step losses (the program's
  outputs are static; each call returns copies) equal to JAX's (1e-5);
* the seeds a program feeds a step are the ones the eager step draws from
  the same generator, in count and order, and give the eager loss bit for
  bit, on the flash and the einsum-core routes;
* a tiny GPT-2 ``generate`` through the static token buffer gives JAX's
  greedy streams.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
import flexflow_tpu.kernels.flash_attention  # noqa: F401
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.serving import ServingEngine as JaxServingEngine
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.execution.graphs import DropoutSeeds
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving import ServingEngine

from torch_training_pairs import B, TOL, _build, build_pair, data

# the package re-exports the function under the module's name
jfa = sys.modules["flexflow_tpu.kernels.flash_attention"]
torch.set_num_threads(2)

SEED = 2 ** 32 - 5  # above 2**31: the int32 bits read as unsigned


# ------------------------------------------------------------ (a) seeds
@pytest.mark.parametrize("kind", ["int", "int64", "int32"])
def test_tensor_seed_masks_like_the_int_seed_and_jax(kind):
    rng = np.random.default_rng(5)
    n = 4096
    bh, qp, kp = (rng.integers(0, 2 ** 20, n), rng.integers(0, 2 ** 31, n),
                  rng.integers(0, 2 ** 31, n))
    seed = {"int": SEED,
            "int64": torch.tensor(SEED, dtype=torch.int64),
            "int32": torch.tensor(SEED - 2 ** 32, dtype=torch.int32)}[kind]
    want = np.asarray(jfa.dropout_keep_scale_nd(
        jnp.uint32(SEED), jnp.asarray(bh, jnp.uint32),
        jnp.asarray(qp, jnp.uint32), jnp.asarray(kp, jnp.uint32), 0.1))
    coords = (torch.tensor(bh), torch.tensor(qp), torch.tensor(kp))
    got = fa.dropout_keep_scale_plain(seed, *coords, 0.1).numpy()
    by_int = fa.dropout_keep_scale_plain(SEED, *coords, 0.1).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got.view(np.uint32), by_int.view(np.uint32))


# ------------------------------------------- (b) device step and alpha_t
@pytest.mark.parametrize("kind", ["adam", "sgd_momentum"])
def test_device_step_count_matches_the_jitted_jax_update(kind):
    rng = np.random.default_rng(11)
    params = {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32),
                    "b": rng.standard_normal(3).astype(np.float32)}}
    grads = [{"a": {w: rng.standard_normal(p.shape).astype(np.float32)
                    for w, p in params["a"].items()}} for _ in range(3)]
    if kind == "adam":
        kw = dict(alpha=3e-2, beta1=0.8, beta2=0.95, weight_decay=1e-2)
        jopt, topt = fj.AdamOptimizer(None, **kw), ft.AdamOptimizer(None,
                                                                    **kw)
    else:
        kw = dict(lr=0.05, momentum=0.9, weight_decay=1e-2)
        jopt, topt = fj.SGDOptimizer(None, **kw), ft.SGDOptimizer(None, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {n: {w: torch.tensor(a) for w, a in ws.items()}
          for n, ws in params.items()}
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    counter = ts["step"]
    jupdate = jax.jit(jopt.update)
    for g in grads:
        jp, js = jupdate(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts = topt.update(tp, {n: {w: torch.tensor(a)
                                      for w, a in ws.items()}
                                  for n, ws in g.items()}, ts)
    # one int32 tensor on the params' device, counted in place
    assert ts["step"] is counter
    assert counter.dtype == torch.int32 and counter.dim() == 0
    assert int(counter) == int(js["step"]) == 3
    for w in params["a"]:
        np.testing.assert_allclose(tp["a"][w].numpy(),
                                   np.asarray(jp["a"][w]), rtol=1e-6,
                                   atol=1e-6)
    if kind == "adam":
        at = topt.alpha_t(counter)
        assert at.dtype == torch.float32 and at.dim() == 0
        f = np.float32
        want = f(3e-2) * np.sqrt(f(1) - f(0.95) ** f(3)) / (f(1) - f(0.8)
                                                           ** f(3))
        np.testing.assert_allclose(float(at), want, rtol=1e-6)


# ---------------------------------------------- (c) caching, invalidation
def test_train_step_is_cached_and_invalidated():
    _jff, tff = build_pair("bert")
    ex = tff.executor
    step = ex.make_train_step()
    assert ex.make_train_step() is step
    assert ex.make_train_step(capture=False) is not step
    x, y = data("bert")
    xs, lab = [torch.tensor(x)], torch.tensor(tff._prep_label(y))
    step(tff.params, tff.opt_state, xs, lab, None)
    assert step.program._entries  # the shape's buffers are held
    decode = ex.make_decode_step(16, block_size=8)
    assert ex.make_decode_step(16, block_size=8) is decode
    ex.invalidate_jit_cache()
    assert not step.program._entries
    assert ex.make_train_step() is not step
    assert ex.make_decode_step(16, block_size=8) is not decode
    step2 = ex.make_train_step()
    tff.set_params_numpy(tff.get_params_numpy())
    assert ex.make_train_step() is not step2
    # replaced params without an invalidate: the program starts the shape
    # over instead of reading the old tensors
    step3 = ex.make_train_step()
    step3(tff.params, tff.opt_state, xs, lab, None)
    old = step3.program._entries
    (key, entry), = old.items()
    tff.params = {n: {w: t.clone() for w, t in ws.items()}
                  for n, ws in tff.params.items()}
    step3(tff.params, tff.opt_state, xs, lab, None)
    assert step3.program._entries[key] is not entry


# --------------------------------------------------- (d) fit's outputs
def test_fit_keeps_each_steps_loss():
    jff, tff = build_pair("gpt2")
    x, y = data("gpt2", n=3 * B, seed=4)
    jff._telemetry_requested = True
    jff.fit(x, y, epochs=1, shuffle=False)
    tff.fit(x, y, epochs=1, shuffle=False)
    got = tff.fit_history.loss
    assert len(got) == 3 and len(set(got)) == 3
    np.testing.assert_allclose(got, jff._telemetry.loss_history, **TOL)


# ------------------------------------------------------- (e) the seeds
def _dropout_model(use_flash):
    ff = _build(ft, "bert", optimizer=ft.SGDOptimizer(None, lr=0.0))
    for node in ff.pcg.compute_nodes():
        if node.op.op_type == ft.OperatorType.OP_MULTIHEAD_ATTENTION:
            node.op.attrs["dropout"] = 0.1
            node.op.attrs["use_flash"] = use_flash
    return ff


@pytest.mark.parametrize("use_flash", [True, False])
def test_fed_seeds_are_the_eager_draws(use_flash):
    ff = _dropout_model(use_flash)
    ex = ff.executor
    x, y = data("bert")
    xs, lab = [torch.tensor(x)], torch.tensor(ff._prep_label(y))
    step = ex.make_train_step()

    def gen(k):
        return torch.Generator().manual_seed(k)

    losses = {}
    for k in (1, 2, 3, 2):  # the first call draws, later ones are fed
        _p, _s, loss, _m = step(ff.params, ff.opt_state, xs, lab, gen(k))
        fed = list(step.program.last_seeds)
        eager = DropoutSeeds(gen(k))
        want, _lg, _g = ex.loss_and_grads(ff.params, xs, lab, eager)
        assert fed == eager.drawn and len(fed) == 2  # one per layer
        assert float(loss) == float(want)
        losses.setdefault(k, float(loss))
        assert float(loss) == losses[k]
    assert len(set(losses.values())) == 3  # each generator, its own mask


# -------------------------------------------- (f) decode's token buffer
def _gpt2_pair():
    cfg = dict(batch_size=2, seq_len=32, hidden=64, num_heads=4,
               num_layers=2, intermediate=128, vocab_size=100)
    jc, tc = fj.FFConfig(), ft.FFConfig()
    jc.batch_size, jc.seed, jc.kv_block_size = 2, 42, 8
    tc.batch_size, tc.seed, tc.kv_block_size = 2, 42, 8
    jff = fj.FFModel(jc)
    jax_build_gpt2(jff, JaxGPT2Config(**cfg))
    jff.compile(optimizer=fj.SGDOptimizer(jff),
                loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    tff = ft.FFModel(tc, device="cpu")
    build_gpt2(tff, GPT2Config(**cfg))
    tff.compile()
    tff.set_params_numpy(jax.device_get(jff.params))
    return jff, tff


@pytest.mark.parametrize("chunk", [0, 8])
def test_generate_through_the_static_token_buffer(chunk):
    jff, tff = _gpt2_pair()
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 100, 16).tolist()
    prompts = [shared + [5, 6, 7], shared + [9, 3],
               rng.integers(1, 100, 21).tolist(), [3, 1, 4, 1, 5]]
    want = JaxServingEngine(jff, max_decode_len=32, n_slots=2,
                            prefill_chunk_tokens=chunk).generate(
        prompts, max_new_tokens=8)
    eng = ServingEngine(tff, max_decode_len=32, n_slots=2,
                        prefill_chunk_tokens=chunk)
    got = eng.generate(prompts, max_new_tokens=8)
    tokens = eng._last_tokens
    assert got == want
    assert eng.stats.requests_served == 4 and eng.stats.decode_steps >= 8
    # two slots for four requests: slots are reused; one buffer throughout
    assert eng.generate(prompts[:1], max_new_tokens=2) == \
        [w[:2] for w in want[:1]]
    assert eng._last_tokens is tokens
    assert eng.decode_compiles is None  # nothing is captured on the CPU
