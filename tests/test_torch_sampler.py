"""The serving sampler (``flexflow_tpu_torch/serving/engine.py``
``draw_tokens``, run by ``ServingEngine._sampler`` as one step program per
(temperature, top_k)) on the CPU, through the program's code path (its
static input and output buffers, nothing captured here):

* the sampled-token law: the same (seed, tag, count) and the same logits
  row give the same token whatever the row's position, the batch it is
  drawn in or the order of the rows; and end to end, the same sampled
  streams whatever the slot count or the submission order;
* the draw's law: many draws of one fixed top-8 row against
  ``softmax(vals / T)`` by a chi-square test;
* ``top_k = 1`` streams equal greedy streams;
* the top-k is taken on the raw logits, before the division by the
  temperature;
* a second call through the program's static buffers equals the first, and
  the draw equals :func:`draw_tokens` called directly.

The streams are the port's own: the JAX engine draws from ``jax.random``.
"""
import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving import (ContinuousBatchScheduler, Request,
                                        ServingEngine)
from flexflow_tpu_torch.serving.engine import draw_tokens

torch.set_num_threads(2)

VOCAB = 128  # a multiple of 128: the top-k takes the kernel's route
# chi-square critical value for 7 degrees of freedom (8 candidates) at
# p = 0.001
CHI2_CRIT_7DOF_P001 = 24.32


def _model(vocab=VOCAB):
    c = ft.FFConfig()
    c.batch_size, c.seed = 8, 42
    ff = ft.FFModel(c, device="cpu")
    build_gpt2(ff, GPT2Config(batch_size=8, seq_len=64, hidden=64,
                              num_heads=4, num_layers=2, intermediate=128,
                              vocab_size=vocab))
    ff.compile()
    return ff


@pytest.fixture(scope="module")
def ff():
    return _model()


def _sampler(ff, temperature, top_k):
    return ServingEngine(ff, n_slots=2, max_decode_len=64)._sampler(
        temperature, top_k)


def _i32(rows):
    return torch.tensor(np.asarray(rows, np.int64).astype(np.int32))


def _seed(seed):
    return _i32([np.uint32(seed & 0xFFFFFFFF).view(np.int32)])


# ----------------------------------------------------------- the law
@pytest.mark.parametrize("top_k", [0, 8, 3])
def test_same_seed_tag_count_and_row_give_the_same_token(ff, top_k):
    """Each (tag, count) row keeps its token when drawn alone, in a batch
    of other rows, at another position or in another order."""
    sample = _sampler(ff, 0.9, top_k)
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((6, VOCAB), generator=gen) * 2
    tc = [(0, 0), (0, 1), (5, 0), (5, 3), (2 ** 20, 7), (3, 2 ** 30)]
    seed = _seed(2 ** 32 - 3)
    whole = sample(logits, _i32(tc), seed)
    for i in range(6):
        alone = sample(logits[i:i + 1], _i32([tc[i]]), seed)
        assert int(alone[0]) == int(whole[i])
    perm = [4, 2, 5, 0, 3, 1]
    shuffled = sample(logits[perm], _i32([tc[p] for p in perm]), seed)
    assert shuffled.tolist() == whole[perm].tolist()
    # the seed, the tag and the count each move the draws
    other = sample(logits.repeat(40, 1), _i32([(0, c) for c in range(240)]),
                   seed)
    assert len(set(other.tolist())) > 1


def _serve_tagged(ff, prompts, order, n_slots, **sampling):
    """Serve ``prompts`` submitted in ``order`` (each keeps its tag, its
    index in ``prompts``) over ``n_slots`` slots; streams by tag."""
    eng = ServingEngine(ff, n_slots=n_slots, max_decode_len=64,
                        kv_block_size=8)
    sched = ContinuousBatchScheduler(n_slots=n_slots, max_queue=16,
                                     max_len=64, buckets=eng.buckets)
    reqs = {}
    for i in order:
        reqs[i] = Request(prompt=np.asarray(prompts[i], np.int32),
                          max_new_tokens=6, rng_tag=i)
        eng.admit(sched, reqs[i])
    eng.serve(sched, **sampling)
    return [reqs[i].generated for i in range(len(prompts))]


def test_streams_keep_their_draws_under_any_coscheduling(ff):
    """End to end: the same sampled streams with 1, 3 or 8 slots and in
    reverse submission order."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, VOCAB, int(rng.integers(3, 9))).tolist()
               for _ in range(6)]
    kw = dict(temperature=0.8, top_k=8, seed=11)
    want = _serve_tagged(ff, prompts, range(6), 1, **kw)
    assert _serve_tagged(ff, prompts, range(6), 3, **kw) == want
    assert _serve_tagged(ff, prompts, range(5, -1, -1), 8, **kw) == want
    assert _serve_tagged(ff, prompts, range(6), 3,
                         **dict(kw, seed=12)) != want


# ------------------------------------------------------ the distribution
@pytest.mark.parametrize("temperature,seed", [(0.8, 0), (1.5, 77)])
def test_chi_square_of_one_top8_row(ff, temperature, seed):
    """20000 draws of one fixed row (tag 3, counts 0..19999) against
    ``softmax(top-8 values / T)``: the chi-square statistic stays under
    the 7-degree-of-freedom critical value at p = 0.001."""
    n = 20000
    gen = torch.Generator().manual_seed(1)
    row = torch.randn((1, VOCAB), generator=gen)
    sample = _sampler(ff, temperature, 8)
    toks = sample(row.expand(n, VOCAB).contiguous(),
                  _i32([(3, c) for c in range(n)]), _seed(seed))
    vals, idx = torch.topk(row[0], 8)
    p = torch.softmax(vals.double() / temperature, dim=0).numpy()
    counts = np.array([(toks == int(i)).sum().item() for i in idx])
    assert counts.sum() == n  # every draw is one of the top 8
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < CHI2_CRIT_7DOF_P001, (chi2, counts, n * p)


# ------------------------------------------------ the sampler's order
def test_top_k_1_streams_equal_greedy(ff):
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], list(range(1, 30))]
    eng = ServingEngine(ff, n_slots=2, max_decode_len=64, kv_block_size=8)
    greedy = eng.generate(prompts, max_new_tokens=8)
    top1 = eng.generate(prompts, max_new_tokens=8, temperature=0.8, top_k=1,
                        seed=4)
    assert top1 == greedy


def test_top_k_is_taken_on_the_raw_logits():
    """Two logits that differ in fp32 but tie once divided by the
    temperature, the smaller one at the lower index: the top 2 of the raw
    logits hold the larger, so the smaller one is never drawn (top-k
    after the division would keep the lower index of the tie)."""
    temp = np.float32(0.8)
    small = next(a for a in np.linspace(1.6, 1.99, 4096, dtype=np.float32)
                 if a / temp == np.nextafter(a, np.float32(2)) / temp)
    big = np.nextafter(small, np.float32(2))
    n = 400
    logits = torch.full((n, VOCAB), -5.0)
    logits[:, 10] = float(small)
    logits[:, 20] = float(big)
    logits[:, 30] = float(big) + 0.1
    ff = _model()
    toks = _sampler(ff, float(temp), 2)(
        logits, _i32([(0, c) for c in range(n)]), _seed(0))
    assert set(toks.tolist()) == {20, 30}


def test_program_path_equals_the_body(ff):
    """Two calls through the program (first call, then the static buffers)
    give :func:`draw_tokens`'s tokens."""
    sample = _sampler(ff, 0.7, 0)
    gen = torch.Generator().manual_seed(2)
    logits = torch.randn((4, VOCAB), generator=gen)
    tc, seed = _i32([(0, 0), (1, 5), (2, 9), (3, 1)]), _seed(9)
    want = draw_tokens(logits, tc, seed, 0.7, 0)
    assert sample(logits, tc, seed).tolist() == want.tolist()
    assert sample(logits, tc, seed).tolist() == want.tolist()
    assert _sampler(ff, 0.0, 5)(logits).tolist() == \
        logits.argmax(-1).tolist()
