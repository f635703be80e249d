"""The port's ``SpeculativeDecoder`` (``flexflow_tpu_torch/serving/
speculative.py``) against the JAX package's on the CPU: the cases of
``tests/test_decode_paged.py:164-238``, ``tests/test_serving_async.py:
117-130``, ``tests/test_seqpar_decode.py:199`` and
``tests/test_housekeeping_r13.py:61-86``, on the same seeded tiny GPT-2
(hidden 64, 4 heads, 2 layers, seq 32, vocab 100) and drafter (hidden 16,
2 heads, 1 layer), the JAX weights carried over by ``set_params_numpy``.

Tolerance. The JAX law is "speculative output == the greedy exact-decode
baseline, token for token": there exact decode is bitwise the
whole-sequence forward the verification runs. In the port the two differ
by float rounding (ROADMAP C: 2.4e-6 on logits of order 3), and the two
packages' forwards differ by as much again, so streams are held equal
outside ties: two streams may part only at a position whose top-2 logit
gap, read from the port's forward on the common prefix, is under
``TIE = 1e-4``, and the tokens after such a position are not compared
(they follow other prefixes). On these fixtures no position is excluded;
the rule is there so that a legitimate near-tie cannot fail the test.
"""
import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as fj
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.serving import AdmissionController as JaxController
from flexflow_tpu.serving import ServingEngine as JaxServingEngine
from flexflow_tpu.serving import ServingStats as JaxServingStats
from flexflow_tpu.serving import SpeculativeDecoder as JaxSpeculative
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving import (AdmissionController, ServingEngine,
                                        ServingStats, SpeculativeDecoder)
from flexflow_tpu_torch.serving.kvcache import SeqShardsError

torch.set_num_threads(2)

TIE = 1e-4
SEQ = 32
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [9, 8, 7, 6, 5]]


def _pair(hidden=64, heads=4, layers=2, vocab=100, seed=42):
    """(JAX FFModel, port FFModel on the CPU) with the JAX weights."""
    kw = dict(batch_size=2, seq_len=SEQ, hidden=hidden, num_heads=heads,
              num_layers=layers, intermediate=hidden * 2, vocab_size=vocab)
    jc = fj.FFConfig()
    jc.batch_size, jc.seed = 2, seed
    jff = fj.FFModel(jc)
    jax_build_gpt2(jff, JaxGPT2Config(**kw))
    jff.compile(optimizer=fj.SGDOptimizer(jff),
                loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    tc = ft.FFConfig()
    tc.batch_size, tc.seed = 2, seed
    tff = ft.FFModel(tc, device="cpu")
    build_gpt2(tff, GPT2Config(**kw))
    tff.compile()
    tff.set_params_numpy(jax.device_get(jff.params))
    return jff, tff


@pytest.fixture(scope="module")
def target():
    return _pair()


@pytest.fixture(scope="module")
def drafter():
    return _pair(hidden=16, heads=2, layers=1, seed=7)


def _top2_gap(ff, stream) -> float:
    """The top-2 gap of the port's next-token logits after ``stream``."""
    pre = ff.executor.make_prefill_step(SEQ, SEQ, capture=False)
    ids = np.zeros((1, SEQ), np.int32)
    ids[0, :len(stream)] = stream
    _lg, last, _c = pre(ff.params, [torch.tensor(ids)],
                        torch.tensor([len(stream)], dtype=torch.int32))
    top = torch.topk(last[0], 2).values
    return float(top[0] - top[1])


def _equal_outside_ties(ff, prompts, want, got) -> int:
    """Assert ``got`` equals ``want`` stream by stream, except after a
    position whose top-2 gap is under TIE; returns the tokens excluded."""
    excluded = 0
    for p, a, b in zip(prompts, want, got):
        assert len(a) == len(b), (a, b)
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        gap = _top2_gap(ff, list(p) + list(a[:i]))
        assert gap < TIE, f"streams part at token {i} with top-2 gap {gap}"
        excluded += len(a) - i
    return excluded


def test_speculative_greedy_token_identical(target, drafter):
    """Speculative greedy output equals the exact-decode baseline and the
    JAX package's speculative output, for a random drafter and for the
    perfect drafter (the target itself: acceptance 1.0, fewer rounds than
    tokens); the engine's admission controller sees the rounds."""
    jff, tff = target
    jd, td = drafter
    jax_base = JaxServingEngine(jff, n_slots=2, max_decode_len=SEQ,
                                exact_decode=True).generate(
        PROMPTS, max_new_tokens=10)
    jax_spec = JaxSpeculative(jff, jd, gamma=3, max_context=SEQ).generate(
        PROMPTS, max_new_tokens=10)
    assert jax_spec == jax_base
    eng = ServingEngine(tff, n_slots=2, max_decode_len=SEQ,
                        exact_decode=True)
    base = eng.generate(PROMPTS, max_new_tokens=10)
    spec = SpeculativeDecoder(tff, td, gamma=3, max_context=SEQ,
                              controller=eng.admission)
    out = spec.generate(PROMPTS, max_new_tokens=10)
    assert _equal_outside_ties(tff, PROMPTS, base, out) == 0
    assert _equal_outside_ties(tff, PROMPTS, jax_spec, out) == 0
    assert spec.stats.spec_rounds > 0
    assert spec.stats.acceptance_rate() is not None
    assert spec.stats.tokens_generated == 30
    assert spec.stats.requests_served == 3
    perfect = SpeculativeDecoder(tff, tff, gamma=3, max_context=SEQ)
    assert _equal_outside_ties(
        tff, PROMPTS, base, perfect.generate(PROMPTS, max_new_tokens=10)) \
        == 0
    st = perfect.stats
    assert st.acceptance_rate() == 1.0
    assert st.spec_rounds < st.tokens_generated
    assert eng.admission.spec_acceptance is not None
    assert eng.admission.token_cost_ms > 0


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_speculative_matches_both_loops(target, drafter, loop):
    """The speculative streams against each serve loop's greedy exact
    decode, and the JAX decoder's, on the prompts of
    ``tests/test_serving_async.py``."""
    jff, tff = target
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 99, size=int(rng.integers(3, 8))).tolist()
               for _ in range(3)]
    base = ServingEngine(tff, n_slots=2, max_decode_len=SEQ,
                         exact_decode=True, serve_loop=loop).generate(
        prompts, max_new_tokens=8)
    spec = SpeculativeDecoder(tff, drafter[1], gamma=3, max_context=SEQ)
    out = spec.generate(prompts, max_new_tokens=8)
    assert _equal_outside_ties(tff, prompts, base, out) == 0
    jax_out = JaxSpeculative(jff, drafter[0], gamma=3,
                             max_context=SEQ).generate(prompts,
                                                       max_new_tokens=8)
    assert _equal_outside_ties(tff, prompts, jax_out, out) == 0
    assert spec.stats.spec_rounds > 0


def test_speculative_context_bounded_by_position_table(target):
    """The scoring bound reads the position table: a larger max_context
    is cut to it, and generation stops at it instead of scoring past it,
    at the JAX decoder's length and tokens."""
    jff, tff = target
    spec = SpeculativeDecoder(tff, tff, gamma=2, max_context=1024)
    jspec = JaxSpeculative(jff, jff, gamma=2, max_context=1024)
    assert spec.max_context == jspec.max_context == SEQ
    out = spec.generate([[1, 2, 3]], max_new_tokens=SEQ + 50)
    assert 0 < len(out[0]) <= SEQ - 3
    jout = jspec.generate([[1, 2, 3]], max_new_tokens=SEQ + 50)
    assert _equal_outside_ties(tff, [[1, 2, 3]], jout, out) == 0


def test_speculative_refuses_temperature(target):
    tff = target[1]
    spec = SpeculativeDecoder(tff, tff, gamma=2, max_context=SEQ)
    with pytest.raises(NotImplementedError, match="greedy-only"):
        spec.generate([[1, 2]], max_new_tokens=4, temperature=0.7)
    with pytest.raises(ValueError, match="gamma"):
        SpeculativeDecoder(tff, tff, gamma=0)


def test_speculative_rejects_vocab_mismatch(target):
    tff = target[1]
    tc = ft.FFConfig()
    tc.batch_size = 2
    other = ft.FFModel(tc, device="cpu")
    build_gpt2(other, GPT2Config(batch_size=2, seq_len=SEQ, hidden=64,
                                 num_heads=4, num_layers=2, intermediate=128,
                                 vocab_size=53))
    other.compile()
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeDecoder(tff, other)


def test_speculative_refuses_seq_sharded_models(target, drafter):
    tff, td = target[1], drafter[1]
    tff.config.seq_shards = 2
    try:
        with pytest.raises(SeqShardsError, match="--seq-shards"):
            SpeculativeDecoder(tff, td)
    finally:
        tff.config.seq_shards = 1
    td.config.seq_shards = 2
    try:
        with pytest.raises(SeqShardsError, match="drafter"):
            SpeculativeDecoder(tff, td)
    finally:
        td.config.seq_shards = 1
    SpeculativeDecoder(tff, td)  # a single-shard pair is fine


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_admission_controller_speculation_ewma(pkg):
    """The JAX test's script, run through each package's controller."""
    c = (JaxController if pkg == "jax" else AdmissionController)(alpha=0.5)
    assert c.spec_acceptance is None
    c.observe_speculation(0, 0)  # no proposals: no-op
    assert c.spec_acceptance is None
    c.observe_speculation(4, 4)
    assert c.spec_acceptance == 1.0
    c.observe_speculation(0, 4)
    assert c.spec_acceptance == 0.5  # EWMA with alpha 0.5
    c.observe_step(0.01, 5)
    assert c.token_cost_ms == pytest.approx(2.0)


def test_admission_controller_ewma_matches_jax_on_a_script():
    ours, theirs = AdmissionController(), JaxController()
    rng = np.random.default_rng(3)
    for _ in range(20):
        acc, prop = sorted(int(x) for x in rng.integers(0, 6, size=2))
        ours.observe_speculation(acc, prop)
        theirs.observe_speculation(acc, prop)
        assert ours.spec_acceptance == theirs.spec_acceptance


def test_stats_summary_spec_and_kv_fields_gated():
    """``tests/test_housekeeping_r13.py``'s gates on the summary keys, and
    the same summary from both packages on the same counters."""
    for cls in (JaxServingStats, ServingStats):
        st = cls()
        s = st.summary()
        assert "spec_acceptance" not in s and "kv_bytes_per_token" not in s
        assert "spec_rounds" not in s
        assert st.acceptance_rate() is None
    ours, theirs = ServingStats(), JaxServingStats()
    for st in (ours, theirs):
        st.spec_rounds, st.spec_proposed, st.spec_accepted = 3, 9, 6
        st.tokens_generated, st.kv_bytes_read = 10, 12345
    s = ours.summary()
    assert s["spec_acceptance"] == round(6 / 9, 4)
    assert s["kv_bytes_per_token"] == 1234.5
    assert s["spec_rounds"] == 3
    assert s == theirs.summary()
