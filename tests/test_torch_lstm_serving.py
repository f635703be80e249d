"""LSTM serving in the port (``ops/recurrent.py``, ``execution/executor.py``,
``serving/engine.py``) against the JAX package on the CPU: the carry of
the LSTM is its decode state. The graph is ``tests/test_serving.py:106``'s
``lm_embed -> lm_lstm -> lm_head`` language model (vocab 50, width 16,
batch 4, seq 12), plus a two-layer stack of it, built in both packages,
the JAX weights carried over by ``set_params_numpy``.

* The prefill hands decode the carry at each row's true last token, not
  at the padded tail: its last logits row is the forward's row at
  ``L - 1`` (within 1e-5 of the port's forward, 1e-4 of JAX's prefill).
* Teacher-forced decode logits are within 1e-5 of the port's own
  whole-sequence forward and within 1e-4 of JAX's decode, with the
  greedy tokens equal (the JAX test holds its own decode within 1e-5 of
  its forward).
* ``ServingEngine.generate`` streams equal the JAX engine's, on the paged
  and the ring layout, through the sync and the async loop, with more
  prompts than slots (recycled slots) and with an EOS; a NaN-poisoned
  carry is quarantined and the request re-prefilled, its stream the
  clean one, as in JAX.
* ``prefix_cache="on"`` and ``prefill_chunk_tokens`` raise ``ValueError``
  naming the LSTM in both packages (``tests/test_prefix_cache.py:484``);
  left at its default the prefix cache is off.
* The decode program writes the carry in place into the persistent
  slot-major buffer: two calls of one program advance it twice, and the
  program keeps the buffer it was first called with (a rebinding would
  make it start over, and a captured graph would advance a copy).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
import flexflow_tpu.resilience as jres
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.resilience as tres
from flexflow_tpu.serving import ServingEngine as JaxServingEngine
from flexflow_tpu.serving.kvcache import DecodeState as JaxDecodeState
from flexflow_tpu_torch.serving import ServingEngine
from flexflow_tpu_torch.serving.kvcache import DecodeState

torch.set_num_threads(2)

VOCAB, WIDTH, BATCH, SEQ = 50, 16, 4, 12
OWN_TOL = 1e-5   # the port's decode vs its own forward
JAX_TOL = 1e-4   # the port vs the JAX package


def _lm(pkg, layers=1, device=None):
    c = pkg.FFConfig()
    c.batch_size = BATCH
    ff = pkg.FFModel(c, device=device) if device else pkg.FFModel(c)
    ids = ff.create_tensor((BATCH, SEQ), dtype=pkg.DataType.DT_INT32,
                           name="lm_ids")
    t = ff.embedding(ids, VOCAB, WIDTH, name="lm_embed")
    for i in range(layers):
        t, _state = ff.lstm(t, WIDTH, name="lm_lstm" if i == 0
                            else f"lm_lstm{i}")
    ff.dense(t, VOCAB, name="lm_head")
    if device:
        ff.compile()
    else:
        ff.compile(optimizer=pkg.SGDOptimizer(ff),
                   loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _pair(layers):
    jff = _lm(fj, layers)
    tff = _lm(ft, layers, device="cpu")
    tff.set_params_numpy(jax.device_get(jff.params))
    return jff, tff


@pytest.fixture(scope="module", params=[1, 2], ids=["lstm1", "lstm2"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def pair1():
    return _pair(1)


def _seq(seed=0):
    return np.random.default_rng(seed).integers(
        0, VOCAB, size=(1, SEQ)).astype(np.int32)


def _torch_teacher_forced(ff, seq, L, bucket):
    """Prefill L tokens at ``bucket``, then decode with the true next token
    fed each step: (prefill last row, {position: decode row}, the
    prefill's cache)."""
    pre = ff.executor.make_prefill_step(bucket, SEQ)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :L] = seq[0, :L]
    _lg, last, cache = pre(ff.params, [torch.tensor(ids)],
                           torch.tensor([L], dtype=torch.int32))
    state = DecodeState(caches=dict(cache),
                        lengths=torch.tensor([L], dtype=torch.int32))
    dec = ff.executor.make_decode_step(SEQ, exact=True, capture=False)
    rows = {}
    for t in range(L, SEQ):
        lg, state = dec(ff.params, [torch.tensor(seq[:, t:t + 1])], state)
        rows[t] = lg[0].numpy().copy()
    return last[0].numpy(), rows, cache


def _jax_teacher_forced(ff, seq, L, bucket):
    pre = ff.executor.make_prefill_step(bucket_len=bucket,
                                        max_decode_len=SEQ)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :L] = seq[0, :L]
    _lg, last, cache = pre(ff.params, [jnp.asarray(ids)],
                           jnp.asarray([L], np.int32))
    state = JaxDecodeState(caches=cache,
                           lengths=jnp.asarray([L], jnp.int32))
    dec = ff.executor.make_decode_step(SEQ, exact=True)
    rows = {}
    for t in range(L, SEQ):
        lg, state = dec(ff.params, [jnp.asarray(seq[:, t:t + 1])], state)
        rows[t] = np.asarray(lg)[0]
    return np.asarray(last)[0], rows


def _torch_forward(ff, seq):
    fwd = ff.executor.make_forward()
    return fwd(ff.params, [torch.tensor(np.repeat(seq, BATCH, 0))])[0]\
        .numpy()


@pytest.mark.parametrize("L", [1, 4, 7])
def test_prefill_carry_at_true_length(pair, L):
    jff, tff = pair
    seq = _seq()
    full = _torch_forward(tff, seq)
    last, _rows, cache = _torch_teacher_forced(tff, seq, L, 8)
    jlast, _jrows = _jax_teacher_forced(jff, seq, L, 8)
    np.testing.assert_allclose(last, full[L - 1], rtol=0, atol=OWN_TOL)
    np.testing.assert_allclose(last, jlast, rtol=0, atol=JAX_TOL)
    # the carry is the state at L - 1: the unpadded prefill's carry
    _l, _r, exact = _torch_teacher_forced(tff, seq, L, L)
    for name, carry in cache.items():
        assert carry.shape == (1, 2 * WIDTH)
        np.testing.assert_allclose(carry.numpy(), exact[name].numpy(),
                                   rtol=0, atol=OWN_TOL)


def test_teacher_forced_decode_matches_forward_and_jax(pair):
    jff, tff = pair
    for seed, L in ((0, 4), (1, 2)):
        seq = _seq(seed)
        full = _torch_forward(tff, seq)
        _last, rows, _c = _torch_teacher_forced(tff, seq, L, 8)
        _jl, jrows = _jax_teacher_forced(jff, seq, L, 8)
        assert sorted(rows) == list(range(L, SEQ))
        for t, row in rows.items():
            np.testing.assert_allclose(row, full[t], rtol=0, atol=OWN_TOL)
            np.testing.assert_allclose(row, jrows[t], rtol=0, atol=JAX_TOL)
            assert int(np.argmax(row)) == int(np.argmax(full[t])) == \
                int(np.argmax(jrows[t]))


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(rng.integers(1, 7))).tolist()
            for _ in range(n)]


_JAX_STREAMS = {}


def _jax_streams(jff, kv, ps):
    """The JAX engine's greedy streams, without and with an EOS (one
    engine per model and layout: the loop does not change them)."""
    key = (id(jff), kv)
    if key not in _JAX_STREAMS:
        eng = JaxServingEngine(jff, n_slots=2, max_decode_len=SEQ,
                               kv_cache=kv)
        want = eng.generate(ps, max_new_tokens=5)
        eos = want[0][1]
        _JAX_STREAMS[key] = want, eos, eng.generate(
            ps, max_new_tokens=5, eos_id=eos)
    return _JAX_STREAMS[key]


@pytest.mark.parametrize("kv", ["paged", "ring"])
@pytest.mark.parametrize("loop", ["sync", "async"])
def test_generate_matches_jax(pair, kv, loop):
    """Five prompts through two slots (three recycled), then the same with
    an EOS that ends streams early: the JAX engine's greedy streams."""
    jff, tff = pair
    ps = _prompts(5)
    want, eos, want_eos = _jax_streams(jff, kv, ps)
    eng = ServingEngine(tff, n_slots=2, max_decode_len=SEQ, kv_cache=kv,
                        serve_loop=loop)
    assert eng._prefix is None
    assert eng.generate(ps, max_new_tokens=5) == want
    assert eng.stats.outcomes == {"ok": 5}
    assert any(len(o) < 5 for o in want_eos)
    assert eng.generate(ps, max_new_tokens=5, eos_id=eos) == want_eos


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_poisoned_carry_is_quarantined_and_re_prefilled(pair1, loop):
    """A NaN written into slot 0's carry before decode step 2: the guarded
    program flags that slot alone, the request is retried on a fresh slot
    (its carry rewritten by the re-prefill), and every stream is the clean
    one — the JAX engine's outcome, ledger and streams."""
    jff, tff = pair1
    ps = _prompts(4, seed=3)

    def run(ff, engine_cls, chaos_cls, **kw):
        base = engine_cls(ff, n_slots=2, max_decode_len=SEQ).generate(
            ps, max_new_tokens=5)
        eng = engine_cls(ff, n_slots=2, max_decode_len=SEQ, **kw)
        chaos = chaos_cls(poison_decode_at={2: 0})
        outs = eng.generate(ps, max_new_tokens=5, chaos=chaos)
        st = eng.stats
        return (base, outs, chaos.poisoned_decode_steps, st.quarantines,
                st.decode_retries, dict(st.outcomes))

    j = run(jff, JaxServingEngine, jres.ChaosPlan)
    t = run(tff, ServingEngine, tres.ChaosPlan, serve_loop=loop)
    assert t == j
    base, outs, steps, quarantines, retries, outcomes = t
    assert outs == base and steps == [2]
    assert quarantines == 1 and retries == 1 and outcomes == {"ok": 4}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_lstm_graphs_gate_prefix_and_chunking(pair1, pkg):
    ff = pair1[0] if pkg == "jax" else pair1[1]
    cls = JaxServingEngine if pkg == "jax" else ServingEngine
    eng = cls(ff, n_slots=2, max_decode_len=SEQ)
    assert eng._prefix is None  # default "on" silently degrades
    with pytest.raises(ValueError, match="LSTM"):
        cls(ff, n_slots=2, max_decode_len=SEQ, prefix_cache="on")
    with pytest.raises(ValueError, match="LSTM"):
        cls(ff, n_slots=2, max_decode_len=SEQ, prefill_chunk_tokens=16,
            kv_block_size=4)


def test_lstm_chunk_mode_raises(pair1):
    """The op's backstop: a chunk-mode forward of an LSTM raises."""
    from flexflow_tpu_torch.ops.base import OpContext
    from flexflow_tpu_torch.serving.kvcache import ServingState

    tff = pair1[1]
    node = next(n for n in tff.executor.pcg.compute_nodes()
                if n.op.op_type == ft.OperatorType.OP_LSTM)
    sv = ServingState(mode="chunk", max_len=SEQ,
                      positions=torch.zeros(1, dtype=torch.int32))
    ctx = OpContext(training=False, device=torch.device("cpu"), serving=sv)
    with pytest.raises(NotImplementedError, match="chunk"):
        node.op.forward(tff.params[node.name],
                        [torch.zeros((1, 4, WIDTH))], ctx)


def test_decode_program_advances_the_carry_in_place(pair1):
    _jff, tff = pair1
    name = next(n.name for n in tff.executor.pcg.compute_nodes()
                if n.op.op_type == ft.OperatorType.OP_LSTM)
    prog_step = tff.executor.make_decode_step(SEQ, exact=True)
    eager_step = tff.executor.make_decode_step(SEQ, exact=True,
                                               capture=False)
    rng = np.random.default_rng(5)
    carry0 = torch.tensor(rng.normal(0, 0.5, (2, 2 * WIDTH)),
                          dtype=torch.float32)
    buf = carry0.clone()
    state = DecodeState(caches={name: buf},
                        lengths=torch.zeros(2, dtype=torch.int32))
    ref = DecodeState(caches={name: carry0.clone()},
                      lengths=torch.zeros(2, dtype=torch.int32))
    seen = [buf.clone()]
    entries = []
    for tok in ([[3], [7]], [[11], [2]]):
        x = torch.tensor(tok, dtype=torch.int32)
        lg, state = prog_step(tff.params, [x], state)
        rlg, ref = eager_step(tff.params, [x], ref)
        assert state.caches[name] is buf
        np.testing.assert_array_equal(lg.numpy(), rlg.numpy())
        np.testing.assert_array_equal(buf.numpy(),
                                      ref.caches[name].numpy())
        seen.append(buf.clone())
        entries.append(list(prog_step.program._entries.values()))
    assert not torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[1], seen[2])
    assert state.lengths.tolist() == [2, 2]
    assert list(state.caches) == [name]
    # one program entry, kept across the two calls: the buffer it was
    # first called with is still the state's
    assert len(entries[0]) == len(entries[1]) == 1
    assert entries[0][0] is entries[1][0]
