"""The serving programs (prefill per bucket, chunk prefill per chunk shape,
the sampler per (temperature, top_k), the slot writes) and ``--serve-loop
async`` on the card. Every test here needs an NVIDIA GPU and skips without
one (``tests/test_torch_serving_async.py`` and
``tests/test_torch_sampler.py`` cover the same code on the CPU, through
the programs' buffers):

* captured prefill and chunk prefill against their eager bodies: logits
  and pool rows within 1e-6 (fp32; both run the same kernels, so equal
  in practice);
* a generate after warm-up captures nothing, in every program;
* async streams equal sync streams on the card, greedy and top-k sampled,
  with one token fetch per committed decode step;
* the sampler's top-k kernel (B7) launches inside the captured sampler,
  and its launches are counted through the replays: one per sampler call
  (prefills plus decode steps);
* the sampler on the card against the same sampler on CPU tensors, same
  logits and (seed, tag, count): equal tokens outside a tie margin;
* the guarded decode program against the unguarded one (native and int8
  KV): equal streams, the same B5 launches a step, one fetch a step, no
  capture after warm-up, and a poisoned slot quarantined with the other
  streams unchanged.

It imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py
"""
import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.kernels import topk as tk
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving.engine import (ServingEngine, draw_tokens,
                                               gumbel_scores)
from flexflow_tpu_torch.serving.kvcache import DecodeState, paged_pool_entry

VOCAB = 128  # a multiple of 128: the sampler's top-k takes B7
MAX_LEN, BLOCK = 64, 8
# captured vs eager program, fp32: the same kernels on the same inputs
PROGRAM_TOL = 1e-6
# card vs CPU sampler: a row whose two best Gumbel scores are closer than
# this may flip on a last-ulp difference of log between the two devices
TIE_MARGIN = 1e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the serving programs capture on "
                    "the card only)")
    return torch.device("cuda")


def _gpt2(dev, vocab=VOCAB):
    config = ft.FFConfig()
    config.batch_size, config.seed, config.kv_block_size = 2, 42, BLOCK
    ff = ft.FFModel(config, device=dev)
    build_gpt2(ff, GPT2Config(batch_size=2, seq_len=MAX_LEN, hidden=256,
                              num_heads=4, num_layers=2, intermediate=512,
                              vocab_size=vocab))
    ff.compile()
    return ff


def _prompts(seed=7):
    """Six prompts: three share a 16-token prefix (a prefix hit takes the
    chunk path); those over 8 tokens prefill in chunks of 8."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, VOCAB, 16).tolist()
    return [shared + rng.integers(1, VOCAB, 3).tolist(),
            shared + rng.integers(1, VOCAB, 4).tolist(),
            rng.integers(1, VOCAB, 21).tolist(),
            rng.integers(1, VOCAB, 5).tolist(),
            shared + rng.integers(1, VOCAB, 1).tolist(),
            rng.integers(1, VOCAB, 30).tolist()]


def _engine(ff, loop="sync"):
    return ServingEngine(ff, max_decode_len=MAX_LEN, n_slots=3,
                         kv_block_size=BLOCK, prefill_chunk_tokens=8,
                         serve_loop=loop)


def _captures(eng):
    return sum(p.captures for p in eng.programs())


def _warm(eng, **sampling):
    """Two generates of prompts of the timed ones' shapes (other tokens, so
    no prefix hit reaches the timed run): every program's first call and
    capture."""
    for seed in (100, 101):
        eng.generate(_prompts(seed), max_new_tokens=6, **sampling)


def _ids(dev, rows):
    return torch.tensor(np.asarray(rows, np.int32), device=dev)


@pytest.mark.cuda
def test_captured_prefill_equals_eager():
    dev = _cuda()
    ff = _gpt2(dev)
    ex = ff.executor
    rng = np.random.default_rng(1)
    eager = ex.make_prefill_step(32, MAX_LEN, capture=False)
    prog = ex.make_prefill_step(32, MAX_LEN)
    for call in range(3):  # eager first call, capture, replay
        n = 10 + 7 * call
        ids = np.zeros((1, 32), np.int32)
        ids[0, :n] = rng.integers(1, VOCAB, n)
        args = (ff.params, [_ids(dev, ids)], _ids(dev, [n]))
        want, got = eager(*args), prog(*args)
        for w, g in zip(want[:2], got[:2]):
            assert (g - w).abs().max().item() <= PROGRAM_TOL
        assert list(got[2]) == list(want[2])
        for name in want[2]:
            for w, g in zip(want[2][name], got[2][name]):
                assert (g - w).abs().max().item() <= PROGRAM_TOL
    assert prog.program.captures == 1


def _pools(ff):
    """A zero paged state for one slot of the tiny GPT-2 (one pool per K
    and V of each attention node)."""
    mb = MAX_LEN // BLOCK
    _lg, _last, cache = ff.executor.make_prefill_step(16, MAX_LEN,
                                                      capture=False)(
        ff.params, [_ids(ff.device, np.ones((1, 16)))],
        _ids(ff.device, [1]))
    caches = {n: tuple(paged_pool_entry(leaf, mb + 1, BLOCK)
                       for leaf in leaves) for n, leaves in cache.items()}
    return DecodeState(caches=caches,
                       lengths=torch.zeros((1,), dtype=torch.int32,
                                           device=ff.device),
                       block_tables=torch.zeros((1, mb), dtype=torch.int32,
                                                device=ff.device))


@pytest.mark.cuda
def test_captured_chunk_prefill_equals_eager():
    """A 21-token prompt in three chunks of 8 (the third with 5 real
    tokens): each chunk's last row and the pools it wrote, eager body
    against program (first call, capture, replay)."""
    dev = _cuda()
    ff = _gpt2(dev)
    ex = ff.executor
    seq = np.random.default_rng(2).integers(1, VOCAB, 21)
    row = _ids(dev, np.arange(1, MAX_LEN // BLOCK + 1))
    states = {}
    lasts = {}
    for capture in (False, True):
        fn = ex.make_chunk_prefill_step(8, MAX_LEN, BLOCK, capture=capture)
        state = states[capture] = _pools(ff)
        lasts[capture] = []
        for start in (0, 8, 16):
            n = min(8, len(seq) - start)
            ids = np.zeros((1, 8), np.int32)
            ids[0, :n] = seq[start:start + n]
            last, state = fn(ff.params, [_ids(dev, ids)], state, row,
                             _ids(dev, [start]), _ids(dev, [n]))
            lasts[capture].append(last)
        if capture:
            assert fn.program.captures == 1
    for w, g in zip(lasts[False], lasts[True]):
        assert (g - w).abs().max().item() <= PROGRAM_TOL
    for name, entry in states[False].caches.items():
        for w, g in zip(entry, states[True].caches[name]):
            assert (g - w).abs().max().item() <= PROGRAM_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "top_k": 8,
                                           "seed": 3}],
                         ids=["greedy", "top8"])
def test_async_streams_equal_sync_and_nothing_captures_after_warmup(
        sampling):
    dev = _cuda()
    ff = _gpt2(dev)
    outs = {}
    for loop in ("sync", "async"):
        eng = _engine(ff, loop)
        _warm(eng, **sampling)
        before = _captures(eng)
        tk.reset_launch_count()
        outs[loop] = eng.generate(_prompts(), max_new_tokens=12, **sampling)
        torch.cuda.synchronize()
        st = eng.stats
        assert _captures(eng) == before, f"{loop}: a program captured"
        assert eng.decode_compiles == 1
        assert st.host_syncs == st.decode_steps
        assert st.prefix_hits >= 1 and st.chunked_prefills >= 1
        # one B7 launch a sampler call: every prefill's first token and
        # every decode step, replayed inside the captured sampler
        want = st.prefills + st.decode_steps if sampling else 0
        assert tk.launch_count() == want
        if loop == "async":
            assert st.host_overlap_s > 0.0
    assert outs["sync"] == outs["async"]


@pytest.mark.cuda
def test_topk_launches_inside_the_captured_sampler():
    dev = _cuda()
    ff = _gpt2(dev)
    sample = ServingEngine(ff, n_slots=8, max_decode_len=MAX_LEN)._sampler(
        0.8, 8)
    logits = torch.randn((8, VOCAB), device=dev)
    tc = _ids(dev, [(i, 2 * i) for i in range(8)])
    seed = _ids(dev, [5])
    tk.reset_launch_count()
    toks = [sample(logits, tc, seed) for _ in range(4)]
    torch.cuda.synchronize()
    assert sample.program.captures == 1
    (entry,) = sample.program._entries.values()
    assert entry.launches == {("topk", "topk"): 1}
    assert tk.launch_count() == 4
    assert all(torch.equal(t, toks[0]) for t in toks)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [8, 1, 0])
def test_card_sampler_equals_cpu_sampler_outside_the_tie_margin(top_k):
    """(8, 50304) logits (the int8 runs' padded vocabulary), 64 (tag,
    count) draws: the card's tokens equal the CPU's wherever the two best
    Gumbel scores (computed on the CPU) are more than ``TIE_MARGIN``
    apart."""
    dev = _cuda()
    vocab, temp = 50304, 0.8
    gen = torch.Generator().manual_seed(0)
    inside = 0
    for batch in range(8):
        logits = torch.randn((8, vocab), generator=gen) * 3
        tc = torch.tensor([(batch * 8 + r, batch) for r in range(8)],
                          dtype=torch.int32)
        seed = torch.tensor([11], dtype=torch.int32)
        cpu = draw_tokens(logits, tc, seed, temp, top_k)
        card = draw_tokens(logits.to(dev), tc.to(dev), seed.to(dev), temp,
                           top_k).cpu()
        gaps = _score_gaps(logits, tc, seed, temp, top_k)
        for r in range(8):
            if gaps[r] <= TIE_MARGIN:
                inside += 1
                print(f"row {batch}/{r} inside the tie margin: gap "
                      f"{gaps[r]:.3g}, cpu {int(cpu[r])}, card "
                      f"{int(card[r])}")
            else:
                assert int(cpu[r]) == int(card[r]), (batch, r, gaps[r])
    assert inside <= 2


def _score_gaps(logits, tc, seed, temp, top_k):
    """Per row, the best Gumbel score minus the second best, on the CPU."""
    score, _idx = gumbel_scores(logits, tc, seed, temp, top_k)
    if score.shape[1] == 1:
        return [float("inf")] * score.shape[0]
    top2 = torch.topk(score, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_guarded_decode_streams_equal_unguarded(kv_dtype):
    """The guarded decode program (an empty ``ChaosPlan`` arms it) against
    the unguarded one on one engine, after warm-up of both: equal greedy
    streams, the same B5 launches a decode step (one a layer), one token
    fetch a decode step with the verdict in the same copy, nothing
    captured in the timed runs, ``decode_compiles`` 1 for each mode. Then
    a poisoned slot: quarantined once and retried, the other streams the
    clean run's, still nothing captured."""
    from flexflow_tpu_torch.kernels import flash_decode as fd
    from flexflow_tpu_torch.resilience import ChaosPlan

    dev = _cuda()
    ff = _gpt2(dev)
    eng = ServingEngine(ff, max_decode_len=MAX_LEN, n_slots=3,
                        kv_block_size=BLOCK, kv_dtype=kv_dtype,
                        prefix_cache="off")
    name = "flash_decode_int8" if kv_dtype == "int8" else "flash_decode"

    def prompts_of(seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(1, VOCAB, n).tolist() for n in (5, 9, 3, 12)]

    prompts = prompts_of(7)
    for chaos in (None, ChaosPlan()):
        for seed in (100, 101):
            eng.generate(prompts_of(seed), max_new_tokens=10, chaos=chaos)
    out, per_step = {}, {}
    before = _captures(eng)
    for guarded in (False, True):
        fd.reset_launch_count()
        out[guarded] = eng.generate(prompts, max_new_tokens=10,
                                    chaos=ChaosPlan() if guarded else None)
        torch.cuda.synchronize()
        st = eng.stats
        assert eng._last_guard is guarded and eng.decode_compiles == 1
        assert st.host_syncs == st.decode_steps
        per_step[guarded] = fd.launch_count(name) / st.decode_steps
    assert out[False] == out[True]
    assert per_step[False] == per_step[True] == 2  # one a layer
    chaos = ChaosPlan(poison_decode_at={3: 1})
    poisoned = eng.generate(prompts, max_new_tokens=10, chaos=chaos)
    torch.cuda.synchronize()
    assert chaos.poisoned_decode_steps == [3]
    assert eng.stats.quarantines == 1 and eng.stats.outcomes == {"ok": 4}
    # the neighbours' streams are the clean run's; the retried one
    # re-prefills its committed tokens, which may move a near-tie of B5's
    # logits (exact decode makes it token-identical, on the CPU tests)
    assert sum(a != b for a, b in zip(poisoned, out[False])) <= 1
    assert _captures(eng) == before


# --------------------------------------------- LSTM serving, speculation
LSTM_WIDTH = 128
# greedy streams of two paths may part only where the forward's top-2
# logit gap is under this (both paths are fp32; they differ in summation
# order only)
STREAM_TIE = 1e-4


def _lstm_lm(dev):
    config = ft.FFConfig()
    config.batch_size, config.seed = 2, 42
    ff = ft.FFModel(config, device=dev)
    ids = ff.create_tensor((2, MAX_LEN), dtype=ft.DataType.DT_INT32)
    t = ff.embedding(ids, VOCAB, LSTM_WIDTH)
    for _ in range(2):
        t, _state = ff.lstm(t, LSTM_WIDTH)
    ff.dense(t, VOCAB)
    ff.compile()
    return ff


def _lstm_names(ff):
    return [n.name for n in ff.executor.pcg.compute_nodes()
            if n.op.op_type == ft.OperatorType.OP_LSTM]


def _parts_only_at_ties(ff, prompts, want, got):
    """``got`` equals ``want`` stream by stream, or parts from it at a
    position where ``ff``'s forward has a top-2 gap under STREAM_TIE."""
    for p, a, b in zip(prompts, want, got):
        assert len(a) == len(b)
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        seq = list(p) + list(b[:i + 1])
        full = ff.executor.forward(ff.params, [torch.tensor(
            [seq], dtype=torch.int32, device=ff.device)])[0]
        top = full[len(seq) - 2].topk(2).values
        assert float(top[0] - top[1]) < STREAM_TIE, (i, a, b)


@pytest.mark.cuda
def test_lstm_decode_program_advances_the_carry_in_place():
    """The captured decode program of a two-layer LSTM LM: its first call
    is eager, its second captures, its third replays; each advances the
    slot-major carry buffers in place (the state keeps the same tensors)
    to what the eager body gives from the same carry, and the program
    captures once."""
    dev = _cuda()
    ff = _lstm_lm(dev)
    names = _lstm_names(ff)
    ex = ff.executor
    prog = ex.make_decode_step(MAX_LEN)
    eager = ex.make_decode_step(MAX_LEN, capture=False)
    gen = torch.Generator(device=dev).manual_seed(3)
    bufs = {n: torch.randn((3, 2 * LSTM_WIDTH), generator=gen, device=dev)
            for n in names}
    state = DecodeState(caches=dict(bufs), lengths=torch.zeros(
        3, dtype=torch.int32, device=dev))
    ref = DecodeState(caches={n: b.clone() for n, b in bufs.items()},
                      lengths=torch.zeros(3, dtype=torch.int32, device=dev))
    rng = np.random.default_rng(4)
    for _ in range(3):
        before = {n: b.clone() for n, b in bufs.items()}
        x = _ids(dev, rng.integers(1, VOCAB, (3, 1)))
        lg, state = prog(ff.params, [x], state)
        rlg, ref = eager(ff.params, [x], ref)
        assert (lg - rlg).abs().max().item() <= PROGRAM_TOL
        for n in names:
            assert state.caches[n] is bufs[n]
            assert not torch.equal(bufs[n], before[n])
            assert (bufs[n] - ref.caches[n]).abs().max().item() <= \
                PROGRAM_TOL
    assert prog.program.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["paged", "ring"])
def test_lstm_streams_on_card_equal_cpu(kv):
    """An LSTM LM served on the card: sync and async streams equal, no
    capture after warm-up, ``decode_compiles`` 1, the prefix cache off;
    and the streams of the port's CPU path from the same weights, outside
    ties."""
    dev = _cuda()
    ff = _lstm_lm(dev)
    cpu = _lstm_lm(torch.device("cpu"))
    cpu.set_params_numpy(ff.get_params_numpy())
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, VOCAB, n).tolist() for n in (5, 17, 3, 30,
                                                            9)]
    outs = {}
    for loop in ("sync", "async"):
        eng = ServingEngine(ff, max_decode_len=MAX_LEN, n_slots=3,
                            kv_cache=kv, serve_loop=loop)
        assert eng._prefix is None
        for seed in (100, 101):
            r = np.random.default_rng(seed)
            eng.generate([r.integers(1, VOCAB, len(p)).tolist()
                          for p in prompts], max_new_tokens=12)
        before = _captures(eng)
        outs[loop] = eng.generate(prompts, max_new_tokens=12)
        torch.cuda.synchronize()
        assert _captures(eng) == before and eng.decode_compiles == 1
    assert outs["sync"] == outs["async"]
    want = ServingEngine(cpu, max_decode_len=MAX_LEN, n_slots=3,
                         kv_cache=kv).generate(prompts, max_new_tokens=12)
    _parts_only_at_ties(ff, prompts, want, outs["sync"])


@pytest.mark.cuda
def test_speculative_on_card_equals_the_exact_baseline():
    """Greedy speculative decoding on the card (the file's GPT-2 as
    target, a one-layer width-64 drafter): streams equal the exact-decode
    baseline's outside ties, the perfect drafter accepts every proposal
    but at tied positions and commits more tokens than it runs rounds, and
    nothing captures after warm-up."""
    from flexflow_tpu_torch.serving import SpeculativeDecoder

    dev = _cuda()
    ff = _gpt2(dev)
    config = ft.FFConfig()
    config.batch_size, config.seed = 2, 7
    drafter = ft.FFModel(config, device=dev)
    build_gpt2(drafter, GPT2Config(batch_size=2, seq_len=MAX_LEN, hidden=64,
                                   num_heads=2, num_layers=1,
                                   intermediate=128, vocab_size=VOCAB))
    drafter.compile()

    def prompts_of(seed):
        r = np.random.default_rng(seed)
        return [r.integers(1, VOCAB, n).tolist() for n in (5, 17, 30, 9)]

    prompts = prompts_of(7)
    base = ServingEngine(ff, max_decode_len=MAX_LEN, n_slots=3,
                         exact_decode=True, prefix_cache="off").generate(
        prompts, max_new_tokens=16)

    def captures():
        return sum(getattr(fn, "program", None).captures
                   for m in (ff, drafter)
                   for fn in m.executor._serving_fns.values()
                   if getattr(fn, "program", None) is not None)

    for d in (drafter, ff):
        for seed in (100, 101):
            SpeculativeDecoder(ff, d, gamma=4, max_context=MAX_LEN).generate(
                prompts_of(seed), max_new_tokens=16)
        before = captures()
        spec = SpeculativeDecoder(ff, d, gamma=4, max_context=MAX_LEN)
        outs = spec.generate(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        assert captures() == before
        _parts_only_at_ties(ff, prompts, base, outs)
        st = spec.stats
        assert st.tokens_generated == 64 and st.spec_rounds > 0
        if d is ff:
            assert st.spec_rounds < st.tokens_generated
            assert st.spec_accepted >= st.spec_proposed - 1
