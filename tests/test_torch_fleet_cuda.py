"""The serving fleet on the card (``flexflow_tpu_torch/serving/fleet.py``
over engines that keep their own pool-bound programs). Every test here
needs an NVIDIA GPU and skips without one
(``tests/test_torch_serving_fleet.py`` and
``tests/test_torch_serving_failover.py`` cover the same code on the CPU,
against the JAX package):

* replicas that tick in turn each capture their decode program once over
  a whole run and replay it after (``decode_compiles`` 1 each), through a
  second run as well;
* B5 (native and int8) on a replica's pool and B7 on a replica's decode
  logits against their plain versions, and the B5 / B7 launches of a run
  counted through the replays;
* a real device loss (the pool's storage resized to 0 inside the
  dispatch) rebuilds the pool, whose decode program captures once more
  and only once, and the streams go on;
* a clean fleet's streams equal one engine's.

It imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_fleet_cuda.py
"""
import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.execution.graphs import _tensors_of
from flexflow_tpu_torch.kernels import flash_decode as fd
from flexflow_tpu_torch.kernels import topk as tk
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.resilience import ChaosPlan
from flexflow_tpu_torch.serving import ServingEngine, ServingFleet

VOCAB = 256  # a multiple of 128: the sampler's top-k takes B7
MAX_LEN, BLOCK, SLOTS = 64, 8, 4
KERNEL_ATOL = {"native": 2e-5, "int8": 2e-2}

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the fleet's programs capture on "
                    "the card only)")
    return torch.device("cuda")


def _gpt2(dev, compute="fp32", kv_dtype="native"):
    config = ft.FFConfig()
    config.batch_size, config.seed, config.kv_block_size = 2, 42, BLOCK
    config.kv_dtype = kv_dtype
    if compute == "bf16":
        config.compute_dtype = ft.DataType.DT_BFLOAT16
    ff = ft.FFModel(config, device=dev)
    build_gpt2(ff, GPT2Config(batch_size=2, seq_len=MAX_LEN, hidden=256,
                              num_heads=4, num_layers=2, intermediate=512,
                              vocab_size=VOCAB))
    ff.compile()
    return ff


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, int(rng.integers(3, 20))).tolist()
            for _ in range(n)]


def _fleet(ff):
    fleet = ServingFleet(ff, n_replicas=2, n_slots=SLOTS,
                         max_decode_len=MAX_LEN)
    for rep in fleet.replicas:
        rep.engine.admission.force_token_cost_ms = 1.0
    return fleet


def test_replicas_in_turn_capture_their_decode_once():
    dev = _cuda()
    ff = _gpt2(dev)
    fleet = _fleet(ff)
    fleet.generate(_prompts(10, seed=1), max_new_tokens=12)
    torch.cuda.synchronize()
    progs = [r.engine._decode_fn(True).program for r in fleet.replicas]
    assert progs[0] is not progs[1]
    assert [p.captures for p in progs] == [1, 1]
    assert [r.engine.decode_compiles for r in fleet.replicas] == [1, 1]
    assert all(d > 0 for d in fleet.stats.dispatches)
    fleet.generate(_prompts(10, seed=7), max_new_tokens=12)
    torch.cuda.synchronize()
    assert [p.captures for p in progs] == [1, 1]
    assert [r.engine.decode_compiles for r in fleet.replicas] == [1, 1]


@pytest.mark.parametrize("compute,kv", [("fp32", "native"),
                                        ("bf16", "int8")])
def test_kernels_on_a_replicas_pool_match_plain(compute, kv):
    dev = _cuda()
    ff = _gpt2(dev, compute, kv)
    fleet = _fleet(ff)
    rec = fleet.replicas[0].engine
    real, last = rec._dispatch_decode, []

    def dispatch(params, guard):
        logits, ok = real(params, guard)
        last[:] = [logits.clone()]
        return logits, ok

    rec._dispatch_decode = dispatch
    fd.reset_launch_count()
    tk.reset_launch_count()
    fleet.generate(_prompts(8, seed=2), max_new_tokens=10,
                   temperature=0.8, top_k=8, seed=5)
    torch.cuda.synchronize()
    b5 = "flash_decode_int8" if kv == "int8" else "flash_decode"
    steps = sum(r.decode_steps() for r in fleet.replicas)
    prefills = sum(r.loop.stats.prefills for r in fleet.replicas)
    assert fd.launch_count(b5) == 2 * steps
    assert tk.launch_count() == steps + prefills
    rng = np.random.default_rng(3)
    for rep in fleet.replicas:
        eng = rep.engine
        first = next(iter(eng.state.caches.values()))
        blocks, heads, _bs, d = first[0].shape
        mb = eng.max_blocks_per_slot
        tables = torch.tensor(rng.permutation(np.arange(1, blocks))[
            :SLOTS * mb].reshape(SLOTS, mb), dtype=torch.int32, device=dev)
        n_keys = torch.tensor(rng.integers(1, MAX_LEN + 1, SLOTS),
                              dtype=torch.int32, device=dev)
        q = torch.randn((SLOTS, heads, d), device=dev).to(
            torch.bfloat16 if compute == "bf16" else torch.float32)
        for entry in eng.state.caches.values():
            if kv == "int8":
                kq, ks, vq, vs = entry
                got = fd.flash_decode(q, kq, vq, tables, n_keys, kscale=ks,
                                      vscale=vs)
                want = fd.flash_decode_plain(q, kq, vq, tables, n_keys,
                                             kscale=ks, vscale=vs)
            else:
                got = fd.flash_decode(q, *entry, tables, n_keys)
                want = fd.flash_decode_plain(q, *entry, tables, n_keys)
            assert (got.float() - want.float()).abs().max().item() <= \
                KERNEL_ATOL[kv]
    x = last[0].contiguous()
    v, i = tk.topk(x, 8)
    pv, pi = tk.topk_plain(x, 8)
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_real_loss_rebuilds_the_pool_and_captures_it_once():
    dev = _cuda()
    ff = _gpt2(dev)
    prompts = _prompts(6, seed=4)
    want = ServingEngine(ff, n_slots=SLOTS, max_decode_len=MAX_LEN,
                         exact_decode=True).generate(prompts,
                                                     max_new_tokens=12)
    eng = ServingEngine(ff, n_slots=SLOTS, max_decode_len=MAX_LEN,
                        exact_decode=True)
    real = eng._decode_fn
    program = real(True).program
    fired = []

    def patched(guard=False):
        fn = real(guard=guard)

        def lost(params, toks, state):
            if eng.stats.decode_steps == 5 and not fired:
                fired.append(program.captures)
                for t in _tensors_of((state, eng._last_tokens)):
                    t.untyped_storage().resize_(0)
                raise RuntimeError("CUDA error: CUDA-capable device(s) "
                                   "is/are busy or unavailable")
            return fn(params, toks, state)

        lost.program = fn.program
        return lost

    eng._decode_fn = patched
    got = eng.generate(prompts, max_new_tokens=12, chaos=ChaosPlan())
    torch.cuda.synchronize()
    assert fired == [1] and program.captures == 2
    assert eng.decode_compiles == 1 and eng.stats.replans == 1
    assert eng.stats.outcomes == {"ok": 6}
    assert [len(g) for g in got] == [12] * 6
    # exact decode is not bitwise its re-prefill, so after the loss the
    # streams are held by length; the prefills' first tokens are equal
    assert [g[0] for g in got] == [w[0] for w in want]


def test_clean_fleet_streams_equal_one_engines():
    dev = _cuda()
    ff = _gpt2(dev)
    prompts = _prompts(10, seed=6)
    want = ServingEngine(ff, n_slots=SLOTS, max_decode_len=MAX_LEN,
                         prefix_cache="off").generate(prompts,
                                                      max_new_tokens=12)
    ff.config.prefix_cache = "off"
    try:
        fleet = _fleet(ff)
        got = fleet.generate(prompts, max_new_tokens=12)
    finally:
        ff.config.prefix_cache = "on"
    torch.cuda.synchronize()
    assert got == want
    assert fleet.stats.outcomes == {"ok": 10}
