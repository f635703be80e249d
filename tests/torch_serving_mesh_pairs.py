"""Spawned gloo ranks serving a model compiled under a strategy
(tests/test_torch_serving_mesh.py).

Imports neither jax nor flexflow_tpu: the ranks run the port alone
(``torch_dist_pairs`` spawns them and joins them). The model is a small
GPT-2 (two layers, four heads, a 32-position table) compiled for inference
under the case's strategy; its weights come from the case's ``.npz``.
Case ``serve``: for each run of the case (paged native and int8 KV,
greedy and top-k, chunk prefill over the prefix cache), one fresh
``ServingEngine`` generates the case's prompts, recording the logits of
every decode step; per rank the streams, the logits, the stats' KV bytes
per card and the pool's local head count are written. Case ``generate``:
``FFModel.generate`` on the mesh. Case ``refuse``: the messages of the
options several ranks refuse by name.
"""
import numpy as np

import torch_dist_pairs as tp

SEQ = 32
GPT2 = dict(seq_len=SEQ, hidden=64, num_heads=4, num_layers=2,
            intermediate=128, vocab_size=100)
# one run of a case: (name, engine kwargs, generate kwargs)
RUNS = (
    ("native", dict(), dict()),
    ("int8", dict(kv_dtype="int8"), dict()),
    ("topk", dict(), dict(temperature=0.8, top_k=5, seed=7)),
    ("chunk", dict(prefill_chunk_tokens=8), dict()),
)
NEW_TOKENS = 5


def build(strategy, batch: int = 2, **config):
    """The serving GPT-2 in the port on the CPU, compiled under
    ``strategy`` (a ``torch_dist_pairs`` strategy name, or None)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

    c = ft.FFConfig()
    c.batch_size, c.seed, c.kv_block_size = batch, 0, 8
    for k, v in config.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device="cpu")
    build_gpt2(ff, GPT2Config(batch_size=batch, **GPT2))
    ff.compile(strategy_fn=tp._strategy(strategy) if strategy else None)
    return ff


def prompts(n: int = 5, seed: int = 0):
    """Prompts of several lengths; the last repeats the 17-token one (two
    whole KV blocks: a prefix hit)."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, GPT2["vocab_size"], size=k).tolist()
           for k in (3, 11, 17, 6)[:n - 1]]
    return out + [list(out[2])]


def serve_runs(ff) -> dict:
    """Every run of :data:`RUNS` on ``ff``: streams, decode logits, KV
    bytes per card and the pools' head count, flat for ``np.savez``."""
    import torch

    from flexflow_tpu_torch.serving.engine import ServingEngine

    out = {}
    for name, ekw, gkw in RUNS:
        eng = ServingEngine(ff, n_slots=2, max_decode_len=SEQ, **ekw)
        seen = []
        dispatch = eng._dispatch_decode

        def record(params, guard, dispatch=dispatch, seen=seen):
            logits, ok = dispatch(params, guard)
            seen.append(logits.detach().clone())
            return logits, ok

        eng._dispatch_decode = record
        streams = eng.generate(prompts(), max_new_tokens=NEW_TOKENS, **gkw)
        out[f"{name}/streams"] = np.array(
            [s + [-1] * (NEW_TOKENS - len(s)) for s in streams])
        out[f"{name}/logits"] = torch.stack(seen).numpy()
        out[f"{name}/kv_hbm"] = np.int64(eng.stats.kv_hbm_per_chip_bytes)
        out[f"{name}/kv_pool"] = np.int64(eng.stats.kv_pool_bytes_per_rank)
        first = next(iter(eng.state.caches.values()))
        out[f"{name}/pool_heads"] = np.int64(first[0].shape[1])
        out[f"{name}/hits"] = np.int64(eng.stats.prefix_hits)
    return out


def _case_serve(args, io):
    ff = build(args["strategy"])
    ff.set_params_numpy(tp.unflat("w", io))
    return serve_runs(ff)


def _case_generate(args, io):
    ff = build(args["strategy"], max_inflight=2, max_decode_len=SEQ)
    ff.set_params_numpy(tp.unflat("w", io))
    streams = ff.generate(prompts(), max_new_tokens=NEW_TOKENS)
    return {"streams": np.array(streams)}


def _case_refuse(args, io):
    """What several ranks refuse by name: a request deadline and a serving
    ``ChaosPlan`` (each rank would decide on its own clock or plan)."""
    from flexflow_tpu_torch.resilience import ChaosPlan
    from flexflow_tpu_torch.serving.engine import ServingEngine

    ff = build(args["strategy"])
    ff.set_params_numpy(tp.unflat("w", io))
    eng = ServingEngine(ff, n_slots=2, max_decode_len=SEQ)
    out = {}
    for name, kw in (("deadline", dict(deadline_ms=1000.0)),
                     ("chaos", dict(chaos=ChaosPlan(
                         poison_decode_at={2: 0})))):
        try:
            eng.generate(prompts()[:2], max_new_tokens=2, **kw)
            out[name] = np.array("")
        except NotImplementedError as e:
            out[name] = np.array(str(e))
    return out


CASES = {"serve": _case_serve, "generate": _case_generate,
         "refuse": _case_refuse}


def rank_main(rank: int, world: int, root: str, cases) -> None:
    tp.run_cases(rank, world, root, cases, CASES)


def start(world: int, root: str, cases):
    return tp.start(world, root, cases, main=rank_main)
