"""Speculative decoding: a small drafter proposes, the target verifies
(port of ``flexflow_tpu.serving.speculative``).

A cheap DRAFTER model proposes ``gamma`` greedy tokens a round, and the
TARGET scores the whole proposal in ONE run of its per-bucket prefill
program (``Executor.make_prefill_step(bucket, bucket)``, a step program: a
CUDA graph per bucket on the card). Every accepted token is the target's
own argmax at that position, and a rejected position falls back to the
target's argmax at no extra forward. Each round therefore commits between
1 (drafter useless) and ``gamma + 1`` (all accepted, plus the bonus token)
tokens for one target forward.

The drafter re-scores the growing stream through its own bucketed prefill
program (no drafter-side KV reuse), as in the JAX package: ``gamma`` small
prefills a round beside the one target verification.

Greedy only: under greedy sampling "distribution-identical" is
token-identity, which can be tested. Temperature sampling would need the
rejection-sampling correction; the decoder refuses it.

Token identity with the baseline engine: in the JAX package exact decode
is bitwise the whole-sequence forward, so the speculative stream equals the
greedy ``exact_decode`` stream. In the port exact decode differs from the
forward by float rounding (ROADMAP C's standing record, 2.4e-6 on logits
of order 3 on the CPU), so the two streams agree outside positions whose
top-2 logit gap is within that noise; the tests and ``chip_smoke.py`` hold
them equal outside gaps under 1e-4.

Accounting: ``ServingStats`` carries ``spec_rounds`` / ``spec_proposed`` /
``spec_accepted``, and each round's wall and committed-token count feed an
``AdmissionController`` given as ``controller`` (``observe_step`` and
``observe_speculation``), so admission sees the real per-token cost.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from ..execution.graphs import HostTransfer
from .engine import ServingStats, _HostStaging, position_context_bound
from .scheduler import default_buckets


class SpeculativeDecoder:
    """Greedy speculative decoding over two compiled FFModels.

    ``target`` and ``drafter`` must both be autoregressive (one integer
    token input, a per-token ``(batch, seq, vocab)`` head) and share a
    vocabulary; the drafter is typically a narrower or shallower build.
    ``controller`` (for example a serving engine's ``admission``) keeps the
    EWMA admission cost model honest under speculation."""

    def __init__(self, target, drafter, gamma: int = 4,
                 max_context: Optional[int] = None, controller=None):
        from .kvcache import SeqShardsError

        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        for which, m in (("target", target), ("drafter", drafter)):
            if m.executor is None:
                raise ValueError(f"{which} model: call compile() first")
        # verification scores draft windows through the single-shard
        # prefill; a sequence-sharded model would verify against another
        # score decomposition than it decodes with
        for which, m in (("target", target), ("drafter", drafter)):
            if int(getattr(m.config, "seq_shards", 1) or 1) > 1:
                raise SeqShardsError(
                    f"speculative decoding does not support --seq-shards "
                    f"> 1 (the {which} model requests "
                    f"{int(m.config.seq_shards)} sequence shards); run "
                    "the sharded engine without a drafter, or set "
                    "--seq-shards 1")
        t_vocab = self._vocab(target)
        d_vocab = self._vocab(drafter)
        if t_vocab != d_vocab:
            raise ValueError(
                f"target vocab {t_vocab} != drafter vocab {d_vocab}: "
                "speculative verification compares token ids, the two "
                "models must share a vocabulary")
        self.target = target
        self.drafter = drafter
        self.gamma = int(gamma)
        # the position table caps the scorable length on BOTH models (a
        # longer stream would have no position row to embed)
        requested = int(
            max_context or getattr(target.config, "max_decode_len", 128))
        self.max_context = min(
            position_context_bound(target.executor, requested),
            position_context_bound(drafter.executor, requested))
        self.controller = controller
        self.stats = ServingStats()
        self._buckets = default_buckets(self.max_context)
        self._staging = {m.device: _HostStaging(m.device)
                         for m in (target, drafter)}

    @staticmethod
    def _vocab(model) -> int:
        ex = model.executor
        final = ex.pcg.nodes[ex.final_guid]
        out = final.out_shapes[ex.final_out_idx]
        if len(out) != 3:
            raise ValueError(
                f"speculative decoding needs a per-token (batch, seq, "
                f"vocab) head; {final.name} produces {out}")
        return int(out[-1])

    # ------------------------------------------------------------- scoring
    def _score(self, model, tokens: np.ndarray) -> np.ndarray:
        """Greedy next-token ids for every position of ``tokens`` through
        the model's prefill program (one whole-sequence forward on a
        ``(1, bucket)`` right-padded row). Returns ``(len,)`` int32: entry
        i is the argmax of the distribution for position i + 1. The argmax
        runs on the device, so one copy brings back the ``(bucket,)`` ids,
        not the ``(1, bucket, vocab)`` fp32 logits."""
        import torch

        L = int(tokens.shape[0])
        bucket = next((b for b in self._buckets if L <= b), None)
        if bucket is None:
            raise ValueError(
                f"stream length {L} exceeds the speculative max context "
                f"{self.max_context}")
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :L] = tokens
        staging = self._staging[model.device]
        prefill = model.executor.make_prefill_step(
            bucket, bucket, capture=model._capture_steps)
        with torch.inference_mode():
            logits, _last, _cache = prefill(
                model.params, [staging.to_device(ids)],
                staging.to_device(np.asarray([L], np.int32)))
            best = torch.argmax(logits[0], dim=-1).to(torch.int32)
        return HostTransfer(best).wait()[:L]

    # ------------------------------------------------------------ generate
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 eos_id: Optional[int] = None) -> List[List[int]]:
        """Greedy continuations of ``prompts``, at ``accepted + 1`` tokens
        a target forward."""
        if temperature > 0.0:
            raise NotImplementedError(
                "speculative decoding is greedy-only: temperature "
                "sampling needs the rejection-sampling correction to "
                "stay distribution-identical; decode through "
                "ServingEngine.generate instead")
        return [self._generate_one(np.asarray(p, np.int32),
                                   int(max_new_tokens), eos_id)
                for p in prompts]

    def _generate_one(self, prompt: np.ndarray, max_new: int,
                      eos_id: Optional[int]) -> List[int]:
        stats = self.stats
        stream = [int(t) for t in prompt]
        generated: List[int] = []
        while len(generated) < max_new:
            t0 = time.perf_counter()
            room = min(max_new - len(generated),
                       self.max_context - len(stream))
            if room <= 0:
                break
            # propose: up to gamma greedy drafter tokens (stream + draft
            # must still fit the context for the verification pass)
            g = min(self.gamma, room - 1) if room > 1 else 0
            draft: List[int] = []
            ds = list(stream)
            for _ in range(g):
                nxt = int(self._score(self.drafter,
                                      np.asarray(ds, np.int32))[-1])
                draft.append(nxt)
                ds.append(nxt)
                if eos_id is not None and nxt == int(eos_id):
                    break
            # verify: ONE target pass over stream + draft scores every
            # draft position and the bonus position
            preds = self._score(self.target,
                                np.asarray(stream + draft, np.int32))
            L = len(stream)
            accepted = 0
            commits: List[int] = []
            for i, d in enumerate(draft):
                t_pred = int(preds[L - 1 + i])
                if t_pred != d:
                    commits.append(t_pred)  # the correction token
                    break
                accepted += 1
                commits.append(d)
            else:
                # every draft token accepted: the verification pass
                # already scored position L + len(draft), a free token
                commits.append(int(preds[L - 1 + len(draft)]))
            wall = time.perf_counter() - t0
            stats.wall_s += wall
            stats.spec_rounds += 1
            stats.spec_proposed += len(draft)
            stats.spec_accepted += accepted
            committed_now = 0
            for tok in commits:
                if len(generated) >= max_new:
                    break
                generated.append(tok)
                stream.append(tok)
                committed_now += 1
                stats.tokens_generated += 1
                stats.record_token(wall / max(len(commits), 1))
                if eos_id is not None and tok == int(eos_id):
                    break
            if self.controller is not None and committed_now:
                self.controller.observe_step(wall, committed_now)
                self.controller.observe_speculation(accepted, len(draft))
            if eos_id is not None and generated and \
                    generated[-1] == int(eos_id):
                break
            if committed_now == 0:
                break  # the context ran out mid-round
        stats.requests_served += 1
        return generated
