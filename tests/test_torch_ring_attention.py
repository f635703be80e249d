"""The port's ring and Ulysses attention against the JAX package's.

Four gloo ranks (``tests/torch_seqpar_pairs.py``, spawned once) run
``flexflow_tpu_torch.kernels.ring_attention.ring_attention`` and
``ulysses_attention.ulysses_attention`` on (data, seq) meshes of (2, 2)
and (1, 4), causal and not, with dropout 0 and 0.1; each rank holds its
rows of the batch and its positions of the sequence and runs the backward
against its block of one fixed cotangent. The JAX package runs
``flexflow_tpu.kernels.ring_attention.ring_attention`` and
``ulysses_attention`` on the same mesh shapes of its 8-device CPU mesh,
under ``shard_map``, and ``jax.vjp`` with the same cotangent. Inputs are
made with numpy from a seed. Held: the outputs within 1e-5, the grads of
q, k and v within 1e-5 relative norm; with dropout 0.1 too, since the
counter hash is the JAX package's bit for bit at global coordinates (so
every block of the ring draws the unsharded call's mask).

Beside them, in this process: ``heads % P != 0`` raises the JAX
package's message, and the plain lse merge of two key blocks' flash
partials equals the JAX (m, l, acc) recurrence.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from flexflow_tpu.kernels import ring_attention as jring
from flexflow_tpu.kernels import ulysses_attention as julysses
from flexflow_tpu.parallel.mesh import build_mesh

import torch_dist_pairs as tp
import torch_seqpar_pairs as sq

WORLD = 4
SHAPE = (2, 4, 32, 8)   # (batch, heads, seq, head_dim)
SEED = 1234
TOL = 1e-5
CASES = [(mode, mesh, causal, 0.0) for mode in ("ring", "alltoall")
         for mesh in ((2, 2), (1, 4)) for causal in (False, True)] + \
    [(mode, mesh, True, 0.1) for mode in ("ring", "alltoall")
     for mesh in ((2, 2), (1, 4))]


def _name(case):
    mode, (dp, sp), causal, dropout = case
    return f"{mode}_{dp}x{sp}_{'causal' if causal else 'full'}_d{dropout}"


def _inputs():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(SHAPE).astype(np.float32)
            for k in ("q", "k", "v", "w")}


def _jax_case(case, io):
    mode, (dp, sp), causal, dropout = case
    mesh = build_mesh(mesh_shape=(dp, sp), axis_names=("data", "seq"))
    spec = NamedSharding(mesh, P("data", None, "seq", None))
    fn = jring.ring_attention if mode == "ring" else \
        julysses.ulysses_attention

    def attn(q, k, v):
        return fn(q, k, v, mesh, seq_axis="seq", causal=causal,
                  dropout=dropout, seed=SEED if dropout else None)

    @jax.jit
    def run(q, k, v, w):
        out, vjp = jax.vjp(attn, q, k, v)
        return out, vjp(w)

    args = [jax.device_put(jnp.asarray(io[k]), spec)
            for k in ("q", "k", "v", "w")]
    out, grads = run(*args)
    return {"out": np.asarray(out),
            **{g: np.asarray(a) for g, a in zip(("dq", "dk", "dv"), grads)}}


def _assemble(root, name, key, dp, sp):
    b, h, s, d = SHAPE
    bl, sl = b // dp, s // sp
    out = np.zeros(SHAPE, np.float32)
    for r in range(WORLD):
        got = tp.load(root, name, r)
        dc, sc = (int(c) for c in got["coords"])
        out[dc * bl:(dc + 1) * bl, :, sc * sl:(sc + 1) * sl] = got[key]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seqpar"))
    io = _inputs()
    cases = []
    for case in CASES:
        mode, (dp, sp), causal, dropout = case
        np.savez(f"{root}/{_name(case)}_in.npz", **io)
        cases.append((_name(case), "attn",
                      dict(mode=mode, dp=dp, sp=sp, causal=causal,
                           dropout=dropout, seed=SEED)))
    procs = tp.start(WORLD, root, cases, main=sq.rank_main)
    want = {_name(case): _jax_case(case, io) for case in CASES}
    tp.finish(procs, root, timeout=240)
    return root, want


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_output_matches_the_jax_schedule(runs, case):
    root, want = runs
    _mode, (dp, sp), _causal, _dropout = case
    got = _assemble(root, _name(case), "out", dp, sp)
    np.testing.assert_allclose(got, want[_name(case)]["out"], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_grads_match_the_jax_schedule(runs, case):
    root, want = runs
    _mode, (dp, sp), _causal, _dropout = case
    for g in ("dq", "dk", "dv"):
        got = _assemble(root, _name(case), g, dp, sp)
        ref = want[_name(case)][g]
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert err <= TOL, (g, err)


def test_indivisible_heads_raise_the_jax_message():
    from flexflow_tpu_torch.kernels.ring_attention import SeqGroup
    from flexflow_tpu_torch.kernels.ulysses_attention import \
        ulysses_attention

    mesh = build_mesh(mesh_shape=(1, 2), axis_names=("data", "seq"))
    x = jnp.zeros((1, 3, 8, 8), jnp.float32)
    with pytest.raises(AssertionError) as jerr:
        julysses.ulysses_attention(x, x, x, mesh, seq_axis="seq")
    import torch

    t = torch.zeros((1, 3, 4, 8))
    with pytest.raises(ValueError) as terr:
        ulysses_attention(t, t, t, SeqGroup(None, 2, 0, 1, 1))
    assert str(terr.value) == str(jerr.value)


def test_lse_merge_is_the_jax_recurrence():
    """Two key blocks' plain flash partials (O, lse), merged, against the
    JAX package's ``_block_attn`` (m, l, acc) recurrence over the same
    blocks, at the ring's global offsets, with dropout."""
    import torch

    from flexflow_tpu.kernels.flash_attention import global_bh_indices
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels.ring_attention import _merge

    io = _inputs()
    b, h, s, d = SHAPE
    half = s // 2
    q = io["q"][:, :, half:]
    ks = [io["k"][:, :, :half], io["k"][:, :, half:]]
    vs = [io["v"][:, :, :half], io["v"][:, :, half:]]
    bh = global_bh_indices(b, h, h, 0, 0)
    m = jnp.full(q.shape[:3], jring.NEG_INF, jnp.float32)
    l = jnp.zeros(q.shape[:3], jnp.float32)
    acc = jnp.zeros(q.shape, jnp.float32)
    for i in (1, 0):   # the ring's order on rank 1: own block first
        bm, bl, bacc = jring._block_attn(
            jnp.asarray(q), jnp.asarray(ks[i]), jnp.asarray(vs[i]), half,
            i * half, causal=(i == 1), dropout=0.1,
            seed=jnp.uint32(SEED), bh=bh)
        m_new = jnp.maximum(m, bm)
        l = l * jnp.exp(m - m_new) + bl * jnp.exp(bm - m_new)
        acc = acc * jnp.exp(m - m_new)[..., None] + \
            bacc * jnp.exp(bm - m_new)[..., None]
        m = m_new
    want = np.asarray(acc / l[..., None])
    o = lse = None
    for i in (1, 0):
        o_i, lse_i = fa.flash_forward_plain(
            torch.tensor(q), torch.tensor(ks[i]), torch.tensor(vs[i]),
            causal=(i == 1), dropout=0.1, seed=SEED,
            shard=(0, 0, h, half, i * half))
        if o is None:
            o, lse = o_i.float(), lse_i
        else:
            o, lse = _merge(o, lse, o_i, lse_i)
    np.testing.assert_allclose(o.numpy(), want, rtol=TOL, atol=TOL)
