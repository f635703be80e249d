"""The op zoo of the PyTorch port against the JAX package, on the CPU.

Each case builds the same small graph in both packages through the
FFModel builders, carries the JAX weights over (``set_params_numpy``) and
runs both executors' graph forward on the same seeded numpy inputs, then
each package's vector-Jacobian product with the same seeded cotangent:
``jax.vjp`` against ``torch.autograd.grad``. One parametrised test per op
family: convolutions (grouped, strided, 1x7, every fused activation),
pooling (max, and average whose padded cells do not count), batch norm,
flat, the six binary ops, the unary table with identity, rsqrt, pow and
the four scalar ops, cast, the tensor ops (reshape, transpose, reverse,
concat with split, gather, reduce_sum, mean, slice with a negative step,
batch_matmul) and RMSNorm.

Tolerances: fp32 outputs within 1e-5 absolute (inputs and weights of
magnitude about 1; the two sides differ in summation order only), grads of
the inputs and of every weight within 1e-4 relative norm (a grad that is
exactly zero on the JAX side, as the ceil and round ops give, must be zero
here). bf16 compute (the conv, pool and norm families): the band of the
port's other bf16 comparisons, outputs within 2e-2 absolute plus 2e-2 of
their magnitude against JAX's bf16 outputs and grads within 5e-2 relative
norm of JAX's fp32 grads from the same weights (the two sides round their
activations to bf16 at different points; JAX's conv cannot be
differentiated in bf16 at all, its transpose rule raising on the fp32
cotangent of ``preferred_element_type``). A ReLU or a max pool moves a
grad element whole where its input lies within rounding of the kink or of
a tie, which bf16 rounding (2**-8) makes common: in bf16 their grads are
held in the fp32 cases only, their outputs in both.

Batch norm is also held to its formula in numpy: batch statistics with the
biased variance (``jnp.var``'s, N in the denominator; ``torch.var``
divides by N - 1 unless told otherwise), taken in fp32 also under bf16
compute. Dropout, whose mask cannot follow ``jax.random``'s stream, is
held to its law instead: rate 0 and eval are the identity; in training the
kept share is within 5 sigma of 1 - rate, survivors are scaled by exactly
1/(1 - rate) and the dropped elements are 0; a new seed gives a new mask,
the same seed the same one; and the seed comes from the step's random
stream (a graph-captured step's seed buffer on the card).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
from flexflow_tpu.ffconst import PoolType as JaxPoolType
from flexflow_tpu.ops.base import OpContext as JaxOpContext
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.ops.base import OpContext

torch.set_num_threads(2)

OUT_TOL = {"fp32": dict(atol=1e-5, rtol=0), "bf16": dict(atol=2e-2,
                                                          rtol=2e-2)}
GRAD_TOL = {"fp32": 1e-4, "bf16": 5e-2}


def _build(pkg, specs, build, compute):
    c = pkg.FFConfig()
    c.batch_size, c.seed = specs[0][0][0], 0
    if compute == "bf16":
        c.compute_dtype = pkg.DataType.DT_BFLOAT16
    ff = pkg.FFModel(c) if pkg is fj else pkg.FFModel(c, device="cpu")
    ins = [ff.create_tensor(shape, getattr(pkg.DataType, dt))
           for shape, dt in specs]
    build(ff, pkg, *ins)
    ff.compile(loss_type=pkg.LossType.LOSS_IDENTITY)
    return ff


def _inputs(specs, seed, positive=False):
    rng = np.random.default_rng(seed)
    xs = []
    for shape, dt in specs:
        if dt == "DT_FLOAT":
            x = rng.standard_normal(shape).astype(np.float32)
            xs.append(np.abs(x) + 0.5 if positive else x)
        else:
            xs.append(rng.integers(0, 4, shape).astype(np.int64))
    return xs


def _jax_run(ff, xs, cot, training=False):
    """JAX's output and its vjp with ``cot``: (output, param grads, grads
    of the float inputs); in bf16 compute the output alone (grads None)."""
    ex = ff.executor
    fidx = [i for i, x in enumerate(xs) if x.dtype == np.float32]

    def f(params, fx):
        full = [jnp.asarray(x) for x in xs]
        for i, v in zip(fidx, fx):
            full[i] = v
        params_c, full = ex._cast_for_compute(params, full)
        ctx = JaxOpContext(training=training, rng=jax.random.PRNGKey(0))
        vals = ex.forward_outputs(params_c, ex._bind_inputs(full), ctx)
        return vals[ex.final_guid][ex.final_out_idx].astype(jnp.float32)

    fx = [jnp.asarray(xs[i]) for i in fidx]
    if ff.config.compute_dtype == fj.DataType.DT_BFLOAT16:
        return np.asarray(jax.jit(f)(ff.params, fx)), None, None

    @jax.jit
    def run(params, fx, cot):
        out, vjp = jax.vjp(f, params, fx)
        return (out,) + vjp(cot)

    out, gp, gx = run(ff.params, fx, jnp.asarray(cot))
    return np.asarray(out), jax.device_get(gp), [np.asarray(g) for g in gx]


def _port_run(ff, xs, cot):
    ex = ff.executor
    params = {n: {w: t.detach().clone().requires_grad_(True)
                  for w, t in ws.items()} for n, ws in ff.params.items()}
    full = [torch.tensor(x, requires_grad=x.dtype == np.float32)
            for x in xs]
    params_c, cast = ex._cast_for_compute(params, full)
    vals = ex.forward_outputs(params_c, ex._bind_inputs(cast),
                              OpContext(device=torch.device("cpu")))
    out = vals[ex.final_guid][ex.final_out_idx].float()
    leaves = [t for ws in params.values() for t in ws.values()]
    fx = [t for t in full if t.requires_grad]
    grads = torch.autograd.grad(out, leaves + fx, torch.tensor(cot),
                                allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves + fx)]
    it = iter(grads[:len(leaves)])
    gp = {n: {w: next(it).numpy() for w in ws} for n, ws in params.items()}
    return (out.detach().numpy(), gp,
            [g.numpy() for g in grads[len(leaves):]])


def _assert_grad_close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, what
    den = np.linalg.norm(want)
    err = np.linalg.norm(got - want)
    if den == 0:
        assert err == 0, f"{what}: {err} where JAX's grad is 0"
    else:
        assert err <= tol * den, f"{what}: relative norm error {err / den}"


def check_pair(specs, build, compute="fp32", positive=False, seed=0,
               kink=False):
    """Build ``build(ff, pkg, *inputs)`` in both packages and hold the
    port's output and grads against JAX's. ``kink``: the graph has a ReLU
    or a max pool, whose grads bf16 rounding may move whole (then only the
    bf16 output is held). Returns the port's model, its inputs and
    output."""
    jff = _build(fj, specs, build, compute)
    tff = _build(ft, specs, build, compute)
    tff.set_params_numpy(jax.device_get(jff.params))
    xs = _inputs(specs, seed, positive)
    cot = _cot(jff, seed)
    jout, jgp, jgx = _jax_run(jff, xs, cot)
    if compute == "bf16":
        # JAX's conv cannot be differentiated in bf16 (its transpose rule
        # meets the fp32 cotangent of ``preferred_element_type`` with the
        # bf16 input and raises): bf16 grads are held against the same
        # graph's fp32 grads in JAX, in the bf16 band
        jfp = _build(fj, specs, build, "fp32")
        jfp.params = jff.params
        _, jgp, jgx = _jax_run(jfp, xs, cot)
    tout, tgp, tgx = _port_run(tff, xs, cot)
    np.testing.assert_allclose(tout, jout, **OUT_TOL[compute])
    if compute == "bf16" and kink:
        return tff, xs, tout
    assert set(tgp) == set(jgp)
    for n in jgp:
        assert set(tgp[n]) == set(jgp[n]), n
        for w in jgp[n]:
            _assert_grad_close(tgp[n][w], jgp[n][w], GRAD_TOL[compute],
                               f"{n}.{w}")
    for i, (g, h) in enumerate(zip(tgx, jgx)):
        _assert_grad_close(g, h, GRAD_TOL[compute], f"input {i}")
    return tff, xs, tout


def _cot(jff, seed):
    node = jff.pcg.nodes[jff.executor.final_guid]
    shape = node.out_shapes[jff.executor.final_out_idx]
    return np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)


def F(shape):
    return (tuple(shape), "DT_FLOAT")


# --------------------------------------------------------------- conv
# input shape; out channels, kernel, stride, padding, activation, groups,
# bias
CONV_CASES = {
    "3x3_relu": ((2, 8, 9, 9), 16, (3, 3), (1, 1), (1, 1), "AC_MODE_RELU",
                 1, True),
    "stride2_nopad": ((2, 6, 11, 11), 8, (3, 3), (2, 2), (0, 0),
                      "AC_MODE_NONE", 1, True),
    "grouped": ((2, 8, 7, 7), 16, (3, 3), (1, 1), (1, 1), "AC_MODE_RELU", 4,
                True),
    "1x7_pad": ((2, 4, 9, 9), 6, (1, 7), (1, 1), (0, 3), "AC_MODE_TANH", 1,
                True),
    "11x11_stride4": ((2, 3, 35, 35), 8, (11, 11), (4, 4), (2, 2),
                      "AC_MODE_SIGMOID", 1, True),
    "no_bias_gelu": ((2, 4, 6, 6), 5, (3, 3), (1, 1), (1, 1), "AC_MODE_GELU",
                     1, False),
}


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case, compute):
    shape, out, k, st, pad, act, groups, bias = CONV_CASES[case]

    def build(ff, pkg, x):
        ff.conv2d(x, out, *k, *st, *pad, getattr(pkg.ActiMode, act),
                  groups=groups, use_bias=bias)

    tff, _xs, _out = check_pair([F(shape)], build, compute,
                                kink=act == "AC_MODE_RELU")
    (ws,) = tff.params.values()
    # HWIO, as the JAX package stores it
    assert tuple(ws["kernel"].shape) == k + (shape[1] // groups, out)
    assert ("bias" in ws) == bias


# ------------------------------------------------------------- pooling
def _pool(kh, kw, sh, sw, ph, pw, kind="POOL_MAX", act="AC_MODE_NONE"):
    def build(ff, pkg, x):
        pool = (JaxPoolType if pkg is fj else ft.PoolType)[kind]
        ff.pool2d(x, kh, kw, sh, sw, ph, pw, pool,
                  getattr(pkg.ActiMode, act))
    return build


POOL_CASES = {
    "max_3x3_s2_p1": _pool(3, 3, 2, 2, 1, 1),
    "max_2x2_relu": _pool(2, 2, 2, 2, 0, 0, act="AC_MODE_RELU"),
    # InceptionV3's branch pool: padded cells must not count
    "avg_3x3_s1_p1": _pool(3, 3, 1, 1, 1, 1, "POOL_AVG"),
    "avg_global": _pool(7, 7, 1, 1, 0, 0, "POOL_AVG"),
    # padding above half the window, which F.*_pool2d refuse and
    # reduce_window takes: the op pads explicitly
    "max_3x3_s1_p2": _pool(3, 3, 1, 1, 2, 2),
    "avg_3x3_s1_p2": _pool(3, 3, 1, 1, 2, 2, "POOL_AVG"),
}


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_jax(case, compute):
    check_pair([F((2, 4, 7, 7))], POOL_CASES[case], compute,
               kink=not case.startswith("avg"))


def test_avg_pool_excludes_padding_from_the_count():
    """A padded 3x3 average over ones is 1 everywhere (each window divides
    by its cells inside the input); counting the pad would give 4/9 at a
    corner."""
    def build(ff, pkg, x):
        ff.pool2d(x, 3, 3, 1, 1, 1, 1, ft.PoolType.POOL_AVG)

    tff = _build(ft, [F((1, 1, 4, 4))], build, "fp32")
    out = tff.predict(np.ones((1, 1, 4, 4), np.float32))
    np.testing.assert_array_equal(out, np.ones((1, 1, 4, 4), np.float32))


# ---------------------------------------------------------- batch norm
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("relu", [True, False])
def test_batch_norm_matches_jax(relu, compute):
    def build(ff, pkg, x):
        ff.batch_norm(x, relu=relu)

    check_pair([F((4, 3, 5, 5))], build, compute, kink=relu)


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_batch_norm_uses_biased_fp32_batch_statistics(compute):
    """In eval as in training: (x - mean) / sqrt(var_N + eps) with the
    batch's statistics taken in fp32, then scale and bias, rounded once
    to the compute dtype."""
    def build(ff, pkg, x):
        ff.batch_norm(x, relu=False)

    tff = _build(ft, [F((3, 2, 4, 4))], build, compute)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 2, 4, 4)) * 3 + 1).astype(np.float32)
    params = {n: {w: torch.tensor(rng.standard_normal(t.shape),
                                  dtype=torch.float32)
                  for w, t in ws.items()} for n, ws in tff.params.items()}
    tff.set_params_numpy({n: {w: t.numpy() for w, t in ws.items()}
                          for n, ws in params.items()})
    (ws,) = params.values()
    xin = x
    if compute == "bf16":
        xin = torch.tensor(x).bfloat16().float().numpy()
        ws = {w: t.bfloat16().float() for w, t in ws.items()}
    mean = xin.mean(axis=(0, 2, 3), keepdims=True, dtype=np.float64)
    var = ((xin - mean) ** 2).mean(axis=(0, 2, 3), keepdims=True)
    want = ((xin - mean) / np.sqrt(var + 1e-5)
            * ws["scale"].numpy().reshape(1, -1, 1, 1)
            + ws["bias"].numpy().reshape(1, -1, 1, 1))
    got = tff.predict(x)
    if compute == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        # the fp32 result rounded once to bf16: within one bf16 ulp of it
        # (2**-7 of the value at most; half an ulp but where the fp32
        # arithmetic lands on the other side of a rounding boundary)
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    # the unbiased variance would be off by the factor N / (N - 1)
    unbiased = var * 48 / 47
    assert not np.allclose(
        got, (xin - mean) / np.sqrt(unbiased + 1e-5)
        * ws["scale"].numpy().reshape(1, -1, 1, 1)
        + ws["bias"].numpy().reshape(1, -1, 1, 1), atol=1e-4)


def test_flat_matches_jax():
    def build(ff, pkg, x):
        ff.flat(x)

    _tff, xs, out = check_pair([F((2, 3, 4, 5))], build)
    np.testing.assert_array_equal(out, xs[0].reshape(2, -1))


# ------------------------------------------------------ binary ops
@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide",
                                "max", "min"])
def test_binary_ops_match_jax(op):
    def build(ff, pkg, a, b):
        getattr(ff, op)(a, b)

    # b broadcasts over a's leading axis; the divisor stays away from 0
    check_pair([F((3, 4, 5)), F((4, 5))], build, positive=op == "divide")


# ------------------------------------------------------- unary ops
UNARY = {
    "relu": {}, "sigmoid": {}, "tanh": {}, "elu": {}, "gelu": {},
    "exp": {}, "log": {"positive": True}, "sin": {}, "cos": {},
    "rsqrt": {"positive": True}, "identity": {},
    "pow": {"args": (2.5,), "positive": True},
    "scalar_multiply": {"args": (1.7,)}, "scalar_add": {"args": (0.3,)},
    "scalar_sub": {"args": (0.3,)}, "scalar_true_divide": {"args": (4.0,)},
}
UNARY_BY_TYPE = {"sqrt": "OP_SQRT", "ceil": "OP_CEIL", "round": "OP_ROUND"}


@pytest.mark.parametrize("op", sorted(UNARY) + sorted(UNARY_BY_TYPE))
def test_unary_ops_match_jax(op):
    spec = UNARY.get(op, {"positive": op == "sqrt"})

    def build(ff, pkg, x):
        if op in UNARY_BY_TYPE:
            # the JAX FFModel has no builder for these three ops
            ff._unary(getattr(pkg.OperatorType, UNARY_BY_TYPE[op]), x)
        else:
            getattr(ff, op)(x, *spec.get("args", ()))

    check_pair([F((3, 7))], build, positive=spec.get("positive", False))


def test_round_is_half_to_even_in_both_packages():
    def build(ff, pkg, x):
        ff._unary(pkg.OperatorType.OP_ROUND, x)

    tff = _build(ft, [F((1, 6))], build, "fp32")
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 2.4999]], np.float32)
    np.testing.assert_array_equal(tff.predict(x),
                                  [[0.0, 2.0, 2.0, -0.0, -2.0, 2.0]])
    np.testing.assert_array_equal(np.asarray(jnp.round(x)), tff.predict(x))


@pytest.mark.parametrize("target", ["DT_INT32", "DT_BFLOAT16", "DT_DOUBLE"])
def test_cast_matches_jax(target):
    def build(ff, pkg, x):
        ff.cast(x, getattr(pkg.DataType, target))

    jff = _build(fj, [F((3, 5))], build, "fp32")
    tff = _build(ft, [F((3, 5))], build, "fp32")
    x = (np.random.default_rng(0).standard_normal((3, 5)) * 4).astype(
        np.float32)
    want = np.asarray(jff.predict(x), np.float64)
    got = np.asarray(tff.predict(x), np.float64)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- tensor ops
def _gather(ff, pkg, x, idx):
    ff.gather(x, idx, 1)


TENSOR_CASES = {
    "reshape": ([F((2, 3, 4))], lambda ff, pkg, x: ff.reshape(x, (2, -1))),
    "transpose": ([F((2, 3, 4))],
                  lambda ff, pkg, x: ff.transpose(x, (0, 2, 1))),
    "reverse": ([F((2, 3, 4))], lambda ff, pkg, x: ff.reverse(x, 1)),
    "split_concat": ([F((2, 5, 3))], lambda ff, pkg, x: ff.concat(
        ff.split(x, [2, 3], 1)[::-1], 1)),
    "split_even": ([F((2, 6))], lambda ff, pkg, x: ff.multiply(
        *ff.split(x, 2, 1))),
    "gather": ([F((2, 4, 3)), ((2, 5, 3), "DT_INT64")], _gather),
    "reduce_sum": ([F((2, 3, 4))],
                   lambda ff, pkg, x: ff.reduce_sum(x, (1, -1))),
    "reduce_sum_keepdims": ([F((2, 3, 4))], lambda ff, pkg, x:
                            ff.reduce_sum(x, (1,), keepdims=True)),
    "mean": ([F((2, 3, 4))], lambda ff, pkg, x: ff.mean(x, (2,))),
    "slice": ([F((2, 6, 5))], lambda ff, pkg, x: ff.slice_tensor(
        x, (slice(None), slice(1, 5, 2), None, 3))),
    "slice_negative_step": ([F((2, 6, 5))], lambda ff, pkg, x:
                            ff.slice_tensor(x, (0, slice(None, None, -2),
                                                slice(4, 0, -3)))),
    "batch_matmul": ([F((2, 3, 4)), F((2, 4, 5))],
                     lambda ff, pkg, a, b: ff.batch_matmul(a, b)),
}


@pytest.mark.parametrize("case", sorted(TENSOR_CASES))
def test_tensor_ops_match_jax(case):
    specs, build = TENSOR_CASES[case]
    check_pair(specs, build)


def test_batch_matmul_bf16_in_band():
    def build(ff, pkg, a, b):
        ff.batch_matmul(a, b)

    check_pair([F((2, 8, 16)), F((2, 16, 4))], build, "bf16")


def test_gather_index_out_of_range_raises_here():
    """``jnp.take_along_axis`` clamps or fills an out-of-range index; the
    port passes indices through and ``torch.gather`` raises on the CPU
    (on CUDA it trips a device-side assert): keeping them in range is the
    caller's part (``GatherOp``'s docstring)."""
    tff = _build(ft, [F((2, 4, 3)), ((2, 5, 3), "DT_INT64")], _gather,
                 "fp32")
    idx = np.full((2, 5, 3), 4, np.int64)
    with pytest.raises(RuntimeError):
        tff.predict([np.zeros((2, 4, 3), np.float32), idx])


@pytest.mark.parametrize("axes", [(-1,), (1, 2)])
def test_rms_norm_matches_jax(axes):
    def build(ff, pkg, x):
        ff.rms_norm(x, axes)

    check_pair([F((2, 3, 8))], build)


# ----------------------------------------------------------- dropout
def _dropout_model(rate, shape=(64, 512)):
    c = ft.FFConfig()
    c.batch_size = shape[0]
    ff = ft.FFModel(c, device="cpu")
    ff.dropout(ff.create_tensor(shape), rate=rate)
    ff.compile(loss_type=ft.LossType.LOSS_IDENTITY)
    return ff


def _dropout_forward(ff, x, training, seed):
    ex = ff.executor
    ctx = OpContext(training=training, device=torch.device("cpu"),
                    rng=torch.Generator().manual_seed(seed))
    vals = ex.forward_outputs(ff.params, ex._bind_inputs([x]), ctx)
    return vals[ex.final_guid][0]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_law(rate):
    ff = _dropout_model(rate)
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (64, 512)).astype(np.float32)) + 10.0  # no zeros of its own
    assert torch.equal(_dropout_forward(ff, x, False, 1), x)  # eval
    y = _dropout_forward(ff, x, True, 1)
    kept = y != 0
    n, keep = x.numel(), 1.0 - rate
    share = float(kept.float().mean())
    sigma = (keep * rate / n) ** 0.5
    assert abs(share - keep) <= 5 * sigma, (share, keep)
    scale = np.float32(1.0) / np.float32(keep)
    torch.testing.assert_close(y[kept], x[kept] * float(scale), rtol=1e-6,
                               atol=0)
    # a new seed moves the mask; the same seed repeats it
    assert not torch.equal(_dropout_forward(ff, x, True, 2) != 0, kept)
    assert torch.equal(_dropout_forward(ff, x, True, 1), y)
    # rate 0 is the identity in training too
    assert torch.equal(_dropout_forward(_dropout_model(0.0), x, True, 1), x)


def test_dropout_in_fit_takes_a_fresh_seed_each_step():
    """Through the step program (the CPU runs its plumbing, seed buffer
    included): two steps from the same weights with consecutive
    generators drop different elements, so their losses differ."""
    c = ft.FFConfig()
    c.batch_size, c.seed = 8, 0
    ff = ft.FFModel(c, device="cpu")
    t = ff.dropout(ff.dense(ff.create_tensor((8, 16)), 32), rate=0.5)
    ff.dense(t, 1)
    ff.compile(optimizer=ft.SGDOptimizer(ff, lr=0.0),
               loss_type=ft.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 16)).astype(np.float32)
    y = rng.standard_normal((16, 1)).astype(np.float32)
    ff.fit(np.concatenate([x[:8], x[:8]]), np.concatenate([y[:8], y[:8]]),
           epochs=1, shuffle=False)
    losses = ff.fit_history.loss
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[0] != losses[1]
    program = ff.executor.make_train_step().program
    assert program._entries and next(iter(
        program._entries.values())).n_seeds == 1


def test_dropout_refuses_a_training_forward_without_rng():
    ff = _dropout_model(0.5, (4, 8))
    ex = ff.executor
    with pytest.raises(ValueError, match="random stream"):
        ex.forward_outputs(ff.params, ex._bind_inputs([torch.ones(4, 8)]),
                           OpContext(training=True, device=torch.device(
                               "cpu")))
