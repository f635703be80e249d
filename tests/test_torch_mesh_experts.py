"""Expert parallelism and the column- then row-parallel dense pair on two
gloo ranks, against the JAX package and the port's one-device path
(``tests/torch_dist_pairs.py`` runs the ranks, ``tests/torch_mesh_pairs.py``
the references; tolerances there).

* The MoE MLP under ``expert_parallel_strategy`` at dp = 1 x ep = 2 (each
  expert dense split over the expert axis by its output columns, the
  aggregate reading them gathered): one Adam step's loss and params
  against the JAX package's step under the same strategy on its virtual
  mesh, and loss, grads and params against the one-device port.
* The column- then row-parallel dense pair (tests/test_parallel.py:56):
  ``predict`` equals the unsharded product on every rank, with each kernel
  held as its shard.
* Two such pairs at tp = 2 in bf16 (fp32 masters): one step's grads equal
  the one-device port's bitwise but for a few elements at a rounding
  boundary, because the sums that cross ranks (the row layers' outputs,
  the column layers' input grads) are taken in fp32 and rounded once, as
  the one-device product is. Rounding each rank's partial to bf16 before
  the sum leaves a sixth to a half of each grad's elements equal.
"""
import numpy as np
import pytest

import flexflow_tpu_torch as ft
import torch_dist_pairs as tp
from torch_mesh_pairs import (GRAD_TOL, TOL, assert_trees_close, data,
                              jax_build, jax_step, jax_weights,
                              port_one_device, write_case)

WORLD = 2
MLP = dict(model="mlp", batch=16, strategy="hybrid:1:2",
           compute_dtype=ft.DataType.DT_BFLOAT16)
# the two dense pairs: the share of each grad's elements bitwise the
# one-device port's, and the largest difference relative to the largest
# element
MLP_EQUAL, MLP_MAXREL = 0.99, 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("experts"))
    x, y = data("moe", 16)
    jff = jax_build("moe", "expert:1:2", 16)
    write_case(root, "moe", x, y, jax_weights(jff))
    lx, ly = data("linear", 16)
    lin_w = jax_weights(jax_build("linear", "hybrid:1:2", 16))
    write_case(root, "linear", lx, ly, lin_w)
    mx, my = data("mlp", 16)
    mlp_w = tp.build("mlp", None, 16).get_params_numpy()
    write_case(root, "mlp", mx, my, mlp_w)
    procs = tp.start(WORLD, root, [
        ("moe", "step", dict(model="moe", strategy="expert:1:2", batch=16)),
        ("linear", "linear", dict(model="linear", strategy="hybrid:1:2",
                                  batch=16)),
        ("mlp", "step", MLP)])
    ref = jax_step(jff, x, y)
    one = port_one_device("moe", 16, ref["weights"], x, y)
    mlp = port_one_device("mlp", 16, mlp_w, mx, my,
                          compute_dtype=MLP["compute_dtype"])
    tp.finish(procs, root)
    return root, ref, one, (lx, lin_w), mlp


def test_expert_parallel_step_matches_jax_and_one_device(runs):
    """JAX's ``loss_fn`` in ``jax_step`` leaves out the MoE's load-balance
    term, so its grads are not compared here; its train step's loss and
    params are, and the one-device port's grads."""
    root, ref, (p_loss, p_grads, p_params), _, _ = runs
    for rank in range(WORLD):
        got = tp.load(root, "moe", rank)
        np.testing.assert_allclose(float(got["loss"]), p_loss, **TOL)
        np.testing.assert_allclose(float(got["loss"]), ref["step_loss"],
                                   **TOL)
        assert_trees_close(p_grads, tp.unflat("g", got), **GRAD_TOL)
        assert_trees_close(p_params, tp.unflat("p", got), **TOL)
        assert_trees_close(ref["params"], tp.unflat("p", got), **TOL)


def test_col_row_linear_equals_the_unsharded_product(runs):
    root, _, _, (x, w), _ = runs
    want = np.maximum(x @ w["col_0"]["kernel"], 0) @ w["row_1"]["kernel"]
    for rank in range(WORLD):
        got = tp.load(root, "linear", rank)
        np.testing.assert_allclose(got["pred"], want, rtol=1e-5, atol=1e-5)
        assert tuple(got["col_local"]) == (32, 32)  # columns split
        assert tuple(got["row_local"]) == (32, 8)   # rows split


def test_tensor_parallel_bf16_sums_round_once(runs):
    root, *_, (_loss, want, _params) = runs
    for rank in range(WORLD):
        got = tp.unflat("g", tp.load(root, "mlp", rank))
        for n in want:
            for w, a in want[n].items():
                b = got[n][w]
                assert np.mean(a == b) >= MLP_EQUAL, (n, w)
                assert np.max(np.abs(a - b)) <= \
                    MLP_MAXREL * np.max(np.abs(a)), (n, w)
