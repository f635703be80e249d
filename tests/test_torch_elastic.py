"""``elastic_restore`` in the port against the JAX package's
(tests/test_resilience.py:487-545).

A dp x tp checkpoint saved by four gloo ranks is restored by a job of two
(``tests/torch_safety_pairs.py``): the Unity search re-plans on the two
ranks, the checkpoint is restored host-staged onto the new plan, and a
step trains. The JAX package does the same with its devices cut to four
and ``n_dev=2``. Held: the step and the rng counter come back, the
re-searched plan is the JAX one, the restored params equal the saved
ones bitwise (and the JAX package's saved params within 1e-5), and a
target below the live world raises ``ValueError`` naming ``n_dev`` (the
port's mesh covers every rank of its group). On one device, a restore
onto the same topology is a plain restore in both.
"""
import itertools
import os

import numpy as np
import pytest

import jax

import flexflow_tpu.parallel.pcg as jax_pcg
from flexflow_tpu.execution.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from flexflow_tpu.resilience import elastic_restore as jax_elastic_restore
from flexflow_tpu_torch.execution.checkpoint import save_checkpoint
from flexflow_tpu_torch.resilience import elastic_restore

import torch_dist_pairs as tp
import torch_safety_pairs as sfp
from test_torch_strategy_safety import MACHINE, _data, _jax_build, _world
from test_torch_strategy_safety_one import _pair
from torch_mesh_pairs import TOL, jax_weights, write_case


def _params(jff):
    return {n: {w: np.asarray(a) for w, a in ws.items()}
            for n, ws in jax.device_get(jff.params).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic"))
    path = f"{root}/machine.cfg"
    with open(path, "w") as f:
        f.write(MACHINE)
    machine = dict(machine_model_version=1, machine_model_file=path)
    x, y = _data()
    with pytest.MonkeyPatch.context() as mp:
        _world(mp, 4, path)
        mp.setattr(jax_pcg, "_node_guid", itertools.count(1))
        jffa = _jax_build("mlp2", "hybrid:2:2")
        weights = jax_weights(jffa)
        jffa.fit(x, y, epochs=1, shuffle=False)
        jpath = jax_save_checkpoint(
            jffa, os.path.join(root, "jax_ckpt"), step=8,
            train_state={"step": 8, "epoch": 1, "batch_in_epoch": 0,
                         "rng_counter": jffa._rng_counter})
        mp.setattr(jax_pcg, "_node_guid", itertools.count(1))
        jffb = _jax_build("mlp2")
        jstep = jax_elastic_restore(jffb, jpath, n_dev=2)
        want = dict(saved=_params(jffa), step=jstep,
                    rng=jffb._rng_counter, strategy=jffb.strategy.describe(),
                    restored=_params(jffb))
    write_case(root, "save", x, y, weights)
    tp.finish(tp.start(4, root, [("save", "save", dict(
        model="mlp2", strategy="hybrid:2:2", config=machine))],
        main=sfp.rank_main), root, timeout=240)
    saved = tp.load(root, "save", 0)
    np.savez(os.path.join(root, "elastic_in.npz"), x=x, y=y,
             path=saved["path"], **tp.flat("w", weights))
    tp.finish(tp.start(2, root, [("elastic", "elastic", dict(
        model="mlp2", config=machine))], main=sfp.rank_main), root,
        timeout=240)
    return root, want, saved


def test_restore_onto_half_the_ranks_replans_and_trains(runs):
    root, want, saved = runs
    assert saved["mesh"].tolist() == [2, 2]
    for r in range(2):
        g = tp.load(root, "elastic", r)
        assert int(g["step"]) == 8 == want["step"]
        assert int(g["rng"]) == int(saved["rng"]) == want["rng"]
        assert str(g["strategy"]) == want["strategy"]
        assert int(np.prod(g["mesh"])) == 2
        for k in g:
            if k.startswith("p/"):
                np.testing.assert_array_equal(g[k], saved[k])
                _, n, w = k.split("/")
                np.testing.assert_allclose(g[k], want["restored"][n][w],
                                           **TOL)
        assert np.isfinite(g["loss"]).all() and len(g["loss"]) == 1
        assert "n_dev=1" in str(g["refused"])


def test_elastic_same_topology_is_plain_restore(tmp_path):
    x, y = _data()
    jffa, ffa = _pair(only_data_parallel=True)
    ffa.fit(x, y, epochs=1)
    path = save_checkpoint(ffa, str(tmp_path / "port"), step=8)
    with pytest.MonkeyPatch.context() as mp:
        _world(mp, 1)
        jffa.fit(x, y, epochs=1)
        jpath = jax_save_checkpoint(jffa, str(tmp_path / "jax"), step=8)
        jffb, ffb = _pair(only_data_parallel=True)
        jax_step = jax_elastic_restore(jffb, jpath)
    assert elastic_restore(ffb, path) == 8 == jax_step
    assert ffb.mesh is None and ffa.mesh is None
    assert tuple(jffb.strategy.mesh_shape) == (1,)
    a, b = ffa.get_params_numpy(), ffb.get_params_numpy()
    for n in a:
        for w in a[n]:
            np.testing.assert_array_equal(b[n][w], a[n][w])
            np.testing.assert_allclose(b[n][w],
                                       np.asarray(jffb.params[n][w]), **TOL)
