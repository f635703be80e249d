"""The port's Keras frontend against the JAX package's, on the CPU.

The same Keras-style model is built with each package's
``frontends.keras`` (the port's on ``device="cpu"``), the JAX initial
weights are carried into the port by position (``set_params_numpy``;
each package numbers its layer names on its own), and both are driven
with the same numpy data (``default_rng``). Checked (fp32; the two sides
differ in summation order only; dropout 0, as the packages' random
streams differ):

* Sequential and functional models: params after ``fit`` within 1e-5,
  ``predict`` within 1e-5, ``PerfMetrics`` counts equal;
* the callbacks: ``LearningRateScheduler`` sets the same rates and the
  trained params agree (the port's ``fit`` drops its captured steps after
  ``set_learning_rate``), ``VerifyMetrics`` and ``EpochVerifyMetrics``
  stop at the JAX package's epoch, and ``TelemetryCallback`` writes a
  record with the JAX record's keys, one epoch summary an epoch, armed
  for its own fit only;
* the dataset arrays bit-equal to the JAX package's, from the synthetic
  streams and from ``$FF_DATASET_DIR``; preprocessing equal;
* initializers (a constant bias, a seeded kernel) and L1 / L2
  regularizers (params after a step within 1e-5; the penalty shrinks the
  kernels); Maximum / Minimum / Reshape, the backend ops, ``batch_dot``
  and ``gather`` and node scalar arithmetic, forward within 1e-5;
  ``get_weights`` / ``set_weights`` and the net2net transfer.
"""
import json

import numpy as np
import pytest
import torch

import flexflow_tpu.frontends.keras as JK
import flexflow_tpu.frontends.keras_backend as JB
import flexflow_tpu_torch.frontends.keras as TK
import flexflow_tpu_torch.frontends.keras_backend as TB

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
DEV = {JK: {}, TK: {"device": "cpu"}}


def _jax_params(jm):
    """The JAX model's params in node order (``jax.device_get`` would sort
    the names, and each package numbers its layers on its own)."""
    return [{w: np.asarray(a) for w, a in ws.items()}
            for ws in jm.ffmodel.params.values()]


def _carry(jm, tm):
    """The JAX model's params into the port's, node by node."""
    jp = _jax_params(jm)
    tp = tm.ffmodel.get_params_numpy()
    assert len(jp) == len(tp)
    tree = {}
    for jws, (tn, tws) in zip(jp, tp.items()):
        assert sorted(jws) == sorted(tws)
        assert all(jws[w].shape == tws[w].shape for w in tws)
        tree[tn] = jws
    tm.ffmodel.set_params_numpy(tree)


def _params_close(jm, tm, **tol):
    tp = list(tm.ffmodel.get_params_numpy().values())
    for jws, tws in zip(_jax_params(jm), tp):
        for w in jws:
            np.testing.assert_allclose(tws[w], jws[w], **(tol or TOL),
                                       err_msg=w)


def _pair(build, *args, **kw):
    jm, tm = build(JK, *args, **kw), build(TK, *args, **kw)
    _carry(jm, tm)
    return jm, tm


def _data(n, d, classes, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d, classes))
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return x, y


def _sequential(K, d=20, hidden=32, classes=4, optimizer=None, batch=16,
                init=None, reg=None):
    kw = {}
    if init is not None:
        kw = dict(kernel_initializer=init[0], bias_initializer=init[1])
    model = K.Sequential([
        K.Input(shape=(d,)),
        K.Dense(hidden, activation="relu", kernel_regularizer=reg, **kw),
        K.Dropout(0.0),
        K.Dense(classes),
        K.Activation("softmax"),
    ], **DEV[K])
    model.ffconfig.batch_size = batch
    model.compile(optimizer=optimizer or {
        "class_name": "Adam", "config": {"learning_rate": 0.01}},
        loss="sparse_categorical_crossentropy", metrics=("accuracy",))
    return model


def test_sequential_fit_matches():
    jm, tm = _pair(_sequential)
    assert tm.ffmodel.device.type == "cpu"
    x, y = _data(64, 20, 4)
    jp, tp = jm.fit(x, y, epochs=2), tm.fit(x, y, epochs=2)
    assert (tp.train_all, tp.train_correct) == (jp.train_all,
                                               jp.train_correct)
    _params_close(jm, tm)
    np.testing.assert_allclose(tm.predict(x), jm.predict(x), **TOL)
    je, te = jm.evaluate(x, y), tm.evaluate(x, y)
    assert (te.train_all, te.train_correct) == (je.train_all,
                                               je.train_correct)


def _functional(K):
    a = K.InputTensor(shape=(8,))
    b = K.InputTensor(shape=(8,))
    ha = K.Dense(16, activation="relu")(a)
    hb = K.Dense(16, activation="relu")(b)
    merged = K.Concatenate(axis=1)([ha, hb])
    out = K.Activation("softmax")(K.Dense(3)(merged))
    model = K.Model(inputs=[a, b], outputs=out, **DEV[K])
    model.ffconfig.batch_size = 8
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
                  metrics=("accuracy",))
    return model


def test_functional_fit_matches():
    jm, tm = _pair(_functional)
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=(32, 8)).astype(np.float32) for _ in range(2)]
    y = rng.integers(0, 3, size=32).astype(np.int32)
    jp, tp = jm.fit(xs, y, epochs=2), tm.fit(xs, y, epochs=2)
    assert tp.train_all == jp.train_all == 32
    assert tp.train_correct == jp.train_correct
    _params_close(jm, tm)
    np.testing.assert_allclose(tm.predict(xs), jm.predict(xs), **TOL)


def test_device_rule_without_a_gpu(monkeypatch):
    """``None`` means CUDA: without a GPU the model raises at compile."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TK.Sequential([TK.Input(shape=(4,)), TK.Dense(2)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.compile()
    model = TK.Model(TK.Input(shape=(4,)), TK.Dense(2)(TK.Input(
        shape=(4,))))
    with pytest.raises(RuntimeError, match="no GPU"):
        model.compile()


def test_lr_scheduler_and_verify_callbacks_match():
    runs = {}
    for K in (JK, TK):
        runs[K] = (_sequential(K, d=16, optimizer="sgd"), [])
    _carry(runs[JK][0], runs[TK][0])
    x, y = _data(64, 16, 4)
    for K, (model, lrs) in runs.items():
        def schedule(epoch, lrs=lrs):
            lr = 0.1 * (0.5 ** epoch)
            lrs.append(lr)
            return lr

        cbs = [K.LearningRateScheduler(schedule), K.VerifyMetrics(0.0),
               K.EpochVerifyMetrics(99.0)]
        model.fit(x, y, epochs=4, callbacks=cbs)
    (jm, jl), (tm, tl) = runs[JK], runs[TK]
    assert tl == jl and len(tl) == 4
    assert tm.ffmodel.optimizer.lr == pytest.approx(0.1 * 0.5 ** 3)
    _params_close(jm, tm)
    with pytest.raises(AssertionError, match="Accuracy is wrong"):
        cb = TK.VerifyMetrics(100.5)
        cb.set_model(tm)
        cb.on_train_end()


def test_epoch_early_stop_matches():
    seen = {}
    models = {K: _sequential(K, d=8, hidden=16, classes=2, optimizer={
        "class_name": "Adam", "config": {"learning_rate": 0.05}})
        for K in (JK, TK)}
    _carry(models[JK], models[TK])
    x, y = _data(64, 8, 2)
    for K, model in models.items():
        seen[K] = []

        class Counter(K.Callback):
            def on_epoch_end(self, epoch, logs=None, seen=seen[K]):
                seen.append(epoch)

        model.fit(x, y, epochs=50,
                  callbacks=[Counter(), K.EpochVerifyMetrics(10.0)])
    assert seen[TK] == seen[JK]
    assert len(seen[TK]) < 50


def test_telemetry_callback_record_matches(tmp_path):
    records = {}
    models = {K: _sequential(K) for K in (JK, TK)}
    _carry(models[JK], models[TK])
    x, y = _data(64, 20, 4)
    for K, model in models.items():
        path = tmp_path / f"{K.__name__}.json"
        cb = K.callbacks.TelemetryCallback(telemetry_file=str(path))
        model.fit(x, y, epochs=2, callbacks=[cb])
        assert model.ffmodel._telemetry_requested is False
        records[K] = json.loads(path.read_text())
        assert len(cb.epoch_summaries) == 2
    want, got = records[JK], records[TK]
    assert set(want) <= set(got) and got["phase"] == "train"
    assert [e["epoch"] for e in got["epochs"]] == [0, 1]
    for je, te in zip(want["epochs"], got["epochs"]):
        assert set(je) <= set(te), set(je) - set(te)
        assert te["steps"] == je["steps"] == 4
    # armed for its own fit only: a later fit without it records nothing
    models[TK].fit(x, y, epochs=1)
    assert models[TK].ffmodel.get_telemetry() is None


def test_dataset_arrays_bit_equal():
    (jx, jy), (jxt, jyt) = JK.datasets.mnist.load_data()
    (tx, ty), (txt, tyt) = TK.datasets.mnist.load_data()
    for a, b in ((jx, tx), (jy, ty), (jxt, txt), (jyt, tyt)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tx.shape == (60000, 28, 28) and tx.dtype == np.uint8
    del jx, tx, jxt, txt
    (jc, jcy), _ = JK.datasets.cifar10.load_data(128)
    (tc, tcy), _ = TK.datasets.cifar10.load_data(128)
    assert tc.shape == (128, 3, 32, 32) and tcy.shape == (128, 1)
    assert np.array_equal(jc, tc) and np.array_equal(jcy, tcy)
    (jr, jry), (jrt, _) = JK.datasets.reuters.load_data(num_words=100)
    (tr, try_), (trt, _) = TK.datasets.reuters.load_data(num_words=100)
    assert len(tr) == len(jr) and len(trt) == len(jrt)
    assert all(list(a) == list(b) for a, b in zip(jr, tr))
    assert np.array_equal(jry, try_)


def test_dataset_dir_is_read_first(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    arrays = {k: rng.integers(0, 256, size=(4, 28, 28), dtype=np.uint8)
              for k in ("x_train", "x_test")}
    arrays.update(y_train=np.arange(4, dtype=np.uint8),
                  y_test=np.arange(4, dtype=np.uint8))
    np.savez(tmp_path / "mnist.npz", **arrays)
    monkeypatch.setenv("FF_DATASET_DIR", str(tmp_path))
    (x, y), (xt, yt) = TK.datasets.mnist.load_data()
    (jx, _), _ = JK.datasets.mnist.load_data()
    assert np.array_equal(x, arrays["x_train"]) and np.array_equal(x, jx)
    assert np.array_equal(yt, arrays["y_test"])


def test_preprocessing_matches():
    (seqs, _), _ = TK.datasets.reuters.load_data(num_words=100)
    for mode in ("binary", "count", "freq"):
        got = TK.preprocessing.text.Tokenizer(
            num_words=100).sequences_to_matrix(seqs[:8], mode=mode)
        want = JK.preprocessing.text.Tokenizer(
            num_words=100).sequences_to_matrix(seqs[:8], mode=mode)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for padding in ("pre", "post"):
        for truncating in ("pre", "post"):
            kw = dict(maxlen=32, padding=padding, truncating=truncating)
            assert np.array_equal(
                TK.preprocessing.sequence.pad_sequences(seqs[:8], **kw),
                JK.preprocessing.sequence.pad_sequences(seqs[:8], **kw))


def test_initializers_bind_to_the_port_core():
    from flexflow_tpu_torch.execution import initializers as core

    from flexflow_tpu_torch.frontends.keras_initializers import (
        Constant, RandomNormal, RandomUniform, resolve)

    assert isinstance(resolve(TK.GlorotUniform(5)),
                      core.GlorotUniformInitializer)
    assert isinstance(resolve(TK.Zeros()), core.ZeroInitializer)
    assert isinstance(resolve(RandomUniform()), core.UniformInitializer)
    assert isinstance(resolve(RandomNormal()), core.NormInitializer)
    assert resolve(None) is None

    def kernels(seed):
        m = _sequential(TK, d=8, hidden=16,
                        init=(TK.GlorotUniform(seed), Constant(0.7)))
        return [ws for ws in m.ffmodel.get_params_numpy().values()]

    a, b = kernels(123), kernels(7)
    np.testing.assert_array_equal(a[0]["bias"], np.full(16, 0.7,
                                                        np.float32))
    assert not np.allclose(a[0]["kernel"], b[0]["kernel"])
    np.testing.assert_array_equal(a[0]["kernel"], kernels(123)[0]["kernel"])


@pytest.mark.parametrize("reg", ["l1", "l2"])
def test_regularizers_match(reg):
    def make(K):
        return (K.L1(0.05) if reg == "l1" else K.L2(0.05))

    jm, tm = (_sequential(K, d=8, hidden=16, reg=make(K))
              for K in (JK, TK))
    _carry(jm, tm)
    assert TK.regularizers.resolve(make(TK)) == (reg, 0.05)
    assert TK.regularizers.resolve(reg) == (reg, 0.01)
    with pytest.raises(ValueError):
        TK.regularizers.resolve("l3")
    plain = _sequential(TK, d=8, hidden=16)
    plain.ffmodel.set_params_numpy(dict(zip(
        plain.ffmodel.get_params_numpy(),
        tm.ffmodel.get_params_numpy().values())))
    x, y = _data(64, 8, 4)
    jm.fit(x, y, epochs=3)
    tm.fit(x, y, epochs=3)
    plain.fit(x, y, epochs=3)
    _params_close(jm, tm)

    def norm(model):
        return sum(float(np.sum(np.abs(ws["kernel"])))
                   for ws in model.ffmodel.get_params_numpy().values()
                   if "kernel" in ws)

    assert norm(tm) < norm(plain)


def _max_min_reshape(K):
    inp0, inp1 = K.Input(shape=(32,)), K.Input(shape=(32,))
    x0 = K.Dense(16, activation="relu")(inp0)
    x1 = K.Dense(16, activation="relu")(inp1)
    t = K.concatenate([K.Maximum()([x0, x1]), K.Minimum()([x0, x1])],
                      axis=1)
    t = K.Reshape((32,))(K.Reshape((2, 16))(t))
    model = K.Model([inp0, inp1], K.Dense(4)(t), **DEV[K])
    model.ffconfig.batch_size = 8
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=("accuracy",))
    return model


def _backend_ops(K, B):
    inp = K.Input(shape=(4, 8))
    a = B.sin(inp) + B.cos(inp)
    b = B.exp(B.pow(a, 2.0)) * B.rsqrt(B.exp(inp))
    model = K.Model(inp, K.Dense(3)(B.sum(b, axis=2)), **DEV[K])
    model.ffconfig.batch_size = 8
    model.compile(optimizer="sgd", loss="mean_squared_error",
                  metrics=("mean_squared_error",))
    return model


def _batch_dot_gather(K, B):
    a, bt = K.Input(shape=(4, 8)), K.Input(shape=(8, 5))
    idx = K.Input(shape=(4, 5), dtype="int32")
    g = B.gather(B.batch_dot(a, bt), idx, 1)
    model = K.Model([a, bt, idx], K.Dense(2)(B.sum(g, axis=2)), **DEV[K])
    model.ffconfig.batch_size = 4
    model.compile(optimizer="sgd", loss="mean_squared_error",
                  metrics=("mean_squared_error",))
    return model


def _scalar_arith(K, B):
    inp = K.Input(shape=(8,))
    out = (0.5 * K.Dense(4)(inp) + 1.0 - 2.0) / 1.0
    out = 0.0 - (0.0 - out)
    model = K.Model(inp, out, **DEV[K])
    model.ffconfig.batch_size = 4
    model.compile(optimizer="sgd", loss="mean_squared_error",
                  metrics=("mean_squared_error",))
    return model


def test_maximum_minimum_reshape_match():
    jm, tm = _pair(_max_min_reshape)
    assert len(tm.ffmodel._input_tensors) == 2
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(16, 32)).astype(np.float32) for _ in range(2)]
    np.testing.assert_allclose(tm.predict(xs), jm.predict(xs), **TOL)
    y = rng.integers(0, 4, size=(16, 1)).astype(np.int32)
    assert tm.fit(xs, y, epochs=1).train_all == 16
    jm.fit(xs, y, epochs=1)
    _params_close(jm, tm)


@pytest.mark.parametrize("build", ["backend_ops", "batch_dot_gather",
                                   "scalar_arith"])
def test_backend_graphs_match(build):
    fn = {"backend_ops": _backend_ops, "batch_dot_gather": _batch_dot_gather,
          "scalar_arith": _scalar_arith}[build]
    jm, tm = fn(JK, JB), fn(TK, TB)
    _carry(jm, tm)
    rng = np.random.default_rng(0)
    if build == "backend_ops":
        xs = rng.standard_normal((8, 4, 8)).astype(np.float32)
    elif build == "batch_dot_gather":
        xs = [rng.standard_normal((4, 4, 8)).astype(np.float32),
              rng.standard_normal((4, 8, 5)).astype(np.float32),
              rng.integers(0, 4, size=(4, 4, 5)).astype(np.int32)]
    else:
        xs = rng.standard_normal((4, 8)).astype(np.float32)
    got = tm.predict(xs)
    np.testing.assert_allclose(got, jm.predict(xs), **TOL)
    if build == "scalar_arith":
        ws = list(tm.ffmodel.get_params_numpy().values())[0]
        np.testing.assert_allclose(
            got, 0.5 * (xs @ ws["kernel"] + ws["bias"]) + 1.0 - 2.0,
            **TOL)


def _mlp(K, layers):
    inp = K.Input(shape=(784,))
    out = K.Activation("softmax")(layers[2](layers[1](layers[0](inp))))
    model = K.Model(inp, out, **DEV[K])
    model.ffconfig.batch_size = 64
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
                  metrics=("accuracy",))
    return model


def test_get_set_weights_and_net2net_match():
    """The net2net example's transfer (examples/python/keras/
    func_mnist_mlp_net2net.py) in both packages: the teacher trained one
    epoch from the same weights, its layers' weights moved into a
    student by ``get_weights`` / ``set_weights``; then a ``set_weights``
    between two fits of the student, so the second fit starts from what
    was set (the port drops its captured step)."""
    (x, y), _ = TK.datasets.mnist.load_data()
    x = (x.reshape(-1, 784).astype("float32") / 255)[:256]
    y = y.astype("int32").reshape(-1, 1)[:256]
    out = {}
    for K in (JK, TK):
        t_layers = [K.Dense(128, activation="relu"),
                    K.Dense(128, activation="relu"), K.Dense(10)]
        out[K] = dict(teacher=_mlp(K, t_layers), t_layers=t_layers)
    _carry(out[JK]["teacher"], out[TK]["teacher"])
    for K in (JK, TK):
        o = out[K]
        o["teacher"].fit(x, y, epochs=1)
        o["weights"] = [layer.get_weights(o["teacher"])
                        for layer in o["t_layers"]]
        s_layers = [K.Dense(128, activation="relu"),
                    K.Dense(128, activation="relu"), K.Dense(10)]
        o["student"] = student = _mlp(K, s_layers)
        for layer, ws in zip(s_layers, o["weights"]):
            layer.set_weights(student, *ws)
        o["t_pred"] = o["teacher"].predict(x)
        o["s_pred"] = student.predict(x)
        student.fit(x, y, epochs=1)
        s_layers[0].set_weights(student, *o["weights"][0])
        o["reset"] = s_layers[0].get_weights(student)
        student.fit(x, y, epochs=1)
        with pytest.raises(AssertionError):  # the bias left out
            s_layers[0].set_weights(student, o["weights"][0][0])
    t = out[TK]
    for jw, tw in zip(out[JK]["weights"], t["weights"]):
        assert len(tw) == 2 and tw[0].shape == jw[0].shape
        for a, b in zip(jw, tw):
            np.testing.assert_allclose(b, np.asarray(a), **TOL)
    np.testing.assert_array_equal(t["s_pred"], t["t_pred"])
    np.testing.assert_allclose(t["s_pred"], out[JK]["s_pred"], **TOL)
    for a, b in zip(t["reset"], t["weights"][0]):
        np.testing.assert_array_equal(a, b)
    _params_close(out[JK]["student"], t["student"])


def test_weight_arrays_are_copies():
    """``get_weights`` hands out host copies and ``set_weights`` copies
    what it is given, as the JAX package's immutable arrays behave: on
    the CPU a view would follow the in-place optimizer step (the net2net
    transfer above read a teacher changed by its student's fit)."""
    model = _sequential(TK, d=8, hidden=16, optimizer="sgd")
    layer = model.layers[1]
    kernel, bias = layer.get_weights(model)
    before = kernel.copy()
    given = np.full_like(kernel, 0.25)
    layer.set_weights(model, given, bias)
    x, y = _data(32, 8, 4)
    model.fit(x, y, epochs=1)
    np.testing.assert_array_equal(kernel, before)
    np.testing.assert_array_equal(given, np.full_like(kernel, 0.25))
    assert not np.array_equal(layer.get_weights(model)[0], given)
