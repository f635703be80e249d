"""Keras-frontend dataset loaders (a port of
``flexflow_tpu.frontends.keras_datasets``; reference:
python/flexflow/keras/datasets/{mnist,cifar10,cifar,reuters}.py).

Same ``load_data()`` API and array shapes/dtypes. The reference downloads
from S3 via ``get_file``; here a local cache is honored first
(``$FF_DATASET_DIR`` or ``~/.keras/datasets``, same file names) and when the
file is absent — e.g. on an air-gapped host — a deterministic synthetic
dataset with the exact real shapes/dtypes/class counts is generated so every
example script runs end-to-end (the reference's own examples fall back to
random tensors when ``--dataset`` is absent, README.md:73). The synthetic
arrays come from numpy's ``default_rng``, bit-equal to the JAX package's."""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np


def _cache_path(fname: str):
    for base in (os.environ.get("FF_DATASET_DIR"),
                 os.path.expanduser("~/.keras/datasets")):
        if base:
            p = os.path.join(base, fname)
            if os.path.exists(p):
                return p
    return None


def _mnist_load_data(path: str = "mnist.npz"):
    """reference: datasets/mnist.py load_data — returns
    (x_train (60000, 28, 28) uint8, y_train (60000,) uint8), (x_test ...)."""
    cached = _cache_path(path)
    if cached:
        with np.load(cached, allow_pickle=True) as f:
            return ((f["x_train"], f["y_train"]),
                    (f["x_test"], f["y_test"]))
    rng = np.random.default_rng(0)
    x_train = rng.integers(0, 256, size=(60000, 28, 28), dtype=np.uint8)
    y_train = rng.integers(0, 10, size=(60000,), dtype=np.uint8)
    x_test = rng.integers(0, 256, size=(10000, 28, 28), dtype=np.uint8)
    y_test = rng.integers(0, 10, size=(10000,), dtype=np.uint8)
    return (x_train, y_train), (x_test, y_test)


def _cifar10_load_data(num_samples=40000):
    """reference: datasets/cifar10.py load_data(num_samples=40000) — returns
    channels-first (num_samples, 3, 32, 32) uint8 train / (10000, 3, 32, 32)
    test, truncated to num_samples train rows (the examples call
    cifar10.load_data(10000)); same 40000-row default as the reference."""
    (tr, te) = _cifar10_load_all()
    if num_samples is not None:
        tr = (tr[0][:num_samples], tr[1][:num_samples])
    return tr, te


def _cifar10_load_all():
    cached = _cache_path("cifar-10-batches-py")
    if cached:
        from pickle import load

        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(cached, f"data_batch_{i}"), "rb") as f:
                d = load(f, encoding="bytes")
            xs.append(d[b"data"].reshape(-1, 3, 32, 32))
            ys.append(np.asarray(d[b"labels"]))
        with open(os.path.join(cached, "test_batch"), "rb") as f:
            d = load(f, encoding="bytes")
        x_test = d[b"data"].reshape(-1, 3, 32, 32)
        y_test = np.asarray(d[b"labels"]).reshape(-1, 1)
        return ((np.concatenate(xs), np.concatenate(ys).reshape(-1, 1)),
                (x_test, y_test))
    rng = np.random.default_rng(0)
    x_train = rng.integers(0, 256, size=(50000, 3, 32, 32), dtype=np.uint8)
    y_train = rng.integers(0, 10, size=(50000, 1), dtype=np.uint8)
    x_test = rng.integers(0, 256, size=(10000, 3, 32, 32), dtype=np.uint8)
    y_test = rng.integers(0, 10, size=(10000, 1), dtype=np.uint8)
    return (x_train, y_train), (x_test, y_test)


def _reuters_load_data(path: str = "reuters.npz", num_words=None,
                       skip_top: int = 0, maxlen=None, test_split: float = 0.2,
                       seed: int = 113, start_char: int = 1,
                       oov_char: int = 2, index_from: int = 3):
    """reference: datasets/reuters.py load_data — variable-length word-id
    sequences + 46-topic labels."""
    cached = _cache_path(path)
    if cached:
        with np.load(cached, allow_pickle=True) as f:
            xs, labels = f["x"], f["y"]
    else:
        rng = np.random.default_rng(seed)
        n = 11228
        vocab = num_words or 10000
        lengths = rng.integers(12, 200, size=n)
        xs = np.asarray([
            [start_char] + list(rng.integers(index_from + 1, vocab,
                                             size=ln))
            for ln in lengths], dtype=object)
        labels = rng.integers(0, 46, size=n)
    if num_words is not None:
        xs = np.asarray([[w if w < num_words else oov_char for w in seq]
                         for seq in xs], dtype=object)
    if maxlen is not None:
        keep = [i for i, seq in enumerate(xs) if len(seq) < maxlen]
        xs, labels = xs[keep], labels[keep]
    split = int(len(xs) * (1.0 - test_split))
    return ((xs[:split], labels[:split]), (xs[split:], labels[split:]))


mnist = SimpleNamespace(load_data=_mnist_load_data)
cifar10 = SimpleNamespace(load_data=_cifar10_load_data)
reuters = SimpleNamespace(load_data=_reuters_load_data)
