"""Keras backend functional ops (a port of
``flexflow_tpu.frontends.keras_backend``; reference:
python/flexflow/keras/backend/{internal,backend_functions}.py — BatchMatmul,
Sin, Cos, Exp, Pow, ReduceSum, Rsqrt, Gather as layers plus the functional
aliases the examples use: ``out = rsqrt(x + inp2)``)."""
from __future__ import annotations

from .keras import Layer, _Node


class _Unary(Layer):
    """Maps to an FFModel unary builder by name."""

    builder: str = ""
    attrs: dict = {}

    def apply(self, ff, inputs):
        return getattr(ff, self.builder)(inputs[0], name=self.name,
                                         **self.attrs)


class Sin(_Unary):
    builder = "sin"


class Cos(_Unary):
    builder = "cos"


class Exp(_Unary):
    builder = "exp"


class Rsqrt(_Unary):
    builder = "rsqrt"


class Pow(Layer):
    def __init__(self, a: float, name=None):
        super().__init__(name)
        self.a = a

    def apply(self, ff, inputs):
        return ff.pow(inputs[0], self.a, name=self.name)


class ReduceSum(Layer):
    def __init__(self, axis=None, keepdims: bool = False, name=None):
        super().__init__(name)
        self.axis = axis
        self.keepdims = keepdims

    def apply(self, ff, inputs):
        ndim = len(inputs[0].dims)
        if self.axis is None:
            axes = list(range(1, ndim))  # all but batch (keras contract)
        elif isinstance(self.axis, (list, tuple)):
            axes = list(self.axis)
        else:
            axes = [self.axis]
        return ff.reduce_sum(inputs[0], axes, keepdims=self.keepdims,
                             name=self.name)


class BatchMatmul(Layer):
    def apply(self, ff, inputs):
        return ff.batch_matmul(inputs[0], inputs[1], name=self.name)


class Gather(Layer):
    def __init__(self, axis: int, name=None):
        super().__init__(name)
        self.axis = axis

    def apply(self, ff, inputs):
        return ff.gather(inputs[0], inputs[1], self.axis, name=self.name)


# ------------------------------------------------- functional aliases
def sin(x):
    return Sin()(x)


def cos(x):
    return Cos()(x)


def exp(x):
    return Exp()(x)


def rsqrt(x):
    return Rsqrt()(x)


def pow(x, a):  # noqa: A001  (reference name)
    return Pow(a)(x)


def sum(x, axis=None, keepdims=False):  # noqa: A001  (reference name)
    return ReduceSum(axis=axis, keepdims=keepdims)(x)


def batch_dot(x, y):
    return BatchMatmul()([x, y])


def gather(x, indices, axis):
    return Gather(axis)([x, indices])


# ------------------------------------- node arithmetic (models/tensor.py:131)
class _Scalar(Layer):
    """node-with-python-scalar arithmetic lowers to the scalar ops."""

    def __init__(self, builder: str, scalar: float, name=None):
        super().__init__(name)
        self.builder = builder
        self.scalar = float(scalar)

    def apply(self, ff, inputs):
        return getattr(ff, self.builder)(inputs[0], self.scalar,
                                         name=self.name)


def _arith(self, other, merge_cls_name: str, scalar_builder: str):
    if isinstance(other, (int, float)):
        return _Scalar(scalar_builder, other)(self)
    from . import keras as K

    if not isinstance(other, (_Node, K.Input)):
        return NotImplemented
    return getattr(K, merge_cls_name)()([self, other])


def _node_add(self, other):
    return _arith(self, other, "Add", "scalar_add")


def _node_sub(self, other):
    return _arith(self, other, "Subtract", "scalar_sub")


def _node_rsub(self, other):
    # scalar - node == (-1) * node + scalar
    if isinstance(other, (int, float)):
        return _Scalar("scalar_add", other)(
            _Scalar("scalar_multiply", -1.0)(self))
    return NotImplemented


def _node_mul(self, other):
    return _arith(self, other, "Multiply", "scalar_multiply")


def _node_div(self, other):
    return _arith(self, other, "Divide", "scalar_true_divide")


_Node.__add__ = _node_add
_Node.__radd__ = _node_add
_Node.__sub__ = _node_sub
_Node.__rsub__ = _node_rsub
_Node.__mul__ = _node_mul
_Node.__rmul__ = _node_mul
_Node.__truediv__ = _node_div
