"""Ops of the port. Importing this package registers every ported op."""
from .base import Op, OpContext, op_class_for, register_op  # noqa: F401
from . import attention, conv, elementwise, embedding, linear  # noqa: F401
from . import moe_ops, noop, normalization, recurrent  # noqa: F401
from . import fused, tensor_ops  # noqa: F401
from ..parallel import parallel_op  # noqa: F401
