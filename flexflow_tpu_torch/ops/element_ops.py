"""Elementwise unary, scalar and binary operators (numpy broadcasting).

The port of ``_UnaryBase`` and ``_BinaryBase`` in
``flexflow_tpu/ops/element_ops.py``, with the same tables of functions:
BERT reaches the binary table through ``FFModel.add``, LLaMA the unary
and scalar ones (SwiGLU's sigmoid and multiply, RoPE's scalar multiply).
The reductions, Cast and LeakyReLU come with later slices.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ffconst import DataType, OperatorType
from .registry import OpDef, register

_UNARY_FNS = {
    OperatorType.OP_RELU: torch.relu,
    OperatorType.OP_SIGMOID: torch.sigmoid,
    OperatorType.OP_TANH: torch.tanh,
    OperatorType.OP_ELU: F.elu,
    # jax.nn.gelu defaults to the tanh approximation
    OperatorType.OP_GELU: lambda x: F.gelu(x, approximate="tanh"),
    OperatorType.OP_IDENTITY: lambda x: x,
    OperatorType.OP_EXP: torch.exp,
    OperatorType.OP_LOG: torch.log,
    OperatorType.OP_SQRT: torch.sqrt,
    OperatorType.OP_RSQRT: torch.rsqrt,
    OperatorType.OP_SIN: torch.sin,
    OperatorType.OP_COS: torch.cos,
    OperatorType.OP_CEIL: torch.ceil,
    # half to even, as jnp.round
    OperatorType.OP_ROUND: torch.round,
    OperatorType.OP_LOGICAL_NOT: torch.logical_not,
}

_SCALAR_FNS = {
    OperatorType.OP_SCALAR_MULTIPLY: lambda x, s: x * s,
    OperatorType.OP_SCALAR_ADD: lambda x, s: x + s,
    OperatorType.OP_SCALAR_SUB: lambda x, s: x - s,
    OperatorType.OP_SCALAR_TRUE_DIV: lambda x, s: x / s,
    OperatorType.OP_SCALAR_FLOOR_DIV: lambda x, s: torch.floor_divide(x, s),
    OperatorType.OP_POW: lambda x, s: torch.pow(x, s),
}

_BINARY_FNS = {
    OperatorType.OP_EW_ADD: torch.add,
    OperatorType.OP_EW_SUB: torch.subtract,
    OperatorType.OP_EW_MUL: torch.multiply,
    OperatorType.OP_EW_DIV: torch.divide,
    OperatorType.OP_EW_MAX: torch.maximum,
    OperatorType.OP_EW_MIN: torch.minimum,
    OperatorType.OP_EW_EQUAL: torch.eq,
    OperatorType.OP_EW_GREATER: torch.gt,
    OperatorType.OP_EW_LESS: torch.lt,
    # TASO's alias for elementwise multiply
    OperatorType.OP_MUL: torch.multiply,
}

_CMP_OPS = {OperatorType.OP_EW_EQUAL, OperatorType.OP_EW_GREATER,
            OperatorType.OP_EW_LESS}


class _UnaryBase(OpDef):
    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        fn = _UNARY_FNS.get(self.op_type)
        if fn is not None:
            return [fn(inputs[0])]
        return [_SCALAR_FNS[self.op_type](inputs[0],
                                          params.get("scalar", 1.0))]


for _t in list(_UNARY_FNS) + list(_SCALAR_FNS):
    register(type(f"Unary_{_t.name}", (_UnaryBase,), {"op_type": _t}))


class _BinaryBase(OpDef):
    def infer(self, params, in_shapes, in_dtypes):
        out = tuple(np.broadcast_shapes(in_shapes[0], in_shapes[1]))
        dt = DataType.DT_BOOLEAN if self.op_type in _CMP_OPS else in_dtypes[0]
        return [(out, dt)]

    def emit(self, params, inputs, weights, ctx, name):
        return [_BINARY_FNS[self.op_type](inputs[0], inputs[1])]


for _t in _BINARY_FNS:
    register(type(f"Binary_{_t.name}", (_BinaryBase,), {"op_type": _t}))
