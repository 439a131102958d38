"""Elementwise binary operators (numpy broadcasting).

The port of ``_BinaryBase`` in ``flexflow_tpu/ops/element_ops.py``; BERT
reaches it through ``FFModel.add``. The unary, scalar and reduction ops
come with later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ffconst import DataType, OperatorType
from .registry import OpDef, register

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


class _BinaryBase(OpDef):
    def infer(self, params, in_shapes, in_dtypes):
        out = tuple(np.broadcast_shapes(in_shapes[0], in_shapes[1]))
        dt = DataType.DT_BOOLEAN if self.op_type in _CMP_OPS else in_dtypes[0]
        return [(out, dt)]

    def emit(self, params, inputs, weights, ctx, name):
        return [_BINARY_FNS[self.op_type](inputs[0], inputs[1])]


for _t in _BINARY_FNS:
    register(type(f"Binary_{_t.name}", (_BinaryBase,), {"op_type": _t}))
