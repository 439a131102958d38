"""Elementwise unary, scalar and binary operators (numpy broadcasting),
LeakyReLU, PReLU, Cast, Where and the reductions.

The port of ``flexflow_tpu/ops/element_ops.py``, with the same tables of
functions: BERT reaches the binary table through ``FFModel.add``, LLaMA
the unary and scalar ones (SwiGLU's sigmoid and multiply, RoPE's scalar
multiply), Mixtral's router Equal, Cast and ReduceSum. Where JAX and
torch differ the port follows JAX: LeakyReLU and PReLU take the identity
branch at 0 (``jnp.where(x >= 0, ...)``), Where takes a non-bool
condition as ``!= 0``, max/min reductions split the gradient evenly
among ties (``amax``/``amin``, as ``jnp.max``; ``torch.max(dim=)`` does
not), a reduction over no axes returns its input, and ArgMax/ArgMin
return int32 over exactly one axis.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.tensor import WeightSpec
from ..dtypes import to_torch
from ..ffconst import DataType, InitializerType, OperatorType
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


@register
class LeakyReluOp(_UnaryBase):
    op_type = OperatorType.OP_LEAKYRELU

    def emit(self, params, inputs, weights, ctx, name):
        x = inputs[0]
        return [torch.where(x >= 0, x,
                            params.get("negative_slope", 0.01) * x)]


@register
class PReluOp(OpDef):
    op_type = OperatorType.OP_PRELU

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def weights(self, params, in_shapes, in_dtypes):
        return [WeightSpec("alpha", (in_shapes[0][-1],), in_dtypes[0],
                           InitializerType.CONSTANT, {"value": 0.25})]

    def emit(self, params, inputs, weights, ctx, name):
        x = inputs[0]
        return [torch.where(x >= 0, x, weights["alpha"] * x)]


@register
class CastOp(OpDef):
    op_type = OperatorType.OP_CAST

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], DataType(params["dtype"]))]

    def emit(self, params, inputs, weights, ctx, name):
        return [inputs[0].to(to_torch(params["dtype"]))]


@register
class WhereOp(OpDef):
    op_type = OperatorType.OP_WHERE

    def infer(self, params, in_shapes, in_dtypes):
        out = tuple(np.broadcast_shapes(*in_shapes))
        return [(out, in_dtypes[1])]

    def emit(self, params, inputs, weights, ctx, name):
        cond, x, y = inputs
        if cond.dtype != torch.bool:
            cond = cond != 0
        return [torch.where(cond, x, y)]


# ---------------------------------------------------------------------------
def _prod(x, axes, keepdim):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


class _ReduceBase(OpDef):
    fn = None
    arg = False

    def infer(self, params, in_shapes, in_dtypes):
        ish = in_shapes[0]
        ndim = len(ish)
        axes = sorted(a % ndim for a in params.get("axes", range(ndim)))
        keep = params.get("keepdims", False)
        if keep:
            out = tuple(1 if i in axes else s for i, s in enumerate(ish))
        else:
            out = tuple(s for i, s in enumerate(ish) if i not in axes)
        dt = DataType.DT_INT32 if self.arg else in_dtypes[0]
        return [(out, dt)]

    def emit(self, params, inputs, weights, ctx, name):
        x = inputs[0]
        axes = tuple(a % x.dim() for a in params.get("axes", range(x.dim())))
        keep = params.get("keepdims", False)
        if self.arg:
            if len(axes) != 1:
                raise ValueError(
                    f"arg-reduce takes exactly one axis, got {axes}")
            return [type(self).fn(x, dim=axes[0], keepdim=keep)
                    .to(torch.int32)]
        if not axes:        # torch would reduce every axis over dim=()
            return [x]
        return [type(self).fn(x, axes, keep)]


for _t, _fn, _arg in [
    (OperatorType.OP_REDUCE_SUM, lambda x, a, k: torch.sum(x, a, k), False),
    (OperatorType.OP_REDUCE_MEAN, lambda x, a, k: torch.mean(x, a, k), False),
    (OperatorType.OP_MEAN, lambda x, a, k: torch.mean(x, a, k), False),
    (OperatorType.OP_REDUCE_MAX, lambda x, a, k: torch.amax(x, a, k), False),
    (OperatorType.OP_REDUCE_MIN, lambda x, a, k: torch.amin(x, a, k), False),
    (OperatorType.OP_REDUCE_PROD, _prod, False),
    (OperatorType.OP_REDUCE_ARGMAX, torch.argmax, True),
    (OperatorType.OP_REDUCE_ARGMIN, torch.argmin, True),
]:
    register(type(f"Reduce_{_t.name}", (_ReduceBase,),
                  {"op_type": _t, "fn": staticmethod(_fn), "arg": _arg}))
