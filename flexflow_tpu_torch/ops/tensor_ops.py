"""Tensor-layout operators: Reshape, Slice, Transpose and Concat.

The port of the same classes in ``flexflow_tpu/ops/tensor_ops.py`` (the
BERT pooler reaches Reshape and Slice; LLaMA's primitive attention all
four). The other layout ops come with later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ffconst import OperatorType
from .registry import OpDef, register


@register
class ReshapeOp(OpDef):
    op_type = OperatorType.OP_RESHAPE

    def infer(self, params, in_shapes, in_dtypes):
        shape = tuple(params["shape"])
        vol_in = int(np.prod(in_shapes[0]))
        if -1 in shape:
            known = -int(np.prod(shape))
            shape = tuple(vol_in // known if s == -1 else s for s in shape)
        if int(np.prod(shape)) != vol_in:
            raise ValueError(
                f"reshape to {shape} does not preserve the element "
                f"count of {in_shapes[0]}")
        return [(shape, in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        return [inputs[0].reshape(tuple(params["shape"]))]


@register
class SliceOp(OpDef):
    op_type = OperatorType.OP_SLICE

    def infer(self, params, in_shapes, in_dtypes):
        ish = in_shapes[0]
        starts, ends = params["starts"], params["ends"]
        axes = params.get("axes", list(range(len(starts))))
        out = list(ish)
        for s, e, a in zip(starts, ends, axes):
            n = ish[a % len(ish)]
            s = min(s if s >= 0 else s + n, n)
            e = min(e if e >= 0 else e + n, n)
            out[a % len(ish)] = max(0, e - s)
        return [(tuple(out), in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        x = inputs[0]
        starts, ends = params["starts"], params["ends"]
        axes = params.get("axes", list(range(len(starts))))
        idx = [slice(None)] * x.dim()
        for s, e, a in zip(starts, ends, axes):
            idx[a % x.dim()] = slice(s, e)
        return [x[tuple(idx)]]


@register
class TransposeOp(OpDef):
    op_type = OperatorType.OP_TRANSPOSE

    def infer(self, params, in_shapes, in_dtypes):
        perm = params["perm"]
        return [(tuple(in_shapes[0][p] for p in perm), in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        return [inputs[0].permute(*params["perm"])]


@register
class ConcatOp(OpDef):
    op_type = OperatorType.OP_CONCAT

    def infer(self, params, in_shapes, in_dtypes):
        axis = params["axis"] % len(in_shapes[0])
        out = list(in_shapes[0])
        out[axis] = sum(s[axis] for s in in_shapes)
        return [(tuple(out), in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        return [torch.cat(inputs, dim=params["axis"])]
