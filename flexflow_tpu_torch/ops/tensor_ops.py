"""Tensor-layout operators: NoOp/Input/Weight, Reshape, Transpose,
Reverse, Concat, Split, Squeeze, Unsqueeze, Pad, Slice, TopK, Gather,
Shape, Size and Resize.

The port of ``flexflow_tpu/ops/tensor_ops.py`` (the BERT pooler reaches
Reshape and Slice, LLaMA's primitive attention Transpose and Concat,
Mixtral's router and ``FFModel.moe`` TopK). Where JAX and torch differ
the port follows JAX: TopK is a stable descending sort, so equal values
keep the lower index first as ``jax.lax.top_k`` does (``torch.topk``
promises no order among ties); Unsqueeze's axes are positions in the
output (``jnp.expand_dims``); Pad's ``(lo, hi)`` pairs are in numpy's
dim order; Gather wraps negative indices as ``jnp.take_along_axis``
does; Resize computes ``jax.image.resize``: half-pixel centres, and an
antialiasing filter when a kernel method shrinks a dim.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ffconst import DataType, OperatorType
from .registry import OpDef, register


@register
class NoOp(OpDef):
    op_type = OperatorType.OP_NOOP

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        return [inputs[0]]


@register
class InputOp(NoOp):
    op_type = OperatorType.OP_INPUT


@register
class WeightOp(NoOp):
    op_type = OperatorType.OP_WEIGHT


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
        shape = tuple(params["shape"])
        x = inputs[0]
        vol = int(np.prod(shape))
        if getattr(ctx, "local_shape", False) and -1 not in shape \
                and shape and vol != x.numel():
            # a rank's rows under the quantized sync: the recorded shape
            # is global, so its batch dim takes the rank's share
            rest = vol // shape[0] if shape[0] > 0 else 0
            if rest > 0 and x.numel() % rest == 0:
                shape = (x.numel() // rest,) + shape[1:]
        return [x.reshape(shape)]


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
class ReverseOp(OpDef):
    op_type = OperatorType.OP_REVERSE

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        axis = params["axis"]
        dims = list(axis) if isinstance(axis, (list, tuple)) else [axis]
        return [torch.flip(inputs[0], dims)]


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


@register
class SplitOp(OpDef):
    op_type = OperatorType.OP_SPLIT

    def infer(self, params, in_shapes, in_dtypes):
        ish = in_shapes[0]
        axis = params["axis"] % len(ish)
        sizes = params["sizes"]
        if sum(sizes) != ish[axis]:
            raise ValueError(
                f"split sizes {sizes} do not sum to dim {axis} of "
                f"{ish}")
        outs = []
        for sz in sizes:
            o = list(ish)
            o[axis] = sz
            outs.append((tuple(o), in_dtypes[0]))
        return outs

    def emit(self, params, inputs, weights, ctx, name):
        return list(torch.split(inputs[0], list(params["sizes"]),
                                dim=params["axis"]))


@register
class SqueezeOp(OpDef):
    op_type = OperatorType.OP_SQUEEZE

    def infer(self, params, in_shapes, in_dtypes):
        ish = in_shapes[0]
        axes = [a % len(ish) for a in params["axes"]]
        out = tuple(s for i, s in enumerate(ish) if i not in axes)
        return [(out, in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        x = inputs[0]
        return [x.squeeze(tuple(a % x.dim() for a in params["axes"]))]


@register
class UnsqueezeOp(OpDef):
    op_type = OperatorType.OP_UNSQUEEZE

    def infer(self, params, in_shapes, in_dtypes):
        out = list(in_shapes[0])
        for a in sorted(params["axes"]):
            out.insert(a, 1)
        return [(tuple(out), in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        x = inputs[0]
        ndim = x.dim() + len(params["axes"])
        for a in sorted(a % ndim for a in params["axes"]):
            x = x.unsqueeze(a)
        return [x]


@register
class PadOp(OpDef):
    op_type = OperatorType.OP_PAD

    def infer(self, params, in_shapes, in_dtypes):
        pads = params["pads"]  # [(lo, hi)] * ndim
        out = tuple(s + lo + hi for s, (lo, hi) in zip(in_shapes[0], pads))
        return [(out, in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        flat = [p for lo_hi in reversed(params["pads"]) for p in lo_hi]
        return [F.pad(inputs[0], flat, value=params.get("value", 0.0))]


@register
class TopKOp(OpDef):
    """The k largest values along the last axis and their int32 indices,
    largest first, ties lower index first (``jax.lax.top_k``; ``sorted``
    changes nothing there either)."""
    op_type = OperatorType.OP_TOPK

    def infer(self, params, in_shapes, in_dtypes):
        k = params["k"]
        out = tuple(in_shapes[0][:-1]) + (k,)
        return [(out, in_dtypes[0]), (out, DataType.DT_INT32)]

    def emit(self, params, inputs, weights, ctx, name):
        k = params["k"]
        vals, idx = torch.sort(inputs[0], dim=-1, descending=True,
                               stable=True)
        return [vals[..., :k], idx[..., :k].to(torch.int32)]


@register
class GatherOp(OpDef):
    """torch.gather semantics (reference ``src/ops/gather.cc``)."""
    op_type = OperatorType.OP_GATHER

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[1], in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        x, index = inputs
        dim = params.get("dim", 0) % x.dim()
        index = index.long()
        index = torch.where(index < 0, index + x.shape[dim], index)
        return [torch.gather(x, dim, index)]


@register
class ShapeOp(OpDef):
    op_type = OperatorType.OP_SHAPE

    def infer(self, params, in_shapes, in_dtypes):
        return [((len(in_shapes[0]),), DataType.DT_INT32)]

    def emit(self, params, inputs, weights, ctx, name):
        x = inputs[0]
        return [torch.tensor(x.shape, dtype=torch.int32, device=x.device)]


@register
class SizeOp(OpDef):
    op_type = OperatorType.OP_SIZE

    def infer(self, params, in_shapes, in_dtypes):
        return [((), DataType.DT_INT32)]

    def emit(self, params, inputs, weights, ctx, name):
        x = inputs[0]
        return [torch.tensor(x.numel(), dtype=torch.int32, device=x.device)]


def _lanczos(radius):
    def fill(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        safe = torch.where(x != 0, math.pi ** 2 * x ** 2,
                           torch.ones_like(x))
        out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return fill


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., torch.zeros_like(x), out)


# jax.image.resize's method names and kernels
_RESIZE_KERNELS = {
    **dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"),
                    lambda x: torch.clamp(1 - x.abs(), min=0)),
    **dict.fromkeys(("cubic", "bicubic", "tricubic"), _keys_cubic),
    "lanczos3": _lanczos(3.0),
    "lanczos5": _lanczos(5.0),
}


def _resize_weights(m: int, n: int, kernel, device) -> torch.Tensor:
    """The (m, n) weights taking m input samples to n output samples:
    ``compute_weight_mat`` of ``jax.image.scale_and_translate`` at scale
    n / m, no translation, antialiased (the kernel widened by m / n when
    it shrinks), in f32."""
    inv_scale = m / n
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000. * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@register
class ResizeOp(OpDef):
    """Nearest/linear image resize (ONNX Resize) over every dim whose size
    changes, as ``jax.image.resize``."""
    op_type = OperatorType.OP_RESIZE

    def infer(self, params, in_shapes, in_dtypes):
        return [(tuple(params["size"]), in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        x = inputs[0]
        size = tuple(params["size"])
        if len(size) != x.dim():
            raise ValueError(f"resize size {size} does not match the rank "
                             f"of {tuple(x.shape)}")
        method = params.get("method", "nearest")
        if method != "nearest" and method not in _RESIZE_KERNELS:
            raise ValueError(f'Unknown resize method "{method}"')
        if method != "nearest" and not x.is_floating_point():
            x = x.float()
        for d, (m, n) in enumerate(zip(x.shape, size)):
            if m == n:
                continue
            if method == "nearest":
                idx = torch.floor(
                    (torch.arange(n, dtype=torch.float32, device=x.device)
                     + 0.5) * m / n).long()
                x = x.index_select(d, idx)
                continue
            w = _resize_weights(m, n, _RESIZE_KERNELS[method],
                                x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])),
                              -1, d)
        return [x]
