"""Recurrent ops: the multi-layer LSTM.

The port of ``flexflow_tpu/ops/rnn_ops.py``. The JAX package runs the
recurrence as one ``lax.scan`` with the input projection of every step
hoisted into one product before it; here the same hoisted product is
followed by a plain loop over the steps, each a (b, h) x (h, 4h) product
and the gate arithmetic, and autograd takes the place of ``jax.grad``
through the scan. ``torch.nn.LSTM`` (cuDNN's) is not used: its gate
layout, its two biases and its lack of the +1 forget bias make it
another function. The loop launches a dozen small kernels per step, so
it is bound by the host's launch rate, not the card.
"""
from __future__ import annotations

import torch

from ..core.tensor import WeightSpec
from ..ffconst import InitializerType, OperatorType
from .registry import OpDef, compute_dtype, mm_f32, register


@register
class LSTMOp(OpDef):
    """Multi-layer unidirectional LSTM.

    input (b, s, d) -> output (b, s, h); zero initial state. Weights per
    layer l: ``w{l}`` ((in_l + h), 4h) with gate order [i, f, g, o] and
    ``b{l}`` (4h,); the forget gate gets +1 in the step, so the
    zero-initialised bias starts it open. h and c are carried in f32 and
    h is cast to the compute dtype before each recurrent product."""
    op_type = OperatorType.OP_LSTM

    def infer(self, params, in_shapes, in_dtypes):
        b, s, _ = in_shapes[0]
        return [((b, s, params["hidden_size"]), in_dtypes[0])]

    def weights(self, params, in_shapes, in_dtypes):
        h = params["hidden_size"]
        d = in_shapes[0][2]
        dt = in_dtypes[0]
        out = []
        for l in range(params.get("num_layers", 1)):
            in_l = d if l == 0 else h
            out.append(WeightSpec(f"w{l}", (in_l + h, 4 * h), dt,
                                  InitializerType.GLOROT_UNIFORM))
            out.append(WeightSpec(f"b{l}", (4 * h,), dt,
                                  InitializerType.ZERO))
        return out

    def emit(self, params, inputs, weights, ctx, name):
        (x,) = inputs
        h = params["hidden_size"]
        b, s = x.shape[0], x.shape[1]
        mdt = compute_dtype(ctx, x.dtype)
        y = x
        for l in range(params.get("num_layers", 1)):
            w = weights[f"w{l}"]
            d_in = y.shape[-1]
            w_ih, w_hh = w[:d_in].to(mdt), w[d_in:].to(mdt)
            # the input projection of all s steps in one product
            zx = mm_f32(y.to(mdt), w_ih) + weights[f"b{l}"].float()
            h_t = torch.zeros((b, h), dtype=torch.float32, device=x.device)
            c_t = torch.zeros_like(h_t)
            hs = []
            for t in range(s):
                z = zx[:, t] + mm_f32(h_t.to(mdt), w_hh)
                i, f, g, o = z.chunk(4, dim=-1)
                c_t = torch.sigmoid(f + 1.0) * c_t \
                    + torch.sigmoid(i) * torch.tanh(g)
                h_t = torch.sigmoid(o) * torch.tanh(c_t)
                hs.append(h_t)
            y = torch.stack(hs, dim=1).to(x.dtype)     # (b, s, h)
        return [y]

    def flops(self, params, in_shapes, out_shapes):
        b, s, d = in_shapes[0]
        h = params["hidden_size"]
        total = 0.0
        for l in range(params.get("num_layers", 1)):
            in_l = d if l == 0 else h
            total += 2.0 * b * s * (in_l + h) * 4 * h
        return total

    def backward_flops_factor(self):
        return 2.0
