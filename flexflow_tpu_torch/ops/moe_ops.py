"""Mixture-of-Experts operator family: GroupBy dispatch, Aggregate and
AggregateSpec combine, Cache.

The port of ``flexflow_tpu/ops/moe_ops.py`` (reference
``src/ops/{group_by,aggregate,aggregate_spec,cache}.cc``): GShard-style
dense dispatch and combine products over a static capacity, so shapes
stay static. Routing is TopK's (``tensor_ops.TopKOp``). The dispatch and
combine products take bf16 operands with f32 sums where the config
allows (``mm_f32``), as the JAX package's einsums do; they are plain
matrix products, outside any kernel there too.

Shapes (numpy order):
  group_by:  input (B, D), assign (B, K) int  ->  n tensors (C, D),
             C = ceil(alpha * K * B / n)
  aggregate: [gate_preds (B,K), gate_assign (B,K), true_assign (B,K),
              full_gate_preds (B,n), exp_pred_0 (C,Do), ... exp_pred_{n-1}]
             -> (B, Do)
"""
from __future__ import annotations

import math

import torch

from ..ffconst import OperatorType
from .registry import OpDef, compute_dtype, mm_f32, register


def _capacity(params, batch: int, k: int) -> int:
    n = params["n"]
    alpha = params.get("alpha", 1.0)
    return int(math.ceil(alpha * k * batch / n))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot of ``idx`` over ``n`` classes, all zeros for an index
    outside [0, n) (``jax.nn.one_hot``; ``F.one_hot`` raises there and
    reads the indices back to the host to check)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def _dispatch_mask(assign: torch.Tensor, n: int,
                   capacity: int) -> torch.Tensor:
    """(B, K) int assignments -> (T=B*K, n, C) f32 one-hot dispatch tensor.

    The slot of each (token, choice) in its expert's buffer is its running
    count in flattened token order; those beyond the capacity are dropped
    (the reference kernels' first-come policy)."""
    onehot = _one_hot(assign.reshape(-1).long(), n)        # (T, n)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1         # slot per token
    in_cap = (pos < capacity) & (pos >= 0)
    poscap = torch.where(in_cap, pos, torch.zeros_like(pos))
    poshot = _one_hot(poscap.sum(-1), capacity).float()    # (T, C)
    mask = onehot.float() * in_cap.float()
    return mask[:, :, None] * poshot[:, None, :]


def dropped_slots(assign: torch.Tensor, n: int, capacity: int) -> int:
    """How many (token, choice) slots of ``assign`` the capacity drops."""
    return int(assign.numel() - _dispatch_mask(assign, n, capacity).sum())


@register
class GroupByOp(OpDef):
    op_type = OperatorType.OP_GROUP_BY

    def infer(self, params, in_shapes, in_dtypes):
        (b, d), (b2, k) = in_shapes[0], in_shapes[1]
        if b != b2:
            raise ValueError(
                f"group_by input/assign batch dims differ: {in_shapes}")
        c = _capacity(params, b, k)
        return [((c, d), in_dtypes[0])] * params["n"]

    def emit(self, params, inputs, weights, ctx, name):
        x, assign = inputs
        b, k = assign.shape
        n = params["n"]
        c = _capacity(params, b, k)
        disp = _dispatch_mask(assign, n, c)                # (T, n, C)
        xr = x.repeat_interleave(k, dim=0)                 # (T, D)
        mdt = compute_dtype(ctx, x.dtype)
        # "tec,td->ecd" as one (n*C, T) x (T, D) product
        buf = mm_f32(disp.reshape(b * k, n * c).t().to(mdt), xr.to(mdt))
        buf = buf.to(x.dtype).reshape(n, c, -1)
        return [buf[e] for e in range(n)]


@register
class AggregateOp(OpDef):
    """Combine expert outputs weighted by gate probabilities; adds the
    lambda_bal load-balancing auxiliary loss (the reference injects an
    equivalent term directly into gate gradients in ``aggregate.cu``)."""
    op_type = OperatorType.OP_AGGREGATE

    def infer(self, params, in_shapes, in_dtypes):
        b = in_shapes[0][0]
        out_dim = in_shapes[4][-1]
        return [((b, out_dim), in_dtypes[4])]

    def emit(self, params, inputs, weights, ctx, name):
        gate_preds, gate_assign = inputs[0], inputs[1]
        full_gate_preds = inputs[3]
        exp_preds = inputs[4:]
        n = params["n"]
        b, k = gate_assign.shape
        c = exp_preds[0].shape[0]
        disp = _dispatch_mask(gate_assign, n, c)           # (T, n, C)
        combine = disp * gate_preds.reshape(-1)[:, None, None]
        stacked = torch.stack(list(exp_preds), dim=0)      # (n, C, Do)
        mdt = compute_dtype(ctx, exp_preds[0].dtype)
        # "tec,ecd->td" as one (T, n*C) x (n*C, Do) product
        out = mm_f32(combine.reshape(b * k, n * c).to(mdt),
                     stacked.reshape(n * c, -1).to(mdt))
        out = out.reshape(b, k, -1).sum(dim=1).to(exp_preds[0].dtype)
        # GShard-style load-balance aux loss:
        # n * sum_e(frac_tokens_e * mean_gate_e)
        lam = params.get("lambda_bal", 0.0)
        if lam > 0.0 and full_gate_preds is not None:
            frac = _one_hot(gate_assign[:, 0].long(), n).float().mean(0)
            mean_gate = torch.softmax(full_gate_preds, dim=-1).mean(0)
            ctx.aux_losses.append(lam * n * torch.sum(frac * mean_gate))
        return [out]


@register
class AggregateSpecOp(AggregateOp):
    """Aggregate variant that ignores gate weighting for the expert pass-
    through (reference ``aggregate_spec.cc``, used with Cache for MoE
    speculation). Same output shape as Aggregate."""
    op_type = OperatorType.OP_AGG_SPEC

    def emit(self, params, inputs, weights, ctx, name):
        inputs = list(inputs)
        inputs[0] = torch.ones_like(inputs[0]) / inputs[0].shape[-1]
        return super().emit(params, inputs, weights, ctx, name)


@register
class CacheOp(OpDef):
    """Rolling tensor cache (reference ``src/ops/cache.cc``): stores the
    input in the state collection; with ``use_cached`` an inference
    forward serves the value stored by the step before. The stored value
    is detached: state carries no gradient, as in the JAX package, where
    it leaves the train step as a value."""
    op_type = OperatorType.OP_CACHE

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def state_spec(self, params, in_shapes, in_dtypes):
        return {"cached": (in_shapes[0], in_dtypes[0])}

    def emit(self, params, inputs, weights, ctx, name):
        (x,) = inputs
        st = ctx.state.get(name)
        if st is not None:
            ctx.new_state[name] = {"cached": x.detach()}
            if params.get("use_cached", False) and not ctx.training:
                return [st["cached"]]
        return [x]
