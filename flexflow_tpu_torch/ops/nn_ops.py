"""Neural-net operators of the serving slice: Linear, Softmax, Dropout,
LayerNorm, Embedding and MultiHeadAttention.

The port of the same classes in ``flexflow_tpu/ops/nn_ops.py``: the same
params, weight specs (names, shapes, initializers) and math, on torch
tensors. Sequences are (batch, seq, hidden). Conv, pooling, norms other
than LayerNorm, RoPE, sliding-window attention, ring attention and the
KV-cache paths come with later slices and raise here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ffconst import ActiMode, AggrMode, DataType, InitializerType, \
    OperatorType
from ..core.tensor import WeightSpec
from ..dtypes import to_torch
from .registry import (OpDef, compute_dtype, generator_on, host_seed,
                       matmul, mm_f32, register)


def apply_activation(x, acti: ActiMode):
    acti = ActiMode(acti)
    if acti == ActiMode.AC_MODE_NONE:
        return x
    if acti == ActiMode.AC_MODE_RELU:
        return torch.relu(x)
    if acti == ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(x)
    if acti == ActiMode.AC_MODE_TANH:
        return torch.tanh(x)
    if acti == ActiMode.AC_MODE_GELU:
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(acti)


# ---------------------------------------------------------------------------
@register
class LinearOp(OpDef):
    """y = act(x @ kernel + bias); kernel (in_dim, out_dim)."""
    op_type = OperatorType.OP_LINEAR

    def infer(self, params, in_shapes, in_dtypes):
        (ish,) = in_shapes
        out_dtype = params.get("dtype", in_dtypes[0])
        return [(tuple(ish[:-1]) + (params["out_dim"],), out_dtype)]

    def weights(self, params, in_shapes, in_dtypes):
        in_dim = in_shapes[0][-1]
        out_dim = params["out_dim"]
        dt = params.get("dtype", in_dtypes[0])
        ws = [WeightSpec("kernel", (in_dim, out_dim), dt,
                         params.get("kernel_initializer",
                                    InitializerType.GLOROT_UNIFORM))]
        if params.get("use_bias", True):
            ws.append(WeightSpec("bias", (out_dim,), dt, InitializerType.ZERO))
        return ws

    def emit(self, params, inputs, weights, ctx, name):
        (x,) = inputs
        y = matmul(x, weights["kernel"], ctx=ctx)
        if "bias" in weights:
            y = y + weights["bias"]
        y = apply_activation(y, params.get("activation",
                                           ActiMode.AC_MODE_NONE))
        if "dtype" in params:
            y = y.to(to_torch(params["dtype"]))
        return [y]


# ---------------------------------------------------------------------------
@register
class SoftmaxOp(OpDef):
    op_type = OperatorType.OP_SOFTMAX

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        (x,) = inputs
        return [torch.softmax(x, dim=params.get("axis", -1))]


# ---------------------------------------------------------------------------
@register
class DropoutOp(OpDef):
    """Identity outside training; in training a Bernoulli keep mask drawn
    on the tensor's device from the layer's rng (its bits differ from
    JAX's)."""
    op_type = OperatorType.OP_DROPOUT

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        (x,) = inputs
        rate = params.get("rate", 0.5)
        if not ctx.training or rate <= 0.0:
            return [x]
        rng = ctx.rng_for(name)
        if rng is None:
            raise RuntimeError(f"dropout layer {name} needs an rng")
        gen = generator_on(rng, x.device)
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return [torch.where(mask, x / keep, torch.zeros_like(x))]


# ---------------------------------------------------------------------------
@register
class LayerNormOp(OpDef):
    """Layer norm in f32: population variance, ``eps`` 1e-5 by default."""
    op_type = OperatorType.OP_LAYERNORM

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def weights(self, params, in_shapes, in_dtypes):
        if not params.get("elementwise_affine", True):
            return []
        axes = params.get("axes", [len(in_shapes[0]) - 1])
        shape = tuple(in_shapes[0][a] for a in axes)
        dt = in_dtypes[0]
        return [WeightSpec("scale", shape, dt, InitializerType.ONE),
                WeightSpec("bias", shape, dt, InitializerType.ZERO)]

    def emit(self, params, inputs, weights, ctx, name):
        (x,) = inputs
        ndim = x.dim()
        axes = tuple(a % ndim for a in params.get("axes", [ndim - 1]))
        eps = params.get("eps", 1e-5)
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = xf.var(dim=axes, correction=0, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if "scale" in weights:
            bshape = [x.shape[a] if a in axes else 1 for a in range(ndim)]
            y = y * weights["scale"].float().reshape(bshape) \
                + weights["bias"].float().reshape(bshape)
        return [y.to(x.dtype)]


# ---------------------------------------------------------------------------
@register
class EmbeddingOp(OpDef):
    """Embedding lookup with none/sum/avg aggregation."""
    op_type = OperatorType.OP_EMBEDDING

    def infer(self, params, in_shapes, in_dtypes):
        ish = in_shapes[0]
        out_dim = params["out_dim"]
        dt = params.get("dtype", DataType.DT_FLOAT)
        aggr = AggrMode(params.get("aggr", AggrMode.AGGR_MODE_NONE))
        if aggr == AggrMode.AGGR_MODE_NONE:
            return [(tuple(ish) + (out_dim,), dt)]
        return [(tuple(ish[:-1]) + (out_dim,), dt)]

    def weights(self, params, in_shapes, in_dtypes):
        dt = params.get("dtype", DataType.DT_FLOAT)
        return [WeightSpec("kernel", (params["num_entries"], params["out_dim"]),
                           dt, params.get("kernel_initializer",
                                          InitializerType.GLOROT_UNIFORM))]

    def emit(self, params, inputs, weights, ctx, name):
        (ids,) = inputs
        out = F.embedding(ids.long(), weights["kernel"])
        aggr = AggrMode(params.get("aggr", AggrMode.AGGR_MODE_NONE))
        if aggr == AggrMode.AGGR_MODE_SUM:
            out = out.sum(dim=-2)
        elif aggr == AggrMode.AGGR_MODE_AVG:
            out = out.mean(dim=-2)
        return [out]


# ---------------------------------------------------------------------------
@register
class MultiHeadAttentionOp(OpDef):
    """Multi-head attention. Inputs: query (B, Lq, E), key (B, Lk, Ek),
    value (B, Lv, Ev); output (B, Lq, E) after the output projection.

    Two impls, chosen per layer by the kernel tier: ``xla`` (the plain
    path: einsum attention with an f32 softmax; the name is the JAX
    package's) and ``flash`` (``kernels/flash_attention.py``, whose
    autograd Function runs the backward kernels in training). In training,
    the attention dropout runs inside the flash kernel, seeded from the
    host, or as a Bernoulli mask on the plain path."""
    op_type = OperatorType.OP_MULTIHEAD_ATTENTION

    def infer(self, params, in_shapes, in_dtypes):
        q = in_shapes[0]
        return [((q[0], q[1], params["embed_dim"]), in_dtypes[0])]

    def weights(self, params, in_shapes, in_dtypes):
        e = params["embed_dim"]
        h = params["num_heads"]
        kvh = params.get("num_kv_heads", 0) or h
        kdim = params.get("kdim", 0) or e
        vdim = params.get("vdim", 0) or e
        dt = in_dtypes[0]
        qe, ke, ve = in_shapes[0][-1], in_shapes[1][-1], in_shapes[2][-1]
        ws = [WeightSpec("wq", (qe, h, kdim // h), dt),
              WeightSpec("wk", (ke, kvh, kdim // h), dt),
              WeightSpec("wv", (ve, kvh, vdim // h), dt),
              WeightSpec("wo", (h, vdim // h, e), dt)]
        if params.get("bias", True):
            ws += [WeightSpec("bq", (h, kdim // h), dt, InitializerType.ZERO),
                   WeightSpec("bk", (kvh, kdim // h), dt,
                              InitializerType.ZERO),
                   WeightSpec("bv", (kvh, vdim // h), dt,
                              InitializerType.ZERO),
                   WeightSpec("bo", (e,), dt, InitializerType.ZERO)]
        return ws

    @staticmethod
    def _flash_mode(ctx) -> str:
        """Resolved flash-attention mode: "true" | "false" | "auto"."""
        return getattr(getattr(ctx, "config", None), "use_flash_attention",
                       "auto")

    @staticmethod
    def _impl_for(ctx, name: str):
        """This op's impl from the adopted plan: the layer-name key wins
        over the "attention" kind key; None = no plan."""
        plan = getattr(ctx, "kernel_impls", None)
        if not plan:
            return None
        return plan.get(name, plan.get("attention"))

    # The sequence length from which "auto" takes the flash kernel. The
    # JAX package's value, kept until an H100 measurement of the
    # crossover replaces it.
    FLASH_AUTO_MIN_SEQ = 1024

    @classmethod
    def _flash_enabled(cls, ctx, seq_len: int = 0, mode: str = None,
                       device_type: str = "") -> bool:
        mode = mode or cls._flash_mode(ctx)
        if mode == "false":
            return False
        if mode == "true":
            return True
        # "auto" keys on the card, where the JAX package keys on the TPU
        return device_type == "cuda" and seq_len >= cls.FLASH_AUTO_MIN_SEQ

    @staticmethod
    def _expand_kv(x, h):
        """GQA: repeat kv-head groups up to ``h`` query heads
        ((B, L, kvh, d) -> (B, L, h, d)); identity when kvh == h."""
        kvh = x.shape[2]
        if kvh == h:
            return x
        return torch.repeat_interleave(x, h // kvh, dim=2)

    def emit(self, params, inputs, weights, ctx, name):
        q, k, v = inputs
        cdt = q.dtype
        mdt = compute_dtype(ctx, cdt)
        for key in ("rope", "sliding_window"):
            if params.get(key):
                raise NotImplementedError(
                    f"{name}: MultiHeadAttention {key} is not ported yet")
        if ctx.kv_mode is not None:
            raise NotImplementedError(
                f"{name}: KV-cache {ctx.kv_mode} is not ported yet")

        def proj(x, w, b):
            bsz, length, e = x.shape
            y = mm_f32(x.to(mdt), w.to(mdt).reshape(e, -1))
            y = y.reshape(bsz, length, w.shape[1], w.shape[2])
            if b is not None:
                y = y + b.float()
            return y

        qh = proj(q, weights["wq"], weights.get("bq"))
        kh = proj(k, weights["wk"], weights.get("bk"))
        vh = proj(v, weights["wv"], weights.get("bv"))
        rate = params.get("dropout", 0.0) if ctx.training else 0.0
        causal = params.get("causal", False)
        kh = self._expand_kv(kh, qh.shape[2])
        vh = self._expand_kv(vh, qh.shape[2])
        bsz, lq, h, d = qh.shape
        lk = kh.shape[1]
        impl = self._impl_for(ctx, name)
        if impl == "ring":
            raise NotImplementedError(
                f"{name}: kernel impl 'ring' is not ported yet")
        # a planned impl overrides the legacy tri-state
        flash_mode = {"flash": "true", "xla": "false"}.get(
            impl, self._flash_mode(ctx))
        if self._flash_enabled(ctx, seq_len=max(lq, lk), mode=flash_mode,
                               device_type=q.device.type) \
                and not (causal and lq != lk) \
                and not (rate > 0.0 and flash_mode != "true"):
            # in "auto" mode the dropout case stays on the plain path
            from ..kernels.flash_attention import flash_attention
            # the kernel's seed is drawn on the host: no device sync
            seed = host_seed(ctx.rng_for(name)) if rate > 0.0 else None
            o = flash_attention(
                qh.transpose(1, 2).to(mdt).contiguous(),
                kh.transpose(1, 2).to(mdt).contiguous(),
                vh.transpose(1, 2).to(mdt).contiguous(),
                causal=causal, dropout_rate=rate, dropout_seed=seed)
            ctxv = o.transpose(1, 2).float()
        else:
            scale = 1.0 / math.sqrt(d)
            qb = qh.to(mdt).permute(0, 2, 1, 3).reshape(bsz * h, lq, d)
            kb = kh.to(mdt).permute(0, 2, 3, 1).reshape(bsz * h, d, lk)
            logits = mm_f32(qb, kb).reshape(bsz, h, lq, lk) * scale
            if causal:
                qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
                kpos = torch.arange(lk, device=q.device)[None, :]
                logits = torch.where(kpos <= qpos, logits,
                                     torch.full_like(logits, -1e9))
            probs = torch.softmax(logits, dim=-1)
            if rate > 0.0:
                keep = 1.0 - rate
                gen = generator_on(ctx.rng_for(name), probs.device)
                mask = torch.rand(probs.shape, generator=gen,
                                  device=probs.device) < keep
                probs = torch.where(mask, probs / keep,
                                    torch.zeros_like(probs))
            vb = vh.to(mdt).permute(0, 2, 1, 3).reshape(bsz * h, lk, d)
            ctxv = mm_f32(probs.to(mdt).reshape(bsz * h, lq, lk), vb)
            ctxv = ctxv.reshape(bsz, h, lq, d).transpose(1, 2)
        wo = weights["wo"]
        out = mm_f32(ctxv.to(mdt).reshape(bsz, lq, h * d),
                     wo.to(mdt).reshape(h * d, wo.shape[2]))
        if "bo" in weights:
            out = out + weights["bo"].float()
        return [out.to(cdt)]
