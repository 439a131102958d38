"""Neural-net operators: Linear, Conv2D, Pool2D, Flat, Softmax, Dropout,
BatchNorm, LayerNorm, RMSNorm, Embedding, BatchMatmul/Matmul and
MultiHeadAttention (with its sliding window, its in-op rotary embeddings
and its KV-cache prefill and decode paths).

The port of the same classes in ``flexflow_tpu/ops/nn_ops.py``: the same
params, weight specs (names, shapes, initializers) and math, on torch
tensors. Images are NCHW, sequences (batch, seq, hidden). Ring attention
comes with a later slice and raises here.
"""
from __future__ import annotations

import math

import numpy as np

import torch
import torch.nn.functional as F

from ..ffconst import ActiMode, AggrMode, DataType, InitializerType, \
    OperatorType, PoolType
from ..core.tensor import WeightSpec
from ..dtypes import to_torch
from .registry import (OpDef, bf16_enabled, compute_dtype, generator_on,
                       host_seed, matmul, mm_f32, register)


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

    def flops(self, params, in_shapes, out_shapes):
        batch = int(np.prod(in_shapes[0][:-1]))
        return 2.0 * batch * in_shapes[0][-1] * params["out_dim"]

    def backward_flops_factor(self):
        return 2.0


# ---------------------------------------------------------------------------
def _out_hw(params, h, w):
    """The (oh, ow) of a conv or pool window over an (h, w) image."""
    oh = (h + 2 * params["padding_h"] - params["kernel_h"]) \
        // params["stride_h"] + 1
    ow = (w + 2 * params["padding_w"] - params["kernel_w"]) \
        // params["stride_w"] + 1
    return oh, ow


@register
class Conv2DOp(OpDef):
    """2-D convolution, NCHW input, OIHW kernel, ``groups``, bias and a
    trailing activation. As in the JAX package, f32 operands are cast to
    bf16 (when bf16 compute is on) and the convolution returns bf16,
    which is then cast to the input dtype before the f32 bias: the
    result is rounded to bf16 once, where an f32-output convolution would
    not round it. The convolution itself is ``F.conv2d`` (cuDNN on the
    card): the JAX package leaves it to XLA too."""
    op_type = OperatorType.OP_CONV2D

    def infer(self, params, in_shapes, in_dtypes):
        n, _, h, w = in_shapes[0]
        oh, ow = _out_hw(params, h, w)
        return [((n, params["out_channels"], oh, ow), in_dtypes[0])]

    def weights(self, params, in_shapes, in_dtypes):
        c = in_shapes[0][1]
        groups = params.get("groups", 1)
        dt = in_dtypes[0]
        ws = [WeightSpec("kernel",
                         (params["out_channels"], c // groups,
                          params["kernel_h"], params["kernel_w"]), dt,
                         params.get("kernel_initializer",
                                    InitializerType.GLOROT_UNIFORM))]
        if params.get("use_bias", True):
            ws.append(WeightSpec("bias", (params["out_channels"],), dt,
                                 InitializerType.ZERO))
        return ws

    def emit(self, params, inputs, weights, ctx, name):
        (x,) = inputs
        k = weights["kernel"]
        cdt = x.dtype
        if cdt == torch.float32 and bf16_enabled(ctx):
            x16, k16 = x.to(torch.bfloat16), k.to(torch.bfloat16)
        else:
            x16, k16 = x, k.to(cdt)
        y = F.conv2d(x16, k16, stride=(params["stride_h"],
                                       params["stride_w"]),
                     padding=(params["padding_h"], params["padding_w"]),
                     groups=params.get("groups", 1))
        y = y.to(cdt)
        if "bias" in weights:
            y = y + weights["bias"][None, :, None, None]
        return [apply_activation(y, params.get("activation",
                                               ActiMode.AC_MODE_NONE))]

    def flops(self, params, in_shapes, out_shapes):
        n, co, oh, ow = out_shapes[0]
        ci = in_shapes[0][1] // params.get("groups", 1)
        return 2.0 * n * co * oh * ow * ci * params["kernel_h"] \
            * params["kernel_w"]

    def backward_flops_factor(self):
        return 2.0


# ---------------------------------------------------------------------------
@register
class Pool2DOp(OpDef):
    """Max or average pooling, NCHW. Max pooling starts from -inf, so
    padding never wins; average pooling divides by the
    whole window, padding included (``count_include_pad``, cuDNN's
    default, which the reference uses)."""
    op_type = OperatorType.OP_POOL2D

    def infer(self, params, in_shapes, in_dtypes):
        n, c, h, w = in_shapes[0]
        oh, ow = _out_hw(params, h, w)
        return [((n, c, oh, ow), in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        (x,) = inputs
        kernel = (params["kernel_h"], params["kernel_w"])
        stride = (params["stride_h"], params["stride_w"])
        ph, pw = params["padding_h"], params["padding_w"]
        is_max = PoolType(params.get("pool_type", PoolType.POOL_MAX)) \
            == PoolType.POOL_MAX
        if ph > kernel[0] // 2 or pw > kernel[1] // 2:
            # torch's pools refuse padding above half the window, which
            # the JAX package's reduce_window takes: pad explicitly with
            # what the window starts from
            x = F.pad(x, (pw, pw, ph, ph),
                      value=float("-inf") if is_max else 0.0)
            ph = pw = 0
        if is_max:
            y = F.max_pool2d(x, kernel, stride, (ph, pw))
        else:
            y = F.avg_pool2d(x, kernel, stride, (ph, pw),
                             count_include_pad=True)
        return [apply_activation(y, params.get("activation",
                                               ActiMode.AC_MODE_NONE))]


# ---------------------------------------------------------------------------
@register
class FlatOp(OpDef):
    """NCHW -> (N, C*H*W)."""
    op_type = OperatorType.OP_FLAT

    def infer(self, params, in_shapes, in_dtypes):
        s = in_shapes[0]
        return [((s[0], math.prod(s[1:])), in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        (x,) = inputs
        return [x.reshape(x.shape[0], -1)]


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
class BatchNormOp(OpDef):
    """Batch norm over NCHW (or (N, C)) input with running statistics in
    the op state (``mean``, ``var``). In training, or without state, the
    batch's mean and variance normalise; with state they also update the
    running statistics (``ctx.new_state``, detached). Outside training
    the running statistics normalise. As in the JAX package, the
    variance is the biased one (divided by N) for both: torch's
    ``F.batch_norm`` would update its running buffer with the unbiased
    one, so it is not used. Computed in f32, cast back to the input's
    dtype, then ReLU unless ``relu=False``."""
    op_type = OperatorType.OP_BATCHNORM

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def weights(self, params, in_shapes, in_dtypes):
        c = in_shapes[0][1]
        dt = in_dtypes[0]
        return [WeightSpec("scale", (c,), dt, InitializerType.ONE),
                WeightSpec("bias", (c,), dt, InitializerType.ZERO)]

    def state_spec(self, params, in_shapes, in_dtypes):
        c = in_shapes[0][1]
        return {"mean": ((c,), DataType.DT_FLOAT),
                "var": ((c,), DataType.DT_FLOAT)}

    def emit(self, params, inputs, weights, ctx, name):
        (x,) = inputs
        eps = params.get("eps", 1e-5)
        momentum = params.get("momentum", 0.1)
        axes = (0, 2, 3) if x.dim() == 4 else (0,)
        bshape = (1, -1) + (1,) * (x.dim() - 2)
        st = ctx.state.get(name, {})
        xf = x.float()
        if ctx.training or not st:
            mean = xf.mean(dim=axes)
            var = xf.var(dim=axes, correction=0)
            if st:
                ctx.new_state[name] = {
                    "mean": (1 - momentum) * st["mean"]
                    + momentum * mean.detach(),
                    "var": (1 - momentum) * st["var"]
                    + momentum * var.detach()}
        else:
            mean, var = st["mean"], st["var"]
        inv = torch.rsqrt(var + eps) * weights["scale"].float()
        y = (xf - mean.reshape(bshape)) * inv.reshape(bshape) \
            + weights["bias"].float().reshape(bshape)
        y = y.to(x.dtype)
        if params.get("relu", True):
            y = torch.relu(y)
        return [y]


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
class RMSNormOp(OpDef):
    """RMSNorm over the last dim in f32: mean of squares, ``rsqrt``,
    scale, cast back (LLaMA's norm)."""
    op_type = OperatorType.OP_RMSNORM

    def infer(self, params, in_shapes, in_dtypes):
        return [(in_shapes[0], in_dtypes[0])]

    def weights(self, params, in_shapes, in_dtypes):
        return [WeightSpec("scale", (in_shapes[0][-1],), in_dtypes[0],
                           InitializerType.ONE)]

    def emit(self, params, inputs, weights, ctx, name):
        (x,) = inputs
        eps = params.get("eps", 1e-6)
        xf = x.float()
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * weights["scale"].float()
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
def _apply_rope(x, pos, theta: float):
    """Rotary position embedding, LLaMA's half-split-rotate convention.
    ``x``: (B, L, h, d) with d even; ``pos``: (L,) absolute positions
    shared by the batch, or (B, L) per row (ragged-prompt decode). The
    frequencies are taken in f32 in the JAX package's order."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    pf = pos.to(device=x.device, dtype=torch.float32)
    if pf.dim() == 1:
        pf = pf[None, :]                                 # (1, L)
    freqs = pf[:, :, None] * inv[None, None, :]          # (B|1, L, d/2)
    emb = torch.cat([freqs, freqs], dim=-1)              # (B|1, L, d)
    cos = torch.cos(emb)[:, :, None, :]
    sin = torch.sin(emb)[:, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rot = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


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

    @staticmethod
    def _out_proj(ctxv, weights, mdt, cdt):
        """(B, L, h, d) f32 attention context -> (B, L, E) output."""
        bsz, lq, h, d = ctxv.shape
        wo = weights["wo"]
        out = mm_f32(ctxv.to(mdt).reshape(bsz, lq, h * d),
                     wo.to(mdt).reshape(h * d, wo.shape[2]))
        if "bo" in weights:
            out = out + weights["bo"].float()
        return [out.to(cdt)]

    @staticmethod
    def _prefill_cache(params, ctx, kh, vh):
        """The decode cache seeded from a prefill's K/V (B, L, kvh, d),
        at the kv-head count. With a sliding window W < L and one shared
        prompt length, an O(W) ring buffer: position p lives at slot
        p % W, slot s holds the largest prompt position congruent to s
        (mod W), and slots no prompt position reached carry position
        -10**9 (masked). Otherwise the full K/V; padded positions hold
        garbage that the decode step rewrites before it unmasks them."""
        W = params.get("sliding_window", 0)
        plen = ctx.kv_prefill_len
        L = kh.shape[1]
        if not (W and plen is not None and W < L):
            return {"k": kh, "v": vh}
        s_idx = torch.arange(W, device=kh.device)
        pstar = plen - 1 - torch.remainder(plen - 1 - s_idx, W)
        gather = pstar.clamp(0, L - 1)
        pos = torch.where(pstar >= 0, pstar,
                          torch.full_like(pstar, -(10 ** 9)))
        return {"k": kh.index_select(1, gather),
                "v": vh.index_select(1, gather),
                "pos": pos[None, :].expand(kh.shape[0], W).contiguous()}

    def emit(self, params, inputs, weights, ctx, name):
        q, k, v = inputs
        cdt = q.dtype
        mdt = compute_dtype(ctx, cdt)

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
        window = params.get("sliding_window", 0)
        if params.get("rope", False):
            # rotary embeddings in the op: positions are absolute, so the
            # decode token rotates at kv_index and the cache stores keys
            # already rotated
            if not causal:
                raise ValueError(
                    "rope is only supported for causal attention")
            if qh.shape[1] != kh.shape[1]:
                raise ValueError(
                    "rope=True requires self-attention (Lq == Lk); "
                    "cross-attention has no single absolute position "
                    "stream")
            theta = float(params.get("rope_theta", 10000.0))
            if ctx.kv_mode == "decode":
                idx = ctx.kv_index
                # a scalar index -> (1,); per-row (ragged prompts) -> (B, 1)
                pos = idx[:, None] if torch.is_tensor(idx) and idx.dim() \
                    else torch.full((1,), int(idx), device=qh.device)
            else:
                pos = torch.arange(qh.shape[1], device=qh.device)
            qh = _apply_rope(qh, pos, theta)
            kh = _apply_rope(kh, pos, theta)
        if ctx.kv_mode == "prefill":
            ctx.new_kv[name] = self._prefill_cache(params, ctx, kh, vh)
        elif ctx.kv_mode == "decode":
            return self._emit_decode(params, weights, ctx, name, qh, kh, vh,
                                     mdt, cdt)
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
                and not (causal and lq != lk) and not window \
                and not (rate > 0.0 and flash_mode != "true"):
            # in "auto" mode the dropout case stays on the plain path; the
            # kernel has no sliding-window mask
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
                mask = kpos <= qpos
                if window:
                    # Mistral-family sliding window: each query attends
                    # the last `window` positions only
                    mask = mask & (kpos > qpos - window)
                logits = torch.where(mask, logits,
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
        return self._out_proj(ctxv, weights, mdt, cdt)

    def _emit_decode(self, params, weights, ctx, name, qh, kh, vh, mdt,
                     cdt):
        """One-token decode against the KV cache: write this position's
        K/V into the layer's cache buffers (in place), then attend the
        length-1 query over the positions <= kv_index. The same mask and
        softmax domain as the full re-forward's row at kv_index, the
        numerics oracle of the generation tests."""
        if not params.get("causal", False):
            raise ValueError(
                "KV-cache decode requires causal self-attention")
        cache = ctx.kv_cache[name]
        idx = ctx.kv_index
        ragged = torch.is_tensor(idx) and idx.dim() == 1   # (B,) positions
        ring = "pos" in cache
        if ring and ragged:
            raise ValueError(
                "ragged prompts use the full cache (generate passes "
                "prefill_len=None for vector prompt lengths)")
        k_full, v_full = cache["k"], cache["v"]
        b_, lq_, hq, d_ = qh.shape
        if ragged:
            # each row writes at its own position
            rows = torch.arange(b_, device=qh.device)
            k_full[rows, idx] = kh[:, 0].to(k_full.dtype)
            v_full[rows, idx] = vh[:, 0].to(v_full.dtype)
        else:
            idx = int(idx)
            # sliding-window ring buffer: slot idx % W, with the stored
            # position tracked for the validity mask
            slot = idx % k_full.shape[1] if ring else idx
            k_full[:, slot] = kh[:, 0].to(k_full.dtype)
            v_full[:, slot] = vh[:, 0].to(v_full.dtype)
            if ring:
                cache["pos"][:, slot] = idx
        ctx.new_kv[name] = cache
        # GQA: contract the length-1 query against the cache AT kvh
        # heads, g = h / kvh query heads per group, with no expanded copy
        # of the cache; g == 1 is plain MHA
        m = k_full.shape[1]
        kvh = k_full.shape[2]
        g = hq // kvh
        qg = qh.to(mdt).reshape(b_, kvh, g, d_).reshape(b_ * kvh, g, d_)
        kt = k_full.to(mdt).permute(0, 2, 3, 1).reshape(b_ * kvh, d_, m)
        logits = mm_f32(qg, kt).reshape(b_, kvh, g, m) \
            * (1.0 / math.sqrt(d_))
        window = params.get("sliding_window", 0)
        if ring:
            # the slots' positions carry the mask (invalid slots hold
            # -10**9)
            p = cache["pos"][:, None, None, :]
            mask = (p <= idx) & (p > idx - window)
        else:
            kpos = torch.arange(m, device=qh.device)[None, None, None, :]
            iq = idx[:, None, None, None] if ragged else idx
            mask = kpos <= iq
            if window:
                mask = mask & (kpos > iq - window)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
        probs = torch.softmax(logits, dim=-1)
        vb = v_full.to(mdt).permute(0, 2, 1, 3).reshape(b_ * kvh, m, d_)
        ctxv = mm_f32(probs.to(mdt).reshape(b_ * kvh, g, m), vb)
        return self._out_proj(ctxv.reshape(b_, lq_, hq, d_), weights, mdt,
                              cdt)

    def flops(self, params, in_shapes, out_shapes):
        b, lq, _ = in_shapes[0]
        lk = in_shapes[1][1]
        e = params["embed_dim"]
        h = params["num_heads"]
        kv_frac = (params.get("num_kv_heads", 0) or h) / h
        proj = (2.0 * b * lq * e * e                      # q proj
                + 2.0 * b * 2 * lk * e * e * kv_frac     # k+v (GQA)
                + 2.0 * b * lq * e * e)                  # out proj
        attn = 2.0 * b * lq * lk * e * 2
        return proj + attn

    def backward_flops_factor(self):
        return 2.0


# ---------------------------------------------------------------------------
@register
class BatchMatmulOp(OpDef):
    """Batched matmul over equal leading dims (bf16 operands, f32
    accumulation, through ``matmul``)."""
    op_type = OperatorType.OP_BATCHMATMUL

    def infer(self, params, in_shapes, in_dtypes):
        a, b = in_shapes
        if a[:-2] != b[:-2]:
            raise ValueError(
                f"batch_matmul batch dims differ: {a} vs {b}")
        if a[-1] != b[-2]:
            raise ValueError(
                f"batch_matmul contraction dims differ: {a} vs {b}")
        return [(tuple(a[:-1]) + (b[-1],), in_dtypes[0])]

    def emit(self, params, inputs, weights, ctx, name):
        a, b = inputs
        return [matmul(a, b, ctx=ctx)]

    def flops(self, params, in_shapes, out_shapes):
        a, b = in_shapes
        return 2.0 * float(np.prod(a)) * b[-1]

    def backward_flops_factor(self):
        return 2.0


@register
class MatmulOp(BatchMatmulOp):
    op_type = OperatorType.OP_MATMUL
