"""Operator registry.

The port's counterpart of ``flexflow_tpu/ops/registry.py``: each operator
type registers an ``OpDef`` with

  - ``infer``   : shape/dtype inference (compute-graph level)
  - ``weights`` : declarative parameter specs (kernel/bias/...), the same
                  names and shapes as the JAX package, so weights copy 1:1
  - ``emit``    : the forward computation on torch tensors.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ffconst import DataType, OperatorType
from ..core.tensor import WeightSpec


class LayerRng:
    """The dropout randomness of one layer in one train step, keyed by an
    integer path (model seed + 1, step, layer index), as the JAX package
    folds its key (``Executor._rngs_for_step``). Its bits differ from
    JAX's. :meth:`generator` gives a generator on the device that draws:
    the tensor's device for masks (``DropoutOp``, the plain attention
    path), the CPU for the flash kernel's seed, so that costs no device
    sync."""

    def __init__(self, key: Sequence[int]):
        self.key = tuple(int(k) for k in key)

    def generator(self, device) -> torch.Generator:
        from ..runtime.initializers import generator_for
        return generator_for(self.key, device)


def generator_on(rng, device) -> torch.Generator:
    """A generator for drawing on ``device`` from a layer's rng: a
    :class:`LayerRng`, or a ``torch.Generator`` used as it is."""
    if rng is None:
        raise RuntimeError("this op needs an rng in training")
    if isinstance(rng, LayerRng):
        return rng.generator(device)
    return rng


def host_seed(rng) -> int:
    """An int seed drawn on the host from a layer's rng."""
    return int(torch.randint(0, 2 ** 31 - 1, (),
                             generator=generator_on(rng, "cpu")))


class EmitCtx:
    """Per-forward emission context threaded through op emission."""

    def __init__(self, training: bool, rngs: Optional[Dict[str, Any]] = None,
                 state: Optional[Dict[str, Any]] = None, config=None):
        self.training = training
        # layer name -> LayerRng or torch.Generator (training-mode
        # dropout only)
        self.rngs = rngs or {}
        self.state = state or {}
        self.new_state: Dict[str, Any] = {}
        self.config = config
        self.aux_losses: List[Any] = []
        # KV-cache plumbing of the generation path. kv_mode: None = plain
        # forward, "prefill" = full-sequence forward that also records
        # each attention layer's per-position K/V into new_kv, "decode" =
        # one-token forward that writes its K/V into kv_cache (in place)
        # and attends over it; new_kv then holds the written buffers.
        # kv_index = the query position (an int, or a (B,) tensor for
        # ragged prompts); kv_prefill_len = the count of real prompt
        # positions in the prefill batch, from which sliding-window
        # layers seed their O(window) ring-buffer cache.
        self.kv_mode: Optional[str] = None
        self.kv_cache: Optional[Dict[str, Any]] = None
        self.kv_index: Any = None
        self.kv_prefill_len: Optional[int] = None
        self.new_kv: Dict[str, Any] = {}
        # the adopted per-op kernel impls (kernels/registry.py), threaded
        # in by the executor; None/empty = default impls
        self.kernel_impls: Optional[Dict[str, str]] = None

    def rng_for(self, name: str):
        return self.rngs.get(name)


class OpDef:
    op_type: OperatorType = OperatorType.OP_INVALID

    def infer(self, params: Dict[str, Any],
              in_shapes: Sequence[Tuple[int, ...]],
              in_dtypes: Sequence[DataType]
              ) -> List[Tuple[Tuple[int, ...], DataType]]:
        raise NotImplementedError

    def weights(self, params: Dict[str, Any],
                in_shapes: Sequence[Tuple[int, ...]],
                in_dtypes: Sequence[DataType]) -> List[WeightSpec]:
        return []

    def emit(self, params: Dict[str, Any], inputs: List[Any],
             weights: Dict[str, Any], ctx: EmitCtx, name: str) -> List[Any]:
        raise NotImplementedError

    # ---- cost level (search/costmodel.py) ----
    def flops(self, params, in_shapes, out_shapes) -> float:
        """Forward FLOPs estimate. Default: one op per output element."""
        return float(sum(int(np.prod(s)) for s in out_shapes))

    def backward_flops_factor(self) -> float:
        """bwd/fwd FLOP ratio. 2.0 for matmul-like ops (dgrad+wgrad)."""
        return 1.0


OPS: Dict[OperatorType, OpDef] = {}


def register(cls):
    inst = cls()
    if inst.op_type == OperatorType.OP_INVALID:
        raise ValueError(f"{cls.__name__} does not declare an op_type")
    OPS[inst.op_type] = inst
    return cls


def get_op_def(op_type: OperatorType) -> OpDef:
    try:
        return OPS[OperatorType(op_type)]
    except KeyError:
        raise NotImplementedError(
            f"{OperatorType(op_type).name} is not ported to "
            f"flexflow_tpu_torch yet") from None


def bf16_enabled(ctx) -> bool:
    """Whether emission may cast f32 matmul operands to bf16."""
    cfg = getattr(ctx, "config", None) if ctx is not None else None
    if cfg is None:
        return True
    return getattr(cfg, "use_bf16_compute", True) and \
        getattr(cfg, "allow_tensor_op_math_conversion", True)


def compute_dtype(ctx, ref_dtype=None) -> torch.dtype:
    """bf16 when enabled and the reference dtype is f32/bf16, else f32."""
    if bf16_enabled(ctx) and ref_dtype in (None, torch.float32,
                                           torch.bfloat16):
        return torch.bfloat16
    return torch.float32


def _mm_f32_forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cuda":
        if b.dim() == 3:
            return torch.bmm(a, b, out_dtype=torch.float32)
        a2 = a.reshape(-1, a.shape[-1])
        out = torch.mm(a2, b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


class _MmF32(torch.autograd.Function):
    """``mm_f32`` with the JAX package's gradient rule for
    ``einsum(x.astype(bf16), w.astype(bf16), preferred_element_type=f32)``:
    each operand's gradient is the f32 cotangent times the other bf16
    operand, computed in f32 and rounded once to the operand's dtype
    (bf16). The ``out_dtype`` overload has no derivative of its own."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32_forward(a, b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dy = dy.float()
        da = db = None
        if b.dim() == 3:            # (B, m, k) @ (B, k, n)
            if ctx.needs_input_grad[0]:
                da = torch.bmm(dy, b.float().transpose(1, 2)).to(a.dtype)
            if ctx.needs_input_grad[1]:
                db = torch.bmm(a.float().transpose(1, 2), dy).to(b.dtype)
            return da, db
        dy2 = dy.reshape(-1, dy.shape[-1])
        if ctx.needs_input_grad[0]:
            da = torch.mm(dy2, b.float().t()).to(a.dtype).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            a2 = a.reshape(-1, a.shape[-1])
            db = torch.mm(a2.float().t(), dy2).to(b.dtype)
        return da, db


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for bf16 operands with an f32 result, like JAX's
    ``preferred_element_type=jnp.float32``. ``a`` is (..., k), ``b`` is
    (k, n) or, batched, (B, k, n) against ``a`` (B, m, k).

    ``torch.matmul`` on bf16 rounds its result to bf16; here the sum
    stays f32. On the card, ``out_dtype`` asks cuBLAS for the f32 output
    of its bf16 product. On the CPU, which has no such overload, the
    operands are widened: a product of two bf16 values is exact in f32,
    so this computes the same function. The gradient follows the JAX
    package's rule (:class:`_MmF32`) on both. f32 operands take a plain
    f32 product."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    return _MmF32.apply(a, b)


def matmul(a, b, *, prefer_bf16: bool = True, ctx=None):
    """bf16 operands, f32 accumulation and result (the JAX package's
    ``ops/registry.py:matmul``). ``ctx`` gates the bf16 cast on
    ``config.use_bf16_compute`` / ``allow_tensor_op_math_conversion``.
    ``b`` of more than three dims is a batch of matrices against the same
    leading dims of ``a`` (``BatchMatmulOp``), flattened into one batch
    dim around the product."""
    if ctx is not None:
        prefer_bf16 = prefer_bf16 and bf16_enabled(ctx)
    if b.dim() > 3:
        out = matmul(a.reshape(-1, *a.shape[-2:]),
                     b.reshape(-1, *b.shape[-2:]), prefer_bf16=prefer_bf16)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    if prefer_bf16 and a.dtype in (torch.float32, torch.bfloat16):
        out = mm_f32(a.to(torch.bfloat16), b.to(torch.bfloat16))
        return out.to(a.dtype) if a.dtype != torch.float32 else out
    # f32-compute path: still accumulate in f32 for low-precision operands
    if a.dtype == torch.bfloat16:
        return mm_f32(a, b).to(a.dtype)
    return torch.matmul(a, b)
