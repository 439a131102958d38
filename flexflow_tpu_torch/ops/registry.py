"""Operator registry.

The port's counterpart of ``flexflow_tpu/ops/registry.py``: each operator
type registers an ``OpDef`` with

  - ``infer``   : shape/dtype inference (compute-graph level)
  - ``weights`` : declarative parameter specs (kernel/bias/...), the same
                  names and shapes as the JAX package, so weights copy 1:1
  - ``emit``    : the forward computation on torch tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ffconst import DataType, OperatorType
from ..core.tensor import WeightSpec
from ..parallel.local_ops import dist_mm, is_dtensor


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
        # layers seed their O(window) ring-buffer cache. Over a live mesh
        # the cache holds each rank's block (its rows, its kv heads), a
        # ragged kv_index the rank's rows and kv_rows (below) the rank's
        # count of real rows; a scalar index is the same on every rank.
        self.kv_mode: Optional[str] = None
        self.kv_cache: Optional[Dict[str, Any]] = None
        self.kv_index: Any = None
        self.kv_prefill_len: Optional[int] = None
        self.new_kv: Dict[str, Any] = {}
        # the adopted per-op kernel impls (kernels/registry.py), threaded
        # in by the executor; None/empty = default impls
        self.kernel_impls: Optional[Dict[str, str]] = None
        # the ranks of the mesh's seq group (kernels/ring_attention.
        # SeqGroup) that ring attention runs over; None = no seq axis
        self.seq_ring: Any = None
        # local-shape execution (a rank's forward on its own rows with
        # local weights, the quantized sync): a reshape to a recorded
        # global batch shape takes the rank's rows, and local_rows =
        # (global batch, first row) places those rows in the batch, where
        # the dropout masks are drawn or hashed, so they are the global
        # step's masks
        self.local_shape: bool = False
        self.local_rows: Optional[Tuple[int, int]] = None
        # (total heads, first head) of an attention layer whose heads are
        # split over tensor-parallel ranks inside a pipeline stage: where
        # its dropout masks are drawn or hashed. None = its own heads
        self.head_block: Optional[Tuple[int, int]] = None
        # row_chunk > 0 (the KV decode step): every product of mm_f32
        # and every norm runs on blocks of exactly row_chunk rows (batch
        # entries of a batched product), so a row meets the same GEMM and
        # reduction shapes and kernels whatever number of rows shares the
        # batch. The step pads its inputs once to a multiple of the chunk
        # (Executor.kv_decode_step), so its stream of rows already comes
        # in such blocks; kv_rows counts the real rows, the rows of the
        # cache, which the attention layers cut to around the cache.
        # product_log, when a list, receives each mm_f32 product: its
        # operands, the shapes issued and the output (how a probe sees
        # every product).
        self.row_chunk: int = 0
        self.kv_rows: int = 0
        self.product_log: Optional[List[Dict[str, Any]]] = None
        # over a live mesh (a world of ranks), the strategy that the
        # values are laid out by; None on one device
        self.strategy = None

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


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if is_dtensor(a) or is_dtensor(b):
        # over a live mesh: the same product on each rank's blocks
        return dist_mm(a, b, _mm)
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MmF32.apply(a, b)
    # the same forward without the Function's host cost, which the
    # host-bound serving and decode paths pay per product
    return _mm_f32_forward(a, b)


def _rows(x: torch.Tensor, keep: int) -> int:
    """The rows of ``x`` with its last ``keep`` dims kept."""
    return math.prod(x.shape[:x.dim() - keep])


def _row_blocks(x: torch.Tensor, chunk: int, keep: int):
    """``x`` as blocks of exactly ``chunk`` rows, aligned slices of one
    padded copy: its last ``keep`` dims kept, the others flattened into
    rows. The padding rows are left as the allocator gives them (one copy
    kernel, no fill): every caller computes row by row, so no real row
    reads them, and their outputs are cut off. Returns the blocks and the
    count of real rows."""
    tail = x.shape[x.dim() - keep:]
    x2 = x if x.dim() == keep + 1 else x.reshape(-1, *tail)
    n = x2.shape[0]
    pad = -n % chunk
    if pad:
        buf = x2.new_empty((n + pad, *tail))
        buf[:n].copy_(x2)
        x2 = buf
    return (x2,) if n + pad == chunk else x2.split(chunk), n


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended on dim 0 up to ``rows`` (one call:
    the KV decode step pads its inputs and its attention context to the
    row chunk)."""
    pad = rows - x.shape[0]
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad)) if pad else x


def rows_chunked(fn, x: torch.Tensor, chunk: int, keep: int = 1,
                 weights: Optional[Dict[str, Any]] = None):
    """``fn(x, weights)`` for an ``fn`` that works row by row over the
    last ``keep`` dims of ``x`` (a norm), run on blocks of exactly
    ``chunk`` rows (:func:`_row_blocks`): a reduction kernel, like a GEMM,
    picks its order of summation by shape, so a row alone and the same
    row among eight would otherwise be summed in another order. The
    decode step's padded stream is one such block already and costs
    nothing more. Over a live mesh each rank runs its own rows (the
    decode step pads each rank's block to the chunk) with the weights
    whole."""
    weights = weights or {}
    if is_dtensor(x):
        from ..parallel.local_ops import keep_dims, run_local
        whole = {k: w.full_tensor() if is_dtensor(w) else w
                 for k, w in weights.items()}
        return run_local(
            lambda t: rows_chunked(fn, t, chunk, keep, whole), (x,),
            keep_dims(x, range(x.dim() - keep)), x.shape)
    if _rows(x, keep) == chunk:
        return fn(x, weights)
    blocks, n = _row_blocks(x, chunk, keep)
    out = _cat([fn(blk, weights) for blk in blocks])[:n]
    return out.reshape(*x.shape[:x.dim() - keep], *out.shape[1:])


def _mm_chunked(a: torch.Tensor, b: torch.Tensor, chunk: int):
    """``_mm(a, b)`` as products of exactly ``chunk`` rows of ``a`` (2-D
    ``b``) or ``chunk`` batch entries of both (3-D ``b``). Returns the
    output and the operand pairs issued."""
    if _rows(a, 2 if b.dim() == 3 else 1) == chunk:
        return _mm(a, b), [(a, b)]
    if b.dim() == 3:                      # (B, m, k) @ (B, k, n)
        blocks_a, n = _row_blocks(a, chunk, 2)
        parts = list(zip(blocks_a, _row_blocks(b, chunk, 2)[0]))
    else:                                 # (..., k) @ (k, n)
        blocks_a, n = _row_blocks(a, chunk, 1)
        parts = [(x, b) for x in blocks_a]
    out = _cat([_mm(x, y) for x, y in parts])[:n]
    if b.dim() != 3:
        out = out.reshape(*a.shape[:-1], b.shape[-1])
    return out, parts


def mm_f32(a: torch.Tensor, b: torch.Tensor, ctx=None) -> torch.Tensor:
    """``a @ b`` for bf16 operands with an f32 result, like JAX's
    ``preferred_element_type=jnp.float32``. ``a`` is (..., k), ``b`` is
    (k, n) or, batched, (B, k, n) against ``a`` (B, m, k).

    ``torch.matmul`` on bf16 rounds its result to bf16; here the sum
    stays f32. On the card, ``out_dtype`` asks cuBLAS for the f32 output
    of its bf16 product. On the CPU, which has no such overload, the
    operands are widened: a product of two bf16 values is exact in f32,
    so this computes the same function. The gradient follows the JAX
    package's rule (:class:`_MmF32`) on both. f32 operands take a plain
    f32 product.

    A ``ctx`` with ``row_chunk`` set (the KV decode step) runs the
    product on blocks of that many rows (:func:`_mm_chunked`): cuBLAS
    picks its kernel, and so its order of summation, by shape, so a row
    of a one-row batch and the same row among eight would otherwise meet
    different kernels. Over a live mesh the blocks are each rank's own
    rows (the decode step pads each rank's block to the chunk), the
    product's layout :func:`~..parallel.local_ops.dist_mm`'s."""
    chunk = getattr(ctx, "row_chunk", 0)
    if chunk and (is_dtensor(a) or is_dtensor(b)):
        issued = []

        def local(x, y):
            o, p = _mm_chunked(x, y, chunk)
            issued.extend(p)
            return o
        out, parts = dist_mm(a, b, local), issued
    elif chunk:
        out, parts = _mm_chunked(a, b, chunk)
    else:
        out, parts = _mm(a, b), [(a, b)]
    log = getattr(ctx, "product_log", None)
    if log is not None:
        log.append({"issued": [(tuple(x.shape), tuple(y.shape))
                               for x, y in parts],
                    "out": out, "a": a, "b": b})
    return out


def matmul(a, b, *, prefer_bf16: bool = True, ctx=None):
    """bf16 operands, f32 accumulation and result (the JAX package's
    ``ops/registry.py:matmul``). ``ctx`` gates the bf16 cast on
    ``config.use_bf16_compute`` / ``allow_tensor_op_math_conversion``
    and carries the decode step's row chunk (:func:`mm_f32`). ``b`` of
    more than three dims is a batch of matrices against the same leading
    dims of ``a`` (``BatchMatmulOp``), flattened into one batch dim
    around the product."""
    if ctx is not None:
        prefer_bf16 = prefer_bf16 and bf16_enabled(ctx)
    if b.dim() > 3:
        out = matmul(a.reshape(-1, *a.shape[-2:]),
                     b.reshape(-1, *b.shape[-2:]), prefer_bf16=prefer_bf16,
                     ctx=ctx)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    if prefer_bf16 and a.dtype in (torch.float32, torch.bfloat16):
        out = mm_f32(a.to(torch.bfloat16), b.to(torch.bfloat16), ctx)
        return out.to(a.dtype) if a.dtype != torch.float32 else out
    # f32-compute path: still accumulate in f32 for low-precision operands
    if a.dtype == torch.bfloat16:
        return mm_f32(a, b, ctx).to(a.dtype)
    if a.dtype == torch.float32:
        return mm_f32(a, b, ctx)
    return torch.matmul(a, b)
