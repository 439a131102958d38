"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain twins.

Port of ``flexflow_tpu/kernels/flash_attention.py``. Three CUDA kernels
replace the three Pallas ones: ``csrc/flash_attention_fwd.cu`` the
forward ``_fwd_kernel``, ``csrc/flash_attention_bwd.cu`` the backward
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``; their headers say how each is
laid out and what bounds it. ``csrc/flash_common.cuh`` holds what they
share (the dropout hash and its per-tile keep bits among it) and the f32
kernels' helpers, ``csrc/hopper_common.cuh`` the Hopper building blocks
of the three bf16 kernels (the TMA/cp.async tile rings, the swizzled
layout and its ``wgmma`` descriptors, the ``wgmma`` wrappers); f32
inputs run exact FMA kernels, chosen by dtype inside each C entry.

:func:`flash_attention` takes the JAX package's layout, ``(b, h, s, d)``,
and is differentiable: a ``torch.autograd.Function`` (the counterpart of
the JAX ``custom_vjp``) saves q, k, v, o, lse and the seed, and its
backward computes ``delta = rowsum(do * o)`` in f32 and launches the dq
and dk/dv kernels. Serving (under ``torch.inference_mode``) and training
go through this one entry. Tensors on the card launch the kernels (or
raise); tensors on the CPU run the plain versions
(:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`), the
same functions in plain PyTorch, which the tests hold against the JAX
kernels and ``chip_smoke.py`` holds against the CUDA kernels.

Semantics kept from the reference: masked scores are ``NEG_INF = -1e30``
(finite); the softmax denominator sums the undropped p; dropout keeps
``p / (1 - rate)`` where the counter hash of (seed, b*h + h, absolute q
position, absolute k position) clears the threshold; p is cast to the
input dtype before the P.V product; rows with ``l == 0`` give ``o = 0``
and ``lse = m``; the default ``sm_scale`` is ``1/sqrt(d)`` of the
UNPADDED head dim, kept when the wrapper pads d up to the kernel's 64 or
128. The backward rebuilds the keep mask from the same tuple, rounds ds
to k's (q's) dtype before dS.K (dS^T.Q) and p_eff to do's dtype before
P^T.dO, as ``_flash_bwd_rule`` does.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_KERNEL_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# the dropout keep mask (uint32 arithmetic emulated in int64)
# ---------------------------------------------------------------------------
def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32) and a constant
    ``c`` < 2**32, split in 16-bit halves so no int64 product overflows."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & _M32) << 16
    return (lo + hi) & _M32


def _threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def _position_keep(seed: int, bh: torch.Tensor, q_pos: torch.Tensor,
                   k_pos: torch.Tensor, rate: float) -> torch.Tensor:
    """keep = fmix32(seed*0x9E3779B9 ^ bh*0x32139EA9 ^ q*0x85EBCA6B
    ^ k*0xC2B2AE35) >= threshold, bit for bit the JAX ``_position_keep``
    (its int32 multiplies wrap exactly as these uint32 ones do). The
    constants are the JAX code's int32 values -1640531527 and 840146601
    as uint32; its comments name them 0x9E3779B1 and 0x3243F6A9, which
    they are not."""
    h = ((seed & _M32) * 0x9E3779B9) & _M32
    u = (_mul32(bh, 0x32139EA9) ^ _mul32(q_pos, 0x85EBCA6B)
         ^ _mul32(k_pos, 0xC2B2AE35)) ^ h
    u = u ^ (u >> 16)
    u = _mul32(u, 0x85EBCA6B)
    u = u ^ (u >> 13)
    u = _mul32(u, 0xC2B2AE35)
    u = u ^ (u >> 16)
    return u >= _threshold(rate)


def dropout_keep_mask(b: int, h: int, sq: int, sk: int, rate: float,
                      seed: int, device="cpu") -> torch.Tensor:
    """The kernel's counter-based keep mask as a (b, h, sq, sk) bool
    tensor. Bit-identical to the JAX package's ``dropout_keep_mask``."""
    kw = dict(dtype=torch.int64, device=device)
    bh = torch.arange(b * h, **kw)[:, None, None]
    qp = torch.arange(sq, **kw)[None, :, None]
    kp = torch.arange(sk, **kw)[None, None, :]
    return _position_keep(int(seed), bh, qp, kp, rate).reshape(b, h, sq, sk)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def flash_attention_plain(q, k, v, *, causal: bool = False,
                          sm_scale: Optional[float] = None,
                          dropout_rate: float = 0.0, dropout_seed=None):
    """What the kernel computes, in plain PyTorch on any device, with one
    full softmax instead of the kernel's online one. Returns
    ``(o, lse)``: o in q's dtype, lse (b, h, sq) in f32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(b, h, sq, sk, dropout_rate,
                                 int(dropout_seed), q.device)
        p = torch.where(keep, p / (1.0 - dropout_rate),
                        torch.zeros_like(p))
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (pv / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return o, lse


def mha_reference(q, k, v, *, causal: bool = False,
                  sm_scale: Optional[float] = None):
    """Plain attention, the numerics golden of the JAX package's kernel
    tests (``mha_reference``); causal masks with the bottom-right
    diagonal offset ``sk - sq``."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(),
                        v.float()).to(q.dtype)




def _bwd_terms(q, k, v, do, lse, delta, causal, sm_scale, dropout_rate,
               dropout_seed):
    """p_eff and ds of every (query, key) pair, in f32: the quantities
    the dq and dk/dv kernels accumulate (``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``)."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    p_eff = p
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(b, h, sq, sk, dropout_rate,
                                 int(dropout_seed), q.device)
        zero = torch.zeros_like(p)
        dp = torch.where(keep, dp / (1.0 - dropout_rate), zero)
        p_eff = torch.where(keep, p / (1.0 - dropout_rate), zero)
    ds = p * (dp - delta[..., None]) * sm_scale
    return p_eff, ds


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *, causal=False,
                                 sm_scale=None, dropout_rate=0.0,
                                 dropout_seed=None):
    """What the dq kernel computes: ``dq = ds.astype(k.dtype) . k``
    summed in f32, in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _bwd_terms(q, k, v, do, lse, delta, causal, sm_scale,
                       dropout_rate, dropout_seed)
    return torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                        k.float()).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal=False,
                                  sm_scale=None, dropout_rate=0.0,
                                  dropout_seed=None):
    """What the dk/dv kernel computes: ``dv = p_eff.astype(do.dtype)^T .
    do`` and ``dk = ds.astype(q.dtype)^T . q``, summed in f32, in k's and
    v's dtypes."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p_eff, ds = _bwd_terms(q, k, v, do, lse, delta, causal, sm_scale,
                           dropout_rate, dropout_seed)
    dv = torch.einsum("bhqk,bhqd->bhkd", p_eff.to(do.dtype).float(),
                      do.float()).to(v.dtype)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                      q.float()).to(k.dtype)
    return dk, dv


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = False,
                              sm_scale: Optional[float] = None,
                              dropout_rate: float = 0.0, dropout_seed=None):
    """The JAX package's ``_flash_bwd_rule`` in plain PyTorch: delta =
    rowsum(do * o) in f32, then dq, dk, dv as the two backward kernels
    compute them. Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    delta = (do.float() * o.float()).sum(dim=-1)
    kw = dict(causal=causal, sm_scale=sm_scale, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint32
_ARGTYPES = {
    ("flash_attention_fwd", "ff_flash_attention_fwd"):
        [_P] * 5 + [_I] * 6 + [_F, _I, _U, _F, _U, _P],
    ("flash_attention_bwd", "ff_flash_attention_bwd_dq"):
        [_P] * 7 + [_I] * 6 + [_F, _I, _U, _F, _U, _P],
    ("flash_attention_bwd", "ff_flash_attention_bwd_dkv"):
        [_P] * 8 + [_I] * 6 + [_F, _I, _U, _F, _U, _P],
}


def _c_fn(lib: str, sym: str):
    from .build import load
    fn = getattr(load(lib), sym)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[(lib, sym)]
        fn.restype = _I
    return fn


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _dropout_args(dropout_rate: float, seed: int):
    return (int(dropout_rate > 0.0), _threshold(dropout_rate),
            float(1.0 - dropout_rate), seed)


def _kernel_inputs(*ts) -> None:
    """What every kernel takes: cuda tensors of one dtype, contiguous,
    16-byte aligned, head dim 64 or 128, b*h within the grid limit."""
    t0 = ts[0]
    if t0.device.type != "cuda":
        raise ValueError(f"the flash kernels run on cuda tensors, not "
                         f"{t0.device}")
    bh = t0.shape[0] * t0.shape[1]
    if bh > 65535:
        raise ValueError(f"b*h = {bh} exceeds the kernel's grid limit of "
                         f"65535")
    if t0.shape[-1] not in _KERNEL_DIMS:
        raise ValueError(f"the kernels take head dim 64 or 128, got "
                         f"{t0.shape[-1]}")
    for t in ts:
        if t.dtype != t0.dtype or t.device != t0.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel inputs must share one dtype and "
                             "device and be contiguous and 16-byte aligned")


def _fwd(q, k, v, causal, sm_scale, dropout_rate, seed):
    """(o, lse) of the forward: the kernel for cuda tensors, the plain
    version for cpu ones."""
    if q.device.type == "cpu":
        flash_attention.plain_calls += 1
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale,
                                     dropout_rate=dropout_rate,
                                     dropout_seed=seed)
    _kernel_inputs(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _check(_c_fn("flash_attention_fwd", "ff_flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b * h, sq, sk, d, _DTYPE_CODES[q.dtype],
        int(causal), float(sm_scale), *_dropout_args(dropout_rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention_fwd")
    flash_attention.launches += 1
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                           sm_scale: Optional[float] = None,
                           dropout_rate: float = 0.0, dropout_seed=None):
    """dq of flash attention from the forward's lse and ``delta =
    rowsum(do * o)`` (both (b, h, sq) f32). CUDA tensors (head dim 64 or
    128) launch the dq kernel of ``csrc/flash_attention_bwd.cu`` (bf16:
    the ``wgmma`` kernel, which encodes four TMA tensor maps per launch;
    f32: the exact FMA kernel) and count one in ``.launches``; CPU
    tensors run
    :func:`flash_attention_bwd_dq_plain` and count one in
    ``.plain_calls``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    seed = 0 if dropout_seed is None else int(dropout_seed) & _M32
    if q.device.type == "cpu":
        flash_attention_bwd_dq.plain_calls += 1
        return flash_attention_bwd_dq_plain(
            q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale,
            dropout_rate=dropout_rate, dropout_seed=seed)
    _kernel_inputs(q, k, v, do)
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    _check(_c_fn("flash_attention_bwd", "ff_flash_attention_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.contiguous().data_ptr(), delta.contiguous().data_ptr(),
        dq.data_ptr(), b * h, sq, k.shape[2], d, _DTYPE_CODES[q.dtype],
        int(causal), float(sm_scale), *_dropout_args(dropout_rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                            sm_scale: Optional[float] = None,
                            dropout_rate: float = 0.0, dropout_seed=None):
    """(dk, dv) of flash attention, as :func:`flash_attention_bwd_dq`
    takes its inputs: CUDA tensors launch the dk/dv kernel, CPU tensors
    run :func:`flash_attention_bwd_dkv_plain`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    seed = 0 if dropout_seed is None else int(dropout_seed) & _M32
    if q.device.type == "cpu":
        flash_attention_bwd_dkv.plain_calls += 1
        return flash_attention_bwd_dkv_plain(
            q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale,
            dropout_rate=dropout_rate, dropout_seed=seed)
    _kernel_inputs(q, k, v, do)
    b, h, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _check(_c_fn("flash_attention_bwd", "ff_flash_attention_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.contiguous().data_ptr(), delta.contiguous().data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, sq, k.shape[2], d,
        _DTYPE_CODES[q.dtype], int(causal), float(sm_scale),
        *_dropout_args(dropout_rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX ``custom_vjp``: the forward kernel
    saves (q, k, v, o, lse, seed); the backward takes delta in f32 and
    launches the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, dropout_rate, seed):
        o, lse = _fwd(q, k, v, causal, sm_scale, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = dict(causal=causal, sm_scale=sm_scale,
                       dropout_rate=dropout_rate, dropout_seed=seed)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **ctx.cfg)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    return_lse: bool = False):
    """Tiled flash attention, differentiable. q: (b, h, sq, d); k, v:
    (b, h, sk, d), all contiguous, one dtype (float32 or bfloat16), one
    device.

    CUDA tensors launch ``csrc/flash_attention_fwd.cu`` and count one
    launch in ``flash_attention.launches`` (the backward's kernels count
    in ``flash_attention_bwd_dq.launches`` and
    ``flash_attention_bwd_dkv.launches``); CPU tensors run the plain
    versions and count in ``.plain_calls``. Returns o (b, h, sq, d) in
    q's dtype, and with ``return_lse`` also lse (b, h, sq) in f32."""
    if q.dim() != 4:
        raise ValueError(f"q must be (b, h, sq, d), got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2] if k.dim() == 4 else -1
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise ValueError(f"k and v must be (b, h, sk, d) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if min(b * h, sq, sk) == 0:
        raise ValueError(f"empty attention shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q, k, v must share one dtype of float32/bfloat16;"
                        f" got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if causal and sq != sk:
        raise NotImplementedError("causal flash requires sq == sk")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1): {dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)        # of the unpadded head dim
    seed = 0 if dropout_seed is None else int(dropout_seed) & _M32
    d_k = d
    if q.device.type == "cuda":
        d_k = next((x for x in _KERNEL_DIMS if d <= x), None)
        if d_k is None:
            raise ValueError(f"head_dim {d} > {_KERNEL_DIMS[-1]} is not "
                             f"supported by the kernel")
        if d_k != d:
            # zero columns change no score and give zero output columns;
            # padding outside the Function lets autograd slice the
            # gradients back
            q, k, v = (F.pad(t, (0, d_k - d)) for t in (q, k, v))
    o, lse = _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale),
                                   float(dropout_rate), seed)
    if d_k != d:
        o = o[..., :d]
    return (o, lse) if return_lse else o


flash_attention.launches = 0
flash_attention.plain_calls = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.plain_calls = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.plain_calls = 0
