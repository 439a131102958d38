"""Flash attention forward: a hand-written Hopper kernel and its plain twin.

Port of ``flexflow_tpu/kernels/flash_attention.py`` (forward only; the
dq and dk/dv kernels come with the training slice). The CUDA kernel is
``csrc/flash_attention_fwd.cu``, which replaces the Pallas ``_fwd_kernel``;
its header says how it is laid out and what bounds it.

:func:`flash_attention` takes the JAX package's layout, ``(b, h, s, d)``.
A tensor on the card launches the kernel (or raises); a tensor on the CPU
runs :func:`flash_attention_plain`, the same function in plain PyTorch,
which the tests hold against the JAX kernel and ``chip_smoke.py`` holds
against the CUDA kernel.

Semantics kept from the reference: masked scores are ``NEG_INF = -1e30``
(finite); the softmax denominator sums the undropped p; dropout keeps
``p / (1 - rate)`` where the counter hash of (seed, b*h + h, absolute q
position, absolute k position) clears the threshold; p is cast to the
input dtype before the P.V product; rows with ``l == 0`` give ``o = 0``
and ``lse = m``; the default ``sm_scale`` is ``1/sqrt(d)`` of the
UNPADDED head dim, kept when the wrapper pads d up to the kernel's 64 or
128.
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


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------
def _c_fn():
    from .build import load
    fn = load("flash_attention_fwd").ff_flash_attention_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, ctypes.c_float, I,
                       ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32, P]
        fn.restype = I
    return fn


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    return_lse: bool = False):
    """Tiled flash attention forward. q: (b, h, sq, d); k, v: (b, h, sk, d),
    all contiguous, one dtype (float32 or bfloat16), one device.

    CUDA tensors launch ``csrc/flash_attention_fwd.cu`` and count one
    launch in ``flash_attention.launches``; CPU tensors run
    :func:`flash_attention_plain` and count one in
    ``flash_attention.plain_calls``. Returns o (b, h, sq, d) in q's dtype,
    and with ``return_lse`` also lse (b, h, sq) in f32."""
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
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)        # of the unpadded head dim
    seed = 0 if dropout_seed is None else int(dropout_seed) & _M32

    if q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, causal=causal,
                                       sm_scale=sm_scale,
                                       dropout_rate=dropout_rate,
                                       dropout_seed=seed)
        flash_attention.plain_calls += 1
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    if b * h > 65535:
        raise ValueError(f"b*h = {b * h} exceeds the kernel's grid limit "
                         f"of 65535")
    d_k = next((x for x in _KERNEL_DIMS if d <= x), None)
    if d_k is None:
        raise ValueError(f"head_dim {d} > {_KERNEL_DIMS[-1]} is not "
                         f"supported by the kernel")
    if d_k != d:
        # zero columns change no score and give zero output columns
        q, k, v = (F.pad(t, (0, d_k - d)) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    o = torch.empty((b, h, sq, d_k), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _c_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), b * h, sq, sk, d_k, _DTYPE_CODES[q.dtype],
                  int(causal), float(sm_scale), int(dropout_rate > 0.0),
                  _threshold(dropout_rate), float(1.0 - dropout_rate), seed,
                  torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    if d_k != d:
        o = o[..., :d]
    return (o, lse) if return_lse else o


flash_attention.launches = 0
flash_attention.plain_calls = 0
