"""Sequence-parallel attention over the ranks of a ``seq`` group: ring
attention and Ulysses.

The port of ``flexflow_tpu/kernels/ring_attention.py``. Each function
works on one rank's local chunks ``(b, h, s/N, d)`` of q, k and v, the
chunks contiguous along the sequence in rank order:

- :func:`ring_attention`: the K/V chunks rotate around the group, one hop
  to rank ``(i + 1) mod N`` at a time (:class:`SeqGroup`), each rank
  attends its queries to every chunk as it passes and merges the
  normalized partial results by log-sum-exp. The backward runs a second
  ring that rotates (k, v, dk, dv) together, so every chunk's gradient
  accumulators collect every rank's contribution and come home after N
  hops. Causal masking follows the global positions: the chunk that came
  from rank ``src`` is fully visible (``src < i``), the diagonal
  (``src == i``), or skipped (``src > i``).
- :func:`ulysses_attention`: an all-to-all from sequence shards to head
  shards, :func:`~.flash_attention.flash_attention` over the whole
  sequence with ``h/N`` heads (the CUDA forward, dq and dk/dv kernels on
  the card), and an all-to-all back.

The ring's per-chunk math (:func:`_chunk_attn`, :func:`_chunk_grads`) is
plain PyTorch, as the JAX package computes it outside any Pallas kernel
(einsums): the scores are the product in q's dtype (rounded to bf16 for
bf16 operands), then f32; p, o, lse and every gradient are f32.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from .flash_attention import NEG_INF, flash_attention


class SeqGroup:
    """The ranks of this rank's group along the mesh dim named ``axis``
    of ``mesh`` (a ``torch.distributed`` DeviceMesh): its process group,
    size and this rank's index, and the ring's hop, one point-to-point
    transfer to the next rank and one from the previous over
    ``parallel.distributed.Handoff`` (``route`` as there: ``"host"``
    stages a CUDA tensor in host memory for gloo). Constructing it is
    collective: every rank of the world builds its own at the same point.
    ``hops`` counts the ring's rotations and ``bytes`` what this rank
    sent in them."""

    def __init__(self, mesh, axis: str, route: str):
        from ..parallel.distributed import Handoff
        dim = list(mesh.mesh_dim_names).index(axis)
        self.group = mesh.get_group(dim)
        self.size = mesh.size(dim)
        self.index = mesh.get_coordinate()[dim]
        self.handoff = Handoff(mesh, dim, route)
        self.hops = 0

    @property
    def bytes(self) -> int:
        return self.handoff.bytes

    def send_next(self, ts: Sequence[torch.Tensor]) -> None:
        """Start one hop: each of ``ts`` to the next rank (non-blocking;
        the buffers are kept until :meth:`recv_prev`)."""
        nxt = (self.index + 1) % self.size
        for j, t in enumerate(ts):
            self.handoff.send(t, nxt, j)
        self.hops += 1

    def recv_prev(self, likes: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
        """End the hop: the previous rank's tensors, shaped, typed and
        placed as ``likes``."""
        prv = (self.index - 1) % self.size
        out = [self.handoff.recv(t.shape, t.dtype, t.device, prv, j)
               for j, t in enumerate(likes)]
        self.handoff.flush()
        return out


def _mode(causal: bool, src: int, idx: int) -> int:
    """0: every key of chunk ``src`` visible to the queries of chunk
    ``idx``; 1: the causal diagonal; 2: none (skipped)."""
    if not causal or src < idx:
        return 0
    return 1 if src == idx else 2


def _scores(q, k, sm_scale: float, mode: int) -> torch.Tensor:
    """q k^T in q's dtype, then f32 and scaled; the diagonal chunk masked
    to keys ``j <= i``."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() * sm_scale
    if mode == 1:
        sq, sc = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sc, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def _chunk_attn(q, k, v, sm_scale: float, mode: int):
    """Partial attention of the local queries against one k/v chunk:
    the normalized o (b, h, sq, d) and lse (b, h, sq), both f32. ``mode``
    as :func:`_mode` (2 gives zeros and lse ``NEG_INF``)."""
    if mode == 2:
        z = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        return z, z.sum(dim=-1) + NEG_INF
    s = _scores(q, k, sm_scale, mode)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = m[..., 0] + torch.log(l_safe[..., 0])
    return o / l_safe, lse


def _merge(o_acc, lse_acc, o_new, lse_new):
    """Log-sum-exp merge of two normalized partial attention results."""
    lse_max = torch.maximum(lse_acc, lse_new)
    a = torch.exp(lse_acc - lse_max)
    b = torch.exp(lse_new - lse_max)
    denom = a + b
    lse_out = lse_max + torch.log(denom)
    return o_acc * (a / denom)[..., None] + o_new * (b / denom)[..., None], \
        lse_out


def _chunk_grads(q, k, v, do, lse, delta, sm_scale: float, mode: int):
    """The flash backward's math for one chunk, p recomputed from lse:
    (dq, dk, dv) in f32. ``do`` is f32; ``mode`` as :func:`_mode`."""
    if mode == 2:
        return tuple(torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device) for t in (q, k, v))
    p = torch.exp(_scores(q, k, sm_scale, mode) - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """The counterpart of the JAX ``_ring_core`` and its custom VJP: the
    forward ring (N - 1 hops of (k, v)) saves (q, k, v, o, lse), o and lse
    in f32; the backward ring rotates (k, v, dk, dv) N times, the last
    hop carrying dk and dv only (k and v are home by then, and nothing
    reads them: the JAX package's compiled ring drops that rotation as
    dead code). Each hop is started before the chunk's compute, so the
    transfer runs beside it."""

    @staticmethod
    def forward(ctx, q, k, v, comm: SeqGroup, causal: bool,
                sm_scale: float):
        n, idx = comm.size, comm.index
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                         device=q.device)
        kc, vc = k, v
        for r in range(n):
            if r != n - 1:
                comm.send_next((kc, vc))
            mode = _mode(causal, (idx - r) % n, idx)
            if mode != 2:
                # (merging a skipped chunk's zeros and NEG_INF changes
                # nothing: a real chunk always came first, at r = 0)
                o, lse = _merge(o, lse,
                                *_chunk_attn(q, kc, vc, sm_scale, mode))
            if r != n - 1:
                kc, vc = comm.recv_prev((kc, vc))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.comm, ctx.causal, ctx.sm_scale = comm, causal, sm_scale
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        comm, causal, sm_scale = ctx.comm, ctx.causal, ctx.sm_scale
        n, idx = comm.size, comm.index
        do32 = do.float()
        delta = (do32 * o).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kc, vc = k, v
        for r in range(n):
            last = r == n - 1
            if not last:
                comm.send_next((kc, vc))
            mode = _mode(causal, (idx - r) % n, idx)
            if mode != 2:
                dq_c, dk_c, dv_c = _chunk_grads(q, kc, vc, do32, lse, delta,
                                                sm_scale, mode)
                dq = dq + dq_c
                dkc = dkc + dk_c
                dvc = dvc + dv_c
            # the gradient accumulators travel with their chunk: after N
            # hops each is back on its home rank with every contribution
            if last:
                comm.send_next((dkc, dvc))
                dkc, dvc = comm.recv_prev((dkc, dvc))
            else:
                for j, t in enumerate((dkc, dvc)):
                    comm.handoff.send(t, (idx + 1) % n, 2 + j)
                kc, vc, dkc, dvc = comm.recv_prev((kc, vc, dkc, dvc))
        return dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype), None, \
            None, None


def ring_attention(q, k, v, group: SeqGroup, *, causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over the ranks of ``group``. q, k, v are this
    rank's chunks ``(b, h, s/N, d)`` of one dtype (the rank's position
    in ``group`` is its chunk's along the sequence). Differentiable;
    returns o ``(b, h, s/N, d)`` in q's dtype."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"ring attention takes q, k, v chunks of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), group, bool(causal),
                                float(sm_scale))


def ulysses_attention(q, k, v, group: SeqGroup, *, causal: bool = False,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism over the ranks of
    ``group``: q, k, v ``(b, h, s/N, d)`` sequence chunks go all-to-all
    into ``(b, h/N, s, d)`` head shards, ``flash_attention`` attends the
    whole sequence (on a CUDA tensor the forward kernel, and the dq and
    dk/dv kernels in the backward), and the output goes back to
    ``(b, h, s/N, d)``. Requires ``h % N == 0``."""
    from ..parallel.distributed import all_to_all_dim
    if q.shape[1] % group.size:
        raise ValueError(f"Ulysses splits {q.shape[1]} heads over "
                         f"{group.size} ranks: they must divide")
    qh, kh, vh = (all_to_all_dim(t, 1, 2, group.group) for t in (q, k, v))
    o = flash_attention(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    return all_to_all_dim(o, 2, 1, group.group)
