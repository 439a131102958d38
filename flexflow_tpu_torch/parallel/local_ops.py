"""Functions that run on each rank's own block of a DTensor.

Over a live mesh the executor's values are DTensors with their global
logical shapes, and most ops run through DTensor's own sharding rules.
The port's kernels and products do not: a flash launch, an f32-output
product of bf16 operands, a counter-hashed or generator-drawn dropout
mask. Each runs here on ``to_local()`` blocks with stated placements,
and its result becomes a DTensor again (``DTensor.from_local``), the
pattern of ``torch.distributed.tensor.experimental.local_map``. Autograd
crosses both conversions; each operand's gradient placements are stated
(:func:`_grad_placements`), so a replicated weight's gradient comes back
``Partial`` and is summed where the executor reduces it.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch


_DTENSOR = None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (the class imported once: the host-bound
    serving path asks for every product)."""
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


def _stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, mesh, placements,
               shape: Sequence[int]):
    """A DTensor of global ``shape`` from this rank's block (made
    contiguous: the DTensor's strides are the contiguous ones)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), mesh, list(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=_stride(shape))


def _grad_placements(p, out, other) -> object:
    """The placement of an operand's gradient on one mesh dim, given the
    operand's placement ``p``, the output's ``out`` and the other
    operand's ``other``: a Partial operand's gradient is the whole
    (replicated) cotangent; a replicated operand whose output is split, or
    summed with a Partial partner, gets a partial sum on each rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if isinstance(p, Partial):
        return Replicate()
    if isinstance(p, Replicate) and (
            isinstance(out, Shard)
            or (isinstance(out, Partial) and isinstance(other, Partial))):
        return Partial()
    return p


def _mm_rule(x, y, ra: int, batched: bool):
    """(output placement, a's, b's) for ``a @ b`` on one mesh dim: a of
    ``ra`` dims (..., k) against b (k, n), or batched (B, m, k) against
    (B, k, n). Operands are moved to the nearest layout the product can
    use (a local slice where one is replicated; a gather where two
    shardings conflict)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    R = Replicate()
    sx = x.dim % ra if isinstance(x, Shard) else None
    sy = y.dim % (3 if batched else 2) if isinstance(y, Shard) else None
    px, py = isinstance(x, Partial), isinstance(y, Partial)
    if batched:
        if px and not (py or sy is not None):
            return Partial(), x, R
        if py and not (px or sx is not None):
            return Partial(), R, y
        if px or py:
            return R, R, R
        if sx == 0 or sy == 0:
            return Shard(0), Shard(0), Shard(0)
        if sx == 1 and sy is None:
            return Shard(1), x, R
        if sx is None and sy == 2:
            return Shard(2), R, y
        if sx == 2 and sy == 1:
            return Partial(), x, y
        if sx is None and sy is None:
            return R, R, R
        return R, R, R
    k = ra - 1
    if py:
        if not px and sx is None:
            return Partial(), R, y
        y = R
    if px:
        if sy is None:
            return Partial(), x, R
        if sy == 0:
            return Partial(), Shard(k), y
        return Shard(k), R, y
    if sy is None:
        if sx is None:
            return R, R, R
        if sx < k:
            return Shard(sx), x, R
        return Partial(), x, Shard(0)
    if sy == 0:
        if sx is None or sx == k:
            return Partial(), Shard(k), y
        return Shard(sx), x, R
    # b split on n
    if sx is None or sx == k:
        return Shard(k), R, y
    return Shard(sx), x, R


def dist_mm(a, b, mm: Callable):
    """``mm(a, b)`` (``ops/registry._mm``: a product with an f32 result)
    for DTensor operands: each mesh dim's layout by :func:`_mm_rule`, the
    product on the local blocks, the result a DTensor."""
    from torch.distributed.tensor import Replicate
    mesh = a.device_mesh if is_dtensor(a) else b.device_mesh
    if not is_dtensor(a):
        a = from_local(a, mesh, [Replicate()] * mesh.ndim, a.shape)
    if not is_dtensor(b):
        b = from_local(b, mesh, [Replicate()] * mesh.ndim, b.shape)
    batched = b.dim() == 3
    pa, pb, out = list(a.placements), list(b.placements), []
    for m in range(mesh.ndim):
        o, pa[m], pb[m] = _mm_rule(pa[m], pb[m], a.dim(), batched)
        out.append(o)
    if pa != list(a.placements):
        a = a.redistribute(mesh, pa)
    if pb != list(b.placements):
        b = b.redistribute(mesh, pb)
    ga = [_grad_placements(p, o, q) for p, o, q in zip(pa, out, pb)]
    gb = [_grad_placements(q, o, p) for p, o, q in zip(pa, out, pb)]
    local = mm(a.to_local(grad_placements=ga), b.to_local(grad_placements=gb))
    shape = (*a.shape[:-1], b.shape[-1])
    return from_local(local, mesh, out, shape)


def block_offsets(shape: Sequence[int], mesh, placements) -> List[int]:
    """This rank's offset in every dim of a tensor of global ``shape``."""
    from .distributed import shard_bounds
    return [lo for lo, _ in shard_bounds(shape, mesh, placements)]


def keep_dims(x, dims: Sequence[int]) -> List:
    """Placements of ``x`` with its shardings of ``dims`` kept and every
    other mesh dim replicated: the layout a function that works block by
    block over those dims can run in."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim % x.dim() in dims
            else Replicate() for p in x.placements]


def run_local(fn: Callable, args: Sequence, placements, out_shape):
    """``fn`` on the local blocks of DTensors ``args`` laid out as
    ``placements`` (each moved there first); its one result, laid out the
    same, becomes a DTensor of ``out_shape``. Gradients keep the
    placements (sharded or replicated, never partial)."""
    mesh = args[0].device_mesh
    ins = [x if list(x.placements) == list(placements)
           else x.redistribute(mesh, placements) for x in args]
    out = fn(*[x.to_local(grad_placements=placements) for x in ins])
    return from_local(out, mesh, placements, out_shape)


def global_rand(like, draw: Callable[[Tuple[int, ...], torch.device],
                                     torch.Tensor]):
    """A random tensor with ``like``'s global shape and layout: every rank
    draws the whole tensor (``draw(shape, device)``, from the same
    generator state) and keeps its own block, so the values do not depend
    on the sharding. A plain ``like`` gets ``draw`` itself."""
    from .distributed import local_slice
    from .reshard import resolve_partial
    if not is_dtensor(like):
        return draw(tuple(like.shape), like.device)
    pl = resolve_partial(like.placements)
    full = draw(tuple(like.shape), like.to_local().device)
    return from_local(local_slice(full, like.shape, like.device_mesh, pl)
                      .contiguous(), like.device_mesh, pl, like.shape)
