"""Per-op concurrent device-subset placement ("op banks") and
heterogeneous placement regions ("place groups").

The port of ``flexflow_tpu/parallel/banks.py``. Reference analog:
``MachineView`` (``include/flexflow/machine_view.h:14-62``,
``src/runtime/machine_view.cc``) — each op may run on its own device
slice (``start_device_id`` + dim/stride), so e.g. DLRM places its
embedding tables on disjoint GPU subsets running *concurrently*
(``examples/cpp/DLRM/strategies/dlrm_strategy_16embs_16gpus.pb``).

A bank stacks a group of K independent, same-signature ops along a
leading bank dim sharded over dedicated mesh axes; a place group puts K
independent ops of any types on contiguous blocks of one axis. The JAX
package expresses both inside one SPMD program (a vmap over a sharded
dim; a ``lax.switch`` under ``shard_map``). Here each is one autograd
function over a world of ranks (:func:`emit_bank`,
:func:`emit_place_group`): a rank computes only its own members, with
its own block of the bank's weights, and the outputs rejoin by one
collective (an all-gather over the bank axes; an exact all-reduce of
one contributing rank per member). Every rank runs the same collectives
in forward and backward, so the graph stays symmetric.

Wins vs whole-mesh placement (what the reference's DLRM strategies buy):
  - weights are *distributed*, not replicated: per-device table memory
    is divided by the bank degree;
  - the dense embedding-gradient update (the device-memory-bound step
    cost) is divided by the bank degree — each subset updates only its
    tables;
  - member lookups run concurrently on disjoint subsets.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ffconst import OperatorType


@dataclasses.dataclass(frozen=True)
class MachineView:
    """Reference-parity device-subset view (``machine_view.h:14-62``):
    the devices ``start_device_id + i*stride`` for ``i < num_parts``,
    in the mesh's flat device order. Subsets that are not an arithmetic
    progression (possible when the bank axes are non-adjacent in the
    mesh's axis order) carry their exact ids in ``explicit_ids``."""
    start_device_id: int
    num_parts: int
    stride: int = 1
    explicit_ids: Optional[Tuple[int, ...]] = None

    @property
    def device_ids(self) -> Tuple[int, ...]:
        if self.explicit_ids is not None:
            return self.explicit_ids
        return tuple(self.start_device_id + i * self.stride
                     for i in range(self.num_parts))


def _ids_to_view(ids: "np.ndarray") -> MachineView:
    """Compress a sorted flat-id array to start/num/stride when it is
    an arithmetic progression, else keep the exact ids."""
    stride = int(ids[1] - ids[0]) if len(ids) > 1 else 1
    if len(ids) > 2 and not np.all(np.diff(ids) == stride):
        return MachineView(int(ids[0]), len(ids), 1,
                           explicit_ids=tuple(int(i) for i in ids))
    return MachineView(int(ids[0]), len(ids), stride)


@dataclasses.dataclass
class BankSpec:
    """K independent ops placed on disjoint device subsets. ``members``
    is ordered: the stacked bank dim is sharded in contiguous blocks,
    so member k lives at bank coordinate ``k // (K / bank_degree)``.
    ``axes`` are the mesh axes forming the bank dim; their sizes
    multiply to ``bank_degree``, which must divide K.

    ``padded=False``: members share an exact signature (v1).
    ``padded=True``: members share a signature FAMILY — same op type,
    inputs and outputs, differing only in weight shapes (heterogeneous
    embedding tables: different vocab sizes). Weights are zero-padded
    to the per-name max shape before stacking; lookups never touch the
    padding (ids are bounded by each member's true vocab), so banked
    and unbanked runs stay numerically identical. This is the
    reference's MachineView placement for NON-identical ops
    (machine_view.h:14-62) — the r4 'banks v1 is narrow' gap."""
    members: List[str]                  # layer names, bank index = position
    axes: Tuple[str, ...]               # mesh axes carrying the bank dim
    batch_axes: Tuple[str, ...] = ()    # leftover axes for dp inside subsets
    param_name: str = "__bank__"
    padded: bool = False

    def bank_degree(self, dmesh) -> int:
        d = 1
        for a in self.axes:
            d *= dmesh.axis_sizes[a]
        return d

    def machine_views(self, dmesh) -> Dict[str, MachineView]:
        """Per-member flat-device-order subset, for describe/export and
        reference-strategy parity checks. The mesh is laid out
        axis-major (``DeviceMesh`` reshapes ``jax.devices()``), so a
        member's subset is the set of flat ids whose coordinates along
        ``self.axes`` equal the member's bank coordinate."""
        names = list(dmesh.axis_sizes.keys())
        sizes = [dmesh.axis_sizes[a] for a in names]
        B = self.bank_degree(dmesh)
        if len(self.members) % B != 0:
            raise ValueError(f"bank degree {B} must divide member "
                             f"count {len(self.members)}")
        grid = np.arange(int(np.prod(sizes))).reshape(sizes)
        # bank coordinate of every flat device id
        coord = np.zeros_like(grid)
        mult = 1
        for a in reversed(self.axes):
            idx = names.index(a)
            ax_coord = np.indices(grid.shape)[idx]
            coord = coord + ax_coord * mult
            mult *= sizes[idx]
        out: Dict[str, MachineView] = {}
        per = len(self.members) // B
        for k, m in enumerate(self.members):
            ids = np.sort(grid[coord == (k // per)].ravel())
            out[m] = _ids_to_view(ids)
        return out


# Ops safe to bank in v1: pure, stateless, rng-free, single-input/
# single-output, with all weights vmappable. The reference's headline
# use-case (DLRM embedding tables) plus the linear family.
_BANKABLE = {OperatorType.OP_EMBEDDING, OperatorType.OP_LINEAR}


# params that only size the WEIGHT (never the output): members of a
# padded family may differ in them
_PAD_FREE_PARAMS = {OperatorType.OP_EMBEDDING: ("num_entries",)}


def _signature(layer, family: bool = False):
    """Two layers may share a bank iff their signatures match: same op,
    same params, same input/output shapes+dtypes (so their emits are
    vmappable over a stacked leading dim). With ``family=True``,
    weight-sizing params (``_PAD_FREE_PARAMS``) are excluded — members
    then differ only in weight shape and are pad-stackable."""
    skip = _PAD_FREE_PARAMS.get(layer.op_type, ()) if family else ()
    return (layer.op_type,
            tuple(sorted((k, v) for k, v in layer.params.items()
                         if not callable(v) and k not in skip)),
            tuple((tuple(t.shape), t.dtype) for t in layer.inputs),
            tuple((tuple(t.shape), t.dtype) for t in layer.outputs))


def find_bank_groups(layers: Sequence,
                     allow_padded: bool = True) -> List[List]:
    """Groups of >= 2 mutually independent bankable layers sharing a
    signature (or, with ``allow_padded``, a signature family — see
    :class:`BankSpec`). Independence: no member's output (transitively)
    feeds another member — guaranteed here by requiring every member's
    inputs to be produced before the FIRST member (or be graph inputs),
    which also lets the executor emit the whole group at the first
    member's position."""
    by_sig: Dict[tuple, List] = {}
    produced_at: Dict[int, int] = {}    # tensor guid -> producer index
    for i, l in enumerate(layers):
        for t in l.outputs:
            produced_at[t.guid] = i
    pos = {l.name: i for i, l in enumerate(layers)}
    for l in layers:
        if l.op_type not in _BANKABLE:
            continue
        if len(l.outputs) != 1 or len(l.inputs) != 1:
            continue
        by_sig.setdefault(_signature(l, family=allow_padded), []).append(l)
    groups = []
    for sig, ls in by_sig.items():
        if len(ls) < 2:
            continue
        first = min(pos[l.name] for l in ls)
        ok = [l for l in ls
              if all(produced_at.get(t.guid, -1) < first
                     for t in l.inputs)]
        if len(ok) >= 2:
            groups.append(sorted(ok, key=lambda l: pos[l.name]))
    return groups


def group_is_padded(group: Sequence) -> bool:
    """True when the group's members differ in exact signature (weight
    shapes) and need pad-stacking."""
    return len({_signature(l) for l in group}) > 1


@dataclasses.dataclass
class PlaceGroup:
    """K mutually-independent ops of ARBITRARY (mixed) types, each
    placed on its own contiguous block of the ``axis`` coordinates —
    member k owns coords [k*P/K, (k+1)*P/K). The executor lowers the
    group as one shard_map region that ``lax.switch``es on the block
    coordinate, so each device EXECUTES only its member's branch
    (MPMD-inside-SPMD) and the members run concurrently; outputs rejoin
    by an exact masked psum over the axis.

    Complements :class:`BankSpec`: banks distribute both compute AND
    weights for signature-family groups (stacking); a PlaceGroup
    handles heterogeneous op types, trading replicated weights for
    generality — the compute-placement half of the reference's
    arbitrary per-op MachineView (machine_view.h:14-62)."""
    members: List[str]
    axis: str

    def machine_views(self, dmesh) -> Dict[str, MachineView]:
        names = list(dmesh.axis_sizes.keys())
        sizes = [dmesh.axis_sizes[a] for a in names]
        P_ = dmesh.axis_sizes[self.axis]
        K = len(self.members)
        if P_ % K != 0:
            raise ValueError(f"place axis {self.axis} size {P_} must "
                             f"divide into {K} members")
        grid = np.arange(int(np.prod(sizes))).reshape(sizes)
        ax = names.index(self.axis)
        coord = np.indices(grid.shape)[ax]
        out: Dict[str, MachineView] = {}
        per = P_ // K
        for k, m in enumerate(self.members):
            ids = np.sort(grid[(coord >= k * per)
                               & (coord < (k + 1) * per)].ravel())
            out[m] = _ids_to_view(ids)
        return out


def choose_bank_axes(dmesh, k_members: int,
                     reserved: Sequence[str] = ()
                     ) -> Optional[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """Pick mesh axes for the bank dim: the largest realizable degree
    that divides K (so members spread evenly), leaving the remaining
    axes for batch parallelism inside each subset. Returns
    ``(bank_axes, batch_axes)`` or None."""
    reserved = tuple(reserved)
    best = None
    for d in sorted(dmesh.valid_degrees(), reverse=True):
        if d <= 1 or k_members % d != 0:
            continue
        ax = dmesh.allocate_axes(d, reserved)
        if ax is not None:
            best = ax
            break
    if best is None:
        return None
    batch = tuple(a for a in dmesh.axis_sizes
                  if a not in best and a not in reserved)
    return tuple(best), batch


def stack_members(members: Sequence[Dict[str, torch.Tensor]],
                  padded: bool) -> Dict[str, torch.Tensor]:
    """A bank's stacked weights from its members' (in bank order):
    ``(K, ...)`` per weight name, each member zero-padded to the largest
    shape when the bank is ``padded`` (a lookup never reads past its own
    table)."""
    out = {}
    for wn in members[0]:
        arrs = [m[wn] for m in members]
        if padded:
            tgt = [max(a.shape[d] for a in arrs)
                   for d in range(arrs[0].dim())]
            arrs = [torch.nn.functional.pad(
                a, [x for d in reversed(range(a.dim()))
                    for x in (0, tgt[d] - a.shape[d])])
                if list(a.shape) != tgt else a for a in arrs]
        out[wn] = torch.stack(arrs)
    return out


def unstack_members(leaf: torch.Tensor, shapes: Sequence[Sequence[int]]
                    ) -> List[torch.Tensor]:
    """Each member's weight from a whole stacked leaf ``(K, ...)``: member
    k at [k], cut to its own ``shapes[k]`` (a padded bank's rows past a
    member's table dropped)."""
    return [leaf[k][tuple(slice(0, n) for n in shape)]
            for k, shape in enumerate(shapes)]


def _dims(mesh, names) -> List[int]:
    order = list(mesh.mesh_dim_names)
    return [order.index(a) for a in names]


def _flat_all_reduce(ts: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The sum over ``group`` of each tensor of ``ts`` (one f32 buffer for
    the floating ones; other dtypes one call each)."""
    import torch.distributed as dist
    out = list(ts)
    flt = [i for i, t in enumerate(ts) if t.dtype == torch.float32]
    if flt:
        buf = torch.cat([ts[i].reshape(-1) for i in flt])
        dist.all_reduce(buf, group=group)
        off = 0
        for i in flt:
            n = ts[i].numel()
            out[i] = buf[off:off + n].view_as(ts[i])
            off += n
    for i, t in enumerate(ts):
        if i not in flt:
            t = t.contiguous().clone()
            dist.all_reduce(t, group=group)
            out[i] = t
    return out


def _vjp(outs, ins, gs) -> List[Optional[torch.Tensor]]:
    """Gradients of ``outs`` against ``gs`` with respect to ``ins`` (those
    that require it); zeros where unused. The inner graph is kept: a
    value that reaches the loss by two paths (a pipeline's region and a
    skip past it) brings two backward passes through the function."""
    want = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad(outs, want, gs, allow_unused=True,
                                   retain_graph=True)
               if want and outs else [])
    res = []
    for t in ins:
        if not t.requires_grad:
            res.append(None)
            continue
        g = next(got)
        res.append(torch.zeros_like(t) if g is None else g)
    return res


class _Bank(torch.autograd.Function):
    """A bank's members on this rank's rows: ``run(k, x, w)`` computes
    member ``k`` on its input and its weight block; the rank computes its
    own members (``own``), and the stacked outputs are gathered over the
    bank group (``rejoin_stack``). Backward: each own member's gradients;
    an input's gradient summed over the bank group (its owner alone
    contributes), so it is the same on every rank there; the weight
    blocks' summed over the batch group (each rank saw its rows).

    Each own member's weights are leaves of their own (views of the
    rank's stacked block), and the backward runs one member at a time
    into one gradient of the stacked block: a member taken by indexing
    the stacked leaf would make a full-size gradient of the stack a
    member, before autograd sums them."""

    @staticmethod
    def forward(ctx, meta, *flat):
        run, K, own, bank_g, batch_g = meta
        xs, ws = list(flat[:K]), list(flat[K:])
        with torch.enable_grad():
            xd = [x.detach().requires_grad_(x.is_floating_point())
                  for x in xs]
            wd = [[w.detach()[j].requires_grad_(True) for w in ws]
                  for j in range(len(own))]
            outs = [run(k, xd[k], wd[j]) for j, k in enumerate(own)]
        ctx.saved = (outs, xd, wd, ws, K, own, bank_g, batch_g)
        stacked = torch.stack([o.detach() for o in outs])
        full = rejoin_stack(stacked, bank_g, K)
        return tuple(full[k] for k in range(K))

    @staticmethod
    def backward(ctx, *g_outs):
        outs, xd, wd, ws, K, own, bank_g, batch_g = ctx.saved
        gx: List[Optional[torch.Tensor]] = [
            torch.zeros_like(x) if x.requires_grad else None for x in xd]
        gw = [torch.zeros_like(w) for w in ws]
        for j, k in enumerate(own):
            grads = _vjp([outs[j]], [xd[k]] + wd[j],
                         [g_outs[k].contiguous()])
            if grads[0] is not None:
                gx[k] = grads[0]
            for i, g in enumerate(grads[1:]):
                gw[i][j] = g
            del grads
        idx = [k for k in range(K) if gx[k] is not None]
        if idx and bank_g is not False:
            for k, g in zip(idx, _flat_all_reduce([gx[k] for k in idx],
                                                  bank_g)):
                gx[k] = g
        if gw and batch_g is not False:
            gw = _flat_all_reduce(gw, batch_g)
        return (None, *gx, *gw)


def rejoin_stack(stacked: torch.Tensor, bank_group, k_members: int):
    """The stacked outputs of this rank's members, ``(K / degree, ...)``,
    gathered over the bank group into ``(K, ...)`` (bank coordinate
    order): where the banked outputs rejoin the rest of the graph. The
    JAX package gathers only the bank dim through its reshard planner;
    this is that one all-gather."""
    import torch.distributed as dist
    if bank_group is False:
        return stacked
    flat = stacked.reshape(stacked.shape[0], -1).contiguous()
    out = flat.new_empty((k_members, flat.shape[1]))
    dist.all_gather_into_tensor(out, flat, group=bank_group)
    return out.reshape((k_members,) + tuple(stacked.shape[1:]))


def shard_stack(x, mesh, batch_dims: Sequence[int]) -> torch.Tensor:
    """A member's input (a DTensor) as this rank's plain block in the
    bank's layout: its rows over the batch axes, whole over the bank
    axes. Its gradient must be the same on every rank of the bank axes,
    which ``_Bank`` makes it."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(0) if d in batch_dims else Replicate()
          for d in range(mesh.ndim)]
    if tuple(x.placements) != tuple(pl):
        x = x.redistribute(mesh, pl)
    return x.to_local()


def _group(mesh, dims):
    """The c10d group over ``dims`` (False where there are none)."""
    from .distributed import mesh_group
    if not dims:
        return False
    return mesh_group(mesh, dims)[0]


def emit_bank(bk: BankSpec, members, xs, weights: Dict[str, object],
              run: Callable, mesh) -> List:
    """The outputs of a bank's members (DTensors over ``mesh``, rows laid
    out over the batch axes) from their inputs ``xs`` (DTensors) and the
    stacked weights ``weights`` (name -> a DTensor ``(K, ...)`` sharded
    over the bank axes). ``run(k, x, [w ...])`` computes member ``k`` on
    plain tensors, the weight blocks in ``weights``' order. Each rank
    computes only its own members."""
    from torch.distributed.tensor import Replicate, Shard
    from .distributed import mesh_group
    from .local_ops import from_local
    K = len(members)
    bank_dims = _dims(mesh, bk.axes)
    batch_dims = _dims(mesh, bk.batch_axes)
    rows = members[0].inputs[0].shape[0] if members[0].inputs[0].shape \
        else 0
    nb = 1
    for d in batch_dims:
        nb *= mesh.size(d)
    if not rows or rows % nb:
        batch_dims = []
    _, deg, coord = mesh_group(mesh, bank_dims)
    if K % deg:
        raise ValueError(f"bank degree {deg} must divide member count {K}")
    per = K // deg
    own = list(range(coord * per, (coord + 1) * per))
    x_loc = [shard_stack(x, mesh, batch_dims) for x in xs]
    names = list(weights)
    w_loc = [weights[n].to_local() for n in names]
    outs = _Bank.apply((lambda k, x, w: run(k, x, dict(zip(names, w))),
                        K, own, _group(mesh, bank_dims),
                        _group(mesh, batch_dims)), *x_loc, *w_loc)
    pl = [Shard(0) if d in batch_dims else Replicate()
          for d in range(mesh.ndim)]
    return [from_local(o, mesh, pl, tuple(m.outputs[0].shape))
            for o, m in zip(outs, members)]


class _Place(torch.autograd.Function):
    """A place group's members on whole (replicated) inputs: this rank
    runs its own member (``mine``), contributes its output where it is
    the member's one contributor (``first``: the first rank of the
    owning block, at coordinate 0 on every other axis), and every output
    is summed over the world: exact, and the same on every rank.
    Backward: the own member's gradients, contributed the same way and
    summed, so every input's and weight's gradient is exact and the same
    on every rank."""

    @staticmethod
    def forward(ctx, meta, *flat):
        run, K, mine, first, n_x, w_counts, out_like = meta
        xs = list(flat[:n_x])
        ws, off = [], n_x
        for c in w_counts:
            ws.append(list(flat[off:off + c]))
            off += c
        with torch.enable_grad():
            xd = [x.detach().requires_grad_(x.is_floating_point())
                  for x in xs]
            wd = [w.detach().requires_grad_(True) for w in ws[mine]]
            out = run(mine, xd[mine], wd)
        ctx.saved = (out, xd, wd, mine, first, w_counts, flat[n_x:])
        outs = [torch.zeros(s, dtype=dt, device=xs[0].device)
                for s, dt in out_like]
        if first:
            outs[mine] = out.detach().to(out_like[mine][1])
        return tuple(_flat_all_reduce(outs, None))

    @staticmethod
    def backward(ctx, *g_outs):
        out, xd, wd, mine, first, w_counts, w_all = ctx.saved
        ins = [xd[mine]] + wd
        grads = _vjp([out], ins, [g_outs[mine].to(out.dtype)])
        gx = [torch.zeros_like(x) if x.requires_grad else None for x in xd]
        gw = [torch.zeros_like(w) for w in w_all]
        if first:
            if grads[0] is not None:
                gx[mine] = grads[0]
            off = sum(w_counts[:mine])
            for i, g in enumerate(grads[1:]):
                gw[off + i] = g
        idx = [i for i, g in enumerate(gx) if g is not None]
        for i, g in zip(idx, _flat_all_reduce([gx[i] for i in idx], None)):
            gx[i] = g
        gw = _flat_all_reduce(gw, None) if gw else gw
        return (None, *gx, *gw)


def emit_place_group(pg: PlaceGroup, members, xs, weights, run: Callable,
                     mesh) -> List:
    """The outputs of a place group's members (DTensors over ``mesh``,
    replicated) from their inputs ``xs`` (DTensors, made whole) and
    weights ``weights[i]`` (name -> a replicated DTensor). ``run(i, x,
    [w ...])`` computes member ``i`` on plain tensors. Each rank executes
    only its own member, the one its block of ``pg.axis`` owns."""
    from torch.distributed.tensor import Replicate
    from .local_ops import from_local
    K = len(members)
    ax = _dims(mesh, [pg.axis])[0]
    P_ = mesh.size(ax)
    if P_ % K != 0:
        raise ValueError(f"place axis {pg.axis} size {P_} must divide "
                         f"into {K} members")
    per = P_ // K
    coord = mesh.get_coordinate()
    mine = coord[ax] // per
    first = coord[ax] % per == 0 and all(
        c == 0 for d, c in enumerate(coord) if d != ax)
    rep = [Replicate()] * mesh.ndim
    x_loc = [(x if tuple(x.placements) == tuple(rep)
              else x.redistribute(mesh, rep)).to_local() for x in xs]
    names = [list(w) for w in weights]
    out_like = []
    from ..dtypes import to_torch
    for m in members:
        t = m.outputs[0]
        out_like.append((tuple(t.shape), to_torch(t.dtype)))
    flat_w = [t for i in range(K) for t in
              (weights[i][n].to_local() for n in names[i])]
    outs = _Place.apply((lambda i, x, w: run(i, x, dict(zip(names[i], w))),
                         K, mine, first, K, [len(n) for n in names],
                         out_like), *x_loc, *flat_w)
    return [from_local(o, mesh, rep, like[0])
            for o, like in zip(outs, out_like)]
