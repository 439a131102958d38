"""ZeRO-1 optimizer-state sharding over a world of ranks.

The port of ``flexflow_tpu/runtime/zero.py``. There, a ZeRO-sharded
moment is a sharding annotation and GSPMD lowers the update to
reduce-scatter(grad) + sharded update + all-gather(param). Here a
sharded moment is a DTensor with ``Shard(dim)`` over the mesh axes its
weight is replicated on (:func:`shard_optimizer_state`), and the train
step spells the three stages out with c10d collectives
(:func:`reduce_scatter_blocks`, :func:`gather_blocks`): the leaf's
partial gradient reduce-scattered to the moment's block, the optimizer
(the fused Adam kernel or the plain one) on each rank's blocks of
weight, gradient and moments, the updated weight blocks all-gathered
back into the weight's own layout. Every collective moves a whole group
of leaves as one flat buffer of ``(W, K)``: row ``j`` holds block ``j``
of every leaf, flattened.

Memory effect: Adam's m and v (2x params) and SGD momentum (1x) shrink
by the data-parallel degree.

Two entry modes, as in the JAX package:

  - **uniform** (``FFConfig.shard_optimizer_states``, ``--zero`` /
    ``--shard-optimizer-states``): every leaf takes its
    :func:`zero_spec`;
  - **per-parameter** (a :class:`ZeroAssignment` on the strategy, read
    from an imported strategy file): exactly the leaves it names shard,
    onto the axes it names. Planning one (``zero_policy`` ``auto`` /
    ``memory`` / ``all``, ``search/zero_plan.py``) is ROADMAP queue 1
    item 5.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..parallel.strategy import P


def _entries_of(spec, rank: int) -> List[Optional[Tuple[str, ...]]]:
    """Normalize a spec tuple / JSON-list spec to per-dim axis tuples
    (None = unsharded), padded to ``rank``."""
    out: List[Optional[Tuple[str, ...]]] = []
    for e in tuple(spec or ()):
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append(tuple(e))
        else:
            out.append((e,))
    out += [None] * (rank - len(out))
    return out[:rank]


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec consumes (flattened, in order)."""
    axes: List[str] = []
    for e in _entries_of(spec, len(tuple(spec or ()))):
        if e:
            axes.extend(e)
    return tuple(axes)


def spec_degree(spec, axis_sizes: Dict[str, int]) -> int:
    """Total shard degree of a spec (product of its axes' sizes)."""
    deg = 1
    for a in spec_axes(spec):
        deg *= axis_sizes.get(a, 1)
    return deg


def zero_spec(shape: Sequence[int], weight_spec,
              axis_sizes: Dict[str, int]) -> Optional[P]:
    """ZeRO spec for one state leaf of ``shape`` whose weight is placed
    by ``weight_spec``: shard the dim that absorbs the LARGEST total
    degree from the free (unused-by-this-leaf) mesh axes that divide it
    (ties: the larger dim). None when nothing can be (or need be)
    sharded. The spec never reuses an axis the weight's own spec
    consumes."""
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    if ndim == 0:
        return None
    spec = _entries_of(weight_spec, ndim)
    used: set = set()
    for e in spec:
        if e:
            used.update(e)
    free = sorted(((a, sz) for a, sz in axis_sizes.items()
                   if a not in used and sz > 1),
                  key=lambda t: -t[1])
    if not free:
        return None
    best_dim, best_axes, best_deg = None, None, 1
    for d in range(ndim):
        if spec[d] is not None:
            continue
        axes, rem, deg = [], shape[d], 1
        for a, sz in free:
            if rem % sz == 0:
                axes.append(a)
                rem //= sz
                deg *= sz
        if deg > best_deg or (deg == best_deg and best_dim is not None
                              and shape[d] > shape[best_dim]):
            best_dim, best_axes, best_deg = d, axes, deg
    if best_dim is None or not best_axes:
        return None
    out = [e if e is None else (e[0] if len(e) == 1 else tuple(e))
           for e in spec]
    out[best_dim] = tuple(best_axes) if len(best_axes) > 1 \
        else best_axes[0]
    return P(*out)


def dtensor_spec(x) -> Tuple:
    """The spec of a DTensor's placements (axis names x0, x1 ... of its
    mesh; a dim sharded over several mesh dims names them in mesh order);
    all None for a plain tensor."""
    from ..parallel.local_ops import is_dtensor
    out: List[Any] = [None] * x.ndim
    if not is_dtensor(x):
        return tuple(out)
    from torch.distributed.tensor import Shard
    names = x.device_mesh.mesh_dim_names or tuple(
        f"x{i}" for i in range(x.device_mesh.ndim))
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard):
            d = p.dim % x.ndim
            cur = out[d]
            out[d] = names[m] if cur is None else (
                (cur if isinstance(cur, tuple) else (cur,)) + (names[m],))
    return tuple(out)


def zero_sharding(x, axis_sizes) -> Optional[P]:
    """ZeRO spec for one live state leaf (a DTensor laid out as its
    weight): :func:`zero_spec` against the leaf's own placements."""
    if getattr(x, "ndim", 0) == 0:
        return None
    return zero_spec(x.shape, dtensor_spec(x), axis_sizes)


def opt_slots(optimizer) -> int:
    """Optimizer-state leaves per parameter: Adam-family keeps two
    moments, momentum-SGD one, plain SGD none. Unknown optimizers are
    costed at two (conservative)."""
    if optimizer is None:
        return 2
    name = type(optimizer).__name__.lower()
    if "adam" in name or "lamb" in name:
        return 2
    if "sgd" in name:
        return 1 if getattr(optimizer, "momentum", 0.0) else 0
    return 2


# ---------------------------------------------------------------------------
# per-parameter assignment
# ---------------------------------------------------------------------------
class ZeroAssignment:
    """Per-parameter optimizer-state sharding decisions, the JAX
    package's record key for key.

    ``decisions`` maps layer name -> weight name -> a record dict::

        {"spec": <spec JSON form or None>,   # None = replicate
         "degree": int,            # total absorbed shard degree
         "bytes_saved": float,     # per-device opt-state bytes saved
         "overhead_s": float,      # predicted marginal collective cost
         "replicated_s": float}    # predicted replicated-update cost

    The uniform ``--zero`` flag is the "all" assignment
    (:meth:`uniform`). Serializes with the strategy
    (``search/serialization.py``), so an imported assignment is honored
    verbatim.
    """

    def __init__(self, decisions: Optional[Dict[str, Dict[str, Dict]]]
                 = None, policy: str = "auto"):
        self.decisions: Dict[str, Dict[str, Dict]] = decisions or {}
        self.policy = policy

    def spec_for(self, layer: str, wname: str) -> Optional[P]:
        rec = self.decisions.get(layer, {}).get(wname)
        if rec is None or rec.get("spec") is None:
            return None
        return P(*[tuple(e) if isinstance(e, list) else e
                   for e in rec["spec"]])

    def degree_for(self, layer: str, wname: str) -> int:
        rec = self.decisions.get(layer, {}).get(wname)
        return int(rec.get("degree", 1)) if rec else 1

    def sharded_params(self) -> List[Tuple[str, str]]:
        return [(l, w) for l, ws in self.decisions.items()
                for w, rec in ws.items() if rec.get("spec") is not None]

    def __len__(self) -> int:
        return sum(len(ws) for ws in self.decisions.values())

    def __bool__(self) -> bool:
        return len(self.sharded_params()) > 0

    def is_uniform(self) -> bool:
        """True when every recorded parameter shards."""
        return len(self.sharded_params()) == len(self)

    @classmethod
    def uniform(cls, params_meta: Dict[str, Dict[str, Tuple]],
                strategy, axis_sizes: Dict[str, int]) -> "ZeroAssignment":
        """The "all" assignment: every leaf takes its :func:`zero_spec`
        against its weight's strategy placement."""
        out: Dict[str, Dict[str, Dict]] = {}
        for lname, ws in params_meta.items():
            os_ = getattr(strategy, "ops", {}).get(lname)
            for wname, shape in ws.items():
                wspec = os_.weights.get(wname) if os_ is not None else None
                sp = zero_spec(shape, wspec, axis_sizes)
                deg = 1
                if sp is not None:
                    for a in spec_axes(sp):
                        if a not in spec_axes(wspec):
                            deg *= axis_sizes.get(a, 1)
                out.setdefault(lname, {})[wname] = {
                    "spec": None if sp is None else
                    [list(e) if isinstance(e, tuple) else e for e in sp],
                    "degree": deg, "bytes_saved": 0.0,
                    "overhead_s": 0.0, "replicated_s": 0.0}
        return cls(out, policy="all")

    def to_json(self) -> Dict[str, Any]:
        return {"policy": self.policy, "decisions": self.decisions}

    @classmethod
    def from_json(cls, doc: Optional[Dict[str, Any]]
                  ) -> Optional["ZeroAssignment"]:
        if not doc:
            return None
        return cls(dict(doc.get("decisions", {})),
                   policy=str(doc.get("policy", "auto")))

    def summary(self) -> Dict[str, Any]:
        sharded = self.sharded_params()
        return {
            "policy": self.policy,
            "n_params": len(self),
            "n_sharded": len(sharded),
            "uniform": self.is_uniform(),
            "bytes_saved_total": sum(
                rec.get("bytes_saved", 0.0)
                for ws in self.decisions.values() for rec in ws.values()),
            "overhead_s_total": sum(
                rec.get("overhead_s", 0.0)
                for ws in self.decisions.values()
                for rec in ws.values() if rec.get("spec") is not None),
        }


# ---------------------------------------------------------------------------
# state placement
# ---------------------------------------------------------------------------
def _map_state_leaves(opt_state: Any, fn):
    """Apply ``fn(layer, wname, leaf)`` to every optimizer-state leaf of a
    ``{slot: {layer: {wname: leaf}}}`` tree; other structures pass."""
    if not isinstance(opt_state, dict):
        return opt_state
    out = {}
    for slot, layers in opt_state.items():
        if not isinstance(layers, dict):
            out[slot] = layers
            continue
        out[slot] = {lname: ({w: fn(lname, w, leaf) for w, leaf in ws.items()}
                             if isinstance(ws, dict) else ws)
                     for lname, ws in layers.items()}
    return out


def _mesh_order(spec, names: Sequence[str]):
    """``spec`` with each multi-axis entry in mesh order, the only order
    DTensor tiles a dim in (``strategy.spec_placements``)."""
    return tuple(tuple(sorted(e, key=names.index))
                 if isinstance(e, (tuple, list)) else e
                 for e in tuple(spec))


def place_zero(leaf, spec, dmesh):
    """``leaf`` (a DTensor laid out as its weight) re-laid per the ZeRO
    ``spec``: this rank keeps the contiguous block of its local value
    that the spec's extra axes give it; no collective."""
    from ..parallel.distributed import shard_bounds
    from ..parallel.local_ops import from_local
    from ..parallel.strategy import spec_placements
    spec = _mesh_order(spec, list(dmesh.axis_names))
    pl = spec_placements(spec, dmesh, leaf.ndim)
    bounds = shard_bounds(leaf.shape, dmesh.mesh, pl)
    mine = shard_bounds(leaf.shape, dmesh.mesh, leaf.placements)
    local = leaf.to_local()
    for d, ((lo, hi), (mlo, _)) in enumerate(zip(bounds, mine)):
        local = local.narrow(d, lo - mlo, hi - lo)
    return from_local(local.clone(), dmesh.mesh, pl, leaf.shape)


def shard_optimizer_state(opt_state: Any, strategy,
                          assignment: Optional[ZeroAssignment] = None
                          ) -> Any:
    """Re-place optimizer-state leaves with their ZeRO layouts.

    ``assignment=None`` is the uniform path (the ``--zero`` flag): every
    leaf takes its :func:`zero_sharding`; leaves with no free axis or no
    divisible dim stay as initialized. With an assignment, only the
    leaves it shards move."""
    dmesh = strategy.dmesh
    axis_sizes = dict(dmesh.axis_sizes)

    def place(lname, wname, leaf):
        spec = zero_sharding(leaf, axis_sizes) if assignment is None \
            else assignment.spec_for(lname, wname)
        return leaf if spec is None else place_zero(leaf, spec, dmesh)

    return _map_state_leaves(opt_state, place)


def state_constraints(opt_state: Any):
    """The placements of every state leaf: what the train step keeps each
    updated moment on (the update works in place, so they hold by
    construction; the executor reads the ZeRO layouts from them)."""
    return _map_state_leaves(
        opt_state, lambda l, w, x: tuple(getattr(x, "placements", ())))


def state_sharding_doc(opt_state: Any) -> Dict[str, Any]:
    """Per-leaf sharding record: key path (``['slot']['layer']['w']``, as
    the JAX package's ``keystr``) -> spec JSON form (None = replicated or
    a plain tensor)."""
    out: Dict[str, Any] = {}
    for slot, layers in (opt_state or {}).items():
        for lname, ws in layers.items():
            for wname, leaf in ws.items():
                spec = dtensor_spec(leaf)
                out[f"[{slot!r}][{lname!r}][{wname!r}]"] = None \
                    if all(e is None for e in spec) else \
                    [list(e) if isinstance(e, tuple) else e for e in spec]
    return out


# ---------------------------------------------------------------------------
# the three stages of a sharded update
# ---------------------------------------------------------------------------
#: the largest flat buffer one ZeRO collective of the serial step moves
#: (a leaf larger than it goes alone): the sync's temporaries stay far
#: below the moments it saves
ZERO_CHUNK_BYTES = 64 << 20


def chunks(items: Sequence, nbytes, cap: Optional[int] = None
           ) -> List[List]:
    """``items`` in order, cut into runs of at most ``cap`` bytes each
    (``ZERO_CHUNK_BYTES`` by default; ``nbytes(item)``), every run
    holding at least one item."""
    cap = ZERO_CHUNK_BYTES if cap is None else cap
    out: List[List] = []
    acc = 0
    for it in items:
        n = nbytes(it)
        if not out or acc + n > cap:
            out.append([])
            acc = 0
        out[-1].append(it)
        acc += n
    return out


class ZeroLeaf:
    """How one weight's optimizer state is split: dim ``dim`` of the
    weight's local value into ``size`` blocks over the mesh dims
    ``mesh_dims`` (mesh order, major first); this rank owns block
    ``index``."""

    def __init__(self, weight, moment):
        from torch.distributed.tensor import Replicate, Shard
        mesh = weight.device_mesh
        self.mesh_dims = tuple(
            m for m, (pw, pm) in enumerate(zip(weight.placements,
                                               moment.placements))
            if isinstance(pw, Replicate) and isinstance(pm, Shard))
        dims = {moment.placements[m].dim % moment.ndim
                for m in self.mesh_dims}
        if len(dims) != 1 or any(
                not isinstance(moment.placements[m], Shard)
                and pw != moment.placements[m]
                for m, pw in enumerate(weight.placements)):
            raise ValueError(f"moment placements {moment.placements} are "
                             f"not a ZeRO split of {weight.placements}")
        self.dim = dims.pop()
        self.local_shape = tuple(weight.to_local().shape)
        coord = mesh.get_coordinate()
        self.size, self.index = 1, 0
        for m in self.mesh_dims:
            self.size *= mesh.size(m)
            self.index = self.index * mesh.size(m) + coord[m]
        self.block = self.local_shape[self.dim] // self.size
        self.block_shape = tuple(self.block if i == self.dim else s
                                 for i, s in enumerate(self.local_shape))
        self.numel = int(torch.Size(self.block_shape).numel())

    def rows(self, full: torch.Tensor) -> torch.Tensor:
        """``(size, numel)``: row j is block j of ``full`` flattened."""
        d = self.dim
        split = full.reshape(self.local_shape[:d] + (self.size, self.block)
                             + self.local_shape[d + 1:])
        return split.movedim(d, 0).reshape(self.size, self.numel)

    def own(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a view)."""
        return full.narrow(self.dim, self.index * self.block, self.block)

    def unrows(self, rows: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`rows`: ``(size, numel)`` -> the full
        local shape."""
        d = self.dim
        return rows.reshape((self.size,) + self.block_shape).movedim(
            0, d).reshape(self.local_shape)


def reduce_scatter_blocks(fulls: Sequence[torch.Tensor],
                          layouts: Sequence[ZeroLeaf], group,
                          async_op: bool = False):
    """One reduce-scatter of several leaves' partial sums (each the full
    local value) over ``group``: returns ``(work, blocks)``, each rank's
    summed block of every leaf, contiguous, valid once ``work`` (None
    when synchronous) has been waited on."""
    import torch.distributed as dist
    from ..parallel.distributed import SYNC_STATS
    size = layouts[0].size
    flat = torch.cat([lay.rows(f) for f, lay in zip(fulls, layouts)],
                     dim=1) if len(fulls) > 1 else \
        layouts[0].rows(fulls[0]).contiguous()
    out = flat.new_empty((flat.shape[1],))
    SYNC_STATS.add(flat)
    work = dist.reduce_scatter_tensor(out, flat.reshape(size * out.numel()),
                                      group=group, async_op=async_op)
    blocks, off = [], 0
    for lay in layouts:
        blocks.append(out[off:off + lay.numel].view(lay.block_shape))
        off += lay.numel
    return work, blocks


def block_buffer(layouts: Sequence[ZeroLeaf], like: torch.Tensor):
    """One flat buffer holding a block of every leaf, and each leaf's
    block as a contiguous view of it: where the update writes the weight
    blocks that :func:`gather_blocks` sends (the fused Adam needs each
    contiguous; a block split along dim 1 is a strided view of its
    weight)."""
    flat = like.new_empty((sum(l.numel for l in layouts),))
    views, off = [], 0
    for lay in layouts:
        views.append(flat[off:off + lay.numel].view(lay.block_shape))
        off += lay.numel
    return flat, views


def gather_blocks(flat: torch.Tensor, layouts: Sequence[ZeroLeaf],
                  fulls: Sequence[torch.Tensor], group,
                  async_op: bool = False):
    """One all-gather of the blocks in ``flat`` (:func:`block_buffer`)
    over ``group`` into each leaf's full local value ``fulls[i]``, in
    place. Returns ``(work, finish)``: call ``finish()`` after waiting on
    ``work`` (None when synchronous) to write the gathered blocks."""
    import torch.distributed as dist
    from ..parallel.distributed import SYNC_STATS
    size = layouts[0].size
    out = flat.new_empty((size * flat.numel(),))
    SYNC_STATS.add(flat)
    work = dist.all_gather_into_tensor(out, flat, group=group,
                                       async_op=async_op)
    out = out.view(size, flat.numel())

    def finish():
        off = 0
        for lay, full in zip(layouts, fulls):
            full.copy_(lay.unrows(out[:, off:off + lay.numel]))
            off += lay.numel
    return work, finish
