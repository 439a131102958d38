"""Communication-computation overlap: the bucketed gradient sync.

The port of ``flexflow_tpu/runtime/overlap.py``. Weighted layers are
grouped into size-bucketed launch groups in reverse program order (the
order backward completes them): consecutive layers join a bucket until
``FFConfig.overlap_bucket_mb`` of gradient bytes accumulate, a giant
layer gets a bucket of its own, many small ones coalesce. The schedule
and its record are the JAX package's, field for field.

Where the JAX package chains the buckets with ``optimization_barrier``
tokens and leaves the interleaving to XLA's scheduler, eager PyTorch
needs a real schedule (:class:`BucketedSync`): a hook on every parameter
leaf (``Tensor.register_hook``, which fires under ``torch.autograd.grad``
with the leaf's whole gradient) notes each gradient as backward produces
it; when a bucket is complete, and every bucket before it has launched,
its sync starts asynchronously (``async_op=True``) while backward goes
on: one flat all-reduce of the bucket, or under ZeRO one reduce-scatter
of its blocks. After backward, each bucket in order waits for its sync,
runs its update (the fused Adam kernel: one launch a bucket) and, under
ZeRO, all-gathers its updated weight blocks: at once with
``zero_prefetch`` >= 1, so a bucket's gather overlaps the next bucket's
update, or all at the end with 0. The adds of a flat all-reduce are the
per-leaf all-reduce's, so the result is the serial step's bit for bit on
two ranks. With gradient accumulation the buckets wait for the last
micro-batch, whose hooks add the earlier micro-batches' sums first.

``FFConfig.overlap`` is ``"auto"`` by default, which reads ``FF_OVERLAP``
and is off when unset: the serial step stays the default. A pipeline
gets no schedule (the ``overlap.pipeline_fallbacks`` counter); bank and
place-group members are left to the unscheduled tail; an optimizer
state that is not ``{slot: {layer: {weight: leaf}}}`` takes one update
(:func:`overlapped_update`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["GradBucket", "OverlapSchedule", "overlap_enabled",
           "build_overlap_schedule", "overlapped_update", "BucketedSync"]

#: default gradient-bucket size (MiB) when FFConfig carries no knob
DEFAULT_BUCKET_MB = 4


def overlap_enabled(cfg=None) -> bool:
    """``FFConfig.overlap`` "on"/"off" wins; "auto" (and no config) reads
    ``FF_OVERLAP`` and defaults off."""
    mode = str(getattr(cfg, "overlap", "auto") or "auto").lower()
    if mode in ("on", "true", "1", "yes"):
        return True
    if mode in ("off", "false", "0", "no"):
        return False
    return os.environ.get("FF_OVERLAP", "").lower() \
        in ("1", "true", "yes", "on")


@dataclasses.dataclass
class GradBucket:
    """One grad-sync launch group: ``order`` is the launch position (0 =
    first, the deepest layers), ``members`` the layers whose weights
    update together, ``nbytes`` the bucket's gradient payload."""
    order: int
    members: List[str]
    nbytes: int

    def to_json(self) -> Dict[str, Any]:
        return {"order": self.order, "members": list(self.members),
                "nbytes": int(self.nbytes)}


@dataclasses.dataclass
class OverlapSchedule:
    """The executable bucket schedule and its record."""
    buckets: List[GradBucket]
    bucket_bytes: int
    zero_prefetch: int

    def record(self) -> Dict[str, Any]:
        """JSON form carried as ``strategy.overlap``."""
        return {"enabled": True,
                "bucket_bytes": int(self.bucket_bytes),
                "zero_prefetch": int(self.zero_prefetch),
                "buckets": [b.to_json() for b in self.buckets]}


def _weight_bytes(layer) -> int:
    import numpy as np
    from ..dtypes import itemsize
    return sum(int(np.prod(w.shape)) * itemsize(w.dtype)
               for w in layer.weights or ())


def build_overlap_schedule(program, strategy, config
                           ) -> Optional[OverlapSchedule]:
    """The bucketed grad-sync schedule of one program, or None when
    overlap is off or a pipeline region owns the schedule. An imported
    record (``strategy.overlap``) is honored verbatim."""
    if not overlap_enabled(config):
        return None
    if getattr(strategy, "pipeline", None) is not None:
        from ..obs import events as obs_events
        obs_events.counter("overlap.pipeline_fallbacks")
        return None
    rec = getattr(strategy, "overlap", None)
    if rec and rec.get("buckets"):
        buckets = [GradBucket(int(b.get("order", i)),
                              list(b.get("members") or ()),
                              int(b.get("nbytes", 0)))
                   for i, b in enumerate(rec["buckets"])]
        buckets.sort(key=lambda b: b.order)
        return OverlapSchedule(
            buckets,
            int(rec.get("bucket_bytes", DEFAULT_BUCKET_MB << 20)),
            max(0, int(rec.get("zero_prefetch", 1))))
    grouped: set = set()
    for bk in getattr(strategy, "banks", None) or ():
        grouped.update(bk.members)
    for pg in getattr(strategy, "place_groups", None) or ():
        grouped.update(pg.members)
    try:
        cap_mb = float(getattr(config, "overlap_bucket_mb",
                               DEFAULT_BUCKET_MB))
    except (TypeError, ValueError):
        cap_mb = float(DEFAULT_BUCKET_MB)
    if cap_mb <= 0:
        cap_mb = float(DEFAULT_BUCKET_MB)
    cap = max(1, int(cap_mb * (1 << 20)))
    prefetch = max(0, int(getattr(config, "zero_prefetch", 1)))

    from ..ops import ensure_weight_specs
    weighted: List[Tuple[str, int]] = []
    for layer in program.layers:
        if layer.name in grouped or not ensure_weight_specs(layer):
            continue
        weighted.append((layer.name, _weight_bytes(layer)))
    if not weighted:
        return None
    buckets: List[GradBucket] = []
    members: List[str] = []
    acc = 0
    for name, nb in reversed(weighted):
        if members and acc + nb > cap:
            buckets.append(GradBucket(len(buckets), members, acc))
            members, acc = [], 0
        members.append(name)
        acc += nb
    if members:
        buckets.append(GradBucket(len(buckets), members, acc))
    return OverlapSchedule(buckets, cap, prefetch)


def _subtree(tree: Dict[str, Any], names: Sequence[str]) -> Dict[str, Any]:
    return {k: tree[k] for k in names if k in tree}


def _state_subtree(opt_state: Dict[str, Any], names: Sequence[str]
                   ) -> Dict[str, Any]:
    keep = set(names)
    return {slot: {k: v for k, v in layers.items() if k in keep}
            for slot, layers in opt_state.items()}


def _splittable_state(opt_state) -> bool:
    """The bucketed update partitions a ``{slot: {layer: {w: leaf}}}``
    tree by layer; anything else takes one update."""
    return isinstance(opt_state, dict) and all(
        isinstance(layers, dict) for layers in opt_state.values())


def bucket_names(schedule: OverlapSchedule, params) -> List[List[str]]:
    """Each bucket's layers present in ``params``, in launch order, then
    the unscheduled tail (when any)."""
    claimed: set = set()
    out = []
    for bucket in schedule.buckets:
        names = [n for n in bucket.members if n in params]
        if names:
            claimed.update(names)
            out.append(names)
    tail = [k for k in params if k not in claimed]
    if tail:
        out.append(tail)
    return out


def overlapped_update(update: Callable, params, grads, opt_state, step,
                      schedule: OverlapSchedule):
    """Per-bucket updates in launch order on gradients already synced
    (the quantized-sync path, where the sync happened in
    ``sharded_grads``): ``update(params, grads, state, step)`` on each
    bucket's sub-trees, then once on the unscheduled tail. Identity math:
    every leaf sees the serial update. An optimizer state that cannot be
    split by layer takes one update."""
    if not _splittable_state(opt_state):
        return update(params, grads, opt_state, step)
    for names in bucket_names(schedule, params):
        update(_subtree(params, names), _subtree(grads, names),
               _state_subtree(opt_state, names), step)
    return params, opt_state


class _Leaf:
    """One parameter leaf's part in the bucketed sync."""

    def __init__(self, ln: str, wn: str, weight, zero):
        self.ln, self.wn, self.weight, self.zero = ln, wn, weight, zero
        self.local = None      # this micro-batch's local gradient
        self.placements_in = None
        self.kind = None       # ("ar", dims) / ("rs", dims) / ready / ...
        self.grad = None       # the update's gradient, after the wait


class BucketedSync:
    """The overlap schedule of one train step over a world of ranks.

    ``leaves``: ``(layer, weight, weight DTensor, ZeroLeaf or None)`` of
    every parameter in the params tree's order; ``buckets``: each
    bucket's leaf indices in launch order (:func:`bucket_names`).
    :meth:`hook` is registered on each leaf's differentiable copy before
    the last micro-batch's backward; :meth:`finish` completes what
    backward did not produce; :meth:`drain` waits, updates and gathers
    bucket by bucket."""

    def __init__(self, leaves, buckets: Sequence[Sequence[int]], mesh,
                 prefetch: int):
        self.leaves = [_Leaf(*x) for x in leaves]
        self.buckets = [list(b) for b in buckets]
        self.mesh = mesh
        self.prefetch = prefetch
        self.bucket_of = {i: k for k, b in enumerate(self.buckets)
                          for i in b}
        # leaves whose gradient backward never produced on the first
        # step: from the second step on their zeros are filled up front,
        # so they do not hold their buckets back until backward ends
        self.unused: Optional[set] = None

    # -- one step ------------------------------------------------------
    def begin(self, params, acc: Optional[List[Optional[torch.Tensor]]]
              ) -> None:
        """Reset for a step over ``params`` (the live tree); ``acc``
        holds each leaf's local gradient sum of the earlier micro-batches
        (None without accumulation)."""
        self.acc = acc
        for lf in self.leaves:
            lf.weight = params[lf.ln][lf.wn]
        self.pending = [None] * len(self.buckets)
        self.left = [len(b) for b in self.buckets]
        self.launched = 0
        self.seen = set()
        for lf in self.leaves:
            lf.local = lf.kind = lf.grad = None
        for i in sorted(self.unused or ()):
            self._arrive(i, None)

    def hook(self, i: int):
        def fn(g):
            self._arrive(i, g)
        return fn

    def finish(self) -> None:
        """After backward: zeros for each leaf it did not reach, then
        every bucket not launched yet, in order."""
        missed = [i for i in range(len(self.leaves)) if i not in self.seen]
        if self.unused is None:
            self.unused = set(missed)
        for i in missed:
            self._arrive(i, None)

    def _arrive(self, i: int, g) -> None:
        from ..parallel.local_ops import is_dtensor
        lf = self.leaves[i]
        self.seen.add(i)
        if g is None or not is_dtensor(g):
            lf.local = torch.zeros_like(lf.weight.to_local()) \
                if g is None else g
            lf.kind = "ready" if lf.zero is None else "slice"
        else:
            lf.local = g.to_local()
            lf.placements_in = g.placements
            lf.kind = self._kind(lf, g)
        if self.acc is not None and self.acc[i] is not None:
            lf.local = self.acc[i] + lf.local
        k = self.bucket_of[i]
        self.left[k] -= 1
        while self.launched < len(self.buckets) \
                and self.left[self.launched] == 0:
            self._launch(self.launched)
            self.launched += 1

    def _kind(self, lf: _Leaf, g) -> Any:
        """How a leaf's arriving gradient reaches its update layout."""
        from torch.distributed.tensor import Partial, Replicate
        gp, wp = tuple(g.placements), tuple(lf.weight.placements)
        if lf.zero is not None:
            m = lf.zero.mesh_dims
            if all(isinstance(gp[d], Partial) for d in m) and all(
                    gp[d] == wp[d] for d in range(len(wp)) if d not in m):
                return ("rs", m)
            return "slice" if gp == wp else "fallback"
        if gp == wp:
            return "ready"
        diff = [d for d in range(len(wp)) if gp[d] != wp[d]]
        if all(isinstance(gp[d], Partial) and isinstance(wp[d], Replicate)
               for d in diff):
            return ("ar", tuple(diff))
        return "fallback"

    def _launch(self, k: int) -> None:
        """Start bucket ``k``'s sync: one collective per kind."""
        import torch.distributed as dist
        from ..parallel.distributed import SYNC_STATS, mesh_group
        from .zero import reduce_scatter_blocks
        groups: Dict[Any, List[int]] = {}
        for i in self.buckets[k]:
            kind = self.leaves[i].kind
            if isinstance(kind, tuple):
                groups.setdefault(kind, []).append(i)
        works = []
        for kind, idx in groups.items():
            group = mesh_group(self.mesh, kind[1])[0]
            if kind[0] == "ar":
                flat = torch.cat([self.leaves[i].local.reshape(-1)
                                  for i in idx])
                SYNC_STATS.add(flat)
                works.append((dist.all_reduce(flat, group=group,
                                              async_op=True), kind, idx,
                              flat))
            else:
                work, blocks = reduce_scatter_blocks(
                    [self.leaves[i].local for i in idx],
                    [self.leaves[i].zero for i in idx], group,
                    async_op=True)
                works.append((work, kind, idx, blocks))
            for i in idx:       # the flat buffer holds it now
                self.leaves[i].local = None
        self.pending[k] = works

    def _wait(self, k: int, accum: int) -> None:
        """Wait for bucket ``k``'s sync and set each leaf's gradient in
        its update layout (divided by ``accum``)."""
        for work, kind, idx, out in self.pending[k]:
            work.wait()
            if kind[0] == "ar":
                off = 0
                for i in idx:
                    shape = self.leaves[i].weight.to_local().shape
                    n = shape.numel()
                    self.leaves[i].grad = out[off:off + n].view(shape)
                    off += n
            else:
                for i, blk in zip(idx, out):
                    self.leaves[i].grad = blk
        self.pending[k] = None
        for i in self.buckets[k]:
            lf = self.leaves[i]
            if lf.kind == "ready":
                lf.grad = lf.local
            elif lf.kind == "slice":
                lf.grad = lf.zero.own(lf.local).contiguous()
            elif lf.kind == "fallback":
                lf.grad = self._redistributed(lf)
            if accum > 1:
                lf.grad = lf.grad / accum

    def _redistributed(self, lf: _Leaf) -> torch.Tensor:
        """A gradient no flat collective takes: DTensor's own redistribute
        to the leaf's layout (then this rank's block under ZeRO)."""
        from ..parallel.local_ops import from_local
        w = lf.weight
        g = from_local(lf.local, w.device_mesh, lf.placements_in, w.shape)
        local = g.redistribute(w.device_mesh, w.placements).to_local()
        return local if lf.zero is None else lf.zero.own(local).contiguous()

    def drain(self, update: Callable, opt_state, step: int,
              accum: int) -> None:
        """Bucket by bucket in launch order: wait, update in place
        (``update(params, grads, state, step)`` on the bucket's local
        blocks), and under ZeRO gather the updated weight blocks."""
        from .zero import block_buffer, gather_blocks
        from ..parallel.distributed import mesh_group

        def gather(dims, zi, flat):
            return gather_blocks(flat, [self.leaves[i].zero for i in zi],
                                 [self.leaves[i].weight.to_local()
                                  for i in zi],
                                 mesh_group(self.mesh, dims)[0],
                                 async_op=True)
        held, issued = [], []
        for k, idx in enumerate(self.buckets):
            if self.prefetch >= 1:
                # at most ``prefetch`` buckets' gathers in flight: each
                # overlaps the next buckets' waits and updates
                while len(issued) > self.prefetch - 1:
                    work, finish = issued.pop(0)
                    work.wait()
                    finish()
            self._wait(k, accum)
            params, grads, state = {}, {}, {}
            zero: Dict[tuple, List[int]] = {}
            for i in idx:
                lf = self.leaves[i]
                if lf.zero is not None:
                    zero.setdefault(lf.zero.mesh_dims, []).append(i)
                else:
                    params.setdefault(lf.ln, {})[lf.wn] = \
                        lf.weight.to_local()
                grads.setdefault(lf.ln, {})[lf.wn] = lf.grad
                for slot, layers in opt_state.items():
                    state.setdefault(slot, {}).setdefault(lf.ln, {})[
                        lf.wn] = layers[lf.ln][lf.wn].to_local()
            for dims, zi in zero.items():
                flat, views = block_buffer(
                    [self.leaves[i].zero for i in zi],
                    self.leaves[zi[0]].weight.to_local())
                for i, v in zip(zi, views):
                    lf = self.leaves[i]
                    v.copy_(lf.zero.own(lf.weight.to_local()))
                    params.setdefault(lf.ln, {})[lf.wn] = v
                held.append((dims, zi, flat))
            update(params, grads, state, step)
            for i in idx:       # the bucket's gradients are spent
                self.leaves[i].local = self.leaves[i].grad = None
            if self.prefetch >= 1:
                issued += [gather(*h) for h in held]
                held = []
        issued += [gather(*h) for h in held]
        for work, finish in issued:
            work.wait()
            finish()
