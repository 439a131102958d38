"""Planned layout transitions: gather, all-to-all and slice steps.

The port of ``flexflow_tpu/parallel/reshard.py``. A transition ``src
layout -> dst layout`` of a DTensor is lowered to a short sequence of
portable collective steps with explicit semantics (after "Memory-
efficient array redistribution through portable collective
communication", arXiv 2112.01075):

  - ``gather``   all-gather a suffix of a dim's mesh axes (the dim's
                 minor-most shard factors), growing the local shard;
  - ``alltoall`` move one mesh axis from one dim's sharding to another's
                 at constant per-rank memory;
  - ``slice``    slice a dim locally by new mesh axes (no traffic).

The planner enumerates the JAX package's candidate orderings (all-to-all
first, gather first, and the naive gather-everything-then-slice
baseline), scores each for time and peak transient memory with the
port's cost model (``OpCostModel.reshard_step_cost``; the calibrated
collective rows answer first), and runs the winner on the local shards
with ``torch.distributed`` collectives over each mesh axis's process
group (``distributed.gather_dim`` / ``all_to_all_dim``, which autograd
differentiates). Plans are cached per
(mesh, src, dst, itemsize, shape class) in memory and in
``reshard_plans.json`` under the port's cache directory.

The executor's per-op output constraint (:func:`constrain_output`) sends
the layout ops' (``LAYOUT_OPS``) replicated -> sharded transitions
through the planner and every other one through DTensor's
``redistribute``. ``FF_NAIVE_RESHARD=1`` sends them all through
``redistribute``. Every transition counts into :data:`STATS` and the
``ff_reshard_bytes_total`` / ``ff_reshard_plans_total{kind=...}``
counters of the port's registry.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ffconst import OperatorType
from ..obs import events as obs_events
from ..obs.metrics_registry import REGISTRY

#: ops whose transitions on replicated inputs go through the planner
LAYOUT_OPS = frozenset({
    OperatorType.OP_RESHAPE, OperatorType.OP_TRANSPOSE,
    OperatorType.OP_CONCAT, OperatorType.OP_SPLIT, OperatorType.OP_FLAT,
    OperatorType.OP_SLICE, OperatorType.OP_PAD, OperatorType.OP_REVERSE,
    OperatorType.OP_SQUEEZE, OperatorType.OP_UNSQUEEZE,
})


def naive_reshard() -> bool:
    """``FF_NAIVE_RESHARD=1``: every transition through DTensor's own
    ``redistribute``. Read per call."""
    return os.environ.get("FF_NAIVE_RESHARD", "").lower() \
        in ("1", "true", "yes", "on")


# ----------------------------------------------------------------------
# layout normalization
# ----------------------------------------------------------------------

def norm_spec(spec, rank: int) -> Tuple[Tuple[str, ...], ...]:
    """A spec -> per-dim tuples of mesh axes, padded to ``rank``. ``None``
    (no constraint) normalizes to fully replicated."""
    dims: List[Tuple[str, ...]] = []
    if spec is not None:
        for e in tuple(spec):
            if e is None:
                dims.append(())
            elif isinstance(e, (tuple, list)):
                dims.append(tuple(e))
            else:
                dims.append((e,))
    while len(dims) < rank:
        dims.append(())
    return tuple(dims[:rank])


def to_spec(norm: Sequence[Tuple[str, ...]]) -> Tuple:
    """The inverse of :func:`norm_spec`: trailing replicated dims dropped,
    as the JAX package's ``PartitionSpec`` prints them."""
    entries: List[Any] = []
    for d in norm:
        entries.append(None if not d else d[0] if len(d) == 1 else tuple(d))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def layout_key(norm: Sequence[Tuple[str, ...]]) -> str:
    return "|".join("+".join(d) if d else "-" for d in norm)


def placements_spec(placements, dmesh, rank: int
                    ) -> Tuple[Tuple[str, ...], ...]:
    """The normalized spec of DTensor ``placements`` (mesh dims in order,
    so a dim's axes come major first). Partial counts as replicated: a
    caller resolves it before planning."""
    from torch.distributed.tensor import Shard
    dims: List[List[str]] = [[] for _ in range(rank)]
    for name, p in zip(dmesh.axis_names, placements):
        if isinstance(p, Shard):
            dims[p.dim % rank].append(name)
    return tuple(tuple(d) for d in dims)


# ----------------------------------------------------------------------
# step vocabulary + plans
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Step:
    """One portable collective in a lowering plan. ``axes`` are mesh
    axes in major -> minor order; for ``alltoall`` the axis moves from
    ``src_dim``'s sharding (where it is minor-most) onto ``dim``'s
    (appended minor-most)."""
    kind: str                       # "gather" | "alltoall" | "slice"
    dim: int
    axes: Tuple[str, ...]
    src_dim: int = -1               # alltoall only

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "dim": self.dim,
                "axes": list(self.axes), "src_dim": self.src_dim}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Step":
        return cls(d["kind"], int(d["dim"]), tuple(d["axes"]),
                   int(d.get("src_dim", -1)))


@dataclasses.dataclass
class ReshardPlan:
    """A scored lowering of one src -> dst transition."""
    src: Tuple[Tuple[str, ...], ...]
    dst: Tuple[Tuple[str, ...], ...]
    steps: List[Step]
    est_time_s: float = 0.0
    peak_bytes: float = 0.0         # per-rank transient working set
    naive_peak_bytes: float = 0.0   # the gather-everything baseline's
    kind: str = "searched"          # "searched" | "naive" | "constraint"

    def describe(self) -> List[str]:
        out = []
        for s in self.steps:
            if s.kind == "alltoall":
                out.append(f"alltoall[{'+'.join(s.axes)}] "
                           f"dim{s.src_dim}->dim{s.dim}")
            else:
                out.append(f"{s.kind}[{'+'.join(s.axes)}] dim{s.dim}")
        return out


def _candidate_steps(src, dst, priority: Sequence[str]
                     ) -> Optional[List[Step]]:
    """Greedy lowering of src -> dst under a step-kind priority order (the
    JAX package's walk, step for step). A dim is only gathered over the
    suffix of its axes beyond its common prefix with the target, slices
    append minor-most axes in target order, and an all-to-all moves one
    minor-most axis onto the next axis its target dim needs. None when
    the walk cannot reach ``dst``."""
    cur = [list(d) for d in src]
    tgt = [list(d) for d in dst]
    ndim = len(cur)
    steps: List[Step] = []

    def prefix_len(d):
        k = 0
        while k < len(cur[d]) and k < len(tgt[d]) \
                and cur[d][k] == tgt[d][k]:
            k += 1
        return k

    def find_move() -> Optional[Step]:
        for i in range(ndim):
            if len(cur[i]) <= prefix_len(i):
                continue
            a = cur[i][-1]
            for j in range(ndim):
                if j == i or cur[j] != tgt[j][:len(cur[j])]:
                    continue
                if len(cur[j]) < len(tgt[j]) \
                        and tgt[j][len(cur[j])] == a:
                    return Step("alltoall", dim=j, axes=(a,), src_dim=i)
        return None

    def find_gather() -> Optional[Step]:
        for i in range(ndim):
            k = prefix_len(i)
            if len(cur[i]) > k:
                return Step("gather", dim=i, axes=tuple(cur[i][k:]))
        return None

    def find_slice() -> Optional[Step]:
        used = {a for c in cur for a in c}
        for j in range(ndim):
            if cur[j] != tgt[j][:len(cur[j])]:
                continue
            pend = tgt[j][len(cur[j]):]
            take: List[str] = []
            for a in pend:
                if a in used:
                    break
                take.append(a)
            if take:
                return Step("slice", dim=j, axes=tuple(take))
        return None

    finders = {"alltoall": find_move, "gather": find_gather,
               "slice": find_slice}
    while cur != tgt:
        step = None
        for kind in priority:
            step = finders[kind]()
            if step is not None:
                break
        if step is None:
            return None
        steps.append(step)
        if step.kind == "gather":
            del cur[step.dim][len(cur[step.dim]) - len(step.axes):]
        elif step.kind == "slice":
            cur[step.dim].extend(step.axes)
        else:
            cur[step.src_dim].pop()
            cur[step.dim].append(step.axes[0])
        if len(steps) > 8 * ndim + 8:       # safety against livelock
            return None
    return steps


def _naive_steps(src, dst) -> List[Step]:
    """The generic lowering: fully replicate, then slice to the
    destination."""
    steps: List[Step] = []
    for i, axes in enumerate(src):
        if axes:
            steps.append(Step("gather", dim=i, axes=tuple(axes)))
    for j, axes in enumerate(dst):
        if axes:
            steps.append(Step("slice", dim=j, axes=tuple(axes)))
    return steps


# ----------------------------------------------------------------------
# stats
# ----------------------------------------------------------------------

class ReshardStats:
    """Process-wide transition accounting, mirrored into the port's
    registry (``ff_reshard_*``): planned and executed lowerings by kind,
    host placements, and the bytes of the tensors that went through a
    transition (each counted at its global size, as in the JAX
    package)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        with self.lock:
            self.planned = 0
            self.plan_cache_hits = 0
            self.executed_searched = 0
            self.executed_naive = 0
            self.executed_redistribute = 0
            self.host_placements = 0
            self.bytes_total = 0.0

    def record(self, kind: str, nbytes: float):
        with self.lock:
            if kind == "searched":
                self.executed_searched += 1
            elif kind == "redistribute":
                self.executed_redistribute += 1
            else:
                self.executed_naive += 1
            self.bytes_total += nbytes
        REGISTRY.counter(
            "ff_reshard_plans_total",
            "Executed layout-transition lowerings by kind").inc(kind=kind)
        REGISTRY.counter(
            "ff_reshard_bytes_total",
            "Bytes moved through planned layout transitions").inc(
                max(nbytes, 0.0))
        obs_events.counter(f"reshard.{kind}")


STATS = ReshardStats()


def _nbytes(x) -> float:
    return float(x.numel() * x.element_size())


# ----------------------------------------------------------------------
# the planner
# ----------------------------------------------------------------------

class ReshardPlanner:
    """Plan and execute layout transitions on one mesh (the port's
    ``DeviceMesh``; execution needs it ``live``). ``cost_model`` is an
    ``OpCostModel``; by default one over the mesh's machine spec with the
    persisted calibration table attached read-only."""

    def __init__(self, dmesh, cost_model=None,
                 cache_dir: Optional[str] = None, persist: bool = True):
        from ..config import default_cache_dir
        self.dmesh = dmesh
        self._cm = cost_model
        self._cache_dir = cache_dir or default_cache_dir()
        self._memo: Dict[Tuple, ReshardPlan] = {}
        self._disk: Optional[Dict[str, Any]] = None
        self._persist = persist
        self.mesh_key = "x".join(
            f"{a}{s}" for a, s in dmesh.axis_sizes.items())

    @property
    def cost_model(self):
        if self._cm is None:
            from ..search.calibration import (CalibrationTable,
                                              MeshCalibration)
            from ..search.costmodel import OpCostModel, _backend
            cm = OpCostModel(self.dmesh.spec, cache_dir=self._cache_dir)
            # read-only: lookups answer from warm rows, misses fall to
            # the analytic ring model (no measurement from here)
            cm.calib = MeshCalibration(
                backend=_backend(self.dmesh),
                table=CalibrationTable(self._cache_dir))
            self._cm = cm
        return self._cm

    # -- disk plan cache ------------------------------------------------
    @property
    def _disk_path(self) -> str:
        return os.path.join(self._cache_dir, "reshard_plans.json")

    def _disk_cache(self) -> Dict[str, Any]:
        if self._disk is None:
            try:
                with open(self._disk_path) as f:
                    self._disk = json.load(f)
            except (OSError, ValueError):
                self._disk = {}
        return self._disk

    def _disk_put(self, key: str, doc: Dict[str, Any]) -> None:
        cache = self._disk_cache()
        cache[key] = doc
        if not self._persist:
            return
        os.makedirs(self._cache_dir, exist_ok=True)
        # one file per writer, then an atomic rename: ranks that plan the
        # same transition at once never read a half-written file
        tmp = f"{self._disk_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f)
        os.replace(tmp, self._disk_path)

    # -------------------------------------------------------------------
    def _divisible(self, norm, shape) -> bool:
        sizes = self.dmesh.axis_sizes
        for d, axes in enumerate(norm):
            deg = 1
            for a in axes:
                if a not in sizes:
                    return False
                deg *= sizes[a]
            if deg > 1 and (d >= len(shape) or shape[d] % deg != 0):
                return False
        return True

    def _score(self, steps: Sequence[Step], shape, itemsize: int,
               src) -> Tuple[float, float]:
        """(est time s, peak per-rank transient bytes) of a plan: both
        live buffers of the step in flight count toward the peak."""
        sizes = self.dmesh.axis_sizes
        cm = self.cost_model
        global_bytes = float(int(np.prod(shape)) * itemsize) \
            if shape else float(itemsize)
        deg = 1
        for axes in src:
            for a in axes:
                deg *= sizes[a]
        local = global_bytes / max(deg, 1)
        peak, t = local, 0.0
        for st in steps:
            g = 1
            for a in st.axes:
                g *= sizes[a]
            if st.kind == "gather":
                out_local = local * g
                t += cm.reshard_step_cost("all_gather", g, out_local,
                                          axes=st.axes)
            elif st.kind == "alltoall":
                out_local = local
                t += cm.reshard_step_cost("all_to_all", g, local * g,
                                          axes=st.axes)
            else:
                out_local = local / g
                t += cm.reshard_step_cost("slice", g, local)
            peak = max(peak, local + out_local)
            local = out_local
        return t, peak

    def plan(self, src_spec, dst_spec, shape, itemsize: int = 4
             ) -> ReshardPlan:
        """Choose the lowering for ``src_spec -> dst_spec`` on arrays of
        ``shape``: the fastest candidate whose peak does not exceed the
        naive baseline's. Cached in memory and on disk."""
        from ..search.calibration import shape_class
        rank = len(shape)
        src = norm_spec(src_spec, rank)
        dst = norm_spec(dst_spec, rank)
        if src == dst:
            return ReshardPlan(src, dst, [], kind="noop")
        if not (self._divisible(src, shape) and
                self._divisible(dst, shape)):
            # a layout the mesh cannot tile evenly: left to DTensor's
            # redistribution, before the cache (keyed by shape class)
            return ReshardPlan(src, dst, [], kind="constraint")
        nbytes = int(np.prod(shape)) * itemsize if shape else itemsize
        key = (self.mesh_key, layout_key(src), layout_key(dst),
               itemsize, shape_class(nbytes))
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        plan = self._plan_uncached(src, dst, shape, itemsize, key)
        self._memo[key] = plan
        return plan

    def _plan_uncached(self, src, dst, shape, itemsize, key
                       ) -> ReshardPlan:
        dkey = "|".join(str(k) for k in key)
        doc = self._disk_cache().get(dkey)
        naive = _naive_steps(src, dst)
        naive_t, naive_peak = self._score(naive, shape, itemsize, src)
        if doc is not None:
            obs_events.counter("reshard.plan_cache_hits")
            with STATS.lock:
                STATS.plan_cache_hits += 1
            steps = [Step.from_json(s) for s in doc["steps"]]
            t, peak = self._score(steps, shape, itemsize, src)
            return ReshardPlan(src, dst, steps, est_time_s=t,
                               peak_bytes=peak,
                               naive_peak_bytes=naive_peak,
                               kind=doc.get("kind", "searched"))
        with obs_events.span("reshard.plan", src=layout_key(src),
                             dst=layout_key(dst)):
            candidates: List[Tuple[float, float, List[Step], str]] = []
            for prio in (("alltoall", "slice", "gather"),
                         ("alltoall", "gather", "slice"),
                         ("gather", "slice", "alltoall")):
                steps = _candidate_steps(src, dst, prio)
                if steps is not None:
                    t, peak = self._score(steps, shape, itemsize, src)
                    candidates.append((t, peak, steps, "searched"))
            candidates.append((naive_t, naive_peak, naive, "naive"))
            ok = [c for c in candidates if c[1] <= naive_peak + 1e-9] \
                or candidates
            ok.sort(key=lambda c: (round(c[0], 9), c[1], len(c[2])))
            t, peak, steps, kind = ok[0]
        plan = ReshardPlan(src, dst, steps, est_time_s=t,
                           peak_bytes=peak, naive_peak_bytes=naive_peak,
                           kind=kind)
        with STATS.lock:
            STATS.planned += 1
        obs_events.counter("reshard.plans_created")
        self._disk_put(dkey, {"steps": [s.to_json() for s in steps],
                              "time_s": t, "peak_bytes": peak,
                              "kind": kind})
        obs_events.instant("reshard.plan_chosen", src=layout_key(src),
                           dst=layout_key(dst), steps=plan.describe(),
                           est_time_s=t, peak_bytes=peak,
                           naive_peak_bytes=naive_peak, kind=kind)
        return plan

    # -------------------------------------------------------------------
    def _run_step(self, xl, st: Step):
        """One step on this rank's local block, differentiable."""
        from .distributed import all_to_all_dim, gather_dim
        mesh = self.dmesh.mesh
        sizes = self.dmesh.axis_sizes
        if st.kind == "gather":
            # minor-most axis first: its blocks are the adjacent ones
            for a in reversed(st.axes):
                xl = gather_dim(xl, st.dim, mesh.get_group(a))
            return xl
        if st.kind == "alltoall":
            (a,) = st.axes
            return all_to_all_dim(xl, st.dim, st.src_dim, mesh.get_group(a))
        idx, deg = 0, 1
        coord = mesh.get_coordinate()
        names = list(self.dmesh.axis_names)
        for a in st.axes:
            idx = idx * sizes[a] + coord[names.index(a)]
            deg *= sizes[a]
        blk = xl.shape[st.dim] // deg
        return xl.narrow(st.dim, idx * blk, blk)

    def execute(self, x, plan: ReshardPlan):
        """Run a plan on DTensor ``x`` (laid out as ``plan.src``): the
        steps on its local block, the result a DTensor laid out as
        ``plan.dst``. Differentiable."""
        from torch.distributed.tensor import DTensor
        from .strategy import spec_placements
        rank = x.dim()
        dst_pl = spec_placements(to_spec(plan.dst), self.dmesh, rank)
        if plan.kind in ("constraint", "noop") or not plan.steps:
            STATS.record("redistribute" if plan.kind == "constraint"
                         else "searched", _nbytes(x))
            return x.redistribute(self.dmesh.mesh, dst_pl)
        # a mesh axis the source replicates and the destination splits is
        # sliced: each rank's gradient covers its block alone, a partial
        # sum over that axis
        from torch.distributed.tensor import Partial, Replicate
        grad_pl = [Partial() if isinstance(p, Replicate)
                   and not isinstance(q, Replicate) else p
                   for p, q in zip(x.placements, dst_pl)]
        xl = x.to_local(grad_placements=grad_pl)
        for st in plan.steps:
            xl = self._run_step(xl, st)
        out = DTensor.from_local(xl, self.dmesh.mesh, dst_pl,
                                 run_check=False, shape=x.shape,
                                 stride=x.stride())
        STATS.record("searched", _nbytes(x))
        return out

    def apply(self, x, dst_spec):
        """Plan (or load) and run the transition of DTensor ``x`` from its
        own layout to ``dst_spec``. A Partial input is summed first
        (``redistribute``), since the step vocabulary moves values and
        adds none. ``FF_NAIVE_RESHARD=1`` runs DTensor's
        ``redistribute`` instead."""
        from torch.distributed.tensor import Partial
        from .strategy import spec_placements
        mesh = self.dmesh.mesh
        if naive_reshard():
            STATS.record("naive", _nbytes(x))
            return x.redistribute(mesh, spec_placements(
                dst_spec, self.dmesh, x.dim()))
        if any(isinstance(p, Partial) for p in x.placements):
            x = x.redistribute(mesh, resolve_partial(x.placements))
        src = placements_spec(x.placements, self.dmesh, x.dim())
        plan = self.plan(src, dst_spec, tuple(x.shape), x.element_size())
        return self.execute(x, plan)


def resolve_partial(placements) -> List:
    """``placements`` with each Partial made Replicate (an all-reduce)."""
    from torch.distributed.tensor import Partial, Replicate
    return [Replicate() if isinstance(p, Partial) else p
            for p in placements]


# ----------------------------------------------------------------------
# executor hooks
# ----------------------------------------------------------------------

def planner_for(strategy) -> ReshardPlanner:
    """The per-strategy planner, built at first use."""
    pl = getattr(strategy, "resharder", None)
    if pl is None:
        pl = ReshardPlanner(strategy.dmesh)
        strategy.resharder = pl
    return pl


def tensor_spec(strategy, t):
    """The strategy-assigned spec of tensor ``t``: its producer's output
    spec, or the graph-input spec (None = unconstrained)."""
    if t.owner_layer is not None:
        return strategy.output_sharding(t.owner_layer.name, t.owner_idx)
    return strategy.inputs.get(t.name)


def _input_specs_replicated(strategy, layer) -> bool:
    for t in layer.inputs:
        spec = tensor_spec(strategy, t)
        if spec is not None and any(norm_spec(spec, len(t.shape))):
            return False
    return True


def constrain_output(o, spec, strategy, layer):
    """The executor's per-op output constraint over a live mesh. An
    unconstrained output (``spec`` None) keeps its layout, a Partial one
    summed. A layout op's output whose inputs are all replicated goes
    through the planner (a local slice, no traffic); every other
    transition through DTensor's ``redistribute``. Anything that is not
    a DTensor (a host value) passes unchanged."""
    from torch.distributed.tensor import DTensor
    from .strategy import spec_placements
    if not isinstance(o, DTensor):
        return o
    dmesh = strategy.dmesh
    if spec is None:
        want = resolve_partial(o.placements)
    else:
        want = spec_placements(spec, dmesh, o.dim())
    if list(o.placements) == list(want):
        return o
    if spec is not None and not naive_reshard() \
            and layer.op_type in LAYOUT_OPS \
            and _input_specs_replicated(strategy, layer) \
            and not any(placements_spec(o.placements, dmesh, o.dim())):
        return planner_for(strategy).apply(o, spec)
    STATS.record("naive" if naive_reshard() else "redistribute",
                 _nbytes(o))
    return o.redistribute(dmesh.mesh, want)


def place_host(arr, dmesh, spec, device=None, dtype=None):
    """Place one host array (numpy or torch) against ``spec`` on a live
    mesh: each rank keeps only its own block, so a sharded leaf never
    materializes whole on the device. A replicated spec keeps the whole
    array on every rank."""
    from .distributed import put_global
    from .strategy import spec_placements
    pl = spec_placements(spec, dmesh, len(arr.shape))
    out = put_global(arr, dmesh.mesh, pl, device=device, dtype=dtype)
    with STATS.lock:
        STATS.host_placements += 1
    if any(norm_spec(spec, len(arr.shape))):
        STATS.record("naive" if naive_reshard() else "searched",
                     float(np.prod(arr.shape)) * out.element_size())
    return out
