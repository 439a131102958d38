"""Quantized gradient collectives: int8/fp8 gradient sync with error
feedback.

The port of ``flexflow_tpu/ops/quantized_collectives.py`` (EQuARX,
arXiv 2506.17615): an all-reduce whose wire payload is int8 or fp8 with
one f32 scale per :data:`QSYNC_CHUNK` elements, and error feedback: each
rank carries the quantization error it withheld as a residual and
re-injects it at the next step.

  - **collectives** (:func:`quantized_all_reduce`, :func:`phased_sync`):
    the JAX package's ``all_to_all`` + ``all_gather`` inside a
    ``shard_map`` become c10d's ``all_to_all_single`` (the reduce-scatter
    leg) and ``all_gather_into_tensor`` on the payload in its wire dtype
    (fp8 travels viewed as ``uint8``), over the process group of the
    mesh axes a phase names (``parallel/distributed.mesh_group``). The
    quantize and dequantize steps are plain torch ops, as they are
    ``jnp`` code there;
  - **plan** (:class:`QsyncPlan`, :func:`plan_qsync`): per gradient
    tensor, the wire dtype of each phase of its sync, scored by the cost
    model's :meth:`quantized_sync_quote`, serialized with the strategy;
  - **runtime** (:func:`runtime_schedule`, :func:`sharded_grads`): on a
    pure data-parallel program each rank computes its local gradient on
    its rows of the batch with local (non-DTensor) weights and the serial
    step's dropout masks (the JAX package draws each shard's own), then syncs
    every tensor on the plan's wire dtypes. The residual rides the
    optimizer state under :data:`RESIDUAL_SLOT`, one ``(1,) + shape``
    block a rank (a DTensor of global shape ``(degree,) + shape``).

A configuration the runtime cannot honor exactly (a sharded weight, a
stateful op, gradient accumulation, a pipeline, banks) keeps the
full-precision sync, with a warning and the ``qsync.runtime_fallbacks``
counter, as in the JAX package.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import events as obs_events

__all__ = ["RESIDUAL_SLOT", "QSYNC_CHUNK", "WIRE_ITEMSIZE", "QsyncPlan",
           "resolve_qsync_mode", "qsync_disabled", "resolve_qsync_wire",
           "wire_byte_scale", "quantize_chunked", "dequantize_chunked",
           "quantized_all_reduce", "phased_sync", "plan_qsync",
           "audit_record", "QsyncSchedule", "runtime_schedule",
           "init_residuals", "refit_residual", "strip_residual",
           "sharded_grads"]

#: reserved optimizer-state slot carrying the error-feedback residuals
RESIDUAL_SLOT = "qsync_residual"

QSYNC_MODES = ("off", "auto", "dcn_only", "all")

#: quantized-collective wire dtypes and their payload itemsize (the JAX
#: package keeps these in ``parallel/placement.py``)
WIRE_ITEMSIZE = {"int8": 1, "float8_e4m3": 1, "float8_e5m2": 1}

#: elements per quantization scale (one f32 scale rides per chunk)
QSYNC_CHUNK = 1024

_WIRE_DTYPES = {"int8": torch.int8, "float8_e4m3": torch.float8_e4m3fn,
                "float8_e5m2": torch.float8_e5m2}
_QMAX = {"int8": 127.0}


def wire_byte_scale(wire: Optional[str]) -> float:
    """Wire bytes over logical f32 bytes of one quantized leg: the narrow
    payload plus the per-chunk f32 scales. ``None`` (full precision) is
    1.0."""
    if not wire:
        return 1.0
    return (WIRE_ITEMSIZE[wire] + 4.0 / QSYNC_CHUNK) / 4.0


def resolve_qsync_mode(cfg=None) -> str:
    """The quantized-collectives opt-in: ``FF_QUANTIZED_COLLECTIVES``
    wins when set, else ``FFConfig.quantized_collectives``; default
    ``"off"``. ``"disable"`` also resolves off (see
    :func:`qsync_disabled` for its stronger meaning)."""
    env = os.environ.get("FF_QUANTIZED_COLLECTIVES", "").strip().lower()
    mode = env or str(getattr(cfg, "quantized_collectives", "off")
                      or "off").lower()
    if mode in ("", "false", "no", "0", "disable", "disabled"):
        mode = "off"
    if mode in ("true", "yes", "1", "on"):
        mode = "auto"
    if mode not in QSYNC_MODES:
        raise ValueError(f"unknown quantized_collectives mode {mode!r} "
                         f"(expected one of {QSYNC_MODES})")
    return mode


def qsync_disabled(cfg=None) -> bool:
    """True when quantization is EXPLICITLY disabled (the env var set to
    an off value, or ``quantized_collectives="disable"``, what
    ``--no-quantized-collectives`` parses to): an imported strategy's
    plan is then stripped (``FFModel._plan_qsync``), where the plain
    default ``"off"`` honors it."""
    env = os.environ.get("FF_QUANTIZED_COLLECTIVES", "").strip().lower()
    if env in ("off", "false", "no", "0", "disable", "disabled"):
        return True
    return str(getattr(cfg, "quantized_collectives", "") or "").lower() \
        in ("disable", "disabled")


def resolve_qsync_wire(cfg=None) -> str:
    """Wire dtype of quantized legs: ``FF_QSYNC_WIRE`` /
    ``FFConfig.qsync_wire``, default int8."""
    wire = os.environ.get("FF_QSYNC_WIRE", "").strip().lower() \
        or str(getattr(cfg, "qsync_wire", "int8") or "int8").lower()
    if wire not in WIRE_ITEMSIZE:
        raise ValueError(f"unknown qsync wire dtype {wire!r} "
                         f"(expected one of {sorted(WIRE_ITEMSIZE)})")
    return wire


# ---------------------------------------------------------------------------
# quantization and the collectives
# ---------------------------------------------------------------------------

def quantize_chunked(x: torch.Tensor, wire: str):
    """Per-chunk absolute-max quantization of a float tensor whose last
    dim is the chunk dim: ``(q, scale)``, ``q`` in the wire dtype and
    ``scale`` f32 broadcastable over the chunk. int8 rounds to nearest
    (ties to even) within +-127; fp8 is a direct cast after scaling to
    the format's finite max."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    dt = _WIRE_DTYPES[wire]
    qmax = _QMAX["int8"] if wire == "int8" else float(torch.finfo(dt).max)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    y = x / scale
    if wire == "int8":
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        q = y.to(dt)
    return q, scale


def dequantize_chunked(q: torch.Tensor, scale: torch.Tensor):
    return q.float() * scale


def _wire_view(q: torch.Tensor) -> torch.Tensor:
    """The payload as the collectives carry it: fp8 as its bytes."""
    return q.view(torch.uint8) \
        if q.dtype.is_floating_point and q.element_size() == 1 else q


def _exchange(q: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` along dim 0 of a wire payload or scales."""
    import torch.distributed as dist
    from ..parallel.distributed import SYNC_STATS
    out = torch.empty_like(q)
    SYNC_STATS.add(q)
    dist.all_to_all_single(_wire_view(out), _wire_view(q.contiguous()),
                           group=group)
    return out


def _gather(q: torch.Tensor, size: int, group) -> torch.Tensor:
    """``all_gather_into_tensor`` along dim 0 (rank order)."""
    import torch.distributed as dist
    from ..parallel.distributed import SYNC_STATS
    q = q.contiguous()
    out = q.new_empty((size * q.shape[0],) + tuple(q.shape[1:]))
    SYNC_STATS.add(q)
    dist.all_gather_into_tensor(_wire_view(out), _wire_view(q),
                                group=group)
    return out


def quantized_all_reduce(x: torch.Tensor, group, wire: str, degree: int,
                         index: int, residual: Optional[torch.Tensor]
                         = None):
    """Error-feedback quantized all-reduce (SUM) over ``group`` (of
    ``degree`` ranks, this one at ``index``): add the residual, pad to
    ``degree x QSYNC_CHUNK``, quantize per chunk, exchange the wire
    payload and scales (``all_to_all_single``: rank i receives every
    rank's chunks of segment i), sum in f32, requantize, fold the gather
    leg's requantization error into this rank's own segment of the
    residual, all-gather the wire payload, dequantize. Returns
    ``(sum_over_group, new_residual)``."""
    shape = x.shape
    flat = x.float().reshape(-1)
    if residual is not None:
        flat = flat + residual.float().reshape(-1)
    n = flat.numel()
    pad = (-n) % (degree * QSYNC_CHUNK)
    flat_p = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
    seg = flat_p.reshape(degree, -1, QSYNC_CHUNK)        # (d, k, C)
    k = seg.shape[1]
    q, s = quantize_chunked(seg, wire)
    r_new = flat_p - dequantize_chunked(q, s).reshape(-1)
    q2, s2 = _exchange(q, group), _exchange(s, group)
    red = dequantize_chunked(q2, s2).sum(dim=0)           # (k, C)
    qr, sr = quantize_chunked(red, wire)
    gerr = (red - dequantize_chunked(qr, sr)).reshape(-1)
    own = r_new[index * k * QSYNC_CHUNK:(index + 1) * k * QSYNC_CHUNK]
    own.add_(gerr)
    ag_q, ag_s = _gather(qr, degree, group), _gather(sr, degree, group)
    out = dequantize_chunked(ag_q, ag_s).reshape(-1)[:n].reshape(shape)
    return out, r_new[:n].reshape(shape)


def _active_phases(phases, mesh):
    """The phases of degree > 1: ``(group, wire, degree, index)``."""
    from ..parallel.distributed import mesh_group
    names = list(mesh.mesh_dim_names)
    out = []
    for axes, wire in phases:
        dims = [names.index(a) for a in axes if a in names]
        if not dims:
            continue
        group, d, idx = mesh_group(mesh, dims)
        if d > 1:
            out.append((group, wire, d, idx))
    return out


def phased_sync(x: torch.Tensor, phases: Sequence[Tuple[Tuple[str, ...],
                                                        Optional[str]]],
                mesh, residual: Optional[torch.Tensor] = None):
    """Gradient MEAN over the ordered inner-to-outer ``phases`` of
    ``mesh`` (a ``torch.distributed`` DeviceMesh with axes x0, x1 ...).
    Each phase is ``(axes, wire)``: ``wire=None`` is full precision, a
    wire name a quantized leg. Several phases run as the JAX package's
    hierarchical tree: inner legs reduce-scatter, the outermost leg
    all-reduces, the inner legs all-gather back, each leg's payload in
    its wire dtype; every quantized leg's error is accumulated at the
    offset of the window this rank owned at that depth. Returns
    ``(mean, new_residual)``; ``new_residual`` is ``residual`` when no
    phase quantizes."""
    import torch.distributed as dist
    shape = x.shape
    active = _active_phases(phases, mesh)
    total = 1
    for _, _, d, _ in active:
        total *= d
    if not active:
        return x, residual
    if not any(w for _, w, _, _ in active):
        from ..parallel.distributed import SYNC_STATS
        out = x.float().clone()
        for group, _, _, _ in active:
            SYNC_STATS.add(out)
            dist.all_reduce(out, group=group)
        return (out / total).to(x.dtype), residual
    if len(active) == 1:
        group, wire, d, idx = active[0]
        out, r_new = quantized_all_reduce(x, group, wire, d, idx,
                                          residual=residual)
        return out / total, r_new
    flat = x.float().reshape(-1)
    n = flat.numel()
    if residual is not None:
        flat = flat + residual.float().reshape(-1)
    pad = (-n) % (total * QSYNC_CHUNK)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    err = torch.zeros_like(flat)
    cur = flat
    start = 0
    starts: List[int] = []
    down, (last_g, last_wire, last_d, last_i) = active[:-1], active[-1]
    for group, wire, d, idx in down:
        seglen = cur.numel() // d
        if wire is None:
            nxt = cur.new_empty(seglen)
            dist.reduce_scatter_tensor(nxt, cur.contiguous(), group=group)
            cur = nxt
        else:
            q, s = quantize_chunked(cur.reshape(d, -1, QSYNC_CHUNK), wire)
            e = cur - dequantize_chunked(q, s).reshape(-1)
            err[start:start + e.numel()] += e
            q2, s2 = _exchange(q, group), _exchange(s, group)
            cur = dequantize_chunked(q2, s2).sum(dim=0).reshape(-1)
        start += idx * seglen
        starts.append(start)
    if last_wire is None:
        from ..parallel.distributed import SYNC_STATS
        cur = cur.contiguous()
        SYNC_STATS.add(cur)
        dist.all_reduce(cur, group=last_g)
    else:
        cur, e = quantized_all_reduce(cur, last_g, last_wire, last_d,
                                      last_i)
        err[start:start + e.numel()] += e.reshape(-1)
    deeper: List[int] = []
    p = last_d
    for _, _, d, _ in reversed(down):
        deeper.insert(0, p)
        p *= d
    for (group, wire, d, _), st, dp in zip(reversed(down), reversed(starts),
                                           reversed(deeper)):
        if wire is None:
            cur = _gather(cur, d, group)
        else:
            # the dp ranks sharing this window hold identical reduced
            # values: the identical error is scaled by 1/dp, so next
            # step's staged reduction sums the copies back to one
            q, s = quantize_chunked(cur.reshape(-1, QSYNC_CHUNK), wire)
            e = cur - dequantize_chunked(q, s).reshape(-1)
            err[st:st + e.numel()] += e / dp
            cur = dequantize_chunked(_gather(q, d, group),
                                     _gather(s, d, group)).reshape(-1)
    out = (cur[:n] / total).reshape(shape)
    return out, err[:n].reshape(shape)


# ---------------------------------------------------------------------------
# the per-tensor / per-phase plan
# ---------------------------------------------------------------------------

class QsyncPlan:
    """Per-tensor, per-phase wire-dtype plan for gradient sync, the JAX
    package's record key for key.

    ``decisions`` maps layer name -> weight name -> a record dict::

        {"wire": "int8" | "float8_e4m3" | "float8_e5m2" | None,
         "phases": [{"axes": [..], "tier": str, "wire": str | None}],
         "baseline_s": float,     # predicted full-precision sync cost
         "quantized_s": float}    # predicted cost of this plan
    """

    def __init__(self, decisions: Optional[Dict[str, Dict[str, Dict]]]
                 = None, mode: str = "auto", wire: str = "int8"):
        self.decisions: Dict[str, Dict[str, Dict]] = decisions or {}
        self.mode = mode
        self.wire = wire

    def record_for(self, layer: str, wname: str) -> Optional[Dict]:
        return self.decisions.get(layer, {}).get(wname)

    def phases_for(self, layer: str, wname: str
                   ) -> Optional[List[Tuple[Tuple[str, ...],
                                            Optional[str]]]]:
        rec = self.record_for(layer, wname)
        if rec is None:
            return None
        return [(tuple(p.get("axes") or ()), p.get("wire"))
                for p in rec.get("phases", ())]

    def quantized_params(self) -> List[Tuple[str, str]]:
        return [(lname, wname) for lname, ws in self.decisions.items()
                for wname, rec in ws.items()
                if any(p.get("wire") for p in rec.get("phases", ()))]

    def __len__(self) -> int:
        return sum(len(ws) for ws in self.decisions.values())

    def __bool__(self) -> bool:
        return len(self.quantized_params()) > 0

    def summary(self) -> Dict[str, Any]:
        q = self.quantized_params()
        return {
            "mode": self.mode, "wire": self.wire,
            "n_params": len(self), "n_quantized": len(q),
            "baseline_s_total": sum(
                rec.get("baseline_s", 0.0)
                for ws in self.decisions.values() for rec in ws.values()),
            "quantized_s_total": sum(
                rec.get("quantized_s", 0.0)
                for ws in self.decisions.values() for rec in ws.values()),
        }

    def to_json(self) -> Dict[str, Any]:
        return {"mode": self.mode, "wire": self.wire,
                "decisions": self.decisions}

    @classmethod
    def from_json(cls, doc: Optional[Dict[str, Any]]
                  ) -> Optional["QsyncPlan"]:
        if not doc:
            return None
        return cls(dict(doc.get("decisions", {})),
                   mode=str(doc.get("mode", "auto")),
                   wire=str(doc.get("wire", "int8")))


def _tier_phases(dmesh, strategy) -> List[Tuple[Tuple[str, ...], str]]:
    """Mesh axes grouped by hardware tier, innermost tier first: the
    phase skeleton the planner and the runtime share. The strategy's
    ``axis_tiers`` win; a tierless machine is one "ici" phase spanning
    every axis."""
    from ..parallel.topology import TIER_RANK
    sizes = dict(dmesh.axis_sizes)
    tiers = dict(getattr(strategy, "axis_tiers", None) or {})
    if not tiers:
        try:
            tiers = dict(dmesh.axis_tiers)
        except Exception:  # noqa: BLE001 — tierless machine
            tiers = {}
    by_tier: Dict[str, List[str]] = {}
    for a in sizes:
        by_tier.setdefault(tiers.get(a, "ici"), []).append(a)
    return [(tuple(by_tier[t]), t)
            for t in sorted(by_tier, key=lambda t: TIER_RANK.get(t, 99))]


def _grouped(strategy) -> set:
    grouped: set = set()
    for bk in getattr(strategy, "banks", None) or ():
        grouped.update(bk.members)
    for pg in getattr(strategy, "place_groups", None) or ():
        grouped.update(pg.members)
    return grouped


def plan_qsync(strategy, layers: Sequence, dmesh, cost_model, *,
               mode: str = "auto", wire: str = "int8"
               ) -> Optional[QsyncPlan]:
    """Plan per-tensor, per-phase gradient-sync precision for an adopted
    strategy: every trainable replicated weight's sync scored at full
    precision and with its legs quantized
    (``OpCostModel.quantized_sync_quote``). Only the gradient all-reduce
    of replicated weights may quantize; sharded weights and bank / place-
    group / pipeline state stay full precision. Returns None when nothing
    quantizes."""
    import time
    t0 = time.perf_counter()
    if mode == "off" or getattr(strategy, "pipeline", None) is not None:
        return None
    axis_sizes = dict(dmesh.axis_sizes)
    n_dev = int(np.prod(list(axis_sizes.values()) or [1]))
    if n_dev <= 1:
        return None
    from ..dtypes import itemsize
    from ..ops import ensure_weight_specs
    from ..runtime.zero import spec_degree
    grouped = _grouped(strategy)
    skeleton = _tier_phases(dmesh, strategy)
    if mode == "dcn_only" and not any(t == "dcn" for _, t in skeleton):
        return None
    ops = getattr(strategy, "ops", {})
    plan = QsyncPlan({}, mode=mode, wire=wire)
    for layer in layers:
        if layer.name in grouped or not getattr(layer, "trainable", True):
            continue
        if not ensure_weight_specs(layer):
            continue
        os_ = ops.get(layer.name)
        for w in layer.weights or ():
            wspec = os_.weights.get(w.name) if os_ is not None else None
            if spec_degree(wspec, axis_sizes) > 1:
                continue
            wbytes = float(int(np.prod(w.shape)) or 1) * itemsize(w.dtype)
            quote = cost_model.quantized_sync_quote(
                wbytes, n_dev, skeleton, mode=mode, wire=wire)
            if quote is None:
                continue
            base_s, quant_s, phase_wires = quote
            if not any(phase_wires):
                continue
            plan.decisions.setdefault(layer.name, {})[w.name] = {
                "wire": wire,
                "phases": [{"axes": list(axes), "tier": tier, "wire": pw}
                           for (axes, tier), pw in zip(skeleton,
                                                       phase_wires)],
                "baseline_s": float(base_s),
                "quantized_s": float(quant_s),
            }
    if not plan:
        return None
    from ..obs.metrics_registry import REGISTRY
    s = plan.summary()
    REGISTRY.counter(
        "ff_qsync_plans_total",
        "Quantized-collective plans adopted by mode").inc(mode=mode)
    REGISTRY.gauge(
        "ff_qsync_quantized_params",
        "Gradient tensors whose sync the last adopted plan "
        "quantized").set(s["n_quantized"])
    obs_events.record_span("qsync.plan", t0, time.perf_counter() - t0,
                           mode=mode, n_quantized=s["n_quantized"])
    return plan


def audit_record(plan: QsyncPlan) -> Dict[str, Any]:
    """The strategy audit's ``"quantized_sync"`` section: the summary and
    every tensor's per-phase wire choice with both predicted costs."""
    per_param = []
    for lname, ws in plan.decisions.items():
        for wname, rec in ws.items():
            per_param.append({
                "param": f"{lname}/{wname}",
                "wire": rec.get("wire"),
                "phases": [{"tier": p.get("tier"),
                            "wire": p.get("wire") or "float32"}
                           for p in rec.get("phases", ())],
                "baseline_s": rec.get("baseline_s", 0.0),
                "quantized_s": rec.get("quantized_s", 0.0),
            })
    return {**plan.summary(), "per_param": per_param}


# ---------------------------------------------------------------------------
# runtime: the explicit-sync training path
# ---------------------------------------------------------------------------

class QsyncSchedule:
    """The executable schedule: the plan and the mesh it syncs over."""

    def __init__(self, plan: QsyncPlan, dmesh):
        self.plan = plan
        self.axes: Tuple[str, ...] = tuple(dmesh.axis_sizes.keys())
        self.sizes: Dict[str, int] = dict(dmesh.axis_sizes)
        self.degree = int(np.prod(list(self.sizes.values()) or [1]))

    def phases_for(self, layer: str, wname: str
                   ) -> List[Tuple[Tuple[str, ...], Optional[str]]]:
        phases = self.plan.phases_for(layer, wname)
        if phases is None:
            return [(self.axes, None)]
        return phases


def runtime_schedule(program, strategy, config, dmesh
                     ) -> Optional[QsyncSchedule]:
    """The executable quantized-sync schedule, or None where the
    configuration cannot honor the plan exactly: the explicit path needs
    a pure data-parallel program (replicated weights, no pipeline, bank
    or place group, no stateful op, no gradient accumulation, a batch
    dim the world divides)."""
    plan = getattr(strategy, "qsync", None)
    if plan is None or not plan.quantized_params():
        return None

    def fallback(why: str) -> None:
        obs_events.counter("qsync.runtime_fallbacks")
        logging.getLogger("flexflow_tpu_torch").warning(
            "quantized-collectives plan present but the runtime path "
            "is ineligible (%s); keeping the implicit full-precision "
            "sync", why)

    if getattr(strategy, "pipeline", None) is not None:
        fallback("pipelined region")
        return None
    if (getattr(strategy, "banks", None)
            or getattr(strategy, "place_groups", None)):
        fallback("bank/place-group subsets")
        return None
    if max(getattr(config, "gradient_accumulation_steps", 1), 1) > 1:
        fallback("gradient accumulation")
        return None
    n = int(np.prod(list(dmesh.axis_sizes.values()) or [1]))
    if n <= 1:
        return None
    from . import get_op_def
    from ..runtime.zero import spec_degree
    axis_sizes = dict(dmesh.axis_sizes)
    ops = getattr(strategy, "ops", {})
    for layer in program.layers:
        os_ = ops.get(layer.name)
        for w in layer.weights or ():
            sp = os_.weights.get(w.name) if os_ is not None else None
            if spec_degree(sp, axis_sizes) > 1:
                fallback(f"sharded weight {layer.name}/{w.name}")
                return None
        state_spec = getattr(get_op_def(layer.op_type), "state_spec",
                             None)
        if state_spec is not None and state_spec(
                layer.params, [t.shape for t in layer.inputs],
                [t.dtype for t in layer.inputs]):
            fallback(f"stateful op {layer.name}")
            return None
    for t in program.input_tensors:
        if t.get_tensor() is not None:
            continue
        if not t.shape or t.shape[0] % n != 0:
            fallback(f"input {t.name} batch dim not divisible by {n}")
            return None
    return QsyncSchedule(plan, dmesh)


def init_residuals(schedule: QsyncSchedule, program, dmesh, device
                   ) -> Dict[str, Dict[str, Any]]:
    """Zero error-feedback residuals for every quantized tensor: global
    shape ``(degree,) + weight.shape`` f32, dim 0 split over every mesh
    axis, so each rank holds its own ``(1,) + shape`` row. Keyed like the
    params tree."""
    from torch.distributed.tensor import Shard
    from ..parallel.local_ops import from_local
    by_name = {l.name: l for l in program.layers}
    out: Dict[str, Dict[str, Any]] = {}
    mesh = dmesh.mesh
    for lname, wname in sorted(schedule.plan.quantized_params()):
        layer = by_name.get(lname)
        shapes = {w.name: tuple(w.shape) for w in
                  (layer.weights or ())} if layer is not None else {}
        if wname not in shapes:
            continue
        wshape = shapes[wname]
        local = torch.zeros((1,) + wshape, dtype=torch.float32,
                            device=device)
        out.setdefault(lname, {})[wname] = from_local(
            local, mesh, [Shard(0)] * mesh.ndim,
            (schedule.degree,) + wshape)
    return out


def refit_residual(arr: np.ndarray, new_degree: int) -> np.ndarray:
    """Re-fit a saved residual ``(d_old,) + shape`` to ``new_degree``
    sync participants, preserving the total withheld mass exactly:
    merging ranks sum-folds their rows, a growing world keeps the old
    rows and zero-fills the new ones, and a non-divisible change folds
    everything into row 0."""
    arr = np.asarray(arr, np.float32)
    d_old = arr.shape[0]
    if d_old == new_degree:
        return arr
    rest = arr.shape[1:]
    if d_old % new_degree == 0:
        return arr.reshape((new_degree, d_old // new_degree) + rest
                           ).sum(axis=1)
    out = np.zeros((new_degree,) + rest, np.float32)
    if new_degree % d_old == 0:
        out[:d_old] = arr
    else:
        out[0] = arr.sum(axis=0)
    return out


def strip_residual(opt_state):
    """``(residual_tree_or_None, opt_state_without_slot)``: the residuals
    leave the state before the optimizer update."""
    if not isinstance(opt_state, dict) or RESIDUAL_SLOT not in opt_state:
        return None, opt_state
    return (opt_state[RESIDUAL_SLOT],
            {k: v for k, v in opt_state.items() if k != RESIDUAL_SLOT})


def _sync_metrics(bm: Dict[str, torch.Tensor], n: int, group
                  ) -> Dict[str, torch.Tensor]:
    """Batch metrics over the world with their proper reductions: means
    average, counts sum, RMS combines in the square domain; one
    all-reduce."""
    import torch.distributed as dist
    from ..runtime import metrics as metrics_mod
    keys = list(bm)
    vec = torch.stack([(bm[k] * bm[k] if k in metrics_mod.RMS_KEYS
                        else bm[k]).float().reshape(()) for k in keys])
    dist.all_reduce(vec, group=group)
    out = {}
    for i, k in enumerate(keys):
        v = vec[i]
        if k in metrics_mod.COUNT_KEYS:
            out[k] = v
        elif k in metrics_mod.RMS_KEYS:
            out[k] = torch.sqrt(v / n)
        else:
            out[k] = v / n
    return out


def sharded_grads(executor, params, state, batch, step: int, residual):
    """The explicit-sync gradient: each rank computes its LOCAL gradient
    (forward and backward on its rows of the batch, weights as local
    plain tensors, ``EmitCtx.local_shape``, the serial step's dropout
    masks cut to its rows),
    then syncs every gradient tensor by :func:`phased_sync` on the plan's
    wire dtypes, its residual carried in and updated in place. Returns
    ``(grads, metrics)``: each gradient the whole mean as a plain tensor
    (every rank alike), the metrics synced."""
    from ..parallel.distributed import mesh_group
    from ..runtime.optimizers import tree_leaves
    sched: QsyncSchedule = executor._qsync
    mesh = executor.strategy.dmesh.mesh
    group, n, index = mesh_group(mesh, range(mesh.ndim))
    residual = residual or {}
    local = {ln: {wn: t.to_local() if hasattr(t, "to_local") else t
                  for wn, t in ws.items()} for ln, ws in params.items()}
    rows = {}
    glob = executor.config.batch_size
    for k, v in batch.items():
        b = v.shape[0]
        if b == glob:
            v = v[index * (b // n):(index + 1) * (b // n)]
        elif b * n != glob:
            raise ValueError(f"batch input {k!r} has {b} rows: neither "
                             f"the global batch {glob} nor a rank's "
                             f"{glob // n}")
        rows[k] = v
    g, bm = executor._local_grads(local, state, rows, step,
                                  (glob, index * (glob // n)))
    grads: Dict[str, Dict[str, torch.Tensor]] = {}
    for ln, wn, leaf in tree_leaves(g):
        r = residual.get(ln, {}).get(wn)
        r_local = None if r is None else r.to_local()
        out, r_new = phased_sync(leaf, sched.phases_for(ln, wn), mesh,
                                 residual=None if r_local is None
                                 else r_local[0])
        grads.setdefault(ln, {})[wn] = out.to(leaf.dtype)
        if r_local is not None and r_new is not None:
            r_local[0].copy_(r_new)
    return grads, _sync_metrics(bm, n, group)
