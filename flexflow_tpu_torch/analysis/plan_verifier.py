"""Static plan verifier, the serving half.

The port of the serving checks of ``flexflow_tpu/analysis/
plan_verifier.py`` (check 8 there): a searched serving plan's
per-bucket op specs are mesh-sound, every KV-cache shard degree divides
its layer's KV-head count, the recorded per-layer KV bytes match the
declared geometry, seq-sharded KV names a mesh sequence axis of that
degree, and the decode-resident envelope (weights + KV cache + a live
activation pair) at the LARGEST bucket fits the machine's HBM. Failures
raise :class:`PlanVerificationError` naming the op; every run bumps the
``ff_plan_verify_*`` counters under a ``plan_verify.serving`` span.

The verifier's other checks (op-shard, seams, memory, collective
order, placement, ZeRO, quantized sync, kernels) and ``verify_plan`` /
``verify_model`` / ``verify_strategy_file`` are not ported yet (ROADMAP
queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import events as obs_events
from ..obs.metrics_registry import REGISTRY

__all__ = ["Finding", "PlanReport", "PlanVerificationError",
           "serving_envelope", "verify_serving_plan"]


# ---------------------------------------------------------------------------
# findings + report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Finding:
    """One verification finding, attributed to an op and (optionally) a
    seam. ``check`` is the engine that produced it (op-shard / seam /
    memory / collective-order), ``severity`` "error" or "warn"."""
    check: str
    severity: str
    op: str
    message: str
    seam: Optional[str] = None

    def format(self) -> str:
        where = f"{self.op}" + (f" @ {self.seam}" if self.seam else "")
        return f"[{self.check}] {where}: {self.message}"

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class PlanVerificationError(ValueError):
    """A strategy failed static verification. ``findings`` carries the
    error-severity findings, each attributed to an op/seam."""

    def __init__(self, findings: Sequence[Finding], context: str = ""):
        self.findings = [f for f in findings if f.severity == "error"]
        lines = [f.format() for f in self.findings]
        head = f"plan verification failed ({len(lines)} error(s))"
        if context:
            head += f" for {context}"
        super().__init__(head + ":\n  " + "\n  ".join(lines))


@dataclasses.dataclass
class PlanReport:
    """The result of one verification pass: findings plus the derived
    artifacts (memory breakdown, static collective schedule)."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    memory: Dict[str, float] = dataclasses.field(default_factory=dict)
    collectives: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    duration_s: float = 0.0

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warn"]

    def ok(self) -> bool:
        return not self.errors

    def add(self, check: str, severity: str, op: str, message: str,
            seam: Optional[str] = None) -> None:
        self.findings.append(Finding(check, severity, op, message, seam))

    def to_json(self) -> Dict[str, Any]:
        return {"findings": [f.to_json() for f in self.findings],
                "memory": dict(self.memory),
                "collectives": list(self.collectives),
                "duration_s": self.duration_s,
                "ok": self.ok()}

    def raise_if_failed(self, context: str = "") -> None:
        if not self.ok():
            raise PlanVerificationError(self.findings, context)


# ---------------------------------------------------------------------------
# spec helpers
# ---------------------------------------------------------------------------

def _spec_entries(spec) -> List[Tuple[str, ...]]:
    """Per-entry mesh-axis tuples of a PartitionSpec (or its JSON form),
    WITHOUT rank padding — used for rank/soundness checks."""
    out: List[Tuple[str, ...]] = []
    if spec is None:
        return out
    for e in tuple(spec):
        if e is None:
            out.append(())
        elif isinstance(e, (tuple, list)):
            out.append(tuple(e))
        else:
            out.append((e,))
    return out


def _check_spec(report: PlanReport, axis_sizes: Dict[str, int], op: str,
                what: str, spec, shape: Optional[Sequence[int]],
                seam: Optional[str] = None) -> None:
    """Mesh-axis soundness + divisibility of one PartitionSpec against
    one (possibly unknown) shape."""
    entries = _spec_entries(spec)
    if not entries:
        return
    seen: set = set()
    for axes in entries:
        for a in axes:
            if a not in axis_sizes:
                report.add("op-shard", "error", op,
                           f"{what} spec {spec} names unknown mesh axis "
                           f"{a!r} (mesh axes: {sorted(axis_sizes)})",
                           seam)
            elif a in seen:
                report.add("op-shard", "error", op,
                           f"{what} spec {spec} reuses mesh axis {a!r} "
                           f"(an axis may shard at most one dim)", seam)
            seen.add(a)
    if shape is None:
        return
    if len(entries) > len(shape):
        report.add("op-shard", "error", op,
                   f"{what} spec {spec} has {len(entries)} entries for a "
                   f"rank-{len(shape)} tensor of shape {tuple(shape)}",
                   seam)
        return
    for d, axes in enumerate(entries):
        deg = 1
        for a in axes:
            deg *= axis_sizes.get(a, 1)
        if deg > 1 and shape[d] % deg != 0:
            report.add("op-shard", "error", op,
                       f"{what} dim {d} of shape {tuple(shape)} is not "
                       f"divisible by its shard degree {deg} "
                       f"(axes {axes}) — this layout only executes via "
                       f"GSPMD's generic padded resharding", seam)


def _spec_degree(spec, axis_sizes: Dict[str, int]) -> int:
    """Total shard degree of a spec: the product of its axes' sizes (the
    JAX package's ``runtime/zero.spec_degree``)."""
    deg = 1
    for axes in _spec_entries(spec):
        for a in axes:
            deg *= axis_sizes.get(a, 1)
    return deg


def _json_spec(j):
    """JSON spec form -> spec tuple."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in j)



# ---------------------------------------------------------------------------
# check: per-(model, batch-class) serving plans
# ---------------------------------------------------------------------------

def _check_serving(report, serving_doc, by_name, axis_sizes, spec,
                   hbm_bytes) -> None:
    """Serving-block soundness: every bucket's KV-cache shard degree
    must divide the layer's KV-head count (a decode step cannot split
    a KV head across devices), the recorded per-layer KV bytes must
    match the declared geometry, each bucket's op specs must be
    mesh-sound, and the decode-resident envelope (weights + KV cache +
    live activations) at the LARGEST bucket must fit the machine's
    HBM. The memory gate is what makes a replicated-KV plan that only
    fits sharded fail typed at compile instead of OOMing on the first
    large-bucket request. ``serving_doc`` is always the JSON block
    (``ServingPlan.to_block`` form) — both the in-memory attach and
    ``load_strategy`` carry it that way."""
    try:
        buckets = {int(k): (v or {}) for k, v in
                   (serving_doc.get("buckets") or {}).items()}
    except (TypeError, ValueError):
        report.add("serving", "error", "<serving>",
                   "serving block bucket keys must be integers",
                   "serving-plan")
        return
    if not buckets:
        report.add("serving", "error", "<serving>",
                   "serving block carries no buckets", "serving-plan")
        return
    max_seq = int(serving_doc.get("max_seq") or 0)
    if max_seq <= 0:
        report.add("serving", "error", "<serving>",
                   "serving block has no max_seq (KV geometry is "
                   "unsized)", "serving-plan")
        return
    for bucket, sub in sorted(buckets.items()):
        ctx = f"bucket={bucket}"
        for name, os_ in (sub.get("ops") or {}).items():
            layer = by_name.get(name)
            for i, sp in enumerate(os_.get("outputs") or ()):
                if sp is None:
                    continue
                shape = None
                if layer is not None and i < len(layer.outputs):
                    shape = layer.outputs[i].shape
                _check_spec(report, axis_sizes, name,
                            f"serving[{ctx}] output[{i}]",
                            _json_spec(sp), shape)
            wsh = {w.name: tuple(w.shape)
                   for w in (getattr(layer, "weights", None) or ())}
            for wname, sp in (os_.get("weights") or {}).items():
                if sp is None:
                    continue
                _check_spec(report, axis_sizes, name,
                            f"serving[{ctx}] weight {wname!r}",
                            _json_spec(sp), wsh.get(wname),
                            seam="checkpoint-restore")
        for name, kv in (sub.get("kv") or {}).items():
            kv = kv or {}
            deg = int(kv.get("shard_degree") or 1)
            kvh = int(kv.get("num_kv_heads") or 0)
            hd = int(kv.get("head_dim") or 0)
            if by_name and name not in by_name:
                report.add("serving", "error", name,
                           f"serving[{ctx}]: KV entry names a layer "
                           f"absent from the program", "serving-kv")
                continue
            if deg < 1 or kvh <= 0 or kvh % deg != 0:
                report.add(
                    "serving", "error", name,
                    f"serving[{ctx}]: KV shard degree {deg} does not "
                    f"divide num_kv_heads {kvh} — a decode step cannot "
                    f"split a KV head across devices", "serving-kv")
                continue
            sdeg = int(kv.get("seq_shard_degree") or 1)
            if sdeg > 1:
                # seq-sharded KV only executes on a mesh whose sequence
                # axis carries the degree: the decode-step combine is a
                # ppermute rotation OVER that axis
                mesh_seq = int(axis_sizes.get("seq", 1) or 1)
                if mesh_seq % sdeg != 0 or mesh_seq < sdeg:
                    report.add(
                        "serving", "error", name,
                        f"serving[{ctx}]: KV seq shard degree {sdeg} "
                        f"needs a mesh sequence axis of that degree "
                        f"(mesh has seq={mesh_seq})", "serving-kv")
                    continue
                if max_seq and max_seq % sdeg != 0:
                    report.add(
                        "serving", "error", name,
                        f"serving[{ctx}]: KV seq shard degree {sdeg} "
                        f"does not divide max_seq {max_seq}",
                        "serving-kv")
                    continue
            want = (2 * bucket * max_seq * kvh * hd * 4) \
                // (deg * max(sdeg, 1))
            got = int(kv.get("bytes") or 0)
            if got and hd and got != want:
                report.add(
                    "serving", "error", name,
                    f"serving[{ctx}]: recorded KV bytes {got} disagree "
                    f"with the geometry 2*{bucket}*{max_seq}*{kvh}*"
                    f"{hd}*4/({deg}*{sdeg}) = {want}", "serving-kv")
    # decode-resident envelope at the LARGEST bucket. Needs the layer
    # list for weight/output shapes; spec-only strategy files verify
    # structurally above and skip the gate.
    if not hbm_bytes:
        hbm_bytes = getattr(spec, "hbm_bytes", None)
    if not by_name or not hbm_bytes:
        return
    bucket = max(buckets)
    env = serving_envelope(buckets[bucket], bucket, by_name, axis_sizes)
    total = env["envelope_bytes"]
    act_op = env["peak_activation_op"]
    if total > hbm_bytes:
        report.add(
            "serving", "error", act_op or "<model>",
            f"serving envelope at bucket {bucket} "
            f"{total / 2**20:.1f} MiB exceeds the machine model's "
            f"{hbm_bytes / 2**20:.1f} MiB HBM (weights "
            f"{env['weights_bytes'] / 2**20:.1f} MiB + KV cache "
            f"{env['kv_bytes'] / 2**20:.1f} MiB + 2 x peak activation "
            f"{env['peak_activation_bytes'] / 2**20:.1f} MiB [{act_op}])"
            f" — shard the KV cache (head-parallel attention, or "
            f"seq-sharded KV on a sequence-axis mesh) or drop the "
            f"bucket", "serving-memory")


def serving_envelope(sub: Dict, bucket: int, by_name: Dict,
                     axis_sizes: Dict[str, int]) -> Dict[str, float]:
    """Decode-resident per-device envelope of ONE bucket's serving
    sub-strategy (``ServingPlan.to_block()`` bucket form): sharded
    weights + resident KV cache + a live fwd activation pair, with
    activations rescaled from the compile batch to the bucket. No
    grads/optimizer terms — serving is forward-only. Shared by
    ``_check_serving``'s HBM gate and the serving search/smoke, so a
    plan adopted by the search verifies against the same arithmetic."""
    from ..dtypes import itemsize as _isz
    ops_doc = sub.get("ops") or {}
    params_local = 0.0
    kv_local = float(sum(int((kv or {}).get("bytes") or 0)
                         for kv in (sub.get("kv") or {}).values()))
    act_peak, act_op = 0.0, ""
    for name, layer in by_name.items():
        os_ = ops_doc.get(name) or {}
        wspecs = os_.get("weights") or {}
        for w in layer.weights or ():
            total = float(int(np.prod(w.shape)) or 1) * _isz(w.dtype)
            sp = wspecs.get(w.name)
            deg = _spec_degree(_json_spec(sp), axis_sizes) if sp else 1
            params_local += total / max(deg, 1)
        outs = os_.get("outputs") or ()
        local = 0.0
        for i, t in enumerate(layer.outputs):
            total = float(int(np.prod(t.shape)) or 1) * _isz(t.dtype)
            if t.shape and t.shape[0]:
                # activations were shaped at the compile batch; the
                # serving bucket is what is live at runtime
                total *= bucket / float(t.shape[0])
            sp = outs[i] if i < len(outs) else None
            deg = _spec_degree(_json_spec(sp), axis_sizes) if sp else 1
            local += total / max(deg, 1)
        if local > act_peak:
            act_peak, act_op = local, name
    return {
        "weights_bytes": params_local,
        "kv_bytes": kv_local,
        "peak_activation_bytes": act_peak,
        "peak_activation_op": act_op,
        "envelope_bytes": params_local + kv_local + 2 * act_peak,
    }


def verify_serving_plan(plan, layers: Sequence, dmesh, *,
                        hbm_bytes: Optional[float] = None,
                        context: str = "") -> PlanReport:
    """Verify a searched :class:`~flexflow_tpu_torch.search.
    serving_plan.ServingPlan` (or its serialized ``serving`` block) against the
    program and mesh it was searched for. Raises a typed
    :class:`PlanVerificationError` on error findings — called by
    ``optimize_serving_strategy`` before a plan is exported and by the
    serving smoke gate."""
    t0 = time.perf_counter()
    report = PlanReport()
    axis_sizes: Dict[str, int] = dict(getattr(dmesh, "axis_sizes", {}))
    spec = getattr(dmesh, "spec", None)
    by_name = {l.name: l for l in layers}
    block = plan.to_block() if hasattr(plan, "to_block") else dict(plan)
    _check_serving(report, block, by_name, axis_sizes, spec, hbm_bytes)
    report.duration_s = time.perf_counter() - t0
    REGISTRY.counter("ff_plan_verify_runs_total",
                     "Static plan verification passes").inc()
    for f in report.findings:
        REGISTRY.counter("ff_plan_verify_findings_total",
                         "Plan verification findings by check"
                         ).inc(check=f.check)
    obs_events.record_span("plan_verify.serving", t0, report.duration_s,
                           findings=len(report.findings),
                           errors=len(report.errors),
                           context=context or "")
    report.raise_if_failed(context or "the serving plan")
    return report
