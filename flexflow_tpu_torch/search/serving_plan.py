"""Inference-native strategy search: per-batch-class serving plans.

The port of ``flexflow_tpu/search/serving_plan.py``: the same objective,
walk and plan files (a plan written by either package loads in the
other). The training search optimizes one objective, the training step
time; serving is latency-bound, batch shapes churn across the buckets
``InferenceSession`` pads to, and autoregressive decode carries a
resident per-layer KV cache the training cost model knows nothing
about. This module makes serving a search target of its own:

* **Objective** (``ServingCostEvaluator``): prefill cost + per-token
  decode-step LATENCY (not throughput), one evaluation per batch
  bucket. Decode-step collectives are priced latency-side through
  ``OpCostModel.decode_collective_cost`` (calibrated small-message rows,
  dispatch floor): nothing coalesces them across tokens.
* **KV cache as a resident tensor**: sized
  ``2 (K+V) x max_seq x bucket x num_kv_heads x head_dim`` f32 entries
  (respecting GQA; the port's cache holds the compute dtype, so under
  bf16 the budget is twice what it stores), sharded along the attention
  head-parallel degree, counted in the serving memory envelope
  (``analysis/plan_verifier``) and read once per decode step on the HBM
  side of the roofline.
* **Seq-sharded KV as a scored option** (long-prompt buckets): when the
  mesh carries a sequence axis (``DeviceMesh.seq_degree >= 2``), each
  cache-carrying layer may shard its KV cache over the context
  dimension, paid for by a per-step combine of partial attention
  outputs rotated over the seq axis; recorded as ``seq_shard_degree``
  in the KV plan and re-checked by the verifier.
* **Per-(model, batch-class) plans** (``optimize_serving_strategy``):
  one searched assignment per bucket, serialized as a ``serving`` block
  in the strategy file (``search/serialization.py``), audited and
  verified.

The one-device executor runs every plan unsharded; on a described mesh
the plans are searched, verified and exported (executing a multi-device
plan is ROADMAP queue 1 item 4).
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.layer import Layer
from ..dtypes import itemsize
from ..ffconst import OperatorType
from ..obs import audit as obs_audit
from ..obs import events as obs_events
from ..parallel.machine import DeviceMesh
from ..parallel.strategy import P, ShardingStrategy
from .costmodel import OpCostModel
from .opshard import ShardOption, assignment_to_sharding, options_for

#: default batch classes — the buckets InferenceSession pads to
DEFAULT_BUCKETS = (1, 4, 16, 64)

KV_DTYPE_BYTES = 4  # float32 cache entries, as the JAX package budgets


# ---------------------------------------------------------------------------
# KV cache geometry
# ---------------------------------------------------------------------------

def kv_cache_spec(layer: Layer) -> Optional[Dict[str, int]]:
    """KV-cache head geometry for a causal attention layer, or None for
    ops that carry no cache. GQA (``num_kv_heads < num_heads``) shrinks
    the cache — and caps how far it can shard."""
    if layer.op_type != OperatorType.OP_MULTIHEAD_ATTENTION:
        return None
    p = layer.params
    if not p.get("causal", False):
        return None
    embed = int(p["embed_dim"])
    num_heads = int(p["num_heads"])
    kv_heads = int(p.get("num_kv_heads", 0) or num_heads)
    return {"num_kv_heads": kv_heads,
            "head_dim": embed // max(num_heads, 1),
            "embed_dim": embed}


def kv_cache_bytes(layer: Layer, bucket: int, max_seq: int,
                   shard_degree: int = 1) -> int:
    """Resident K+V bytes for one attention layer at one batch bucket,
    per device when ``shard_degree`` shards the kv heads."""
    spec = kv_cache_spec(layer)
    if spec is None:
        return 0
    total = (2 * bucket * max_seq * spec["num_kv_heads"]
             * spec["head_dim"] * KV_DTYPE_BYTES)
    return total // max(int(shard_degree), 1)


def kv_shard_degree(layer: Layer, options: Sequence[ShardOption],
                    degrees: Sequence[int]) -> int:
    """KV-cache shard degree implied by an assignment: the cache co-
    shards with the attention head-parallel weights (the ``parameter``
    option), clamped to what GQA allows — a degree that does not divide
    ``num_kv_heads`` cannot split the kv heads, so the cache stays
    replicated (degree 1) and the envelope must budget for it."""
    spec = kv_cache_spec(layer)
    if spec is None:
        return 1
    for opt, d in zip(options, degrees):
        if opt.kind == "parameter" and d > 1:
            if d <= spec["num_kv_heads"] \
                    and spec["num_kv_heads"] % d == 0:
                return int(d)
            return 1
    return 1


# ---------------------------------------------------------------------------
# serving-objective evaluator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingCost:
    """One bucket's predicted serving profile. ``total`` is the search
    objective: prefill + decode_tokens × decode-step latency (with the
    infeasible-memory penalty folded in, like GraphCost.total)."""
    total: float
    prefill: float
    decode_step: float
    kv_bytes: int
    peak_memory: int
    decode_compute: float = 0.0
    decode_comm: float = 0.0


class ServingCostEvaluator:
    """Scores a per-op assignment under the serving objective for ONE
    batch bucket (the per-batch-class analog of
    ``mcmc.StrategySimulator``; shares its options/assignment
    vocabulary so proposals and strategy materialization reuse the
    training machinery)."""

    def __init__(self, layers: Sequence[Layer], dmesh: DeviceMesh,
                 cost_model: OpCostModel, bucket: int, max_seq: int,
                 decode_tokens: Optional[int] = None):
        self.layers = list(layers)
        self.dmesh = dmesh
        self.cost = cost_model
        self.bucket = int(bucket)
        self.max_seq = int(max_seq)
        self.decode_tokens = int(decode_tokens or max_seq)
        self.options: Dict[str, List[ShardOption]] = {
            l.name: options_for(l) for l in self.layers}
        # compile-time (batch, seq) the graph was built at — cost
        # scaling maps compile-shape op costs to serving shapes
        self.compile_batch, self.compile_seq = self._graph_shape()
        self._n_cache = sum(1 for l in self.layers
                            if kv_cache_spec(l) is not None)

    def _graph_shape(self) -> Tuple[int, int]:
        for l in self.layers:
            for t in list(l.inputs) + list(l.outputs):
                if t.shape and len(t.shape) >= 2:
                    return int(t.shape[0]), int(t.shape[1])
        return 1, 1

    def _carries_seq(self, shape) -> bool:
        return bool(shape) and len(shape) >= 2 \
            and int(shape[1]) == self.compile_seq

    def _degrees_of(self, layer: Layer,
                    assign: Dict[str, Tuple[int, ...]]) -> Dict[int, int]:
        degs: Dict[int, int] = {}
        for opt, d in zip(self.options[layer.name],
                          assign.get(layer.name, ())):
            if d > 1 and opt.out_dim >= 0:
                degs[opt.out_dim] = d
        return degs

    def bucket_feasible(self, layer: Layer,
                        degrees: Sequence[int]) -> bool:
        """Serving adds one constraint the training search lacks: a
        batch-dim (sample) degree must divide the BUCKET — the runtime
        batch the session pads to — not just the compile-time batch."""
        for opt, d in zip(self.options[layer.name], degrees):
            if d > 1 and opt.kind == "sample" and opt.out_dim == 0 \
                    and self.bucket % d != 0:
                return False
        return True

    def kv_plan(self, assign: Dict[str, Tuple[int, ...]]
                ) -> Dict[str, Dict[str, int]]:
        """layer name -> {shard_degree, seq_shard_degree, bytes (per
        device, this bucket), num_kv_heads, head_dim} for every
        cache-carrying op."""
        plan: Dict[str, Dict[str, int]] = {}
        for l in self.layers:
            spec = kv_cache_spec(l)
            if spec is None:
                continue
            deg = kv_shard_degree(l, self.options[l.name],
                                  assign.get(l.name, ()))
            sdeg = self.kv_seq_degree(l, assign)
            plan[l.name] = {
                "shard_degree": deg,
                "seq_shard_degree": sdeg,
                "bytes": kv_cache_bytes(l, self.bucket, self.max_seq,
                                        deg * sdeg),
                "num_kv_heads": spec["num_kv_heads"],
                "head_dim": spec["head_dim"]}
        return plan

    def _seq_combine_cost(self, act_bytes: int, sdeg: int) -> float:
        """Per-decode-step price of combining seq-sharded partial
        attention outputs: a (sdeg-1)-hop ppermute rotation of the
        (bucket × embed) partial output + running softmax statistics
        (flash-decoding style) over the sequence axis. Priced from the
        calibrated per-tier ``coll_ppermute`` rows when the table has
        them; otherwise through the decode-latency collective path
        (per-dispatch floor included — these fire once per token)."""
        if sdeg <= 1 or act_bytes <= 0:
            return 0.0
        cm = self.cost
        tier = getattr(self.dmesh, "axis_tiers", {}).get(
            getattr(self.dmesh, "seq_axis", None))
        hop = None
        if cm.calib is not None:
            hop = cm.calib.collective_time("ppermute", sdeg, act_bytes,
                                           tier=tier)
            if hop is None and tier is not None:
                hop = cm.calib.collective_time("ppermute", sdeg,
                                               act_bytes)
        if hop is not None:
            floor = cm.calib.dispatch_s or 0.0
            return max((sdeg - 1) * float(hop), floor)
        return cm.decode_collective_cost(act_bytes, "all_gather", sdeg)

    def kv_seq_degree(self, layer: Layer,
                      assign: Dict[str, Tuple[int, ...]]) -> int:
        """Sequence-dim KV shard degree scored for this layer: the
        mesh's seq degree when context sharding WINS — the per-step
        cache-read saving beats the per-step partial-output combine —
        or when the head-sharded cache alone cannot fit this model's
        HBM share (the long-prompt bucket a flat cache would reject);
        1 otherwise. Deterministic in (layer, assign) so ``evaluate``,
        ``kv_plan`` and the audit all agree."""
        sdeg = int(getattr(self.dmesh, "seq_degree", 0) or 0)
        if sdeg < 2:
            return 1
        spec = kv_cache_spec(layer)
        if spec is None or self.max_seq % sdeg != 0:
            return 1
        kv_deg = kv_shard_degree(layer, self.options[layer.name],
                                 assign.get(layer.name, ()))
        flat = kv_cache_bytes(layer, self.bucket, self.max_seq, kv_deg)
        saved = self.cost.kv_read_time(flat) \
            - self.cost.kv_read_time(flat // sdeg)
        act = self.bucket * spec["embed_dim"] * KV_DTYPE_BYTES
        if saved > self._seq_combine_cost(act, sdeg):
            return sdeg
        # memory-bound adoption: head-sharded residency across all
        # cache layers busts HBM — seq sharding is what makes the
        # bucket feasible at all
        if flat * max(self._n_cache, 1) > self.cost.spec.hbm_bytes:
            return sdeg
        return 1

    def evaluate(self, assign: Dict[str, Tuple[int, ...]]) -> ServingCost:
        prefill = dec_compute = dec_comm = 0.0
        mem = kv_total = 0
        sb = self.bucket / max(self.compile_batch, 1)
        seq = max(self.compile_seq, 1)
        out_degrees: Dict[int, Dict[int, int]] = {}
        for layer in self.layers:
            opts = self.options[layer.name]
            degs = self._degrees_of(layer, assign)
            if not self.bucket_feasible(layer,
                                        assign.get(layer.name, ())):
                # unrealizable at this bucket: make the walk reject it
                return ServingCost(float("inf"), float("inf"),
                                   float("inf"), 0, 0)
            wdeg = 1
            head_deg = 1
            for opt, d in zip(opts, assign.get(layer.name, ())):
                if d > 1 and opt.weight_dims:
                    wdeg *= d
                if d > 1 and opt.kind == "parameter" \
                        and opt.out_dim == -1:
                    head_deg = d
            cm = self.cost.op_cost(layer, degs, wdeg)
            # ---- prefill: one full-sequence forward at the bucket ----
            l_prefill = cm.forward_time * sb
            # ---- decode step: one token through the same weights ----
            # compute shrinks ~1/seq for sequence-carrying ops (the
            # fused attention's per-step cost is O(S) cache reads, which
            # fwd/seq captures); the floor is the HBM side — every
            # decode step re-reads the full local weights and KV cache
            kv_deg = kv_shard_degree(layer, opts,
                                     assign.get(layer.name, ()))
            kv_sdeg = self.kv_seq_degree(layer, assign)
            kv_local = kv_cache_bytes(layer, self.bucket, self.max_seq,
                                      kv_deg * kv_sdeg)
            kv_total += kv_local
            if kv_sdeg > 1:
                # seq-sharded KV: each step combines partial outputs
                # over the sequence axis (flash-decoding rotation)
                spec_l = kv_cache_spec(layer) or {}
                dec_comm += self._seq_combine_cost(
                    self.bucket * int(spec_l.get("embed_dim") or 0)
                    * KV_DTYPE_BYTES, kv_sdeg)
            seq_scale = 1.0 / seq \
                if self._carries_seq(layer.outputs[0].shape
                                     if layer.outputs else None) else 1.0
            l_dec = max(cm.forward_time * sb * seq_scale,
                        self.cost.kv_read_time(cm.weights_memory
                                               + kv_local))
            # ---- communication -------------------------------------
            # producer/consumer resharding, forward-only, at serving
            # shapes; decode moves one-token activations (the small-
            # message rows of the calibration tables)
            for t in layer.inputs:
                src = out_degrees.get(t.guid, {})
                dst = {d: v for d, v in degs.items()
                       if d < len(t.shape) and t.shape[d] % v == 0} \
                    if t.shape else {}
                tb = int(np.prod(t.shape)) * itemsize(t.dtype) \
                    if t.shape else 0
                t_seq = 1.0 / seq if self._carries_seq(t.shape) else 1.0
                l_prefill += self.cost.resharding_cost(tb * sb, src, dst)
                dec_comm += self.cost.resharding_cost(
                    tb * sb * t_seq, src, dst)
            # head-parallel attention ends in an all-reduce after wo
            # (opshard: out_dim == -1, output unsharded on hidden);
            # per decode step that is a (bucket × embed) payload —
            # priced latency-side (xfer_cost: calibrated small-message
            # rows + placement tree + dispatch floor)
            if head_deg > 1:
                spec = kv_cache_spec(layer) or {}
                embed = spec.get("embed_dim") or (
                    int(layer.outputs[0].shape[-1])
                    if layer.outputs and layer.outputs[0].shape else 0)
                act = self.bucket * embed * KV_DTYPE_BYTES
                l_prefill += self.cost.xfer_cost(act * seq, "all_reduce",
                                                 head_deg)
                dec_comm += self.cost.decode_collective_cost(
                    act, "all_reduce", head_deg)
            prefill += l_prefill
            dec_compute += l_dec
            for o in layer.outputs:
                out_degrees[o.guid] = degs
            # resident memory: weights (no grads/optimizer states in
            # serving) + KV cache + double-buffered activations at the
            # serving batch
            mem += cm.weights_memory + kv_local \
                + 2 * int(cm.outputs_memory * sb)
        decode_step = dec_compute + dec_comm
        total = prefill + self.decode_tokens * decode_step
        if mem > self.cost.spec.hbm_bytes:
            total *= 100.0  # infeasible: KV + weights exceed HBM
        return ServingCost(total, prefill, decode_step, kv_total, mem,
                           decode_compute=dec_compute,
                           decode_comm=dec_comm)


# ---------------------------------------------------------------------------
# per-bucket search
# ---------------------------------------------------------------------------

def serving_baseline_assignment(layers: Sequence[Layer],
                                dmesh: DeviceMesh,
                                evaluator: ServingCostEvaluator
                                ) -> Dict[str, Tuple[int, ...]]:
    """The reused-training-plan analog: batch-parallel wherever the
    compile shape AND the bucket allow it, degree clamped to the
    largest mesh-realizable divisor (bucket 1 yields the all-replicated
    plan — exactly what reusing a DP training plan degrades to)."""
    n = dmesh.num_devices
    valid = sorted(dmesh.valid_degrees(), reverse=True)
    assign: Dict[str, Tuple[int, ...]] = {}
    for l in layers:
        degs = []
        for opt in evaluator.options[l.name]:
            d = 1
            if opt.kind == "sample" and opt.out_dim == 0 and l.outputs \
                    and l.outputs[0].shape:
                for cand in valid:
                    if cand <= n \
                            and l.outputs[0].shape[0] % cand == 0 \
                            and evaluator.bucket % cand == 0:
                        d = cand
                        break
            degs.append(d)
        cand = tuple(degs)
        if assignment_to_sharding(l, evaluator.options[l.name], cand,
                                  dmesh) is None:
            cand = tuple(1 for _ in degs)
        assign[l.name] = cand
    return assign


def search_serving_assignment(layers: Sequence[Layer],
                              dmesh: DeviceMesh,
                              cost_model: OpCostModel,
                              bucket: int, max_seq: int,
                              budget: int = 200,
                              decode_tokens: Optional[int] = None,
                              seed: int = 0, alpha: float = 0.05
                              ) -> Tuple[Dict[str, Tuple[int, ...]],
                                         ServingCost,
                                         ServingCostEvaluator]:
    """MCMC walk over per-op assignments under the serving objective
    for one bucket (same proposal scheme as ``mcmc.mcmc_search``, plus
    the bucket-divisibility constraint on batch-dim degrees)."""
    rng = random.Random(seed ^ (bucket << 16))
    ev = ServingCostEvaluator(layers, dmesh, cost_model, bucket,
                              max_seq, decode_tokens)
    valid_degrees = dmesh.valid_degrees()
    current = serving_baseline_assignment(layers, dmesh, ev)
    cur = ev.evaluate(current)
    best, best_cost = dict(current), cur
    shardable = [l for l in layers if ev.options[l.name]]
    if not shardable or budget <= 0:
        return best, best_cost, ev
    from .mcmc import _propagate_neighbors
    consumers: Dict[int, List[Layer]] = {}
    for l in layers:
        for t in l.inputs:
            consumers.setdefault(t.guid, []).append(l)
    with obs_events.span("serving.search", bucket=bucket,
                         budget=budget):
        for it in range(budget):
            layer = rng.choice(shardable)
            opts = ev.options[layer.name]
            oi = rng.randrange(len(opts))
            old = current[layer.name]
            choices = [d for d in valid_degrees
                       if d * math.prod(old[:oi] + old[oi + 1:])
                       <= dmesh.num_devices]
            if not choices:
                continue
            cand = old[:oi] + (rng.choice(choices),) + old[oi + 1:]
            if not ev.bucket_feasible(layer, cand):
                continue
            if assignment_to_sharding(layer, opts, cand, dmesh) is None:
                continue
            moves = _propagate_neighbors(layer, cand, ev, consumers,
                                         dmesh, rng)
            moves = {n: c for n, c in moves.items()
                     if ev.bucket_feasible(
                         next(l for l in layers if l.name == n), c)}
            if layer.name not in moves:
                continue
            olds = {n: current[n] for n in moves}
            current.update(moves)
            nxt = ev.evaluate(current)
            delta = nxt.total - cur.total
            if delta < 0 or (math.isfinite(delta) and rng.random()
                             < math.exp(-delta / max(alpha * cur.total,
                                                     1e-12))):
                cur = nxt
                if nxt.total < best_cost.total:
                    best, best_cost = dict(current), nxt
            else:
                current.update(olds)
    return best, best_cost, ev


def serving_assignment_to_strategy(layers: Sequence[Layer],
                                   input_tensors,
                                   assign: Dict[str, Tuple[int, ...]],
                                   dmesh: DeviceMesh,
                                   evaluator: ServingCostEvaluator
                                   ) -> ShardingStrategy:
    """Materialize one bucket's assignment. Unlike the training path,
    input batch specs are only emitted when the batch degree divides
    the BUCKET (the runtime batch), not the full device count."""
    st = ShardingStrategy(dmesh)
    batch_axes = None
    batch_deg = 1
    for layer in layers:
        opts = evaluator.options[layer.name]
        degs = assign.get(layer.name, ())
        res = assignment_to_sharding(layer, opts, degs, dmesh)
        if res is None:
            continue
        out_specs, wspecs = res
        st.set_op(layer.name, out_specs, wspecs)
        if batch_axes is None and out_specs and out_specs[0] \
                and len(out_specs[0]) > 0 and out_specs[0][0] is not None:
            for opt, d in zip(opts, degs):
                if opt.kind == "sample" and opt.out_dim == 0 and d > 1:
                    batch_axes = out_specs[0][0]
                    batch_deg = d
    for t in input_tensors:
        if batch_axes is not None and t.shape \
                and t.shape[0] % batch_deg == 0 \
                and evaluator.bucket % batch_deg == 0:
            st.inputs[t.name] = P(batch_axes)
    return st


# ---------------------------------------------------------------------------
# plan container + entry point
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BucketPlan:
    bucket: int
    assignment: Dict[str, Tuple[int, ...]]
    strategy: ShardingStrategy
    cost: ServingCost
    kv: Dict[str, Dict[str, int]]
    # calibration provenance of the adopted assignment's predicted cost
    # (deduped {term, table, key} rows from the cost model's provenance
    # tap) — what serving drift detection attributes out-of-band
    # prefill/decode ratios to
    calib: List[Dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServingPlan:
    """Per-(model, batch-class) searched plans + shared geometry."""
    buckets: Dict[int, BucketPlan]
    max_seq: int
    decode_tokens: int
    baseline: Dict[int, ServingCost]

    @property
    def largest(self) -> BucketPlan:
        return self.buckets[max(self.buckets)]

    def to_block(self) -> Dict:
        """The ``serving`` block of the strategy artifact: one complete
        sub-strategy (ops + inputs + assignment) per bucket, so load
        paths can adopt any bucket's plan standalone."""
        from .serialization import _spec_to_json
        block: Dict = {"version": 1, "max_seq": self.max_seq,
                       "decode_tokens": self.decode_tokens,
                       "buckets": {}}
        for b, plan in sorted(self.buckets.items()):
            st = plan.strategy
            ops = {}
            for name, op in st.ops.items():
                ops[name] = {
                    "outputs": [_spec_to_json(s) for s in op.outputs],
                    "weights": {w: _spec_to_json(s)
                                for w, s in op.weights.items()}}
            block["buckets"][str(b)] = {
                "ops": ops,
                "inputs": {n: _spec_to_json(s)
                           for n, s in st.inputs.items()},
                "assignment": {n: list(d)
                               for n, d in plan.assignment.items()},
                "kv": plan.kv,
                "predicted": {
                    "prefill_s": plan.cost.prefill,
                    "decode_step_s": plan.cost.decode_step,
                    "decode_comm_s": plan.cost.decode_comm,
                    "kv_bytes": plan.cost.kv_bytes,
                    "peak_memory_bytes": plan.cost.peak_memory,
                    "total_s": plan.cost.total},
                "calib": plan.calib}
        return block


def bucket_strategy_doc(doc: Dict, bucket: int) -> Dict:
    """Extract one bucket's sub-strategy from a serving artifact as a
    standalone strategy document (loadable by
    ``serialization.load_strategy`` / importable via
    ``FFConfig.import_strategy_file``)."""
    serving = doc.get("serving")
    if not serving:
        raise ValueError("strategy document carries no serving block")
    bkey = str(int(bucket))
    if bkey not in serving.get("buckets", {}):
        raise KeyError(
            f"serving block has no bucket {bucket} "
            f"(have {sorted(serving.get('buckets', {}))})")
    sub = serving["buckets"][bkey]
    return {"version": doc.get("version", 1),
            "mesh_axes": doc["mesh_axes"],
            "inputs": sub.get("inputs", {}),
            "ops": sub["ops"],
            "assignment": sub.get("assignment", {}),
            "meta": {"serving_bucket": int(bucket)},
            # single-bucket serving block: load_strategy attaches it to
            # the strategy, so compile's plan verification runs the
            # serving KV/envelope checks at THIS bucket — an unsharded
            # KV cache that does not fit fails typed at compile
            "serving": {"version": serving.get("version", 1),
                        "max_seq": serving.get("max_seq"),
                        "decode_tokens": serving.get("decode_tokens"),
                        "buckets": {bkey: sub}}}


def _assignment_provenance(ev: ServingCostEvaluator, assign) -> List[Dict]:
    """Calibration provenance of one bucket's adopted assignment:
    re-score it with the cost model's provenance tap installed (the
    attribution/drift machinery's tap, here installed by the serving
    evaluator too) and dedup the recorded rows to ``{term, table,
    key}``.  READ-ONLY by construction — the tap changes what
    ``op_cost`` RECORDS, never what it returns, so pricing (and the
    fidelity number keyed on it) is untouched."""
    cm = ev.cost
    prev = cm.provenance
    cm.provenance = []
    try:
        ev.evaluate(assign)
        rows = cm.provenance
    finally:
        cm.provenance = prev
    seen = set()
    out: List[Dict] = []
    for r in rows:
        k = (r.get("term"), r.get("table"), r.get("key"))
        if k in seen:
            continue
        seen.add(k)
        out.append({"term": r.get("term"),
                    "table": r.get("table") or "analytic",
                    "key": r.get("key")})
    return out


def _serving_cost_model(ff, dmesh) -> OpCostModel:
    """The cost model serving scoring prices with. Reuses the training
    search's calibrated model when compile built one; otherwise builds
    one the same way, with collective constants fitted on the live mesh
    unless a machine file is the ground truth (the port attaches no
    hierarchical placement: its search prices one tier). Calibration
    tables are READ here, never refit."""
    cm = getattr(ff, "_search_cost_model", None)
    if cm is not None:
        return cm
    cfg = ff.config
    cm = OpCostModel(dmesh.spec)
    cm.device = getattr(ff, "device", None)
    cm.segment_size = max(1, cfg.simulator_segment_size)
    cm.max_segments = max(1, cfg.simulator_max_num_segments)
    if not cfg.machine_model_file:
        try:
            cm.calibrate_collectives(dmesh)
        except Exception:  # noqa: BLE001 — analytic constants suffice
            pass
    return cm


def optimize_serving_strategy(ff, buckets: Optional[Sequence[int]] = None,
                              max_seq: Optional[int] = None,
                              budget: Optional[int] = None,
                              decode_tokens: Optional[int] = None,
                              verify: bool = True) -> ServingPlan:
    """Search one serving plan per batch bucket (``optimize_strategy``'s
    ``mode="serving"``). ``ff`` must be compiled (or at least carry a
    ``dmesh``): the mesh the plans target is the mesh serving runs on.

    Verifies the per-bucket plans (KV sharding sound, serving memory
    envelope fits at the largest bucket — typed
    ``PlanVerificationError`` otherwise), writes a ``serving`` audit
    block, and exports the artifact when
    ``FFConfig.export_strategy_file`` is set."""
    if getattr(ff, "dmesh", None) is None:
        raise ValueError("compile() the model first: serving plans "
                         "target the compiled mesh")
    cfg = ff.config
    dmesh = ff.dmesh
    if buckets is None:
        buckets = cfg.serving_buckets_list() or DEFAULT_BUCKETS
    buckets = sorted(set(int(b) for b in buckets))
    cost_model = _serving_cost_model(ff, dmesh)
    probe = ServingCostEvaluator(ff.layers, dmesh, cost_model, 1, 1)
    if max_seq is None:
        max_seq = cfg.serving_max_seq or probe.compile_seq
    if decode_tokens is None:
        decode_tokens = cfg.serving_decode_tokens or 0
    budget = budget if budget is not None else (
        cfg.search_budget if cfg.search_budget > 0 else 200)
    t0 = time.perf_counter()
    plans: Dict[int, BucketPlan] = {}
    baseline: Dict[int, ServingCost] = {}
    for b in buckets:
        best, best_cost, ev = search_serving_assignment(
            ff.layers, dmesh, cost_model, b, max_seq, budget=budget,
            decode_tokens=decode_tokens or None, seed=cfg.seed)
        baseline[b] = ev.evaluate(
            serving_baseline_assignment(ff.layers, dmesh, ev))
        strategy = serving_assignment_to_strategy(
            ff.layers, ff.graph_inputs, best, dmesh, ev)
        errs = strategy.validate()
        if errs:
            raise RuntimeError(f"serving search produced an unsound "
                               f"strategy at bucket {b}: {errs}")
        plans[b] = BucketPlan(b, best, strategy, best_cost,
                              ev.kv_plan(best),
                              calib=_assignment_provenance(ev, best))
    plan = ServingPlan(plans, int(max_seq),
                       int(decode_tokens or max_seq), baseline)
    # the per-bucket strategies carry their serving block so any later
    # verify_plan/verify_model pass runs the serving checks on them
    block = plan.to_block()
    for b, p in plan.buckets.items():
        p.strategy.serving = {
            "version": block["version"], "max_seq": block["max_seq"],
            "decode_tokens": block["decode_tokens"],
            "buckets": {str(b): block["buckets"][str(b)]}}
    if verify:
        from ..analysis.plan_verifier import verify_serving_plan
        hbm = None
        if getattr(cfg, "device_mem_mb", 0):
            hbm = cfg.device_mem_mb * (1 << 20)
        verify_serving_plan(plan, ff.layers, dmesh,
                            hbm_bytes=hbm, context="serving-search")
    _write_serving_audit(ff, plan, time.perf_counter() - t0)
    if cfg.export_strategy_file:
        save_serving_plan(cfg.export_strategy_file, plan)
    ff._serving_plan = plan
    return plan


def save_serving_plan(path: str, plan: ServingPlan) -> None:
    """Write the serving artifact: the largest bucket's strategy as the
    base document + the per-bucket ``serving`` block."""
    from .serialization import save_strategy
    big = plan.largest
    save_strategy(path, big.strategy, big.assignment,
                  meta={"mode": "serving",
                        "buckets": sorted(plan.buckets),
                        "max_seq": plan.max_seq},
                  serving=plan.to_block())


def _write_serving_audit(ff, plan: ServingPlan, search_s: float) -> None:
    """Strategy audit record with a ``serving`` block: per-bucket
    predicted prefill/decode-step/kv profile of the adopted plan vs the
    reused-training-plan baseline."""
    if not obs_events.enabled():
        return
    try:
        key = obs_audit.workload_key(ff.layers, ff.dmesh.num_devices)
        buckets = {}
        for b, p in sorted(plan.buckets.items()):
            base = plan.baseline.get(b)
            buckets[str(b)] = {
                "prefill_s": p.cost.prefill,
                "decode_step_s": p.cost.decode_step,
                "decode_comm_s": p.cost.decode_comm,
                "kv_bytes": p.cost.kv_bytes,
                "peak_memory_bytes": p.cost.peak_memory,
                "baseline_decode_step_s":
                    base.decode_step if base else None,
                "predicted_baseline_over_searched":
                    (base.decode_step / max(p.cost.decode_step, 1e-12))
                    if base else None,
                "kv": p.kv,
                "assignment": {n: list(d)
                               for n, d in p.assignment.items()},
                "calib": p.calib}
        record = {
            "search_algo": "serving",
            "ranker": "serving-latency",
            "n_devices": ff.dmesh.num_devices,
            "search_s": round(search_s, 4),
            "serving": {"max_seq": plan.max_seq,
                        "decode_tokens": plan.decode_tokens,
                        "buckets": buckets}}
        path = obs_audit.write_strategy_audit(record, key + "-serving")
        if path:
            ff._strategy_audit_path = path
            obs_events.counter("search.serving_audit_records")
    except Exception:  # noqa: BLE001 — audit must never kill the search
        pass
