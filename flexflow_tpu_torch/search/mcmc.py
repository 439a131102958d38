"""MCMC strategy search: simulated annealing over per-op sharding
assignments. The port of ``flexflow_tpu/search/mcmc.py``.

Analog of the reference's legacy search (``FFModel::mcmc_optimize``,
``src/runtime/model.cc:3286-3357``): start from the canonical data-parallel
assignment, randomly rewrite one op's parallel config, score with the
simulator, accept with probability exp(-alpha * delta). The Unity
substitution-DP search (search/unity.py) supersedes this but the MCMC
remains the cheap robust fallback, exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.layer import Layer
from ..dtypes import itemsize
from ..obs import events as obs_events
from ..parallel.machine import DeviceMesh
from ..parallel.strategy import P, ShardingStrategy
from .costmodel import OpCostModel
from .opshard import ShardOption, assignment_to_sharding, options_for


@dataclasses.dataclass
class GraphCost:
    total: float
    compute: float
    xfer: float
    sync: float
    peak_memory: int
    # gradient-sync seconds hidden behind backward compute under
    # overlap-aware scoring (OpCostModel.overlap_mode); 0.0 when off
    sync_hidden: float = 0.0


class StrategySimulator:
    """Scores a full per-op assignment (reference ``simulate_runtime`` in
    its additive DP-search approximation)."""

    def __init__(self, layers: Sequence[Layer], dmesh: DeviceMesh,
                 cost_model: OpCostModel):
        self.layers = list(layers)
        self.dmesh = dmesh
        self.cost = cost_model
        self.options: Dict[str, List[ShardOption]] = {
            l.name: options_for(l) for l in self.layers}

    def _degrees_of(self, layer: Layer,
                    assign: Dict[str, Tuple[int, ...]]) -> Dict[int, int]:
        degs: Dict[int, int] = {}
        for opt, d in zip(self.options[layer.name],
                          assign.get(layer.name, ())):
            if d > 1 and opt.out_dim >= 0:
                degs[opt.out_dim] = d
        return degs

    def evaluate(self, assign: Dict[str, Tuple[int, ...]]) -> GraphCost:
        gc, _ = self._evaluate(assign, breakdown=False)
        return gc

    def evaluate_breakdown(self, assign: Dict[str, Tuple[int, ...]]
                           ) -> Tuple[GraphCost, List[Dict]]:
        """(GraphCost, per-op entries) — the strategy-audit breakdown;
        entry component sums equal the GraphCost components (before the
        infeasibility penalty, flagged per entry set by the caller)."""
        try:
            return self._evaluate(assign, breakdown=True)
        finally:
            # the provenance tap (installed below for breakdowns only)
            # must not survive onto the MCMC walk's hot loop
            self.cost.provenance = None

    def _evaluate(self, assign: Dict[str, Tuple[int, ...]],
                  breakdown: bool) -> Tuple[GraphCost, List[Dict]]:
        compute = xfer = sync = 0.0
        # overlap-aware sync pricing: unity's contract, the split
        # resolved by the shared _overlap_split after the walk
        overlap_on = bool(getattr(self.cost, "overlap_mode", False))
        sync_sites: List[Dict] = []
        mem = 0
        entries: List[Dict] = []
        if breakdown:
            # calibration-row provenance for obs/drift.py — same
            # contract as GraphCostEvaluator.graph_cost_breakdown: each
            # entry records which table rows priced it, so drift on an
            # mcmc-searched plan marks the right rows stale instead of
            # reporting calibrated predictions as "analytic"
            self.cost.provenance = []
        out_degrees: Dict[int, Dict[int, int]] = {}  # tensor guid -> degrees
        for layer in self.layers:
            opts = self.options[layer.name]
            degs = self._degrees_of(layer, assign)
            wdeg = 1
            for opt, d in zip(opts, assign.get(layer.name, ())):
                if d > 1 and opt.weight_dims:
                    wdeg *= d
            # kernel tier attached: attention prices at its cheapest
            # available implementation (the impl is a search dimension)
            cm = self.cost.op_cost_with_impl(layer, degs, wdeg)
            compute += cm.forward_time + cm.backward_time
            l_mem = cm.weights_memory + cm.outputs_memory
            mem += l_mem
            # input resharding: producer layout vs this op's batch layout
            l_xfer = 0.0
            for t in layer.inputs:
                src = out_degrees.get(t.guid, {})
                dst = {d: v for d, v in degs.items()
                       if d < len(t.shape) and t.shape[d] % v == 0} \
                    if t.shape else {}
                tb = int(np.prod(t.shape)) * itemsize(t.dtype) \
                    if t.shape else 0
                l_xfer += self.cost.resharding_cost(tb, src, dst)
                # backward: cotangent moves the other way
                l_xfer += self.cost.resharding_cost(tb, dst, src)
            xfer += l_xfer
            for o in layer.outputs:
                out_degrees[o.guid] = degs
            # gradient sync: weights replicated across the dp degree
            dp_deg = self.dmesh.num_devices
            for opt, d in zip(opts, assign.get(layer.name, ())):
                if opt.weight_dims and d > 1:
                    dp_deg //= d
            l_sync = 0.0
            if layer.weights:
                wbytes = sum(int(np.prod(w.shape)) * itemsize(w.dtype)
                             for w in layer.weights) // max(wdeg, 1)
                l_sync = self.cost.weight_sync_cost(wbytes, dp_deg)
            sync += l_sync
            n_entries = len(entries)
            if breakdown:
                e = {
                    "name": layer.name,
                    "op_type": getattr(layer.op_type, "name",
                                       str(layer.op_type)),
                    "fwd_s": cm.forward_time, "bwd_s": cm.backward_time,
                    "xfer_s": l_xfer, "sync_s": l_sync,
                    "mem_bytes": l_mem,
                    "total_s": cm.forward_time + cm.backward_time
                    + l_xfer + l_sync}
                if l_sync > 0:
                    # wire dtype the sync was priced at (same contract
                    # as unity's entries — "float32" unless quantized)
                    e["sync_wire"] = getattr(self.cost,
                                             "last_sync_wire",
                                             "float32")
                if getattr(self.cost, "last_kernel_impl", None):
                    # kernel implementation this op was priced at
                    # (searchable kernel tier; same contract as unity)
                    e["kernel_impl"] = self.cost.last_kernel_impl
                prov = self.cost.provenance
                if prov:
                    e["calib"] = list(prov)
                if prov is not None:
                    del prov[:]
                entries.append(e)
            if overlap_on:
                sync_sites.append({
                    "bwd": cm.backward_time, "sync": l_sync,
                    "entry": entries[-1] if len(entries) > n_entries
                    else None})
        sync_hidden = 0.0
        if overlap_on and sync > 0:
            from .unity import _overlap_split
            sync, sync_hidden = _overlap_split(sync_sites)
        total = compute + xfer + sync
        # memory feasibility: ~4x weights (param + grad + 2 Adam moments)
        if mem * 4 > self.cost.spec.hbm_bytes:
            total *= 100.0  # infeasible penalty (memory-aware search refines)
        return GraphCost(total, compute, xfer, sync, mem,
                         sync_hidden=sync_hidden), entries


def data_parallel_assignment(layers: Sequence[Layer], dmesh: DeviceMesh,
                             options: Dict[str, List[ShardOption]]
                             ) -> Dict[str, Tuple[int, ...]]:
    n = dmesh.num_devices
    assign = {}
    for l in layers:
        degs = []
        for opt in options[l.name]:
            if opt.kind == "sample" and l.outputs and l.outputs[0].shape \
                    and l.outputs[0].shape[opt.out_dim] % n == 0:
                degs.append(n)
            else:
                degs.append(1)
        assign[l.name] = tuple(degs)
    return assign


def _option_signature(opts: Sequence[ShardOption]) -> Tuple:
    return tuple((o.kind, o.out_dim) for o in opts)


def _propagate_neighbors(layer: Layer, cand: Tuple[int, ...],
                         sim: StrategySimulator,
                         consumers: Dict[int, List[Layer]],
                         dmesh: DeviceMesh, rng,
                         p_cont: float = 0.7) -> Dict[str, Tuple[int, ...]]:
    """Flood the mutated config to same-shape neighbors.

    Reference ``FFModel::propagate`` (``model.cc:3181-3261``,
    ``FF_USE_PROPAGATE``): after rewriting one op's parallel config, the
    proposal copies it to graph neighbors with matching output shape and
    option structure, continuing each hop with probability ``p_cont`` —
    so chain-structured graphs (transformer blocks) change whole
    segments per step instead of one op, removing the resharding seams
    single-op moves leave behind."""
    sig = _option_signature(sim.options[layer.name])
    oshape = tuple(layer.outputs[0].shape) if layer.outputs else None
    changed: Dict[str, Tuple[int, ...]] = {layer.name: cand}
    frontier = [layer]
    while frontier:
        cur = frontier.pop()
        nbrs: List[Layer] = []
        for t in cur.inputs:
            if t.owner_layer is not None:
                nbrs.append(t.owner_layer)
        for t in cur.outputs:
            nbrs.extend(consumers.get(t.guid, ()))
        for nb in nbrs:
            if nb.name in changed or nb.name not in sim.options:
                continue
            if not nb.outputs \
                    or tuple(nb.outputs[0].shape) != oshape:
                continue
            if _option_signature(sim.options[nb.name]) != sig:
                continue
            if rng.random() > p_cont:
                continue
            if assignment_to_sharding(nb, sim.options[nb.name], cand,
                                      dmesh) is None:
                continue
            changed[nb.name] = cand
            frontier.append(nb)
    return changed


def mcmc_search(layers: Sequence[Layer], dmesh: DeviceMesh,
                cost_model: OpCostModel, budget: int = 1000,
                alpha: float = 0.05, seed: int = 0,
                verbose: bool = False, propagate: bool = True):
    """Returns (best_assignment, best_cost, simulator).

    ``propagate`` enables the reference's ``FF_USE_PROPAGATE`` proposal
    (``model.cc:3181-3261``): each accepted rewrite may carry its config
    to same-shape neighbors, accepted/rejected atomically."""
    rng = random.Random(seed)
    sim = StrategySimulator(layers, dmesh, cost_model)
    valid_degrees = dmesh.valid_degrees()
    current = data_parallel_assignment(layers, dmesh, sim.options)
    cur_cost = sim.evaluate(current).total
    best, best_cost = dict(current), cur_cost
    shardable = [l for l in layers if sim.options[l.name]]
    if not shardable or budget <= 0:
        return best, best_cost, sim
    consumers: Dict[int, List[Layer]] = {}
    for l in layers:
        for t in l.inputs:
            consumers.setdefault(t.guid, []).append(l)
    with obs_events.span("mcmc.search", budget=budget):
        for it in range(budget):
            layer = rng.choice(shardable)
            opts = sim.options[layer.name]
            oi = rng.randrange(len(opts))
            old = current[layer.name]
            # propose a new degree for this option; keep product ≤
            # num devices
            choices = [d for d in valid_degrees
                       if d * math.prod(old[:oi] + old[oi + 1:])
                       <= dmesh.num_devices]
            if not choices:
                continue
            new_deg = rng.choice(choices)
            cand = old[:oi] + (new_deg,) + old[oi + 1:]
            # realizability check (divisibility + axis allocation)
            if assignment_to_sharding(layer, opts, cand, dmesh) is None:
                continue
            if propagate:
                moves = _propagate_neighbors(layer, cand, sim, consumers,
                                             dmesh, rng)
            else:
                moves = {layer.name: cand}
            olds = {n: current[n] for n in moves}
            current.update(moves)
            obs_events.counter("mcmc.proposals")
            new_cost = sim.evaluate(current).total
            delta = new_cost - cur_cost
            if delta < 0 or rng.random() < math.exp(-delta / max(
                    alpha * cur_cost, 1e-12)):
                obs_events.counter("mcmc.accepts")
                cur_cost = new_cost
                if new_cost < best_cost:
                    best, best_cost = dict(current), new_cost
                    if verbose:
                        print(f"  mcmc iter {it}: best "
                              f"{best_cost * 1e3:.3f} ms")
            else:
                current.update(olds)
    return best, best_cost, sim


def assignment_to_strategy(layers: Sequence[Layer], input_tensors,
                           assign: Dict[str, Tuple[int, ...]],
                           dmesh: DeviceMesh,
                           sim: StrategySimulator) -> ShardingStrategy:
    """Materialize an assignment as a ShardingStrategy (the searched
    artifact — reference (PCG, MachineView map) analog)."""
    st = ShardingStrategy(dmesh)
    batch_sharding_axes = None
    for layer in layers:
        opts = sim.options[layer.name]
        degs = assign.get(layer.name, ())
        res = assignment_to_sharding(layer, opts, degs, dmesh)
        if res is None:
            continue
        out_specs, wspecs = res
        st.set_op(layer.name, out_specs, wspecs)
        if batch_sharding_axes is None and out_specs and out_specs[0]:
            first = out_specs[0][0] if len(out_specs[0]) > 0 else None
            if first is not None:
                batch_sharding_axes = first
    for t in input_tensors:
        if batch_sharding_axes is not None and t.shape and \
                t.shape[0] % dmesh.num_devices == 0:
            st.inputs[t.name] = P(batch_sharding_axes)
    return st
