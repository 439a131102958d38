"""Unity auto-parallelization search: best-first substitution search with
alpha pruning, recursive sequence-split DP with memoization, and
memory-aware multi-objective search. The port of
``flexflow_tpu/search/unity.py``.

Reference analogs:
  - ``base_optimize`` ≙ ``GraphSearchHelper::base_optimize``
    (``substitution.cc:2229``): cost-ordered priority queue of candidate
    graphs, pop best, apply every xfer, keep candidates within
    ``alpha``× best, stop at ``budget`` expansions.
  - ``sequence_optimize`` ≙ ``generic_sequence_optimize``
    (``substitution.cc:2572``): split at a bottleneck (post-dominator of
    all sources), DP over the cut tensor's layout (the analog of the
    (source view, sink view) machine-view pairs), memoized by
    ``dp_state_hash`` (``graph.cc:1863``).
  - ``graph_optimize_with_memory`` ≙ ``substitution.cc:1960`` +
    ``try_one_lambda`` (``graph.cc:1883``): binary search on lambda
    weighting per-device memory against the HBM budget.

The evaluator's execution model is SPMD: every op runs on the whole
mesh (sharded by its annotation), so graph run time is additive over nodes
(unlike the reference's per-view concurrent placement — that role is played
by pipeline parallelism, handled separately). The finalists are ranked by
this additive evaluator: the JAX package's event-driven task simulator
(``tasksim.py``), its default final ranker, is not ported (ROADMAP queue
1 item 5), which its ``FF_FINAL_RANKER=additive`` reproduces.
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.layer import Layer
from ..core.tensor import Tensor
from ..dtypes import itemsize
from ..ffconst import OperatorType, PARALLEL_OPS
from ..obs import events as obs_events
from ..parallel.machine import DeviceMesh
from ..parallel.strategy import P, ShardingStrategy, Spec
from ..pcg.graph import Graph, GraphProgramInfo, ParAnn, PNode
from .costmodel import OpCostModel
from .mcmc import GraphCost
from .substitution import GraphXfer, generate_all_pcg_xfers

Layout = Tuple[Tuple[int, int], ...]       # sorted ((dim, degree), ...)


def _layout(d: Dict[int, int]) -> Layout:
    return tuple(sorted((k, v) for k, v in d.items() if v > 1))


def _coll_bytes(full_bytes: int, in_lay: Layout, own_degree: int = 1) -> int:
    """Logical bytes moved by ONE parallel-op collective group when the
    tensor is co-partitioned by other groups/dims.

    A Combine(dim, d) on a tensor also batch-partitioned by b gathers a
    region of ``full/b`` bytes within each batch shard — charging the
    full tensor would overprice composed (2D) machine views by the
    co-partition factor. ``own_degree`` is the collective's own degree
    when it already appears in the producer layout (Combine)."""
    prod = 1
    for _, d in in_lay:
        prod *= d
    prod = max(1, prod // max(own_degree, 1))
    return max(full_bytes // prod, 1) if full_bytes else 0


def _bytes_of(t: Tensor) -> int:
    return int(np.prod(t.shape)) * itemsize(t.dtype) if t.shape else 0


# ---------------------------------------------------------------------------
# Graph cost evaluation
# ---------------------------------------------------------------------------
def propagate_layouts(graph: Graph,
                      in_pins: Optional[Dict[int, Layout]] = None
                      ) -> Dict[Tuple[int, int], Layout]:
    """(node guid, out_idx) -> layout. Parallel ops transform their
    input layout; compute ops emit their annotation's layout."""
    lay: Dict[Tuple[int, int], Layout] = {}
    in_pins = in_pins or {}
    for n in graph.topo_order():
        t = n.op_type
        in_lay: Layout = ()
        e = graph.producer(n, 0)
        if e is not None:
            in_lay = lay[(e.src.guid, e.src_idx)]
        else:
            for s, tens in graph.external_inputs.get(n.guid, ()):
                if s == 0 and tens.guid in in_pins:
                    in_lay = in_pins[tens.guid]
        if t == OperatorType.OP_REPARTITION:
            d = dict(in_lay)
            dim = n.layer.params["dim"]
            d[dim] = d.get(dim, 1) * n.layer.params["degree"]
            out = _layout(d)
        elif t == OperatorType.OP_COMBINE:
            d = dict(in_lay)
            d.pop(n.layer.params["dim"], None)
            out = _layout(d)
        elif t in (OperatorType.OP_REPLICATE, OperatorType.OP_REDUCTION,
                   OperatorType.OP_NOOP, OperatorType.OP_PIPELINE,
                   OperatorType.OP_FUSED_PARALLEL, OperatorType.OP_INPUT):
            out = in_lay
        else:
            out = _layout(n.ann.out_degrees(0))
        for i in range(max(len(n.layer.outputs), 1)):
            lay[(n.guid, i)] = out if i == 0 else _layout(
                n.ann.out_degrees(i))
    return lay


class GraphCostEvaluator:
    """Scores a PCG: additive node costs + reified communication costs +
    gradient-sync costs + per-device peak memory."""

    def __init__(self, cost_model: OpCostModel, dmesh: DeviceMesh,
                 mem_lambda: float = 0.0):
        self.cost = cost_model
        self.dmesh = dmesh
        self.mem_lambda = mem_lambda  # $/byte weighting for memory-aware DP
        self._cache: Dict[Tuple, GraphCost] = {}

    # -- expected input layout of a compute node ----------------------------
    def _expected_input(self, node: PNode, in_idx: int,
                        in_shape: Tuple[int, ...]) -> Layout:
        ann = node.ann
        if ann.is_trivial():
            return ()
        if ann.replicate is not None:
            return ()
        if ann.reduce is not None and in_idx == 0 and in_shape:
            # contraction dim partitioned by the reduce group, PLUS any
            # co-partitioned output dims (e.g. the dp batch dim of the
            # composed row-parallel 2D rule) that pass through the input
            degs = {len(in_shape) - 1: ann.degree_of(ann.reduce)}
            for d, v in ann.out_degrees(0).items():
                if d < len(in_shape) - 1 and in_shape[d] % v == 0:
                    degs[d] = v
            return _layout(degs)
        degs = {d: v for d, v in ann.out_degrees(0).items()
                if in_shape and d < len(in_shape)
                and in_shape[d] % v == 0}
        # parameter-dim placements don't constrain the input
        out_shape = node.layer.outputs[0].shape
        if in_shape and out_shape and in_shape[-1] != out_shape[-1] \
                and len(in_shape) - 1 in degs:
            degs.pop(len(in_shape) - 1, None)
        return _layout(degs)

    # -- cost ---------------------------------------------------------------
    def graph_cost(self, graph: Graph,
                   in_pins: Optional[Dict[int, Layout]] = None,
                   out_pin: Optional[Layout] = None) -> GraphCost:
        key = (graph.hash(),
               tuple(sorted((in_pins or {}).items())),
               out_pin, self.mem_lambda)
        hit = self._cache.get(key)
        if hit is not None:
            obs_events.counter("unity.graph_cost_cache_hits")
            return hit
        obs_events.counter("unity.graph_cost_evals")
        gc, _ = self._evaluate(graph, in_pins, out_pin, breakdown=False)
        self._cache[key] = gc
        return gc

    def graph_cost_breakdown(self, graph: Graph,
                             in_pins: Optional[Dict[int, Layout]] = None,
                             out_pin: Optional[Layout] = None
                             ) -> Tuple[GraphCost, List[Dict]]:
        """(GraphCost, per-op entries) — uncached; the entries' component
        sums equal the GraphCost components BY CONSTRUCTION (the
        aggregate is accumulated from the same per-node terms), which is
        what makes the strategy audit record diffable against the
        search's reported cost."""
        try:
            return self._evaluate(graph, in_pins, out_pin,
                                  breakdown=True)
        finally:
            # the tap must not survive onto the search's hot loop (the
            # cost model is shared across evaluators)
            self.cost.provenance = None

    def _evaluate(self, graph: Graph, in_pins: Optional[Dict[int, Layout]],
                  out_pin: Optional[Layout], breakdown: bool
                  ) -> Tuple[GraphCost, List[Dict]]:
        lay = propagate_layouts(graph, in_pins)
        compute = xfer = sync = 0.0
        mem = 0
        entries: List[Dict] = []
        n_dev = self.dmesh.num_devices
        if breakdown:
            # calibration-row provenance tap (obs/drift.py): the cost
            # model appends which table row answered each pricing call;
            # note() folds the rows accumulated since the previous
            # entry into that entry's "calib" list. Breakdowns are
            # uncached audit-only evaluations, so the tap never rides
            # along on the search's hot loop.
            self.cost.provenance = []

        def note(node, fwd=0.0, bwd=0.0, nx=0.0, ns=0.0, nmem=0):
            if breakdown:
                e = {
                    "name": node.layer.name,
                    "op_type": getattr(node.op_type, "name",
                                       str(node.op_type)),
                    "fwd_s": fwd, "bwd_s": bwd, "xfer_s": nx,
                    "sync_s": ns, "mem_bytes": nmem,
                    "total_s": fwd + bwd + nx + ns
                    + self.mem_lambda * nmem}
                if ns > 0:
                    # the wire dtype this site's gradient collective was
                    # priced at ("float32" unless a quantized-
                    # collectives policy narrowed it) — drift detection
                    # attributes quantized rows by it
                    e["sync_wire"] = getattr(self.cost,
                                             "last_sync_wire",
                                             "float32")
                if (fwd or bwd) and getattr(self.cost,
                                            "last_kernel_impl", None):
                    # the kernel implementation this compute node was
                    # priced at (searchable kernel tier) — fresh only
                    # right after op_cost_with_impl, hence the fwd/bwd
                    # guard keeps it off reshard-only entries
                    e["kernel_impl"] = self.cost.last_kernel_impl
                prov = self.cost.provenance
                if prov:
                    e["calib"] = list(prov)
                if prov is not None:
                    del prov[:]
                entries.append(e)

        for n in graph.topo_order():
            t = n.op_type
            in_bytes = 0
            in_lay: Layout = ()
            e0 = graph.producer(n, 0)
            if e0 is not None:
                src_t = e0.src.layer.outputs[e0.src_idx]
                in_bytes = _bytes_of(src_t)
                in_lay = lay[(e0.src.guid, e0.src_idx)]
            elif n.layer.inputs:
                in_bytes = _bytes_of(n.layer.inputs[0])
                for s, tens in graph.external_inputs.get(n.guid, ()):
                    if s == 0 and in_pins and tens.guid in in_pins:
                        in_lay = in_pins[tens.guid]
            if t in (OperatorType.OP_INPUT, OperatorType.OP_NOOP,
                     OperatorType.OP_WEIGHT):
                continue
            if t == OperatorType.OP_REPARTITION:
                deg = n.layer.params["degree"]
                # fwd: slicing replicated/owned data is (near-)local under
                # SPMD; bwd: the cotangent re-gathers within the group.
                # Charged on the per-existing-shard region so composed
                # (2D) views aren't overpriced by the co-partition factor.
                nx = self.cost.xfer_cost(_coll_bytes(in_bytes, in_lay),
                                         "all_to_all", deg)
                xfer += nx
                note(n, nx=nx)
                continue
            if t == OperatorType.OP_COMBINE:
                deg = n.layer.params["degree"]
                eff = _coll_bytes(in_bytes, in_lay, deg)
                nx = self.cost.xfer_cost(eff, "all_gather", deg) \
                    + self.cost.xfer_cost(eff, "all_to_all", deg)
                xfer += nx
                note(n, nx=nx)
                continue
            if t == OperatorType.OP_REPLICATE:
                deg = n.layer.params["degree"]
                # fwd free under SPMD when input already replicated;
                # bwd: all-reduce of input cotangent across the group
                nx = self.cost.xfer_cost(_coll_bytes(in_bytes, in_lay),
                                         "all_reduce", deg)
                xfer += nx
                note(n, nx=nx)
                continue
            if t == OperatorType.OP_REDUCTION:
                deg = n.layer.params["degree"]
                nx = self.cost.xfer_cost(_coll_bytes(in_bytes, in_lay),
                                         "all_reduce", deg)
                xfer += nx
                note(n, nx=nx)
                continue
            if t in (OperatorType.OP_PIPELINE,
                     OperatorType.OP_FUSED_PARALLEL):
                continue
            # ---- compute node ----
            ann = n.ann
            scale_groups = {g for (_, _, g) in ann.out}
            if ann.reduce:
                scale_groups.add(ann.reduce)
            scale = 1
            for g in scale_groups:
                scale *= ann.degree_of(g)
            degs = {0: scale} if scale > 1 else {}
            # kernel tier attached: attention prices at its cheapest
            # available implementation (the impl is a search dimension)
            cm = self.cost.op_cost_with_impl(n.layer, degs,
                                             ann.weight_degree())
            compute += cm.forward_time + cm.backward_time
            n_mem = cm.weights_memory * 4 + cm.outputs_memory
            mem += n_mem
            # input mismatch safety net
            n_xfer = 0.0
            for e in graph.in_edges[n]:
                src_lay = lay[(e.src.guid, e.src_idx)]
                src_t = e.src.layer.outputs[e.src_idx]
                want = self._expected_input(n, e.dst_idx, src_t.shape)
                if src_lay != want:
                    n_xfer += self.cost.resharding_cost(
                        _bytes_of(src_t), dict(src_lay), dict(want))
            xfer += n_xfer
            # gradient sync for weights: all-reduce over the mesh part not
            # sharding the weight
            n_sync = 0.0
            wdeg = ann.weight_degree()
            wbytes = sum(_bytes_of_spec(w) for w in n.layer.weights)
            if wbytes:
                dp_deg = max(1, n_dev // max(wdeg, 1))
                n_sync = self.cost.weight_sync_cost(
                    wbytes // max(wdeg, 1), dp_deg)
            sync += n_sync
            note(n, fwd=cm.forward_time, bwd=cm.backward_time,
                 nx=n_xfer, ns=n_sync, nmem=n_mem)
        # output pin: resharding from final layout to the pinned layout
        if out_pin is not None and graph.outputs:
            n0, i0 = graph.outputs[0]
            fin = lay.get((n0.guid, i0), ())
            if fin != out_pin:
                nx = self.cost.resharding_cost(
                    _bytes_of(n0.layer.outputs[i0]), dict(fin),
                    dict(out_pin))
                xfer += nx
                if breakdown:
                    e = {
                        "name": "__out_pin__", "op_type": "RESHARD",
                        "fwd_s": 0.0, "bwd_s": 0.0, "xfer_s": nx,
                        "sync_s": 0.0, "mem_bytes": 0, "total_s": nx}
                    prov = self.cost.provenance
                    if prov:
                        e["calib"] = list(prov)
                        del prov[:]
                    entries.append(e)
        total = compute + xfer + sync + self.mem_lambda * mem
        return GraphCost(total, compute, xfer, sync, mem), entries


def _bytes_of_spec(w) -> int:
    return int(np.prod(w.shape)) * itemsize(w.dtype)


# ---------------------------------------------------------------------------
# Best-first substitution search (base_optimize)
# ---------------------------------------------------------------------------
class SearchPool:
    """Global work budget shared by every ``base_optimize`` call of one
    search. The DP recursion fans out over split positions x cut
    layouts; without a GLOBAL cap the per-call budget multiplies into
    hours on deep graphs (the reference's budget is likewise a whole-
    search iteration count, ``substitution.cc`` ``budget--``)."""

    __slots__ = ("remaining", "deadline")

    def __init__(self, expansions: int, seconds: float):
        self.remaining = expansions
        self.deadline = time.monotonic() + seconds

    def take(self, want: int) -> int:
        if time.monotonic() >= self.deadline:
            return 0
        got = max(0, min(want, self.remaining))
        return got

    def spend(self, used: int):
        self.remaining -= used


def base_optimize(graph: Graph, xfers: Sequence[GraphXfer],
                  evaluator: GraphCostEvaluator, budget: int = 32,
                  alpha: float = 1.05, max_num_ops: int = 512,
                  in_pins: Optional[Dict[int, Layout]] = None,
                  out_pin: Optional[Layout] = None,
                  pool: Optional[SearchPool] = None
                  ) -> Tuple[Graph, float]:
    """Cost-ordered best-first search over rewrites
    (reference ``base_optimize``, ``substitution.cc:2229``)."""
    counter = itertools.count()
    start_cost = evaluator.graph_cost(graph, in_pins, out_pin).total
    best, best_cost = graph, start_cost
    if pool is not None:
        budget = pool.take(budget)
        if budget == 0:
            return best, best_cost
    heap: List[Tuple[float, int, Graph]] = [(start_cost, next(counter),
                                            graph)]
    seen = {graph.hash()}
    expansions = 0
    while heap and expansions < budget \
            and (pool is None or time.monotonic() < pool.deadline):
        cost, _, g = heapq.heappop(heap)
        if cost > alpha * best_cost:
            continue  # alpha-pruned
        expansions += 1
        for xfer in xfers:
            for g2 in xfer.run(g, max_num_ops):
                h = g2.hash()
                if h in seen:
                    continue
                seen.add(h)
                c2 = evaluator.graph_cost(g2, in_pins, out_pin).total
                if c2 < best_cost:
                    best, best_cost = g2, c2
                if c2 <= alpha * best_cost:
                    heapq.heappush(heap, (c2, next(counter), g2))
    if pool is not None:
        pool.spend(expansions)
    return best, best_cost


# ---------------------------------------------------------------------------
# Unity sequence-split DP
# ---------------------------------------------------------------------------
class UnitySearch:
    def __init__(self, evaluator: GraphCostEvaluator,
                 xfers: Sequence[GraphXfer], budget: int = 32,
                 alpha: float = 1.05, base_optimize_threshold: int = 12,
                 max_num_ops: int = 512,
                 pool: Optional[SearchPool] = None):
        self.ev = evaluator
        self.xfers = list(xfers)
        self.budget = budget
        self.alpha = alpha
        self.threshold = base_optimize_threshold
        self.max_num_ops = max_num_ops
        # whole-search budget: the DP visits many (subgraph, pins) leaves;
        # give the search `budget` expansions per leaf locally but at most
        # 16x `budget` expansions / 15+4*budget seconds GLOBALLY
        self.pool = pool or SearchPool(budget * 16, 15.0 + 4.0 * budget)
        self._memo: Dict[Tuple, Tuple[Graph, float]] = {}
        # structural (guid-independent) memo: identical transformer
        # blocks are isomorphic subproblems — solve one, replay the
        # rewrite onto the others (the reference memoizes by
        # dp_state_hash over op guids, graph.cc:1863, so it re-solves
        # every block; repeated-block models dominate the workload here)
        self._smemo: Dict[Tuple, Tuple[List[PNode], List, Graph,
                                       float]] = {}
        self.smemo_hits = 0
        self._run_cache: Dict[Tuple, Optional[Tuple]] = {}

    def _cut_layout_candidates(self, t: Tensor,
                               depth: int = 0) -> List[Layout]:
        """Candidate layouts of the cut tensor — the analog of enumerating
        the bottleneck node's machine views (reference ``graph.h:205``):
        replicated, every divisible dim at every realizable degree, and
        batch×feature 2-dim combinations. Ordered best-guess-first
        (replicated, batch shardings, feature, interior, combos) and
        capped at deeper DP levels to bound the layout×position
        combinatorics."""
        if not t.shape:
            return [()]
        rank = len(t.shape)
        degrees = sorted((d for d in self.ev.dmesh.valid_degrees()
                          if d > 1), reverse=True)
        batch: List[Layout] = []
        feature: List[Layout] = []
        interior_dims: List[Layout] = []
        combos: List[Layout] = []
        for d in degrees:
            if t.shape[0] % d == 0:
                batch.append(_layout({0: d}))
            if rank > 1 and t.shape[-1] % d == 0:
                feature.append(_layout({rank - 1: d}))
            for dim in range(1, rank - 1):
                if t.shape[dim] % d == 0:
                    interior_dims.append(_layout({dim: d}))
        if rank > 1:
            valid = set(self.ev.dmesh.valid_degrees())
            for d0 in degrees:
                if t.shape[0] % d0:
                    continue
                for d1 in degrees:
                    if t.shape[rank - 1] % d1 == 0 and d0 * d1 in valid:
                        combos.append(_layout({0: d0, rank - 1: d1}))
        cands = list(dict.fromkeys(
            [()] + batch + feature + interior_dims + combos))
        cap = 12 if depth < 2 else 6
        return cands[:cap]

    def _split_positions(self, interior: List[PNode], depth: int,
                         order: Optional[List[PNode]] = None
                         ) -> List[PNode]:
        """Split positions to try. Repeated-block boundaries (transformer
        blocks, residual stacks) are preferred: cutting there aligns the
        sub-chains on whole blocks, so offset-shifted chains become
        isomorphic subproblems and the structural memo replays one
        block-run's solution across the others. Otherwise: at shallow
        depth several bottlenecks compete (the reference's
        per-bottleneck recursion, substitution.cc:2572); deeper, the
        midpoint alone."""
        bounds: List[PNode] = []
        if order is not None and len(order) >= 6:
            from ..parallel.pipeline_lowering import find_repeated_run
            layers = [n.layer for n in order]
            # run detection is O(n^2)-ish; identical subgraphs recur
            # across the DP (pre/post splits rebuild the same node sets)
            rkey = tuple(l.guid for l in layers)
            if rkey in self._run_cache:
                run = self._run_cache[rkey]
            else:
                run = self._run_cache[rkey] = find_repeated_run(layers, 1)
            if run is not None:
                total, start, unit = run
                reps = total // unit
                by_layer = {n.layer.guid: n for n in order}
                ok = {n.guid for n in interior}
                for k in range(1, reps):
                    n = by_layer.get(layers[start + k * unit - 1].guid)
                    if n is not None and n.guid in ok:
                        bounds.append(n)
        if bounds:
            if depth >= 2 or len(bounds) == 1:
                return [bounds[len(bounds) // 2]]
            q = len(bounds) // 4
            picks = [bounds[len(bounds) // 2], bounds[q], bounds[-1 - q]]
            return list(dict.fromkeys(picks))
        if depth >= 2 or len(interior) == 1:
            return [interior[len(interior) // 2]]
        if len(interior) <= 3:
            return list(interior)
        q = len(interior) // 4
        picks = [interior[q], interior[len(interior) // 2],
                 interior[-1 - q]]
        return list(dict.fromkeys(picks))

    # ------------------------------------------------------------------
    # structural memoization (guid-independent; isomorphic-subproblem
    # replay across repeated blocks)
    # ------------------------------------------------------------------
    def _canonical(self, graph: Graph, in_pins: Dict[int, Layout],
                   out_pin) -> Tuple[Optional[Tuple],
                                     Optional[List[PNode]]]:
        """Fully-structural key of (subgraph, pins): node signatures in
        canonical (topo) order, positional edges/externals/outputs. Two
        isomorphic subproblems produce equal keys with position-aligned
        node lists; equality of the full key (not a hash) rules out
        collisions. Returns (None, None) when a pin references a tensor
        outside the subgraph's externals (no safe structural identity)."""
        from ..core.layer import _hashable
        order = graph.topo_order()
        pos = {n.guid: i for i, n in enumerate(order)}
        sigs = tuple(
            (n.layer.op_type, _hashable(n.layer.params),
             tuple((t.shape, t.dtype) for t in n.layer.inputs),
             tuple((t.shape, t.dtype) for t in n.layer.outputs),
             n.ann)
            for n in order)
        edges = tuple(sorted(
            (pos[e.src.guid], pos[e.dst.guid], e.src_idx, e.dst_idx)
            for es in graph.in_edges.values() for e in es))
        covered = set()
        ext = []
        for n in order:
            for slot, t in graph.external_inputs.get(n.guid, ()):
                covered.add(t.guid)
                ext.append((pos[n.guid], slot, tuple(t.shape), t.dtype,
                            in_pins.get(t.guid)))
        # pins on tensors the subgraph never consumes are inert (the
        # evaluator only consults pins for node-input tensors present in
        # the graph) and are EXCLUDED from the key; a pin on an internal
        # (non-external) consumed tensor cannot be keyed structurally
        consumed = {t.guid for n in order for t in n.layer.inputs}
        if any(g in consumed and g not in covered for g in in_pins):
            return None, order
        outs = tuple((pos[n.guid], i) for n, i in graph.outputs)
        return (sigs, edges, tuple(sorted(ext)), outs, out_pin), order

    def _replay(self, result: Graph, memo_order: List[PNode],
                memo_ext: List, query: Graph,
                query_order: List[PNode]) -> Optional[Graph]:
        """Re-instantiate a memoized optimized subgraph onto an
        isomorphic query subgraph: query layers substitute for memo
        layers position-by-position; layers the rewrite introduced
        (parallel ops, fused replacements) are cloned with their inputs
        re-plumbed to query tensors — exactly what re-running the same
        rewrite on the query block would create. Returns None when any
        tensor fails to map (caller re-searches)."""
        try:
            tmap: Dict[int, Tensor] = {}
            lmap: Dict[int, Layer] = {}
            for mn, qn in zip(memo_order, query_order):
                lmap[mn.layer.guid] = qn.layer
                for mt, qt in zip(mn.layer.outputs, qn.layer.outputs):
                    tmap[mt.guid] = qt
            qpos = {n.guid: i for i, n in enumerate(query_order)}
            qext = {}
            for n in query_order:
                for slot, t in query.external_inputs.get(n.guid, ()):
                    qext[(qpos[n.guid], slot)] = t
            for p, slot, t in memo_ext:
                tmap[t.guid] = qext[(p, slot)]
            g = Graph()
            new_nodes: Dict[int, PNode] = {}
            for n in result.topo_order():
                ql = lmap.get(n.layer.guid)
                if ql is None:
                    ins = [tmap[t.guid] for t in n.layer.inputs]
                    ql = Layer(n.layer.op_type, None, ins,
                               dict(n.layer.params))
                    for t in n.layer.outputs:
                        ql.outputs.append(Tensor(t.shape, t.dtype,
                                                 owner_layer=ql))
                    for mt, qt in zip(n.layer.outputs, ql.outputs):
                        tmap[mt.guid] = qt
                    lmap[n.layer.guid] = ql
                nn = PNode(ql, n.ann)
                new_nodes[n.guid] = nn
                g.add_node(nn)
            for es in result.in_edges.values():
                for e in es:
                    g.add_edge(new_nodes[e.src.guid], new_nodes[e.dst.guid],
                               e.src_idx, e.dst_idx)
            for guid, slots in result.external_inputs.items():
                if guid not in new_nodes:
                    continue
                g.external_inputs[new_nodes[guid].guid] = [
                    (slot, tmap[t.guid]) for slot, t in slots]
            g.input_tensors = [tmap[t.guid] for t in result.input_tensors]
            g.outputs = [(new_nodes[n.guid], i) for n, i in result.outputs]
            return g
        except KeyError:
            return None

    @staticmethod
    def _ext_list(graph: Graph, order: List[PNode]) -> List:
        pos = {n.guid: i for i, n in enumerate(order)}
        out = []
        for n in order:
            for slot, t in graph.external_inputs.get(n.guid, ()):
                out.append((pos[n.guid], slot, t))
        return out

    def _store(self, skey, graph, order, res) -> None:
        if skey is not None and skey not in self._smemo:
            self._smemo[skey] = (order, self._ext_list(graph, order),
                                 res[0], res[1])

    def optimize(self, graph: Graph,
                 in_pins: Optional[Dict[int, Layout]] = None,
                 out_pin: Optional[Layout] = None, depth: int = 0
                 ) -> Tuple[Graph, float]:
        """``generic_sequence_optimize``: recursively split at a bottleneck
        with DP over cut layouts; base case: best-first rewrite search."""
        in_pins = in_pins or {}
        key = (graph.hash(), tuple(sorted(in_pins.items())), out_pin)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        skey, order = self._canonical(graph, in_pins, out_pin)
        if skey is not None:
            sh = self._smemo.get(skey)
            if sh is not None:
                memo_order, memo_ext, res_g, res_c = sh
                replayed = self._replay(res_g, memo_order, memo_ext,
                                        graph, order)
                if replayed is not None:
                    self.smemo_hits += 1
                    res = (replayed, res_c)
                    self._memo[key] = res
                    return res
        interior = [n for n in graph.bottlenecks()
                    if graph.in_edges[n] and graph.out_edges[n]
                    and n.op_type not in PARALLEL_OPS
                    and n is not order[-1]]
        if graph.num_nodes() <= self.threshold or not interior \
                or depth > 6 or self.pool.take(1) == 0:
            res = base_optimize(graph, self.xfers, self.ev, self.budget,
                                self.alpha, self.max_num_ops, in_pins,
                                out_pin, pool=self.pool)
            self._memo[key] = res
            self._store(skey, graph, order, res)
            return res
        # DP over split positions × cut layouts (reference recurses at
        # each bottleneck over machine-view sets, substitution.cc:2572;
        # memoization by (subgraph hash, pins) keeps this polynomial)
        best_merged: Optional[Graph] = None
        best_cost = float("inf")
        for b in self._split_positions(interior, depth, order):
            pre, post = graph.split_at(b)
            # crossing tensors, positionally aligned with pre.outputs —
            # substitutions may replace the producing node (fresh output
            # Tensors), but graph.outputs positions are rewired in place,
            # so index k of the optimized pre's outputs still corresponds
            # to original cut tensor k
            cut_tensors = [n.layer.outputs[i] for n, i in pre.outputs]
            cut_t = b.layer.outputs[0]
            best_pair: Optional[Tuple[Graph, Graph]] = None
            split_cost = float("inf")
            for L in self._cut_layout_candidates(cut_t, depth):
                g1, c1 = self.optimize(pre, in_pins, L, depth + 1)
                if c1 >= min(split_cost, best_cost):
                    continue
                pins2 = dict(in_pins)
                pins2[cut_t.guid] = L
                g2, c2 = self.optimize(post, pins2, out_pin, depth + 1)
                if c1 + c2 < split_cost:
                    split_cost = c1 + c2
                    best_pair = (g1, g2)
            if best_pair is not None and split_cost < best_cost:
                best_cost = split_cost
                best_merged = _merge_split(best_pair[0], best_pair[1],
                                           graph,
                                           [t.guid for t in cut_tensors])
        if best_merged is None:
            raise RuntimeError(
                "sequence split produced no merged graph")
        res = (best_merged, best_cost)
        self._memo[key] = res
        self._store(skey, graph, order, res)
        return res


def _merge_split(pre: Graph, post: Graph, original: Graph,
                 cut_guids: Sequence[int]) -> Graph:
    """Stitch optimized halves back into one graph: reconnect post's
    external inputs that are pre's outputs. ``cut_guids[k]`` is the
    ORIGINAL tensor guid of pre's k-th output — after substitutions the
    producing node (and its output Tensor) may be new, so the mapping is
    positional, not by the optimized node's tensor guid."""
    g = Graph()
    for part in (pre, post):
        for n in part.in_edges:
            g.add_node(n)
        for edges in part.in_edges.values():
            for e in edges:
                g.add_edge(e.src, e.dst, e.src_idx, e.dst_idx)
    # pre's declared outputs by ORIGINAL crossing-tensor guid (positional)
    if len(cut_guids) != len(pre.outputs):
        raise RuntimeError(f"cut arity changed: {len(cut_guids)} vs "
                           f"{len(pre.outputs)}")
    pre_out: Dict[int, Tuple[PNode, int]] = {}
    for guid, (n, i) in zip(cut_guids, pre.outputs):
        pre_out[guid] = (n, i)
        pre_out.setdefault(n.layer.outputs[i].guid, (n, i))
    for n in post.in_edges:
        ext = post.external_inputs.get(n.guid, ())
        keep = []
        for slot, t in ext:
            if t.guid in pre_out:
                src, si = pre_out[t.guid]
                g.add_edge(src, n, si, slot)
            else:
                keep.append((slot, t))
        if keep:
            g.external_inputs[n.guid] = keep
    for n in pre.in_edges:
        if n.guid in pre.external_inputs:
            g.external_inputs[n.guid] = list(pre.external_inputs[n.guid])
    g.input_tensors = list(original.input_tensors)
    g.outputs = list(post.outputs)
    return g


# ---------------------------------------------------------------------------
# Memory-aware search (lambda binary search)
# ---------------------------------------------------------------------------
def graph_optimize_with_memory(graph: Graph, xfers: Sequence[GraphXfer],
                               cost_model: OpCostModel, dmesh: DeviceMesh,
                               mem_budget_bytes: float, budget: int = 32,
                               alpha: float = 1.05, iters: int = 6,
                               base_optimize_threshold: int = 12,
                               evaluator_cls=None
                               ) -> Tuple[Graph, GraphCost]:
    """Binary search on the memory weight lambda until the best strategy
    fits per-device HBM (reference ``graph_optimize_with_memory`` +
    ``try_one_lambda``, ``substitution.cc:1960``, ``graph.cc:1883``)."""
    if evaluator_cls is None:
        evaluator_cls = GraphCostEvaluator

    def run(lam: float) -> Tuple[Graph, GraphCost]:
        ev = evaluator_cls(cost_model, dmesh, mem_lambda=lam)
        search = UnitySearch(ev, xfers, budget=budget, alpha=alpha,
                             base_optimize_threshold=base_optimize_threshold)
        g, _ = search.optimize(graph)
        pure = evaluator_cls(cost_model, dmesh)
        return g, pure.graph_cost(g)

    g0, c0 = run(0.0)
    per_dev = c0.peak_memory / max(dmesh.num_devices, 1)
    if per_dev <= mem_budget_bytes:
        return g0, c0
    lo, hi = 0.0, 1e-6
    best_feasible: Optional[Tuple[Graph, GraphCost]] = None
    for _ in range(iters):
        g, c = run(hi)
        if c.peak_memory / max(dmesh.num_devices, 1) <= mem_budget_bytes:
            best_feasible = (g, c)
            break
        hi *= 10
    for _ in range(iters):
        mid = (lo + hi) / 2
        g, c = run(mid)
        if c.peak_memory / max(dmesh.num_devices, 1) <= mem_budget_bytes:
            best_feasible = (g, c)
            hi = mid
        else:
            lo = mid
    return best_feasible if best_feasible is not None else (g0, c0)


# ---------------------------------------------------------------------------
# Strategy extraction: optimized PCG -> executable program + shardings
# ---------------------------------------------------------------------------
def _group_tier_prefs(graph: Graph) -> Dict[str, str]:
    """Per-group axis-tier preference for placement-aware allocation:
    groups that shard weights or carry partial sums (tensor/reduce
    parallelism — per-op, per-layer collectives) belong on the fastest
    fabric (``"inner"``); pure output-sharding groups (data parallel —
    one gradient sync per step, lowered as a hierarchical tree) can
    afford the outermost tiers (``"outer"``)."""
    prefs: Dict[str, str] = {}
    for n in graph.in_edges:
        ann = n.ann
        for _w, _d, g in ann.weights:
            prefs[g] = "inner"
        if ann.reduce is not None:
            prefs[ann.reduce] = "inner"
        if ann.replicate is not None:
            prefs.setdefault(ann.replicate, "inner")
        for g, _d in ann.groups:
            prefs.setdefault(g, "outer")
    return prefs


def _allocate_group_axes(graph: Graph, dmesh: DeviceMesh,
                         placement_policy: Optional[str] = None
                         ) -> Dict[str, Tuple[str, ...]]:
    """Assign disjoint-where-needed atomic mesh axes to each annotation
    group, consistently across the whole graph (the analog of the
    reference's per-op MachineView assignment).

    With ``placement_policy="hier"`` the assignment is tier-aware: each
    group's axes are taken innermost- or outermost-first per
    :func:`_group_tier_prefs` — the axis→tier placement half of the
    arXiv 2110.10548 search space. ``None`` keeps the historical
    declaration-order greedy (the flat baseline)."""
    co: Dict[str, set] = {}
    degrees: Dict[str, int] = {}
    for n in graph.in_edges:
        gs = [g for g, _ in n.ann.groups]
        for g, d in n.ann.groups:
            degrees[g] = d
            co.setdefault(g, set()).update(x for x in gs if x != g)
    prefs = _group_tier_prefs(graph) if placement_policy == "hier" \
        else {}
    assign: Dict[str, Tuple[str, ...]] = {}
    # inner-preferring (tp/reduce) groups allocate FIRST so the fast
    # axes are still free when they ask; ties keep the legacy
    # biggest-degree-first order
    def alloc_rank(g: str) -> Tuple:
        return (0 if prefs.get(g) == "inner" else 1, -degrees[g], g)

    for g in sorted(degrees, key=alloc_rank):
        used: List[str] = []
        for other in co.get(g, ()):
            used.extend(assign.get(other, ()))
        prefer = prefs.get(g)
        axes = dmesh.allocate_axes(degrees[g], used, prefer=prefer)
        if axes is None:
            axes = dmesh.allocate_axes(degrees[g], [], prefer=prefer)
        assign[g] = axes or ()
    return assign


def extract_strategy(graph: Graph, info: GraphProgramInfo,
                     dmesh: DeviceMesh,
                     placement_policy: Optional[str] = None
                     ) -> ShardingStrategy:
    """Convert the optimized PCG into the executable ShardingStrategy.
    ``placement_policy="hier"`` makes the group→axis assignment
    tier-aware (see :func:`_allocate_group_axes`) and records the
    adopted axis→tier placement on the strategy."""
    st = ShardingStrategy(dmesh)
    axes_of = _allocate_group_axes(graph, dmesh, placement_policy)
    lay = propagate_layouts(graph)
    if placement_policy == "hier":
        try:
            st.axis_tiers = dict(dmesh.axis_tiers)
        except Exception:  # noqa: BLE001 — annotation is best-effort
            pass

    # group axes by (dim -> axes) for a node's layout: we need group names,
    # so rebuild specs from annotations for compute nodes and from layouts
    # (with deterministic axis choice) for parallel ops.
    def spec_from_groups(placements: Dict[int, Tuple[str, ...]], rank: int
                         ) -> Optional[Spec]:
        if not placements:
            return None
        entries = []
        for d in range(rank):
            ax = placements.get(d)
            if not ax:
                entries.append(None)
            else:
                entries.append(ax[0] if len(ax) == 1 else tuple(ax))
        return P(*entries)

    def axes_for_layout(layout: Layout) -> Dict[int, Tuple[str, ...]]:
        used: List[str] = []
        placements: Dict[int, Tuple[str, ...]] = {}
        # under hierarchical placement, batch (dim 0) layouts take the
        # outer tiers and feature/interior layouts the inner — matching
        # the group allocation above
        for dim, deg in layout:
            prefer = None
            if placement_policy == "hier":
                prefer = "outer" if dim == 0 else "inner"
            ax = dmesh.allocate_axes(deg, used, prefer=prefer)
            if ax is None:
                continue
            used.extend(ax)
            placements[dim] = ax
        return placements

    for n in graph.topo_order():
        exec_layer = info.node_to_layer.get(n.guid)
        if exec_layer is None or n.op_type == OperatorType.OP_INPUT:
            continue
        rank = len(exec_layer.outputs[0].shape) if exec_layer.outputs else 0
        ann = n.ann
        if not ann.is_trivial() and n.op_type not in PARALLEL_OPS:
            placements: Dict[int, Tuple[str, ...]] = {}
            valid = True
            for oi, dim, g in ann.out:
                if oi != 0:
                    continue
                ax = axes_of.get(g, ())
                if not ax:
                    valid = False
                    continue
                placements[dim] = placements.get(dim, ()) + ax
            out_spec = spec_from_groups(placements, rank) if valid else None
            wspecs: Dict[str, Spec] = {}
            wplace: Dict[str, Dict[int, Tuple[str, ...]]] = {}
            for wname, wdim, g in ann.weights:
                ax = axes_of.get(g, ())
                if ax:
                    wplace.setdefault(wname, {})[wdim] = ax
            for wname, pl in wplace.items():
                wrank = max(pl.keys()) + 1
                for w in exec_layer.weights:
                    if w.name == wname:
                        wrank = len(w.shape)
                        break
                sp = spec_from_groups(pl, wrank)
                if sp is not None:
                    wspecs[wname] = sp
            outs = [out_spec] + [None] * (len(exec_layer.outputs) - 1)
            st.set_op(exec_layer.name, outs, wspecs)
        else:
            # parallel ops / unannotated ops: constrain to the propagated
            # layout so the lowering materializes the intended collective
            layout = lay.get((n.guid, 0), ())
            pl = axes_for_layout(layout)
            sp = spec_from_groups(pl, rank)
            outs = [sp] + [None] * (max(len(exec_layer.outputs), 1) - 1)
            st.set_op(exec_layer.name, outs, {})

    # inputs: batch-shard when the first consumer's layout says so
    first_layouts: Dict[int, Layout] = {}
    for n in graph.topo_order():
        for s, t in graph.external_inputs.get(n.guid, ()):
            if t.guid not in first_layouts:
                lay_n = lay.get((n.guid, 0), ())
                first_layouts[t.guid] = lay_n
    for t in graph.input_tensors:
        L = first_layouts.get(t.guid, ())
        d0 = dict(L).get(0)
        if d0 and t.shape and t.shape[0] % d0 == 0:
            ax = dmesh.allocate_axes(
                d0, [], prefer="outer" if placement_policy == "hier"
                else None)
            if ax:
                st.inputs[t.name] = P(ax[0] if len(ax) == 1 else tuple(ax))
    errs = st.validate()
    if errs:
        for name in {e.split(":")[0] for e in errs}:
            st.ops.pop(name, None)
    return st


# ---------------------------------------------------------------------------
# Top-level entry
# ---------------------------------------------------------------------------
def data_parallel_graph(layers: Sequence[Layer],
                        input_tensors: Sequence[Tensor],
                        output_tensors: Sequence[Tensor],
                        dmesh: DeviceMesh) -> Graph:
    """The canonical data-parallel PCG: every op whose leading output dim
    divides the device count is batch-partitioned (the reference's
    ``--only-data-parallel`` view, ``graph.cc:1939``). Scoring this with
    the SAME evaluator as the search gives the search a floor: its
    answer is never predicted-worse than plain DP."""
    g = Graph.from_layers(layers, input_tensors, output_tensors)
    d = dmesh.num_devices
    for n in g.in_edges:
        if n.op_type in (OperatorType.OP_INPUT, OperatorType.OP_NOOP,
                         OperatorType.OP_WEIGHT) or d <= 1:
            continue
        outs = tuple((i, 0, "dp")
                     for i, t in enumerate(n.layer.outputs)
                     if t.shape and t.shape[0] % d == 0)
        if outs:
            n.ann = ParAnn(groups=(("dp", d),), out=outs)
    return g


def saturate_xfers(graph: Graph, xfers: Sequence[GraphXfer],
                   max_apply: int = 2048, max_num_ops: int = 4096) -> Graph:
    """Apply each xfer greedily (first match, repeat) until fixpoint."""
    applied = True
    while applied and max_apply > 0:
        applied = False
        for xf in xfers:
            while max_apply > 0:
                g2 = next(iter(xf.run(graph, max_num_ops)), None)
                if g2 is None:
                    break
                graph = g2
                applied = True
                max_apply -= 1
    return graph


def hybrid_template_graphs(layers: Sequence[Layer],
                           input_tensors: Sequence[Tensor],
                           output_tensors: Sequence[Tensor],
                           dmesh: DeviceMesh
                           ) -> List[Tuple[str, Graph]]:
    """Uniform composed-2D candidate strategies, one per (dp, tp)
    factorization of the machine: batch x column-parallel every Linear,
    batch x head-parallel every attention, batch-partition everything
    else by dp, then cancel adjacent combine/partition pairs.

    The reference's search starts FROM per-op data-parallel MachineViews
    (``graph.cc:1939``) so hybrid corners of the space are a few moves
    away; our rewrite search seeds from the serial graph, so these
    templates (like the DP floor) guarantee the well-known strategy
    families are always in the candidate set, whatever the budget."""
    from .substitution import (_ELEMENTWISE_PARTITIONABLE,
                               _NORM_PARTITIONABLE,
                               create_combine_partition_elimination,
                               create_partition_attention_combine_2d,
                               create_partition_ffn_2d,
                               create_partition_linear_combine_2d,
                               create_partition_op_combine)
    n = dmesh.num_devices
    degs = set(d for d in dmesh.valid_degrees() if d > 1)
    out: List[Tuple[str, Graph]] = []
    for dp in sorted(degs):
        tp = n // dp
        if dp >= n or n % dp or tp not in degs:
            continue
        base = Graph.from_layers(layers, input_tensors, output_tensors)
        # paired-FFN rule FIRST: it claims linear->linear chains before
        # the per-op column rule can split them apart
        xfers = [create_partition_ffn_2d(dp, tp),
                 create_partition_linear_combine_2d(dp, tp),
                 create_partition_attention_combine_2d(dp, tp)]
        for op_type, n_in in (_ELEMENTWISE_PARTITIONABLE
                              + _NORM_PARTITIONABLE
                              + ((OperatorType.OP_EMBEDDING, 1),)):
            xfers.append(create_partition_op_combine(op_type, n_in, 0, dp))
        xfers.append(create_combine_partition_elimination(0, dp))
        out.append((f"2d_dp{dp}xtp{tp}",
                    saturate_xfers(base, xfers)))
    return out


def unity_search(layers: Sequence[Layer], input_tensors: Sequence[Tensor],
                 output_tensors: Sequence[Tensor], dmesh: DeviceMesh,
                 cost_model: OpCostModel, budget: int = 32,
                 alpha: float = 1.05,
                 mem_budget_bytes: Optional[float] = None,
                 base_optimize_threshold: int = 12,
                 xfers: Optional[Sequence[GraphXfer]] = None,
                 evaluator_cls=None
                 ) -> Tuple[GraphProgramInfo, ShardingStrategy, GraphCost,
                            Graph]:
    """Full Unity pipeline: Layer graph -> PCG -> substitution/DP search ->
    executable program + ShardingStrategy (reference
    ``Graph::graph_optimize_task``, ``graph.cc:2046``).

    ``evaluator_cls`` selects the scoring backend: the additive
    GraphCostEvaluator (machine model v0; the JAX package's task-graph
    simulator, machine model v1, is not ported)."""
    graph = Graph.from_layers(layers, input_tensors, output_tensors)
    degrees = [d for d in dmesh.valid_degrees() if d > 1]
    if xfers is None:
        xfers = generate_all_pcg_xfers(degrees)
    if evaluator_cls is None:
        evaluator_cls = GraphCostEvaluator
    dp_predicted_total = None
    if mem_budget_bytes is not None:
        with obs_events.span("unity.memory_search", budget=budget):
            g, gc = graph_optimize_with_memory(
                graph, xfers, cost_model, dmesh, mem_budget_bytes, budget,
                alpha, base_optimize_threshold=base_optimize_threshold,
                evaluator_cls=evaluator_cls)
    else:
        ev = evaluator_cls(cost_model, dmesh)
        search = UnitySearch(ev, xfers, budget=budget, alpha=alpha,
                             base_optimize_threshold=base_optimize_threshold)
        with obs_events.span("unity.dp", budget=budget):
            g, _ = search.optimize(graph)
        gc = ev.graph_cost(g)
        # DP floor: never return a strategy predicted worse than the
        # canonical data-parallel view (the reference search starts FROM
        # per-op data-parallel configs, so DP is always in its space; our
        # rewrite search seeds from the serial graph and can exhaust its
        # budget before reaching full batch partitioning on small models)
        dp_g = data_parallel_graph(layers, input_tensors, output_tensors,
                                   dmesh)
        dp_gc = ev.graph_cost(dp_g)
        dp_predicted_total = dp_gc.total
        finalists = [(g, gc), (dp_g, dp_gc)]
        # hybrid composed-2D template floor (see hybrid_template_graphs)
        for _name, tg in hybrid_template_graphs(layers, input_tensors,
                                                output_tensors, dmesh):
            finalists.append((tg, ev.graph_cost(tg)))
        g, gc = min(finalists, key=lambda p: p[1].total)
    info = g.to_program()
    info.final_ranker = "additive"
    # predicted DP-baseline cost (already computed for the DP floor in
    # the non-memory branch) — consumed by optimizer reporting
    info.dp_predicted_total = dp_predicted_total
    strategy = extract_strategy(
        g, info, dmesh,
        placement_policy=getattr(cost_model, "placement_policy", None))
    return info, strategy, gc, g
