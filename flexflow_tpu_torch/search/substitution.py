"""Graph substitution engine: TASO-style rewrite rules over the PCG.
The port of ``flexflow_tpu/search/substitution.py``.

Reference analog: ``GraphXfer`` (``src/runtime/substitution.cc:596``),
``OpX``/``TensorX``/``PMConstraint`` (``include/flexflow/substitution.h:39-122``).
A rule is a source pattern (``src_ops``) matched against the graph with
backtracking, a destination pattern (``dst_ops``) instantiated in its place,
and a mapping of boundary outputs. Parallelization rules
(``create_partition_linear_combine`` etc., ``substitution.cc:61-110,1726``)
are generated programmatically per parallel degree; algebraic rule
collections load from JSON (``substitution_loader.py``).

Semantics: a dst op may *re-annotate* a matched compute op (new
``ParAnn`` — the analog of giving it a different machine view) and insert
parallel ops (Repartition/Combine/Replicate/Reduction) that execute as
sharding transitions (collectives), not explicit copies.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple, Union)

from ..core.layer import Layer
from ..core.tensor import Tensor
from ..ffconst import OperatorType
from ..pcg.graph import Graph, ParAnn, PNode

# A binding of a pattern-input TensorX to reality: either an internal
# producer ("node", PNode, out_idx) or a graph-external tensor ("ext", Tensor,
# consumer_guid_hint)
SrcBinding = Tuple


class TensorX:
    """Symbolic tensor in a pattern: output `idx` of pattern op `op`, or a
    free input (op is None) bound during matching."""
    __slots__ = ("op", "idx", "uid")
    _uid = itertools.count()

    def __init__(self, op: Optional["OpX"] = None, idx: int = 0):
        self.op = op
        self.idx = idx
        self.uid = next(TensorX._uid)

    def __repr__(self):
        return f"TX({self.op.name if self.op else 'in'}:{self.idx})"


@dataclasses.dataclass(frozen=True)
class PMConstraint:
    """Compare a layer param against a constant (reference ``PMConstraint``)."""
    key: str
    value: Any
    compare: str = "eq"   # eq | ne | ge | le

    def check(self, layer: Layer) -> bool:
        v = layer.params.get(self.key)
        if self.compare == "eq":
            return v == self.value
        if self.compare == "ne":
            return v != self.value
        if v is None:
            return False
        return v >= self.value if self.compare == "ge" else v <= self.value


class OpX:
    """Pattern op. In a src pattern: matches a graph node by op type,
    param constraints, annotation predicate, and input-wiring consistency.
    In a dst pattern: instantiates either a re-annotated copy of a matched
    src op (``share``) or a brand-new op (parallel ops, fused ops)."""

    def __init__(self, op_type: Optional[OperatorType],
                 inputs: Sequence[TensorX] = (), num_outputs: int = 1,
                 name: str = "", constraints: Sequence[PMConstraint] = (),
                 cond: Optional[Callable[[PNode, Graph], bool]] = None,
                 share: Optional["OpX"] = None,
                 ann: Union[None, ParAnn,
                            Callable[[Dict["OpX", PNode]], ParAnn]] = None,
                 params: Union[None, Dict[str, Any],
                               Callable[[Dict["OpX", PNode]],
                                        Dict[str, Any]]] = None):
        self.op_type = op_type
        self.inputs = list(inputs)
        self.outputs = [TensorX(self, i) for i in range(num_outputs)]
        self.name = name or (op_type.name.lower() if op_type else "any")
        self.constraints = list(constraints)
        self.cond = cond
        self.share = share        # dst-only: reuse matched layer of this OpX
        self.ann = ann            # dst-only: parallel annotation
        self.params = params      # dst-only: params for a new op
        # arity of a params callable, computed once (hot path avoids
        # per-application inspect.signature)
        if callable(params):
            import inspect
            self._params_nargs = len(inspect.signature(params).parameters)
        else:
            self._params_nargs = 0

    def out(self, idx: int = 0) -> TensorX:
        return self.outputs[idx]

    # -- src matching ------------------------------------------------------
    def can_match(self, node: PNode, graph: Graph) -> bool:
        if self.op_type is not None and node.op_type != self.op_type:
            return False
        if len(self.inputs) > (len(graph.in_edges[node])
                               + len(graph.external_inputs.get(node.guid, ()))):
            return False
        for c in self.constraints:
            if not c.check(node.layer):
                return False
        if self.cond is not None and not self.cond(node, graph):
            return False
        return True

    def __repr__(self):
        return f"OpX({self.name})"


class SkipRewrite(Exception):
    """Raised by dst-pattern param callables to veto one concrete rewrite
    (e.g. a loaded rule whose dim translation is invalid for the matched
    tensor ranks)."""


class GraphXfer:
    """One rewrite rule. ``run(graph)`` yields every rewritten graph."""

    def __init__(self, name: str, src_ops: Sequence[OpX],
                 dst_ops: Sequence[OpX],
                 mapped_outputs: Sequence[Tuple[TensorX, TensorX]]):
        self.name = name
        self.src_ops = list(src_ops)
        self.dst_ops = list(dst_ops)
        self.mapped_outputs = list(mapped_outputs)
        # layer cache for instantiated dst ops, keyed by
        # (op_type, params, input tensor guids) — the analog of the
        # reference's get_or_create_node caching (model.h:678)
        self._layer_cache: Dict[Tuple, Layer] = {}

    # ------------------------------------------------------------------
    def run(self, graph: Graph, max_num_ops: int = 10_000
            ) -> Iterable[Graph]:
        """Backtracking match over src_ops (reference ``GraphXfer::run``),
        yielding one rewritten graph per complete, safe match."""
        mapping: Dict[OpX, PNode] = {}
        bindings: Dict[int, SrcBinding] = {}   # TensorX.uid -> binding
        yield from self._match(0, graph, mapping, bindings, max_num_ops)

    # ------------------------------------------------------------------
    def _input_binding_of(self, graph: Graph, node: PNode, slot: int
                          ) -> Optional[SrcBinding]:
        e = graph.producer(node, slot)
        if e is not None:
            return ("node", e.src, e.src_idx)
        for s, t in graph.external_inputs.get(node.guid, ()):
            if s == slot:
                return ("ext", t)
        return None

    def _try_bind(self, tx: TensorX, actual: SrcBinding,
                  mapping: Dict[OpX, PNode],
                  bindings: Dict[int, SrcBinding]) -> Optional[bool]:
        """Returns True if newly bound (caller must unbind), False if
        consistent with an existing binding, None on conflict."""
        if tx.op is not None:
            # must be the output of the matched node for tx.op
            m = mapping.get(tx.op)
            if m is None:
                # pattern op not yet matched: defer — record as binding
                if tx.uid in bindings:
                    return False if bindings[tx.uid] == actual else None
                bindings[tx.uid] = actual
                return True
            want = ("node", m, tx.idx)
            return False if actual == want else None
        if tx.uid in bindings:
            return False if bindings[tx.uid] == actual else None
        bindings[tx.uid] = actual
        return True

    def _match(self, depth: int, graph: Graph, mapping: Dict[OpX, PNode],
               bindings: Dict[int, SrcBinding], max_num_ops: int
               ) -> Iterable[Graph]:
        if depth == len(self.src_ops):
            if self._check_match_safe(graph, mapping, bindings):
                try:
                    g2 = self._apply(graph, mapping, bindings)
                except SkipRewrite:
                    g2 = None
                if g2 is not None and g2.num_nodes() <= max_num_ops:
                    yield g2
            return
        opx = self.src_ops[depth]
        matched = set(mapping.values())
        for node in list(graph.in_edges.keys()):
            if node in matched or not opx.can_match(node, graph):
                continue
            # check + record input wiring
            newly: List[int] = []
            ok = True
            for slot, tx in enumerate(opx.inputs):
                actual = self._input_binding_of(graph, node, slot)
                if actual is None:
                    ok = False
                    break
                r = self._try_bind(tx, actual, mapping, bindings)
                if r is None:
                    ok = False
                    break
                if r:
                    newly.append(tx.uid)
            if ok:
                # deferred check: outputs of this node that earlier pattern
                # ops consumed must line up
                mapping[opx] = node
                if self._outputs_consistent(opx, node, bindings):
                    yield from self._match(depth + 1, graph, mapping,
                                           bindings, max_num_ops)
                del mapping[opx]
            for uid in newly:
                del bindings[uid]

    def _outputs_consistent(self, opx: OpX, node: PNode,
                            bindings: Dict[int, SrcBinding]) -> bool:
        for tx in opx.outputs:
            b = bindings.get(tx.uid)
            if b is not None and b != ("node", node, tx.idx):
                return False
        return True

    # ------------------------------------------------------------------
    def _check_match_safe(self, graph: Graph, mapping: Dict[OpX, PNode],
                          bindings: Dict[int, SrcBinding]) -> bool:
        """Every edge from a matched node to the outside must leave through
        a mapped output (reference: srcOp output use check)."""
        matched = set(mapping.values())
        mapped_src: Set[Tuple[int, int]] = set()
        for stx, _ in self.mapped_outputs:
            m = mapping.get(stx.op)
            if m is None:
                return False
            mapped_src.add((m.guid, stx.idx))
        for opx, node in mapping.items():
            for e in graph.out_edges[node]:
                if e.dst not in matched and \
                        (node.guid, e.src_idx) not in mapped_src:
                    return False
            # graph outputs count as external consumers
            for (n, i) in graph.outputs:
                if n is node and (node.guid, i) not in mapped_src:
                    return False
        return True

    # ------------------------------------------------------------------
    def _resolve_ann(self, opx: OpX, mapping) -> ParAnn:
        if opx.ann is None:
            return ParAnn.trivial()
        return opx.ann(mapping) if callable(opx.ann) else opx.ann

    def _resolve_params(self, opx: OpX, mapping,
                        in_tensors: Optional[List[Tensor]] = None
                        ) -> Dict[str, Any]:
        if opx.params is None:
            return {}
        if callable(opx.params):
            # loader-generated params also need the concrete input tensors
            # (rank/shape-dependent dim translation); programmatic xfers
            # take mapping only
            return (opx.params(mapping, in_tensors)
                    if opx._params_nargs >= 2 else opx.params(mapping))
        return dict(opx.params)

    def _dst_layer(self, opx: OpX, in_tensors: List[Tensor],
                   mapping) -> Layer:
        """Create (or fetch cached) the concrete Layer for a new dst op."""
        params = self._resolve_params(opx, mapping, in_tensors)
        key = (opx.op_type,
               tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                            for k, v in params.items())),
               tuple(t.guid for t in in_tensors))
        hit = self._layer_cache.get(key)
        if hit is not None:
            return hit
        layer = Layer(opx.op_type, None, in_tensors, params)
        # real shape inference via the op registry (loaded rules introduce
        # shape-changing dst ops like Concat/Split); identity fallback ONLY
        # for unregistered ops — a registered op whose infer rejects these
        # inputs vetoes the rewrite instead of fabricating a wrong shape
        from ..ops import get_op_def
        try:
            op = get_op_def(opx.op_type)
        except (KeyError, NotImplementedError):
            op = None
        if op is None:
            for t in in_tensors[:1]:
                layer.outputs.append(
                    Tensor(t.shape, t.dtype, owner_layer=layer))
        else:
            try:
                outs = op.infer(params, [t.shape for t in in_tensors],
                                [t.dtype for t in in_tensors])
            except Exception as e:
                raise SkipRewrite(f"{opx.name}: infer failed: {e}")
            for shape, dt in outs:
                layer.outputs.append(Tensor(shape, dt, owner_layer=layer))
        self._layer_cache[key] = layer
        return layer

    def _apply(self, graph: Graph, mapping: Dict[OpX, PNode],
               bindings: Dict[int, SrcBinding]) -> Optional[Graph]:
        g = graph.copy()
        matched = set(mapping.values())

        # tx.uid -> concrete ("node", PNode, idx) or ("ext", Tensor) in g
        def src_loc(tx: TensorX) -> SrcBinding:
            if tx.op is not None and tx.op in mapping:
                return ("node", mapping[tx.op], tx.idx)
            b = bindings.get(tx.uid)
            if b is None:
                raise RuntimeError(f"unbound pattern input {tx}")
            return b

        # Instantiate dst ops in dependency order.
        dst_nodes: Dict[OpX, PNode] = {}
        produced: Dict[int, Tuple[PNode, int]] = {}  # tx.uid -> (node, idx)

        def resolve(tx: TensorX) -> SrcBinding:
            if tx.uid in produced:
                n, i = produced[tx.uid]
                return ("node", n, i)
            if tx.op is not None and tx.op in dst_nodes:
                return ("node", dst_nodes[tx.op], tx.idx)
            return src_loc(tx)

        pending = list(self.dst_ops)
        while pending:
            progressed = False
            for opx in list(pending):
                locs = []
                ready = True
                for tx in opx.inputs:
                    if tx.op is not None and tx.op in [p for p in pending
                                                       if p is not opx]:
                        ready = False
                        break
                    locs.append(resolve(tx))
                if not ready:
                    continue
                pending.remove(opx)
                progressed = True
                ann = self._resolve_ann(opx, mapping)
                if opx.share is not None:
                    layer = mapping[opx.share].layer
                    node = PNode(layer, ann)
                else:
                    in_ts: List[Tensor] = []
                    for loc in locs:
                        if loc[0] == "node":
                            in_ts.append(loc[1].layer.outputs[loc[2]])
                        else:
                            in_ts.append(loc[1])
                    layer = self._dst_layer(opx, in_ts, mapping)
                    node = PNode(layer, ann)
                dst_nodes[opx] = node
                g.add_node(node)
                for slot, loc in enumerate(locs):
                    if loc[0] == "node":
                        g.add_edge(loc[1], node, loc[2], slot)
                    else:
                        g.external_inputs.setdefault(node.guid, []).append(
                            (slot, loc[1]))
                for tx in opx.outputs:
                    produced[tx.uid] = (node, tx.idx)
            if not progressed:
                return None  # cyclic dst pattern

        # Rewire external consumers of mapped outputs.
        for stx, dtx in self.mapped_outputs:
            src_node = mapping[stx.op]
            d = resolve(dtx)
            if d[0] != "node":
                raise RuntimeError(
                    f"substitution output resolved to {d[0]}, expected "
                    f"a node binding")
            d_node, d_idx = d[1], d[2]
            for e in list(g.out_edges.get(src_node, ())):
                if e.src_idx == stx.idx and e.dst not in matched:
                    g.remove_edge(e)
                    g.add_edge(d_node, e.dst, d_idx, e.dst_idx)
            g.outputs = [(d_node, d_idx)
                         if (n is src_node and i == stx.idx) else (n, i)
                         for n, i in g.outputs]
        # Remove matched nodes.
        for node in matched:
            g.remove_node(node)
        return g

    def __repr__(self):
        return f"GraphXfer({self.name})"


# ===========================================================================
# Programmatic parallelization xfers (reference substitution.cc:61-110,1726)
# ===========================================================================
def _unannotated(node: PNode, graph: Graph) -> bool:
    return node.ann.is_trivial()


def _rank_of(node: PNode) -> int:
    return len(node.layer.outputs[0].shape)


def _divisible(dim: int, d: int) -> Callable[[PNode, Graph], bool]:
    def cond(node: PNode, graph: Graph) -> bool:
        if not node.ann.is_trivial():
            return False
        shape = node.layer.outputs[0].shape
        dd = dim if dim >= 0 else len(shape) + dim
        return 0 <= dd < len(shape) and shape[dd] % d == 0 \
            and shape[dd] >= d
    return cond


def _partition(x: TensorX, dim: int, degree: int, group: str) -> OpX:
    return OpX(OperatorType.OP_REPARTITION, [x],
               params={"dim": dim, "degree": degree, "group": group},
               ann=ParAnn(groups=((group, degree),),
                          out=((0, dim, group),)))


def _combine(x: TensorX, dim: int, degree: int, group: str) -> OpX:
    return OpX(OperatorType.OP_COMBINE, [x],
               params={"dim": dim, "degree": degree, "group": group})


def _replicate(x: TensorX, degree: int, group: str) -> OpX:
    return OpX(OperatorType.OP_REPLICATE, [x],
               params={"degree": degree, "group": group},
               ann=ParAnn(groups=((group, degree),), replicate=group))


def _reduction(x: TensorX, degree: int, group: str) -> OpX:
    return OpX(OperatorType.OP_REDUCTION, [x],
               params={"degree": degree, "group": group})


def create_partition_op_combine(op_type: OperatorType, n_inputs: int,
                                dim: int, degree: int,
                                weight_dims: Sequence[Tuple[str, int]] = (),
                                name: Optional[str] = None) -> GraphXfer:
    """Generic data/attribute-partition rule: partition every input along
    ``dim`` by ``degree``, run the op sharded, combine the output.
    Reference: ``create_partition_add_combine``/``relu``/``softmax``/
    ``concat`` family."""
    g = f"p{dim}d{degree}"
    src_ins = [TensorX() for _ in range(n_inputs)]
    src = OpX(op_type, src_ins, cond=_divisible(dim, degree))
    parts = [_partition(t, dim, degree, g) for t in src_ins]
    dst = OpX(op_type, [p.out() for p in parts], share=src,
              ann=ParAnn(groups=((g, degree),), out=((0, dim, g),),
                         weights=tuple((w, wd, g) for w, wd in weight_dims)))
    comb = _combine(dst.out(), dim, degree, g)
    nm = name or f"partition_{op_type.name[3:].lower()}_dim{dim}_deg{degree}"
    return GraphXfer(nm, [src], parts + [dst, comb],
                     [(src.out(), comb.out())])


def create_partition_linear_combine(degree: int, out_dim: int = 0
                                    ) -> GraphXfer:
    """Batch-partition a Linear (reference
    ``create_partition_linear_combine``, ``substitution.cc:61``)."""
    return create_partition_op_combine(OperatorType.OP_LINEAR, 1, out_dim,
                                       degree)


def create_replicate_linear_combine(degree: int) -> GraphXfer:
    """Column-parallel (tensor-parallel) Linear: replicate the input, shard
    the kernel's output dim, combine the sharded last output dim.
    Reference: ``create_replicate_linear_combine``."""
    g = f"tp{degree}"
    x = TensorX()
    src = OpX(OperatorType.OP_LINEAR, [x],
              cond=lambda n, gr: (_unannotated(n, gr)
                                  and n.layer.outputs[0].shape[-1] % degree
                                  == 0
                                  and n.layer.outputs[0].shape[-1] >= degree))
    rep = _replicate(x, degree, g)

    def ann(mapping):
        r = _rank_of(mapping[src])
        return ParAnn(groups=((g, degree),), out=((0, r - 1, g),),
                      weights=(("kernel", 1, g), ("bias", 0, g)))

    dst = OpX(OperatorType.OP_LINEAR, [rep.out()], share=src, ann=ann)

    def comb_params(mapping):
        return {"dim": _rank_of(mapping[src]) - 1, "degree": degree,
                "group": g}

    comb = OpX(OperatorType.OP_COMBINE, [dst.out()], params=comb_params)
    return GraphXfer(f"replicate_linear_combine_deg{degree}", [src],
                     [rep, dst, comb], [(src.out(), comb.out())])


def create_partition_linear_reduce(degree: int) -> GraphXfer:
    """Row-parallel Linear: partition the contraction dim of input + kernel;
    outputs are partial sums resolved by a Reduction (all-reduce).
    Reference: partition_linear w/ Reduction dst."""
    g = f"rp{degree}"
    x = TensorX()

    def cond(n: PNode, gr: Graph) -> bool:
        if not _unannotated(n, gr):
            return False
        ishape = n.layer.inputs[0].shape
        return bool(ishape) and ishape[-1] % degree == 0 \
            and ishape[-1] >= degree

    src = OpX(OperatorType.OP_LINEAR, [x], cond=cond)

    def part_params(mapping):
        r = len(mapping[src].layer.inputs[0].shape)
        return {"dim": r - 1, "degree": degree, "group": g}

    part = OpX(OperatorType.OP_REPARTITION, [x], params=part_params,
               ann=ParAnn(groups=((g, degree),)))
    dst = OpX(OperatorType.OP_LINEAR, [part.out()], share=src,
              ann=ParAnn(groups=((g, degree),),
                         weights=(("kernel", 0, g),), reduce=g))
    red = _reduction(dst.out(), degree, g)
    return GraphXfer(f"partition_linear_reduce_deg{degree}", [src],
                     [part, dst, red], [(src.out(), red.out())])


def create_partition_attention_combine(degree: int) -> GraphXfer:
    """Head-parallel MultiHeadAttention: replicate inputs, shard all
    projection weights on the head dim, all-reduce after the output
    projection. Reference: ``create_partition_attention_combine``
    (``substitution.cc:1756-1769``)."""
    g = f"hp{degree}"
    q, k, v = TensorX(), TensorX(), TensorX()

    def cond(n: PNode, gr: Graph) -> bool:
        return _unannotated(n, gr) and \
            n.layer.params.get("num_heads", 1) % degree == 0 and \
            n.layer.params.get("num_heads", 1) >= degree

    src = OpX(OperatorType.OP_MULTIHEAD_ATTENTION, [q, k, v], cond=cond)
    reps = [_replicate(t, degree, g) for t in (q, k, v)]
    dst = OpX(OperatorType.OP_MULTIHEAD_ATTENTION,
              [r.out() for r in reps], share=src,
              ann=ParAnn(groups=((g, degree),),
                         weights=(("wq", 1, g), ("wk", 1, g), ("wv", 1, g),
                                  ("wo", 0, g), ("bq", 0, g), ("bk", 0, g),
                                  ("bv", 0, g)),
                         reduce=g))
    red = _reduction(dst.out(), degree, g)
    return GraphXfer(f"partition_attention_combine_deg{degree}", [src],
                     reps + [dst, red], [(src.out(), red.out())])


def create_partition_conv2d_combine(degree: int) -> GraphXfer:
    return create_partition_op_combine(OperatorType.OP_CONV2D, 1, 0, degree)


def create_partition_embedding_combine(degree: int) -> GraphXfer:
    """Parameter-parallel embedding: shard the table's output-feature dim."""
    g = f"ep{degree}"
    x = TensorX()

    def cond(n: PNode, gr: Graph) -> bool:
        return _unannotated(n, gr) and \
            n.layer.outputs[0].shape[-1] % degree == 0

    src = OpX(OperatorType.OP_EMBEDDING, [x], cond=cond)

    def ann(mapping):
        r = _rank_of(mapping[src])
        return ParAnn(groups=((g, degree),), out=((0, r - 1, g),),
                      weights=(("kernel", 1, g),))

    dst = OpX(OperatorType.OP_EMBEDDING, [x], share=src, ann=ann)

    def comb_params(mapping):
        return {"dim": _rank_of(mapping[src]) - 1, "degree": degree,
                "group": g}

    comb = OpX(OperatorType.OP_COMBINE, [dst.out()], params=comb_params)
    return GraphXfer(f"partition_embedding_combine_deg{degree}", [src],
                     [dst, comb], [(src.out(), comb.out())])


# ---------------------------------------------------------------------------
# Composed 2D machine views. The reference enumerates per-op MachineViews
# with multiple parallel degrees at once (``graph.h:205``: a view can
# partition batch AND an attribute dim). Single-group xfers cannot compose
# — every ``cond`` requires an unannotated source — so the composed view
# must be reachable in ONE rewrite. These rules take a serial op directly
# to a batch(dp) x feature/head(tp) hybrid, the strategy family Megatron/
# Unity find for transformer blocks.
# ---------------------------------------------------------------------------
def _col_linear_cond(dp: int, tp: int):
    """Shared eligibility for batch(dp) x column(tp) linear rewrites."""
    def cond(n: PNode, gr: Graph) -> bool:
        if not _unannotated(n, gr):
            return False
        o = n.layer.outputs[0].shape
        return len(o) >= 2 and o[0] % dp == 0 and o[0] >= dp \
            and o[-1] % tp == 0 and o[-1] >= tp
    return cond


def _col_linear_ann(src: OpX, dp: int, tp: int, g1: str, g2: str):
    """Shared annotation: batch on g1, kernel output-dim on g2."""
    def ann(mapping):
        r = _rank_of(mapping[src])
        return ParAnn(groups=((g1, dp), (g2, tp)),
                      out=((0, 0, g1), (0, r - 1, g2)),
                      weights=(("kernel", 1, g2), ("bias", 0, g2)))
    return ann


def create_partition_linear_combine_2d(dp: int, tp: int) -> GraphXfer:
    """Batch-partition by ``dp`` AND column-parallel the kernel by ``tp``
    in one rewrite (composed analog of ``create_partition_linear_combine``
    + ``create_replicate_linear_combine``)."""
    g1, g2 = f"dp{dp}", f"tp{tp}"
    x = TensorX()
    src = OpX(OperatorType.OP_LINEAR, [x], cond=_col_linear_cond(dp, tp))
    part = _partition(x, 0, dp, g1)
    rep = _replicate(part.out(), tp, g2)
    dst = OpX(OperatorType.OP_LINEAR, [rep.out()], share=src,
              ann=_col_linear_ann(src, dp, tp, g1, g2))

    def comb_params(mapping):
        return {"dim": _rank_of(mapping[src]) - 1, "degree": tp,
                "group": g2}

    comb_tp = OpX(OperatorType.OP_COMBINE, [dst.out()], params=comb_params)
    comb_dp = _combine(comb_tp.out(), 0, dp, g1)
    return GraphXfer(f"partition_linear_combine_2d_dp{dp}xtp{tp}", [src],
                     [part, rep, dst, comb_tp, comb_dp],
                     [(src.out(), comb_dp.out())])


def create_partition_linear_reduce_2d(dp: int, tp: int) -> GraphXfer:
    """Batch-partition by ``dp`` AND row-parallel the kernel's contraction
    dim by ``tp``: outputs are partial sums resolved by a Reduction within
    each batch shard."""
    g1, g2 = f"dp{dp}", f"rp{tp}"
    x = TensorX()

    def cond(n: PNode, gr: Graph) -> bool:
        if not _unannotated(n, gr):
            return False
        o = n.layer.outputs[0].shape
        ish = n.layer.inputs[0].shape
        return bool(o) and o[0] % dp == 0 and o[0] >= dp and bool(ish) \
            and ish[-1] % tp == 0 and ish[-1] >= tp

    src = OpX(OperatorType.OP_LINEAR, [x], cond=cond)
    part_b = _partition(x, 0, dp, g1)

    def part_params(mapping):
        r = len(mapping[src].layer.inputs[0].shape)
        return {"dim": r - 1, "degree": tp, "group": g2}

    part_k = OpX(OperatorType.OP_REPARTITION, [part_b.out()],
                 params=part_params, ann=ParAnn(groups=((g2, tp),)))
    dst = OpX(OperatorType.OP_LINEAR, [part_k.out()], share=src,
              ann=ParAnn(groups=((g1, dp), (g2, tp)), out=((0, 0, g1),),
                         weights=(("kernel", 0, g2),), reduce=g2))
    red = _reduction(dst.out(), tp, g2)
    comb = _combine(red.out(), 0, dp, g1)
    return GraphXfer(f"partition_linear_reduce_2d_dp{dp}xrp{tp}", [src],
                     [part_b, part_k, dst, red, comb],
                     [(src.out(), comb.out())])


def create_partition_attention_combine_2d(dp: int, tp: int) -> GraphXfer:
    """Batch-partition by ``dp`` AND head-parallel MultiHeadAttention by
    ``tp`` (composed analog of ``create_partition_attention_combine``,
    ``substitution.cc:1756``)."""
    g1, g2 = f"dp{dp}", f"hp{tp}"
    q, k, v = TensorX(), TensorX(), TensorX()

    def cond(n: PNode, gr: Graph) -> bool:
        if not _unannotated(n, gr):
            return False
        o = n.layer.outputs[0].shape
        h = n.layer.params.get("num_heads", 1)
        return bool(o) and o[0] % dp == 0 and o[0] >= dp \
            and h % tp == 0 and h >= tp

    src = OpX(OperatorType.OP_MULTIHEAD_ATTENTION, [q, k, v], cond=cond)
    parts = [_partition(t, 0, dp, g1) for t in (q, k, v)]
    reps = [_replicate(p.out(), tp, g2) for p in parts]
    dst = OpX(OperatorType.OP_MULTIHEAD_ATTENTION,
              [r.out() for r in reps], share=src,
              ann=ParAnn(groups=((g1, dp), (g2, tp)),
                         out=((0, 0, g1),),
                         weights=(("wq", 1, g2), ("wk", 1, g2),
                                  ("wv", 1, g2), ("wo", 0, g2),
                                  ("bq", 0, g2), ("bk", 0, g2),
                                  ("bv", 0, g2)),
                         reduce=g2))
    red = _reduction(dst.out(), tp, g2)
    comb = _combine(red.out(), 0, dp, g1)
    return GraphXfer(f"partition_attention_combine_2d_dp{dp}xhp{tp}", [src],
                     parts + reps + [dst, red, comb],
                     [(src.out(), comb.out())])


def create_partition_ffn_2d(dp: int, tp: int) -> GraphXfer:
    """Megatron-paired FFN in one rewrite: Linear -> Linear becomes
    batch-partition(dp) x [column-parallel d1 -> row-parallel d2] with a
    SINGLE tp all-reduce after d2 — the intermediate (the wide dim)
    never leaves the shard, unlike rewriting the two linears
    independently (which gathers the wide activation). The canonical
    transformer-FFN machine view (Megatron-LM); the reference's rule set
    reaches it only through multi-step substitution chains."""
    g1, g2 = f"dp{dp}", f"mp{tp}"
    x = TensorX()
    l1 = OpX(OperatorType.OP_LINEAR, [x], cond=_col_linear_cond(dp, tp))
    # l2's input IS l1's output, so cond1's last-dim % tp check already
    # guarantees l2's contraction-dim divisibility
    l2 = OpX(OperatorType.OP_LINEAR, [l1.out()], cond=_unannotated)

    part = _partition(x, 0, dp, g1)
    rep = _replicate(part.out(), tp, g2)
    d1 = OpX(OperatorType.OP_LINEAR, [rep.out()], share=l1,
             ann=_col_linear_ann(l1, dp, tp, g1, g2))
    d2 = OpX(OperatorType.OP_LINEAR, [d1.out()], share=l2,
             ann=ParAnn(groups=((g1, dp), (g2, tp)), out=((0, 0, g1),),
                        weights=(("kernel", 0, g2),), reduce=g2))
    red = _reduction(d2.out(), tp, g2)
    comb = _combine(red.out(), 0, dp, g1)
    return GraphXfer(f"partition_ffn_2d_dp{dp}xmp{tp}", [l1, l2],
                     [part, rep, d1, d2, red, comb],
                     [(l2.out(), comb.out())])


def degree_pairs(degrees: Sequence[int]) -> List[Tuple[int, int]]:
    """(dp, tp) pairs whose product is itself a realizable degree —
    the composed-2D rule instantiation set."""
    ds = sorted({d for d in degrees if d > 1})
    dset = set(ds)
    return [(a, b) for a in ds for b in ds if a * b in dset]


def create_partition_combine_elimination(dim: int, degree: int) -> GraphXfer:
    """Repartition(dim,d) then Combine(dim,d) → identity."""
    x = TensorX()
    c1 = PMConstraint("dim", dim)
    c2 = PMConstraint("degree", degree)
    part = OpX(OperatorType.OP_REPARTITION, [x], constraints=[c1, c2])
    comb = OpX(OperatorType.OP_COMBINE, [part.out()], constraints=[c1, c2])
    noop = OpX(OperatorType.OP_NOOP, [x])
    return GraphXfer(f"partition_combine_elim_dim{dim}_deg{degree}",
                     [part, comb], [noop], [(comb.out(), noop.out())])


def create_combine_partition_elimination(dim: int, degree: int) -> GraphXfer:
    """Combine(dim,d) then Repartition(dim,d) → identity — the propagation
    enabler that merges adjacent partitioned regions
    (reference leaf/fuse patterns, ``substitution.cc:1726``)."""
    x = TensorX()
    c1 = PMConstraint("dim", dim)
    c2 = PMConstraint("degree", degree)
    comb = OpX(OperatorType.OP_COMBINE, [x], constraints=[c1, c2])
    part = OpX(OperatorType.OP_REPARTITION, [comb.out()],
               constraints=[c1, c2])
    noop = OpX(OperatorType.OP_NOOP, [x])
    return GraphXfer(f"combine_partition_elim_dim{dim}_deg{degree}",
                     [comb, part], [noop], [(part.out(), noop.out())])


def create_reduction_replicate_elimination(degree: int) -> GraphXfer:
    """Replicate(d) ∘ Reduction(d) -> Reduction (replication after a full
    all-reduce is free under GSPMD)."""
    x = TensorX()
    c = PMConstraint("degree", degree)
    red = OpX(OperatorType.OP_REDUCTION, [x], constraints=[c])
    rep = OpX(OperatorType.OP_REPLICATE, [red.out()], constraints=[c])
    red2 = OpX(OperatorType.OP_REDUCTION, [x],
               params={"degree": degree, "group": f"r{degree}"})
    return GraphXfer(f"reduction_replicate_elim_deg{degree}",
                     [red, rep], [red2], [(rep.out(), red2.out())])


_ELEMENTWISE_PARTITIONABLE = (
    (OperatorType.OP_RELU, 1), (OperatorType.OP_GELU, 1),
    (OperatorType.OP_SIGMOID, 1), (OperatorType.OP_TANH, 1),
    (OperatorType.OP_EW_ADD, 2), (OperatorType.OP_EW_MUL, 2),
    (OperatorType.OP_SOFTMAX, 1), (OperatorType.OP_DROPOUT, 1),
    (OperatorType.OP_POOL2D, 1), (OperatorType.OP_FLAT, 1),
    (OperatorType.OP_CAST, 1),
)

# Norm ops: batch-partition the activations; the (replicated) scale/bias
# weights carry no placement, so they need no weight_dims entries.
_NORM_PARTITIONABLE = (
    (OperatorType.OP_LAYERNORM, 1),
    (OperatorType.OP_RMSNORM, 1),
    (OperatorType.OP_BATCHNORM, 1),
)


def generate_all_pcg_xfers(degrees: Sequence[int],
                           include_eliminations: bool = True,
                           max_dims: int = 4) -> List[GraphXfer]:
    """All parallelization + elimination rules for the given degrees —
    the analog of ``generate_all_pcg_xfers`` (``substitution.cc:1726``)."""
    xfers: List[GraphXfer] = []
    for d in degrees:
        if d <= 1:
            continue
        xfers.append(create_partition_linear_combine(d))
        xfers.append(create_replicate_linear_combine(d))
        xfers.append(create_partition_linear_reduce(d))
        xfers.append(create_partition_attention_combine(d))
        xfers.append(create_partition_conv2d_combine(d))
        xfers.append(create_partition_embedding_combine(d))
        for op_type, n_in in (_ELEMENTWISE_PARTITIONABLE
                              + _NORM_PARTITIONABLE):
            xfers.append(create_partition_op_combine(op_type, n_in, 0, d))
        if include_eliminations:
            for dim in range(max_dims):
                xfers.append(create_combine_partition_elimination(dim, d))
                xfers.append(create_partition_combine_elimination(dim, d))
            xfers.append(create_reduction_replicate_elimination(d))
    for dp, tp in degree_pairs(degrees):
        xfers.append(create_partition_linear_combine_2d(dp, tp))
        xfers.append(create_partition_linear_reduce_2d(dp, tp))
        xfers.append(create_partition_attention_combine_2d(dp, tp))
        xfers.append(create_partition_ffn_2d(dp, tp))
    return xfers
