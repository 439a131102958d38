"""PCG graph structure: nodes with parallel annotations, explicit edges,
hashing, dominators, dot export, and conversion to/from the Layer level.
The port of ``flexflow_tpu/pcg/graph.py``.

Reference analogs: ``PCG::Graph``/``Edge``/``Node`` (``include/flexflow/
graph.h:293-377``, ``include/flexflow/node.h``, ``src/runtime/graph.cc``);
``create_operators_from_layers`` (``src/runtime/model.cc:2785``) ≙
``Graph.from_layers``; ``convert_graph_to_operators`` (``model.cc:2834``) ≙
``Graph.to_program``. Parallel annotations replace the reference's
``ParallelDim{degree, parallel_idx}`` records (``parallel_tensor.h:36-70``):
an annotation names *axis groups* (degree-sized slices of the global mesh)
and places them on output dims / weight dims, with an optional partial-sum
group that a downstream Reduction resolves.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.layer import Layer
from ..core.tensor import Tensor
from ..ffconst import OperatorType, PARALLEL_OPS

_node_uid = itertools.count()


# ---------------------------------------------------------------------------
# Parallel annotation
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParAnn:
    """Parallel annotation of one PCG node.

    ``groups``: (group_name, degree) pairs — each group is realized as a
    disjoint set of atomic mesh axes whose sizes multiply to ``degree``.
    ``out``: (out_idx, dim, group) placements on output tensors.
    ``weights``: (weight_name, dim, group) placements on weight tensors.
    ``reduce``: group over which outputs are partial sums awaiting a
    Reduction parallel op (row-parallel linear etc.).
    ``replicate``: group over which the op's *inputs* are replicated
    (pure fan-out; affects cost, not output layout).
    """
    groups: Tuple[Tuple[str, int], ...] = ()
    out: Tuple[Tuple[int, int, str], ...] = ()
    weights: Tuple[Tuple[str, int, str], ...] = ()
    reduce: Optional[str] = None
    replicate: Optional[str] = None

    def degree_of(self, group: str) -> int:
        for g, d in self.groups:
            if g == group:
                return d
        return 1

    def out_degrees(self, out_idx: int = 0) -> Dict[int, int]:
        """dim -> degree for one output tensor."""
        degs: Dict[int, int] = {}
        for oi, dim, g in self.out:
            if oi == out_idx:
                degs[dim] = degs.get(dim, 1) * self.degree_of(g)
        return degs

    def weight_degree(self) -> int:
        """Total shard degree over all weight placements (per unique group)."""
        used = {g for (_, _, g) in self.weights}
        d = 1
        for g in used:
            d *= self.degree_of(g)
        return d

    def total_degree(self) -> int:
        d = 1
        for _, deg in self.groups:
            d *= deg
        return d

    def is_trivial(self) -> bool:
        return not self.groups

    @staticmethod
    def trivial() -> "ParAnn":
        return _TRIVIAL


_TRIVIAL = ParAnn()


# ---------------------------------------------------------------------------
# Nodes and edges
# ---------------------------------------------------------------------------
class PNode:
    """PCG node: a Layer plus its parallel annotation.

    Layers are shared (read-only) across candidate graphs during search;
    only the annotation differs — the analog of the reference's
    (``Op``, ``MachineView``) pair.
    """
    __slots__ = ("layer", "ann", "guid")

    def __init__(self, layer: Layer, ann: ParAnn = _TRIVIAL):
        self.layer = layer
        self.ann = ann
        self.guid = next(_node_uid)

    @property
    def op_type(self) -> OperatorType:
        return self.layer.op_type

    def with_ann(self, ann: ParAnn) -> "PNode":
        return PNode(self.layer, ann)

    def key(self) -> Tuple:
        """Structural identity (for graph hashing): op params + annotation,
        NOT the guid — two nodes with the same layer+ann are equivalent."""
        return (self.layer.guid, self.ann)

    def __repr__(self):
        a = "" if self.ann.is_trivial() else f" ann={self.ann.groups}"
        return f"PNode({self.layer.name}{a})"


@dataclasses.dataclass(frozen=True)
class Edge:
    """src output ``src_idx`` feeds dst input slot ``dst_idx``."""
    src: PNode
    dst: PNode
    src_idx: int = 0
    dst_idx: int = 0


class GraphProgramInfo:
    """Result of ``Graph.to_program``: executable layer list (topo order,
    with freshly-plumbed tensors for inserted parallel ops) plus the
    node -> executable-layer mapping for strategy extraction."""

    def __init__(self, layers: List[Layer], node_to_layer: Dict[int, Layer],
                 output_tensors: List[Tensor]):
        self.layers = layers
        self.node_to_layer = node_to_layer  # PNode.guid -> executable Layer
        self.output_tensors = output_tensors


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------
class Graph:
    """Op-level DAG with in/out edge maps (reference ``PCG::Graph``)."""

    def __init__(self):
        self.in_edges: Dict[PNode, List[Edge]] = {}
        self.out_edges: Dict[PNode, List[Edge]] = {}
        # input tensors feeding source nodes: node guid -> list of
        # (in_slot, Tensor) for graph-external inputs
        self.external_inputs: Dict[int, List[Tuple[int, Tensor]]] = {}
        self.input_tensors: List[Tensor] = []
        # (node, out_idx) pairs that are graph outputs
        self.outputs: List[Tuple[PNode, int]] = []

    # -- construction ------------------------------------------------------
    def add_node(self, node: PNode):
        self.in_edges.setdefault(node, [])
        self.out_edges.setdefault(node, [])

    def add_edge(self, src: PNode, dst: PNode, src_idx: int = 0,
                 dst_idx: int = 0):
        self.add_node(src)
        self.add_node(dst)
        e = Edge(src, dst, src_idx, dst_idx)
        self.in_edges[dst].append(e)
        self.out_edges[src].append(e)

    def remove_node(self, node: PNode):
        for e in list(self.in_edges.get(node, ())):
            self.out_edges[e.src].remove(e)
        for e in list(self.out_edges.get(node, ())):
            self.in_edges[e.dst].remove(e)
        self.in_edges.pop(node, None)
        self.out_edges.pop(node, None)
        self.external_inputs.pop(node.guid, None)

    def remove_edge(self, e: Edge):
        self.in_edges[e.dst].remove(e)
        self.out_edges[e.src].remove(e)

    @property
    def nodes(self) -> List[PNode]:
        return list(self.in_edges.keys())

    def num_nodes(self) -> int:
        return len(self.in_edges)

    def producer(self, node: PNode, in_slot: int) -> Optional[Edge]:
        for e in self.in_edges.get(node, ()):
            if e.dst_idx == in_slot:
                return e
        return None

    # -- queries -----------------------------------------------------------
    def topo_order(self) -> List[PNode]:
        indeg = {n: len(self.in_edges[n]) for n in self.in_edges}
        # Deterministic order: seed queue sorted by guid.
        ready = sorted((n for n, d in indeg.items() if d == 0),
                       key=lambda n: n.guid)
        order: List[PNode] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            fresh = []
            for e in self.out_edges[n]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    fresh.append(e.dst)
            if fresh:
                ready = sorted(ready + fresh, key=lambda x: x.guid)
        if len(order) != self.num_nodes():
            raise RuntimeError("cycle in PCG")
        return order

    def hash(self) -> int:
        """Structural hash: order-independent over (node key, edge keys).
        Analog of the reference's graph hash used for search memoization."""
        h = 17
        items = []
        for n in self.in_edges:
            items.append(("n",) + n.key())
        for edges in self.in_edges.values():
            for e in edges:
                items.append(("e", e.src.key(), e.dst.key(),
                              e.src_idx, e.dst_idx))
        for v in sorted(hash(i) for i in items):
            h = (h * 1000000007 + v) & ((1 << 64) - 1)
        return h

    def check_consistency(self) -> List[str]:
        """Structural validation (reference ``check_correctness``)."""
        errs = []
        for n, edges in self.in_edges.items():
            slots = [e.dst_idx for e in edges]
            slots += [s for s, _ in self.external_inputs.get(n.guid, ())]
            if len(slots) != len(set(slots)):
                errs.append(f"{n}: duplicate input slots {slots}")
            arity = len(n.layer.inputs)
            if n.op_type not in (OperatorType.OP_INPUT,) and \
                    len(slots) != arity:
                errs.append(f"{n}: {len(slots)} inputs wired, arity {arity}")
        for n, edges in self.out_edges.items():
            for e in edges:
                if e not in self.in_edges[e.dst]:
                    errs.append(f"dangling edge {e}")
        # acyclicity (the JAX package asks its native reachability
        # closure, which is not ported; a topological sort decides the
        # same question)
        try:
            self.topo_order()
        except RuntimeError:
            errs.append("graph contains a cycle")
        return errs

    # -- dominators (for Unity sequence splits) ----------------------------
    def post_dominators(self) -> Dict[PNode, Set[PNode]]:
        """node -> set of nodes on EVERY path from node to the sink(s).
        Single-cut "bottleneck" nodes for sequence splitting are nodes that
        post-dominate all source nodes. Reference: ``src/runtime/graph.cc``
        dominator machinery (tested by ``tests/unit/test_dominators.cc``)."""
        order = self.topo_order()
        sinks = [n for n in order if not self.out_edges[n]]
        pdom: Dict[PNode, Set[PNode]] = {}
        allset = set(order)
        for n in reversed(order):
            succs = [e.dst for e in self.out_edges[n]]
            if not succs:
                pdom[n] = {n}
                continue
            inter: Optional[Set[PNode]] = None
            for s in succs:
                inter = set(pdom[s]) if inter is None else inter & pdom[s]
            # Multiple sinks: a node reaching several sinks is post-dominated
            # only by common post-dominators of all of them.
            pdom[n] = (inter or set()) | {n}
        # Nodes reaching different sinks: intersect via the virtual sink =
        # already handled since pdom(sink)={sink}; intersection across sinks
        # empties unless common.
        del allset, sinks
        return pdom

    def bottlenecks(self) -> List[PNode]:
        """Nodes through which every source→sink path passes, in topo order
        (excluding sources and sinks themselves is left to the caller).
        These are the sequence-split points of the Unity DP
        (``substitution.cc:2572``)."""
        order = self.topo_order()
        sources = [n for n in order if not self.in_edges[n]]
        if not sources:
            return []
        pdom = self.post_dominators()
        common: Optional[Set[PNode]] = None
        for s in sources:
            common = set(pdom[s]) if common is None else common & pdom[s]
        common = common or set()
        return [n for n in order if n in common]

    # -- split (Unity sequence decomposition) ------------------------------
    def split_at(self, node: PNode) -> Tuple["Graph", "Graph"]:
        """Sequence-split into (prefix incl. node, suffix) at a bottleneck.
        The suffix consumes the bottleneck's outputs as external inputs."""
        order = self.topo_order()
        idx = order.index(node)
        pre_nodes = set(order[: idx + 1])
        first, second = Graph(), Graph()
        for n in order:
            g = first if n in pre_nodes else second
            g.add_node(n)
            for s, t in self.external_inputs.get(n.guid, ()):
                g.external_inputs.setdefault(n.guid, []).append((s, t))
        for edges in self.in_edges.values():
            for e in edges:
                if e.src in pre_nodes and e.dst in pre_nodes:
                    first.add_edge(e.src, e.dst, e.src_idx, e.dst_idx)
                elif e.src not in pre_nodes and e.dst not in pre_nodes:
                    second.add_edge(e.src, e.dst, e.src_idx, e.dst_idx)
                else:
                    # crossing edge: becomes an output of `first` and an
                    # external input of `second`
                    t = e.src.layer.outputs[e.src_idx]
                    if (e.src, e.src_idx) not in first.outputs:
                        first.outputs.append((e.src, e.src_idx))
                    second.external_inputs.setdefault(
                        e.dst.guid, []).append((e.dst_idx, t))
        first.input_tensors = list(self.input_tensors)
        if not first.outputs:
            first.outputs = [(node, 0)]
        second.outputs = list(self.outputs)
        return first, second

    # -- copy --------------------------------------------------------------
    def copy(self) -> "Graph":
        g = Graph()
        for n in self.in_edges:
            g.add_node(n)
        for edges in self.in_edges.values():
            for e in edges:
                g.add_edge(e.src, e.dst, e.src_idx, e.dst_idx)
        g.external_inputs = {k: list(v)
                             for k, v in self.external_inputs.items()}
        g.input_tensors = list(self.input_tensors)
        g.outputs = list(self.outputs)
        return g

    def replace_node(self, old: PNode, new: PNode):
        """Swap a node keeping all edges (e.g. re-annotate in place)."""
        self.add_node(new)
        for e in list(self.in_edges[old]):
            self.add_edge(e.src, new, e.src_idx, e.dst_idx)
        for e in list(self.out_edges[old]):
            self.add_edge(new, e.dst, e.src_idx, e.dst_idx)
        if old.guid in self.external_inputs:
            self.external_inputs[new.guid] = self.external_inputs.pop(
                old.guid)
        self.outputs = [(new, i) if n is old else (n, i)
                        for n, i in self.outputs]
        self.remove_node(old)

    # -- build from the Layer level ---------------------------------------
    @classmethod
    def from_layers(cls, layers: Sequence[Layer],
                    input_tensors: Sequence[Tensor],
                    output_tensors: Optional[Sequence[Tensor]] = None
                    ) -> "Graph":
        g = cls()
        g.input_tensors = list(input_tensors)
        producer: Dict[int, Tuple[PNode, int]] = {}
        nodes: Dict[int, PNode] = {}
        for layer in layers:
            n = PNode(layer)
            nodes[layer.guid] = n
            g.add_node(n)
            for o_idx, o in enumerate(layer.outputs):
                producer[o.guid] = (n, o_idx)
        input_guids = {t.guid: t for t in input_tensors}
        for layer in layers:
            n = nodes[layer.guid]
            for slot, t in enumerate(layer.inputs):
                if t.guid in producer:
                    src, src_idx = producer[t.guid]
                    g.add_edge(src, n, src_idx, slot)
                else:
                    # graph-external input (dataloader-fed or constant)
                    g.external_inputs.setdefault(n.guid, []).append(
                        (slot, t))
        if output_tensors:
            for t in output_tensors:
                if t.guid not in producer:
                    raise ValueError(
                        f"output {t.name} has no producer")
                g.outputs.append(producer[t.guid])
        else:
            for n in g.topo_order():
                if not g.out_edges[n]:
                    g.outputs.append((n, 0))
        del input_guids
        return g

    # -- convert back to an executable Layer program -----------------------
    def to_program(self) -> GraphProgramInfo:
        """Rebuild an executable layer list in topo order, re-plumbing
        tensors through inserted parallel-op nodes. Reference:
        ``convert_graph_to_operators`` (``model.cc:2834-2838``)."""
        order = self.topo_order()
        # (node guid, out idx) -> live Tensor
        live: Dict[Tuple[int, int], Tensor] = {}
        out_layers: List[Layer] = []
        node_to_layer: Dict[int, Layer] = {}
        used_names: Dict[str, int] = {}
        for n in order:
            orig = n.layer
            # Resolve this node's input tensors.
            ins: List[Optional[Tensor]] = [None] * max(
                len(orig.inputs),
                1 if (self.in_edges[n] or
                      self.external_inputs.get(n.guid)) else 0)
            for e in self.in_edges[n]:
                ins[e.dst_idx] = live[(e.src.guid, e.src_idx)]
            for slot, t in self.external_inputs.get(n.guid, ()):
                ins[slot] = t
            if any(i is None for i in ins):
                raise RuntimeError(f"{n}: unwired input slot")
            same_inputs = len(ins) == len(orig.inputs) and all(
                a is b for a, b in zip(ins, orig.inputs))
            if same_inputs:
                new_layer = orig
            else:
                new_layer = Layer(orig.op_type, None, list(ins),
                                  dict(orig.params))
                # Unique but stable name; strategy keys on it.
                base = orig.name
                k = used_names.get(base, 0)
                used_names[base] = k + 1
                new_layer.name = base if k == 0 else f"{base}__{k}"
                new_layer.trainable = orig.trainable
                new_layer.weights = list(orig.weights)
                for o in orig.outputs:
                    nt = Tensor(o.shape, o.dtype, owner_layer=new_layer,
                                owner_idx=o.owner_idx)
                    new_layer.outputs.append(nt)
            if used_names.get(new_layer.name) is None:
                used_names[new_layer.name] = 1
            out_layers.append(new_layer)
            node_to_layer[n.guid] = new_layer
            for i, o in enumerate(new_layer.outputs):
                live[(n.guid, i)] = o
        outs = [live[(n.guid, i)] for n, i in self.outputs]
        return GraphProgramInfo(out_layers, node_to_layer, outs)

    # -- observability -----------------------------------------------------
    def to_dot(self, costs: Optional[Dict[int, float]] = None) -> str:
        """Graphviz export (reference ``--compgraph``/``--taskgraph``,
        ``graph.h:337-344``)."""
        lines = ["digraph PCG {"]
        ids = {n: f"n{idx}" for idx, n in enumerate(self.topo_order())}
        for n, nid in ids.items():
            label = n.layer.name
            if not n.ann.is_trivial():
                label += "\\n" + ",".join(
                    f"{g}={d}" for g, d in n.ann.groups)
            if costs and n.guid in costs:
                label += f"\\n{costs[n.guid] * 1e6:.1f}us"
            shape = "ellipse" if n.op_type in PARALLEL_OPS else "box"
            lines.append(f'  {ids[n]} [label="{label}", shape={shape}];')
        for edges in self.in_edges.values():
            for e in edges:
                lines.append(f"  {ids[e.src]} -> {ids[e.dst]};")
        lines.append("}")
        return "\n".join(lines)

    def __repr__(self):
        return f"Graph({self.num_nodes()} nodes, {len(self.outputs)} outputs)"
