"""The port's substitution engine (``search/substitution.py``,
``search/substitution_loader.py``, ``pcg/graph.py``) against the JAX
package's: every programmatic xfer of ``generate_all_pcg_xfers([2, 4,
8])`` and every rule of ``flexflow_tpu/data/graph_subst_v3.json`` finds
the same matches on the same PCGs and rewrites them into the same
graphs, compared structurally (op types, params, annotations, shapes,
wiring) since node ids and generated layer names are per-process."""
import dataclasses
import enum
import os
import sys

import pytest

from flexflow_tpu.pcg.graph import Graph as JGraph
from flexflow_tpu.search import substitution as jsub
from flexflow_tpu.search import substitution_loader as jload
from flexflow_tpu_torch.pcg.graph import Graph as TGraph
from flexflow_tpu_torch.search import substitution as tsub
from flexflow_tpu_torch.search import substitution_loader as tload

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_graphs as graphs  # noqa: E402

DEGREES = [2, 4, 8]


def _plain(v):
    if isinstance(v, enum.Enum):
        return (type(v).__name__, int(v))
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _plain(x)) for k, x in v.items()))
    return v


def canon(g) -> tuple:
    """Structure of a PCG independent of node ids and layer names."""
    order = g.topo_order()
    pos = {n.guid: i for i, n in enumerate(order)}
    nodes = tuple(
        (n.op_type.name, _plain(n.layer.params),
         dataclasses.astuple(n.ann),
         tuple((tuple(t.shape), int(t.dtype)) for t in n.layer.inputs),
         tuple((tuple(t.shape), int(t.dtype)) for t in n.layer.outputs))
        for n in order)
    edges = tuple(sorted((pos[e.src.guid], pos[e.dst.guid], e.src_idx,
                          e.dst_idx)
                         for es in g.in_edges.values() for e in es))
    ext = tuple(sorted((pos[n.guid], s, tuple(t.shape))
                       for n in order
                       for s, t in g.external_inputs.get(n.guid, ())))
    outs = tuple((pos[n.guid], i) for n, i in g.outputs)
    return nodes, edges, ext, outs


def _pcgs(name):
    jff, tff = {"mlp": graphs.mlp, "bert": graphs.bert,
                "dlrm": graphs.dlrm}[name]()
    ins = lambda ff: [t for t in ff.input_tensors]  # noqa: E731
    return (JGraph.from_layers(jff.layers, ins(jff)),
            TGraph.from_layers(tff.layers, ins(tff)))


def _same_rewrites(jx, tx, jg, tg, limit=64):
    assert jx.name == tx.name
    got_j = [canon(g) for _, g in zip(range(limit), jx.run(jg))]
    got_t = [canon(g) for _, g in zip(range(limit), tx.run(tg))]
    assert got_t == got_j, jx.name
    return len(got_j)


@pytest.mark.parametrize("graph", ["mlp", "bert", "dlrm"])
def test_programmatic_xfers_rewrite_alike(graph):
    jg, tg = _pcgs(graph)
    assert canon(tg) == canon(jg)
    jx = jsub.generate_all_pcg_xfers(DEGREES)
    tx = tsub.generate_all_pcg_xfers(DEGREES)
    assert [x.name for x in tx] == [x.name for x in jx]
    matched = sum(_same_rewrites(a, b, jg, tg) for a, b in zip(jx, tx))
    assert matched > 0


_TYPES = {"OP_PARTITION": "OP_REPARTITION", "OP_COMBINE": "OP_COMBINE",
          "OP_REPLICATE": "OP_REPLICATE", "OP_REDUCE": "OP_REDUCTION",
          "OP_LINEAR": "OP_LINEAR", "OP_RELU": "OP_RELU",
          "OP_EW_ADD": "OP_EW_ADD", "OP_EW_MUL": "OP_EW_MUL",
          "OP_EW_SUB": "OP_EW_SUB", "OP_SIGMOID": "OP_SIGMOID",
          "OP_TANH": "OP_TANH", "OP_CONCAT": "OP_CONCAT"}
_TASO_ACTI = {0: "AC_MODE_NONE", 1: "AC_MODE_SIGMOID", 2: "AC_MODE_RELU",
              3: "AC_MODE_TANH"}
RANK_SHAPE = (8, 8, 8)


def _source_graph(rule, pkg):
    """A concrete PCG of one rule's source pattern, built with ``pkg``'s
    own classes on (8, 8, 8) tensors (reference dim d of a rank-3
    tensor is numpy axis 2 - d); None when the pattern uses an op this
    builder does not make (split, matmul, softmax)."""
    import importlib
    layer_mod = importlib.import_module(f"{pkg}.core.layer")
    tensor_mod = importlib.import_module(f"{pkg}.core.tensor")
    const = importlib.import_module(f"{pkg}.ffconst")
    ops = importlib.import_module(f"{pkg}.ops")
    graph_mod = importlib.import_module(f"{pkg}.pcg.graph")
    inputs, layers = {}, []

    def tensor(ref):
        if ref["opId"] == -1:
            k = ref["tsId"]
            if k not in inputs:
                inputs[k] = tensor_mod.Tensor(RANK_SHAPE,
                                              const.DataType.DT_FLOAT,
                                              name=f"in{k}")
            return inputs[k]
        return built[ref["opId"]].outputs[ref["tsId"]]

    built = {}
    todo = list(enumerate(rule["srcOp"]))
    while todo:
        ready = [(i, op) for i, op in todo
                 if all(r["opId"] == -1 or r["opId"] in built
                        for r in op["input"])]
        if not ready:
            return None      # a cycle in the pattern
        i, op = ready[0]
        todo.remove((i, op))
        name = _TYPES.get(op["type"])
        if name is None:
            return None
        para = {p["key"]: p["value"] for p in op.get("para", [])}
        ins = [tensor(r) for r in op["input"]]
        rank = len(ins[0].shape)
        dim = rank - 1 - para.get("PM_PARALLEL_DIM", 0)
        deg = para.get("PM_PARALLEL_DEGREE", 2)
        params = {}
        if name in ("OP_REPARTITION", "OP_COMBINE"):
            if dim < 0:
                return None
            params = {"dim": dim, "degree": deg, "group": "g"}
        elif name in ("OP_REPLICATE", "OP_REDUCTION"):
            params = {"degree": deg, "group": "g"}
        elif name == "OP_LINEAR":
            params = {"out_dim": ins[0].shape[-1], "use_bias": True,
                      "activation": const.ActiMode[
                          _TASO_ACTI[para.get("PM_ACTI", 0)]]}
        elif name == "OP_CONCAT":
            axis = rank - 1 - para.get("PM_AXIS", 0)
            if axis < 0:
                return None
            params = {"axis": axis}
        op_type = const.OperatorType[name]
        layer = layer_mod.Layer(op_type, None, ins, params)
        d = ops.get_op_def(op_type)
        try:
            outs = d.infer(params, [t.shape for t in ins],
                           [t.dtype for t in ins])
        except Exception:   # the pattern's shapes do not compose here
            return None
        for shape, dt in outs:
            layer.outputs.append(tensor_mod.Tensor(shape, dt,
                                                   owner_layer=layer))
        layer.weights = d.weights(params, [t.shape for t in ins],
                                  [t.dtype for t in ins])
        built[i] = layer
        layers.append(layer)
    return graph_mod.Graph.from_layers(layers, list(inputs.values()))


@pytest.mark.parametrize("part", range(4))
def test_rule_collection_rewrites_alike(part):
    """Each rule of the vendored collection, run on a concrete graph of
    its own source pattern (built once per package), and on the graph of
    the rule before it: the same matches and rewrites."""
    import json
    # the port reads the JAX package's rule file by path
    path = tload.default_collection_path()
    assert path == jload.default_collection_path()
    jx = jload.load_rule_collection(path)
    tx = tload.load_rule_collection(path)
    assert [x.name for x in tx] == [x.name for x in jx] \
        and len(tx) == 640
    with open(path) as f:
        rules = json.load(f)["rule"]
    matched = built = 0
    prev = None
    for i in range(part, len(rules), 4):
        jg = _source_graph(rules[i], "flexflow_tpu")
        tg = _source_graph(rules[i], "flexflow_tpu_torch")
        assert (jg is None) == (tg is None)
        if jg is None:
            continue
        built += 1
        assert canon(tg) == canon(jg)
        matched += _same_rewrites(jx[i], tx[i], jg, tg, limit=8)
        if prev is not None:
            matched += _same_rewrites(jx[i], tx[i], prev[0], prev[1],
                                      limit=8)
        prev = (jg, tg)
    assert built > 40 and matched > 40, (built, matched)


def test_graph_structure_queries_alike():
    jg, tg = _pcgs("bert")
    assert [n.layer.name for n in tg.bottlenecks()] == \
        [n.layer.name for n in jg.bottlenecks()]
    jn = jg.topo_order()[5]
    tn = tg.topo_order()[5]
    jp, js = jg.split_at(jn)
    tp, ts = tg.split_at(tn)
    assert (canon(tp), canon(ts)) == (canon(jp), canon(js))
    assert tg.check_consistency() == []
    ti, ji = tg.to_program(), jg.to_program()
    assert [l.name for l in ti.layers] == [l.name for l in ji.layers]
    assert tg.to_dot() == jg.to_dot()
