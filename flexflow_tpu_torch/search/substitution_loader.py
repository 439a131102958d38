"""Loader for reference-format substitution rule collections (JSON).
The port of ``flexflow_tpu/search/substitution_loader.py``.

Reads the reference's ``substitutions/graph_subst_3_v2.json`` schema
(``include/flexflow/substitution_loader.h:131``, 640 TASO-generated rules;
``substitution_loader::RuleCollection``) and compiles each rule into a
:class:`~.substitution.GraphXfer` over our PCG.

Schema: a rule has ``srcOp``/``dstOp`` operator lists, each operator with
``type`` (reference OperatorType name), ``input`` tensors referencing
``(opId, tsId)`` — ``opId == -1`` meaning external pattern input ``tsId`` —
and ``para`` key/value constraints (PM_*). ``mappedOutput`` wires boundary
outputs from src to dst.

Dim-numbering translation: the reference orders tensor dims innermost-
first (``ParallelDim`` index 0 = fastest-varying; numpy's last axis), so a
rule dim ``d`` on a rank-r tensor is numpy axis ``r - 1 - d``. The rank is
only known once a concrete match is found, so dim checks compile to match-
time conditions and dst dim params to apply-time callables; a translation
that lands outside the tensor's rank (the reference's replica dim) vetoes
that rewrite (``SkipRewrite``) — conservative, never wrong.

Enum value translation is identity: our ``ffconst`` mirrors the reference's
integer enum values (e.g. ``AC_MODE_RELU == 11``).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..ffconst import ActiMode, OperatorType
from .substitution import GraphXfer, OpX, SkipRewrite, TensorX


def default_collection_path() -> str:
    """The vendored 640-rule collection beside this package
    (``flexflow_tpu/data/graph_subst_v3.json``, decoded once from the
    TASO-era ``.pb`` wire format by ``tools/pb_rules.py``), read by path:
    both packages load the same file."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "flexflow_tpu", "data",
        "graph_subst_v3.json")


# reference OperatorType name -> our op type
_OP_TYPE_MAP = {
    "OP_PARTITION": OperatorType.OP_REPARTITION,
    "OP_COMBINE": OperatorType.OP_COMBINE,
    "OP_REPLICATE": OperatorType.OP_REPLICATE,
    "OP_REDUCE": OperatorType.OP_REDUCTION,
    "OP_LINEAR": OperatorType.OP_LINEAR,
    "OP_RELU": OperatorType.OP_RELU,
    "OP_EW_ADD": OperatorType.OP_EW_ADD,
    "OP_EW_MUL": OperatorType.OP_EW_MUL,
    "OP_CONCAT": OperatorType.OP_CONCAT,
    "OP_SPLIT": OperatorType.OP_SPLIT,
    "OP_SOFTMAX": OperatorType.OP_SOFTMAX,
    "OP_MATMUL": OperatorType.OP_BATCHMATMUL,
    "OP_EW_SUB": OperatorType.OP_EW_SUB,
    "OP_SIGMOID": OperatorType.OP_SIGMOID,
    "OP_TANH": OperatorType.OP_TANH,
}

_PARALLEL_TYPES = {OperatorType.OP_REPARTITION, OperatorType.OP_COMBINE,
                   OperatorType.OP_REPLICATE, OperatorType.OP_REDUCTION}

# PM_ACTI uses the TASO ActiMode numbering (NONE=0, SIGMOID=1, RELU=2,
# TANH=3), not the reference's AC_MODE_* (10..14)
_TASO_ACTI = {0: ActiMode.AC_MODE_NONE, 1: ActiMode.AC_MODE_SIGMOID,
              2: ActiMode.AC_MODE_RELU, 3: ActiMode.AC_MODE_TANH}


def _para(op_doc: Dict) -> Dict[str, int]:
    return {p["key"]: p["value"] for p in op_doc.get("para", [])}


class _ActiConstraint:
    """PM_ACTI check: absent activation param means AC_MODE_NONE."""

    def __init__(self, acti: ActiMode):
        self.acti = acti

    def check(self, layer) -> bool:
        v = layer.params.get("activation", ActiMode.AC_MODE_NONE)
        try:
            return ActiMode(v) == self.acti
        except ValueError:
            return False


def _rank_of_output(node) -> int:
    return len(node.layer.outputs[0].shape)


def _np_dim(ff_dim: int, rank: int) -> Optional[int]:
    """Reference dim index -> numpy axis; None if it names the replica dim
    (or beyond) for this rank."""
    if 0 <= ff_dim < rank:
        return rank - 1 - ff_dim
    return None


def _src_cond(op_type: OperatorType, para: Dict[str, int]):
    """Match-time predicate translating PM_* constraints for one src op."""
    ff_dim = para.get("PM_PARALLEL_DIM")
    degree = para.get("PM_PARALLEL_DEGREE")
    axis = para.get("PM_AXIS")
    numdim = para.get("PM_NUMDIM")
    num_inputs = para.get("PM_NUM_INPUTS")
    num_outputs = para.get("PM_NUM_OUTPUTS")

    def cond(node, graph) -> bool:
        rank = _rank_of_output(node)
        p = node.layer.params
        if numdim is not None and rank != numdim:
            return False
        if degree is not None and p.get("degree") != degree:
            return False
        if ff_dim is not None and op_type in (OperatorType.OP_REPARTITION,
                                              OperatorType.OP_COMBINE):
            nd = _np_dim(ff_dim, rank)
            if nd is None or p.get("dim") != nd:
                return False
        if axis is not None:
            nd = _np_dim(axis, rank)
            if nd is None or p.get("axis", -1) % rank != nd:
                return False
        if num_inputs is not None and len(node.layer.inputs) != num_inputs:
            return False
        if num_outputs is not None \
                and len(node.layer.outputs) != num_outputs:
            return False
        return True

    return cond


def _dst_params(op_type: OperatorType, para: Dict[str, int],
                rule_name: str):
    """Apply-time params for a new dst op; receives the concrete input
    tensors so reference dims translate against the real ranks."""
    ff_dim = para.get("PM_PARALLEL_DIM")
    degree = para.get("PM_PARALLEL_DEGREE", 1)
    axis = para.get("PM_AXIS")
    n_out = para.get("PM_NUM_OUTPUTS", 2)

    def params(mapping, in_tensors):
        if not in_tensors:
            raise SkipRewrite(rule_name)
        shape = in_tensors[0].shape
        rank = len(shape)

        def need_dim(d: Optional[int]) -> int:
            nd = _np_dim(d if d is not None else 0, rank)
            if nd is None:
                raise SkipRewrite(rule_name)  # replica-dim placement
            return nd

        if op_type in (OperatorType.OP_REPARTITION, OperatorType.OP_COMBINE):
            return {"dim": need_dim(ff_dim), "degree": degree,
                    "group": f"j{degree}"}
        if op_type in (OperatorType.OP_REPLICATE, OperatorType.OP_REDUCTION):
            return {"degree": degree, "group": f"j{degree}"}
        if op_type == OperatorType.OP_CONCAT:
            return {"axis": need_dim(axis)}
        if op_type == OperatorType.OP_SPLIT:
            nd = need_dim(axis)
            size = shape[nd]
            if size % n_out != 0:
                raise SkipRewrite(rule_name)
            return {"axis": nd, "sizes": [size // n_out] * n_out}
        return {}

    return params


def compile_rule(rule: Dict) -> Optional[GraphXfer]:
    """Compile one reference Rule doc into a GraphXfer; None if the rule
    uses an operator we can't map."""
    name = rule.get("name", "loaded_rule")
    ext: Dict[int, TensorX] = {}

    def ext_tx(ts_id: int) -> TensorX:
        if ts_id not in ext:
            ext[ts_id] = TensorX()
        return ext[ts_id]

    # ---- src ops ----
    src_ops: List[OpX] = []
    for doc in rule["srcOp"]:
        ot = _OP_TYPE_MAP.get(doc["type"])
        if ot is None:
            return None
        para = _para(doc)
        ins: List[TensorX] = []
        for t in doc.get("input", []):
            if t["opId"] < 0:
                ins.append(ext_tx(t["tsId"]))
            else:
                ins.append(src_ops[t["opId"]].out(t["tsId"]))
        n_out = para.get("PM_NUM_OUTPUTS", 1)
        constraints = []
        if "PM_ACTI" in para:
            acti = _TASO_ACTI.get(para["PM_ACTI"],
                                  ActiMode.AC_MODE_NONE)
            constraints.append(_ActiConstraint(acti))
        src_ops.append(OpX(ot, ins, num_outputs=n_out,
                           name=f"{name}:src{len(src_ops)}",
                           constraints=constraints,
                           cond=_src_cond(ot, para)))

    # ---- dst ops ----
    # compute ops re-use the matched src layer of the same type, in order
    # of appearance (TASO parallelization rules re-wire the same compute
    # around moved parallel ops)
    src_by_type: Dict[OperatorType, List[OpX]] = {}
    for s in src_ops:
        src_by_type.setdefault(s.op_type, []).append(s)
    used_by_type: Dict[OperatorType, int] = {}

    dst_ops: List[OpX] = []
    for doc in rule["dstOp"]:
        ot = _OP_TYPE_MAP.get(doc["type"])
        if ot is None:
            return None
        para = _para(doc)
        ins = []
        for t in doc.get("input", []):
            if t["opId"] < 0:
                ins.append(ext_tx(t["tsId"]))
            else:
                ins.append(dst_ops[t["opId"]].out(t["tsId"]))
        n_out = para.get("PM_NUM_OUTPUTS", 1)
        pool = src_by_type.get(ot, [])
        k = used_by_type.get(ot, 0)
        if ot not in _PARALLEL_TYPES and k < len(pool):
            # re-use the matched src compute op of the same type, in order
            used_by_type[ot] = k + 1
            dst_ops.append(OpX(ot, ins, num_outputs=n_out,
                               name=f"{name}:dst{len(dst_ops)}",
                               share=pool[k]))
        elif ot not in _PARALLEL_TYPES and ot in (
                OperatorType.OP_LINEAR, OperatorType.OP_BATCHMATMUL):
            # a brand-new weighted op (e.g. fused wider linear) would need
            # weight concatenation semantics we don't synthesize — skip rule
            return None
        else:
            # new parallel op, or new unweighted compute op (concat/split/
            # elementwise introduced by fusion rules)
            dst_ops.append(OpX(ot, ins, num_outputs=n_out,
                               name=f"{name}:dst{len(dst_ops)}",
                               params=_dst_params(ot, para, name)))

    mapped = []
    for mo in rule.get("mappedOutput", []):
        mapped.append((src_ops[mo["srcOpId"]].out(mo["srcTsId"]),
                       dst_ops[mo["dstOpId"]].out(mo["dstTsId"])))
    return GraphXfer(name, src_ops, dst_ops, mapped)


def load_rule_collection(path: str) -> List[GraphXfer]:
    """Load a reference-format JSON rule collection into GraphXfers.
    Unmappable rules are skipped (reported via the returned list length)."""
    with open(path) as f:
        doc = json.load(f)
    rules = doc["rule"] if isinstance(doc, dict) else doc
    out: List[GraphXfer] = []
    for r in rules:
        xf = compile_rule(r)
        if xf is not None:
            out.append(xf)
    return out
