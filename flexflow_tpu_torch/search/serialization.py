"""Strategy and program serialization.

The port of ``flexflow_tpu/search/serialization.py``. The strategy half
(reference ``--export``/``--import``, ``src/runtime/strategy.cc``): JSON
with per-layer output/weight specs and the mesh axis sizes, in the JAX
package's schema key for key, so a file either package writes loads in
the other (a spec's tuple entries travel as lists, as ``PartitionSpec``
entries do there); the legacy line-oriented text format of the
reference. The blocks of the JAX package's multi-device planners
(``zero``, ``qsync``, ``overlap``, ``banks``, ``place_groups``,
``serving``) load as the JSON they are and are written back unchanged;
the port executes no strategy that carries them (ROADMAP queue 1 items
4-5). The program half: an executable layer list as JSON, each layer's
op type, params and input references; enums travel by class name and
value (``{"_enum": "ActiMode", "v": 10}``) and resolve through this
package's ``ffconst``, sequences as ``{"_seq": [...]}``, and values JSON
cannot hold (initializer objects) as ``{"_repr": ...}``, read back as
None.
"""
from __future__ import annotations

import enum
import json
from typing import Any, Dict, List, Optional, Tuple

from .. import ffconst
from ..core.layer import Layer
from ..core.tensor import Tensor
from ..parallel.machine import DeviceMesh
from ..parallel.strategy import OpSharding, P, ShardingStrategy, Spec

#: the planners' blocks a strategy file may carry, kept verbatim
_RAW_BLOCKS = ("zero", "qsync", "overlap", "banks", "place_groups",
               "serving")


def _spec_to_json(spec: Optional[Spec]):
    if spec is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _spec_from_json(j) -> Optional[Spec]:
    if j is None:
        return None
    return P(*[tuple(e) if isinstance(e, list) else e for e in j])


def save_strategy(path: str, strategy: ShardingStrategy,
                  assignment: Optional[Dict] = None,
                  meta: Optional[Dict] = None,
                  program: Optional[Dict] = None,
                  serving: Optional[Dict] = None):
    doc = {
        "program": program,
        "mesh_axes": dict(strategy.dmesh.axis_sizes),
        "inputs": {k: _spec_to_json(v) for k, v in strategy.inputs.items()},
        "ops": {
            name: {
                "outputs": [_spec_to_json(s) for s in os.outputs],
                "weights": {w: _spec_to_json(s)
                            for w, s in os.weights.items()},
            } for name, os in strategy.ops.items()},
        "assignment": {k: list(v) for k, v in (assignment or {}).items()},
        "meta": meta or {},
    }
    if getattr(strategy, "axis_tiers", None):
        doc["axis_tiers"] = dict(strategy.axis_tiers)
    if getattr(strategy, "collective_trees", None):
        doc["collective_trees"] = list(strategy.collective_trees)
    for block in ("zero", "qsync", "overlap"):
        if getattr(strategy, block, None):
            doc[block] = getattr(strategy, block)
    if getattr(strategy, "kernel_impls", None):
        # per-op kernel implementations (kernels/registry.py): layer
        # names -> attention impl, plus the graph-wide "opt_update"
        # kind; compile honors it verbatim on import
        doc["kernel_impls"] = dict(strategy.kernel_impls)
    for block in ("banks", "place_groups"):
        if getattr(strategy, block, None):
            doc[block] = getattr(strategy, block)
    if serving is None:
        serving = getattr(strategy, "serving", None)
    if serving:
        # per-(model, batch-class) serving plans (search/serving_plan.py,
        # ServingPlan.to_block): one sub-strategy per bucket
        doc["serving"] = dict(serving)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def load_strategy(path: str, layers, dmesh: DeviceMesh) -> ShardingStrategy:
    with open(path) as f:
        doc = json.load(f)
    saved_axes = doc.get("mesh_axes", {})
    if dict(dmesh.axis_sizes) != saved_axes:
        raise ValueError(
            f"strategy was searched for mesh {saved_axes}, current mesh is "
            f"{dict(dmesh.axis_sizes)}")
    st = ShardingStrategy(dmesh)
    for k, v in doc.get("inputs", {}).items():
        sp = _spec_from_json(v)
        if sp is not None:
            st.inputs[k] = sp
    for name, os in doc.get("ops", {}).items():
        st.ops[name] = OpSharding(
            [_spec_from_json(s) for s in os.get("outputs", [])],
            {w: _spec_from_json(s) for w, s in os.get("weights", {}).items()
             if s is not None})
    if doc.get("axis_tiers"):
        st.axis_tiers = {str(k): str(v)
                         for k, v in doc["axis_tiers"].items()}
    if doc.get("collective_trees"):
        st.collective_trees = list(doc["collective_trees"])
    if doc.get("kernel_impls"):
        st.kernel_impls = {str(k): str(v)
                           for k, v in doc["kernel_impls"].items()}
    for block in _RAW_BLOCKS:
        if doc.get(block):
            setattr(st, block, doc[block])
    return st


# ---------------------------------------------------------------------------
# Legacy text strategy format (reference save/load_strategies_to_file,
# src/runtime/strategy.cc:100-196): line-oriented —
#   <num_ops>
#   then per op: <name> / <device_type> / <nDims> / dim[0..n) /
#   <num_device_ids> / device_ids[0..n)
# The reference's DeviceType enum: 0 = GPU (accelerator), 1 = CPU; we
# write 0.
# ---------------------------------------------------------------------------
def _spec_degrees(spec: Optional[Spec], rank: int,
                  axis_sizes: Dict[str, int]) -> List[int]:
    """Per-tensor-dim shard degree for one spec."""
    degs = [1] * rank
    if spec is None:
        return degs
    for j, e in enumerate(spec):
        if j >= rank or e is None:
            continue
        names = e if isinstance(e, tuple) else (e,)
        d = 1
        for nm in names:
            d *= axis_sizes.get(nm, 1)
        degs[j] = d
    return degs


def _spec_flat_ids(spec, rank: int, dmesh, n: int) -> List[int]:
    """Flat device ids a spec's shards actually occupy: one
    representative device per shard (coordinate 0 on unmapped axes),
    enumerated shard-major in tensor-dim order — so ops sharded over
    non-leading mesh axes export their real placement instead of a
    normalized 0..n-1 prefix (ADVICE r4). Specs a single tensor dim of
    which spans multiple mesh axes fall back to the prefix form."""
    import numpy as np
    names = list(dmesh.axis_sizes.keys())
    sizes = [dmesh.axis_sizes[a] for a in names]
    used: List[str] = []
    if spec is not None:
        for j, e in enumerate(spec):
            if j >= rank or e is None:
                continue
            ax = e if isinstance(e, tuple) else (e,)
            if len(ax) != 1 or ax[0] in used or ax[0] not in names:
                return list(range(n))   # composed/unknown: prefix form
            used.append(ax[0])
    if not used:
        return list(range(n))
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    index = tuple(slice(None) if a in used else 0 for a in names)
    sub = grid[index]
    # sub's axes are the used axes in MESH order; reorder to the order
    # they appear across the tensor dims (shard-major enumeration)
    mesh_order = [a for a in names if a in used]
    sub = np.transpose(sub, [mesh_order.index(a) for a in used])
    ids = [int(i) for i in sub.ravel()]
    return ids if len(ids) == n else list(range(n))


def save_legacy_strategies(path: str, strategy: ShardingStrategy,
                           layers: List[Layer]) -> None:
    """Export the searched strategy in the reference's text wire format
    so its tooling (and ``load_strategies_from_file``-based flows) can
    consume strategies searched here. Device ids are the flat ids each
    shard actually occupies (see :func:`_spec_flat_ids`). Bank
    placements (the JAX package writes their members' device subsets)
    are not ported: a strategy carrying banks is refused."""
    if getattr(strategy, "banks", None):
        raise NotImplementedError(
            "bank placements in the legacy text format are not ported "
            "(ROADMAP queue 1 item 5); use the JSON strategy format")
    axis_sizes = dict(strategy.dmesh.axis_sizes)
    by_name = {l.name: l for l in layers}
    rows = []
    for name, os in strategy.ops.items():
        if any(c.isspace() for c in name):
            raise ValueError(
                f"op name {name!r} contains whitespace, which the "
                f"line-oriented legacy format cannot represent — "
                f"rename the layer or use the JSON export")
        layer = by_name.get(name)
        out_spec = os.outputs[0] if os.outputs else None
        rank = len(layer.outputs[0].shape) if layer is not None \
            and layer.outputs else (len(out_spec) if out_spec else 1)
        degs = _spec_degrees(out_spec, rank, axis_sizes)
        n = 1
        for d in degs:
            n *= d
        ids = _spec_flat_ids(out_spec, rank, strategy.dmesh, n)
        rows.append((name, degs, ids))
    with open(path, "w") as f:
        f.write(f"{len(rows)}\n")
        for name, degs, ids in rows:
            f.write(f"{name}\n0\n{len(degs)}\n")
            f.write("\t".join(str(d) for d in degs) + "\n")
            f.write(f"{len(ids)}\n")
            f.write("\t".join(str(i) for i in ids) + "\n")


def _axes_from_flat_ids(degs: List[int], ids: List[int],
                        dmesh) -> Optional[List]:
    """Invert :func:`_spec_flat_ids`: find the per-dim single-axis
    assignment whose representative-device enumeration equals ``ids``.
    Returns spec entries, or None if no assignment matches
    (a true subset placement). Sharded dims and mesh axes are both few,
    so permutation search is fine."""
    import itertools
    names = list(dmesh.axis_sizes.keys())
    sharded = [j for j, d in enumerate(degs) if d > 1]
    cand_axes = [[a for a in names if dmesh.axis_sizes[a] == degs[j]]
                 for j in sharded]
    for combo in itertools.product(*cand_axes):
        if len(set(combo)) != len(combo):
            continue
        entries: List = [None] * len(degs)
        for j, ax in zip(sharded, combo):
            entries[j] = ax
        rank = len(degs)
        got = _spec_flat_ids(P(*entries), rank, dmesh, len(ids))
        if got == ids:
            return entries
    return None


def load_legacy_strategies(path: str, layers, dmesh: DeviceMesh,
                           ) -> ShardingStrategy:
    """Import the reference's text strategy format. Per-dim degrees are
    mapped back onto mesh axes greedily (axes in mesh order, largest
    dims first); degrees that don't factor over the mesh raise."""
    with open(path) as f:
        toks = f.read().split()
    pos = 0
    banked_names = set()
    sidecar = path + ".banks.json"
    sidecar_present = True
    try:
        with open(sidecar) as f:
            banked_names = set(json.load(f).get("banked_ops", ()))
    except OSError:
        sidecar_present = False
    # rows whose flat ids are a device-id prefix are ambiguous without
    # the sidecar: a bank's true device subset and an axis assignment's
    # representative-per-shard pattern can be byte-identical (see
    # save_legacy_strategies); collected below to warn once per import
    ambiguous_rows = []

    def take() -> str:
        nonlocal pos
        t = toks[pos]
        pos += 1
        return t

    n_ops = int(take())
    st = ShardingStrategy(dmesh)
    axis_items = list(dict(dmesh.axis_sizes).items())
    for _ in range(n_ops):
        name = take()
        int(take())                       # device_type (accelerator)
        ndims = int(take())
        degs = [int(take()) for _ in range(ndims)]
        n_ids = int(take())
        ids = [int(take()) for _ in range(n_ids)]
        if name in banked_names:
            # flagged by the exporter's sidecar: these ids are a true
            # device-subset (bank) placement, which per-dim degrees
            # cannot express — refuse rather than silently import a
            # different strategy (the JSON format round-trips banks).
            # The flat format alone cannot distinguish a subset from
            # the representative-per-shard pattern below, hence the
            # sidecar (reference tooling ignores it).
            raise ValueError(
                f"op {name}: device ids {ids[:8]}... describe a "
                f"device-subset placement; the legacy text import "
                f"cannot represent it — use the JSON strategy format")
        if ids:
            # representative-per-shard ids (what save_legacy_strategies
            # writes): reconstruct the exact axis assignment from the
            # id pattern — including prefix-shaped ids, which on a
            # multi-axis mesh may correspond to a LAST (stride-1) axis,
            # not the greedy first one
            if not sidecar_present and ids == list(range(len(ids))) \
                    and 1 < len(ids) < dmesh.num_devices:
                # prefix-shaped ids on a proper device subset: exactly
                # what an exported bank row looks like once the sidecar
                # that would flag it is gone — checked BEFORE the axis
                # reconstruction below, because a prefix can ALSO match
                # a (stride-1) axis assignment and import cleanly
                ambiguous_rows.append(name)
            entries = _axes_from_flat_ids(degs, ids, dmesh)
            if entries is not None:
                st.ops[name] = OpSharding([P(*entries)], {})
                continue
            if ids != list(range(len(ids))):
                raise ValueError(
                    f"op {name}: device ids {ids[:8]}... match no axis "
                    f"assignment of this mesh — use the JSON strategy "
                    f"format")
        free = dict(axis_items)           # axis -> size, unconsumed
        entries = []
        for d in degs:
            if d == 1:
                entries.append(None)
                continue
            # exact subset-product match over the unconsumed axes
            # (greedy-in-mesh-order fails on e.g. {x0:2, x1:8} with
            # d=8: consuming x0 first strands rem=4); axis counts are
            # tiny so brute force is fine
            import itertools
            got: Optional[Tuple[str, ...]] = None
            names = list(free)
            for r in range(1, len(names) + 1):
                for combo in itertools.combinations(names, r):
                    p = 1
                    for ax in combo:
                        p *= free[ax]
                    if p == d:
                        got = combo
                        break
                if got:
                    break
            if got is None:
                raise ValueError(
                    f"op {name}: degree {d} does not factor over mesh "
                    f"axes {dict(axis_items)}")
            for ax in got:
                del free[ax]
            entries.append(got[0] if len(got) == 1 else tuple(got))
        st.ops[name] = OpSharding([P(*entries)], {})
    if ambiguous_rows:
        import logging
        logging.getLogger("flexflow_tpu_torch").warning(
            "strategy file %s: %d op row(s) (%s%s) have device-subset-"
            "shaped ids but no %s sidecar was found; if this file was "
            "exported from a bank-capable strategy those rows are BANK "
            "placements being imported as regular axis shardings — "
            "restore the sidecar or use the JSON strategy format",
            path, len(ambiguous_rows), ", ".join(ambiguous_rows[:4]),
            "..." if len(ambiguous_rows) > 4 else "", sidecar)
    return st


# ---------------------------------------------------------------------------
# Program (rewritten-graph) serialization
# ---------------------------------------------------------------------------
def _param_to_json(v: Any) -> Any:
    if isinstance(v, enum.Enum):
        return {"_enum": type(v).__name__, "v": int(v)}
    if isinstance(v, (tuple, list)):
        return {"_seq": [_param_to_json(x) for x in v]}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return {"_repr": repr(v)}   # non-serializable (e.g. initializer objects)


def _param_from_json(v: Any) -> Any:
    if isinstance(v, dict):
        if "_enum" in v:
            return getattr(ffconst, v["_enum"])(v["v"])
        if "_seq" in v:
            return tuple(_param_from_json(x) for x in v["_seq"])
        if "_repr" in v:
            return None
    return v


def program_to_json(layers: List[Layer], graph_inputs: List[Tensor],
                    output_tensor: Tensor) -> Dict:
    """Serialize an executable layer list: each layer's op type, params,
    and input references (graph input name or (producer layer, out idx))."""
    producer: Dict[int, Tuple[str, int]] = {}
    input_names = {t.guid: t.name for t in graph_inputs}
    ser = []
    for layer in layers:
        ins = []
        for t in layer.inputs:
            if t.guid in producer:
                ins.append({"op": producer[t.guid][0],
                            "idx": producer[t.guid][1]})
            elif t.guid in input_names:
                ins.append({"input": input_names[t.guid]})
            else:
                ins.append({"input": t.name})
        ser.append({
            "name": layer.name,
            "op_type": layer.op_type.name,
            "params": {k: _param_to_json(v) for k, v in layer.params.items()},
            "inputs": ins,
            "trainable": layer.trainable,
        })
        for i, o in enumerate(layer.outputs):
            producer[o.guid] = (layer.name, i)
    out_ref = producer.get(output_tensor.guid)
    return {"layers": ser, "output": {"op": out_ref[0], "idx": out_ref[1]}
            if out_ref else None}


def program_from_json(doc: Dict, graph_inputs: List[Tensor]):
    """Rebuild (layers, output_tensor) from ``program_to_json`` output.
    Output shapes/dtypes are re-inferred through the op registry."""
    from ..ops import get_op_def
    by_input_name = {t.name: t for t in graph_inputs}
    by_layer: Dict[str, Layer] = {}
    layers: List[Layer] = []
    for ls in doc["layers"]:
        ins: List[Tensor] = []
        for ref in ls["inputs"]:
            if "input" in ref:
                t = by_input_name.get(ref["input"])
                if t is None:
                    raise ValueError(
                        f"program references unknown input {ref['input']}")
                ins.append(t)
            else:
                ins.append(by_layer[ref["op"]].outputs[ref["idx"]])
        params = {k: _param_from_json(v) for k, v in ls["params"].items()}
        op_type = ffconst.OperatorType[ls["op_type"]]
        layer = Layer(op_type, ls["name"], ins, params)
        layer.trainable = ls.get("trainable", True)
        op = get_op_def(op_type)
        for (shape, dtype) in op.infer(params, [t.shape for t in ins],
                                       [t.dtype for t in ins]):
            layer.outputs.append(Tensor(shape, dtype, owner_layer=layer,
                                        owner_idx=len(layer.outputs)))
        by_layer[layer.name] = layer
        layers.append(layer)
    out_ref = doc.get("output")
    out_t = by_layer[out_ref["op"]].outputs[out_ref["idx"]] if out_ref \
        else layers[-1].outputs[0]
    return layers, out_t
