"""Program (layer-list) serialization.

The port of the program half of ``flexflow_tpu/search/serialization.py``:
an executable layer list as JSON, each layer's op type, params and input
references. The schema is the JAX package's, key for key, so a graph file
written by either package loads in the other: enums travel by class name
and value (``{"_enum": "ActiMode", "v": 10}``) and resolve through this
package's ``ffconst``, sequences as ``{"_seq": [...]}``, and values JSON
cannot hold (initializer objects) as ``{"_repr": ...}``, read back as
None. The strategy half of that module (PartitionSpecs, the mesh) comes
with the strategy search.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, List, Tuple

from .. import ffconst
from ..core.layer import Layer
from ..core.tensor import Tensor


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
