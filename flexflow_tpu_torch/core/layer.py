"""Layer: a node in the lazy computation graph.

Analog of the reference's ``Layer`` (``include/flexflow/layer.h:20-61``): an
op-typed node holding key/value properties, input tensors, produced output
tensors, and weight specs. Lowering to the PCG (``Op`` level) happens in
``FFModel.compile`` — mirroring ``create_operators_from_layers``
(reference ``src/runtime/model.cc:2785``). The port's copy of
``flexflow_tpu/core/layer.py``.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

from ..ffconst import OperatorType
from .tensor import Tensor, WeightSpec

_layer_uid = itertools.count(100)  # LAYER_GUID_FIRST_VALID-style offset


def _hashable(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v


class Layer:
    __slots__ = ("op_type", "name", "params", "inputs", "outputs", "weights",
                 "guid", "trainable")

    def __init__(self, op_type: OperatorType, name: Optional[str],
                 inputs: List[Tensor], params: Optional[Dict[str, Any]] = None):
        self.op_type = OperatorType(op_type)
        self.guid = next(_layer_uid)
        self.name = name or f"{self.op_type.name.lower()}_{self.guid}"
        self.params: Dict[str, Any] = dict(params or {})
        self.inputs: List[Tensor] = list(inputs)
        self.outputs: List[Tensor] = []
        self.weights: List[WeightSpec] = []
        self.trainable = True

    # key/value property API (reference Layer::add_int_property etc.)
    def add_property(self, key: str, value: Any):
        self.params[key] = value

    def get_property(self, key: str, default=None):
        return self.params.get(key, default)

    def add_weight(self, spec: WeightSpec):
        self.weights.append(spec)

    def param_key(self) -> Tuple:
        """Hashable identity used for node dedup / cost caching — analog of
        the reference's ``*Params`` structs (``src/ops/*_params.h``)."""
        return (self.op_type, _hashable(self.params),
                tuple(t.shape for t in self.inputs),
                tuple(t.dtype for t in self.inputs))

    def __repr__(self):
        return (f"Layer({self.name}, {self.op_type.name}, "
                f"in={[t.shape for t in self.inputs]}, "
                f"out={[t.shape for t in self.outputs]})")
