"""Operator registry: import the op modules to populate OPS."""
from .registry import (OPS, EmitCtx, LayerRng, OpDef,  # noqa: F401
                       get_op_def, matmul)


def ensure_weight_specs(layer):
    """Materialize (and memoize on the layer) a layer's WeightSpec list."""
    specs = layer.weights or get_op_def(layer.op_type).weights(
        layer.params, [t.shape for t in layer.inputs],
        [t.dtype for t in layer.inputs])
    layer.weights = specs
    return specs


from . import nn_ops        # noqa: E402,F401
from . import element_ops   # noqa: E402,F401
from . import tensor_ops    # noqa: E402,F401
from . import moe_ops       # noqa: E402,F401
from . import rnn_ops       # noqa: E402,F401
