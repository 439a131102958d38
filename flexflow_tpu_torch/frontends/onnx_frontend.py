"""ONNX frontend: onnx.load -> per-node dispatch -> FFModel builders.

The port of ``flexflow_tpu/frontends/onnx_frontend.py``. Reference
parity: ``python/flexflow/onnx/model.py`` (``ONNXModel.apply``, per-op
``handle*`` methods). The ``onnx`` package is not bundled in every
environment, so the import is lazy and gated: without it the frontend
decodes the wire format itself (``onnx_wire``). Initializer weights ride
``ff._pending_onnx_weights`` until ``copy_weights`` after ``compile``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..ffconst import PoolType
from ..core.tensor import Tensor
from ..model import FFModel


def _attrs(node) -> Dict[str, Any]:
    try:
        import onnx
        get = onnx.helper.get_attribute_value
    except ImportError:
        from .onnx_wire import attribute_value as get
    out = {}
    for a in node.attribute:
        out[a.name] = get(a)
    return out


class ONNXModel:
    def __init__(self, path_or_model):
        """Accepts a path, serialized ModelProto bytes, or a loaded
        model object. Uses the ``onnx`` package when installed, else
        the built-in wire decoder (``onnx_wire`` — the reference's
        Triton backend likewise parses ONNX itself,
        ``triton/src/onnx_parser.cc``)."""
        try:
            import onnx
            import onnx.numpy_helper as nh
            self.model = onnx.load(path_or_model) \
                if isinstance(path_or_model, str) else \
                (onnx.ModelProto.FromString(path_or_model)
                 if isinstance(path_or_model, bytes) else path_or_model)
            to_arr = nh.to_array
        except ImportError:
            from . import onnx_wire
            if isinstance(path_or_model, str):
                with open(path_or_model, "rb") as f:
                    path_or_model = f.read()
            self.model = onnx_wire.load_model(path_or_model) \
                if isinstance(path_or_model, bytes) else path_or_model
            to_arr = onnx_wire.to_array
        self.initializers: Dict[str, np.ndarray] = {}
        for init in self.model.graph.initializer:
            self.initializers[init.name] = to_arr(init)

    # ------------------------------------------------------------------
    def apply(self, ff: FFModel, input_tensors: Dict[str, Tensor]
              ) -> List[Tensor]:
        """Build the FF graph (reference ``ONNXModel.apply``).
        ``input_tensors`` maps graph-input names to FF tensors."""
        env: Dict[str, Any] = dict(input_tensors)
        for name, arr in self.initializers.items():
            env[name] = arr
        for node in self.model.graph.node:
            handler = getattr(self, f"handle_{node.op_type}", None)
            if handler is None:
                raise NotImplementedError(
                    f"ONNX op {node.op_type} not supported")
            outs = handler(ff, node, env)
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for oname, o in zip(node.output, outs):
                env[oname] = o
        return [env[o.name] for o in self.model.graph.output]

    # ---- handlers ----------------------------------------------------
    def handle_Conv(self, ff, node, env):
        a = _attrs(node)
        x = env[node.input[0]]
        w = env[node.input[1]]  # numpy initializer
        out_c = w.shape[0]
        kh, kw = a.get("kernel_shape", w.shape[2:4])
        sh, sw = a.get("strides", [1, 1])
        pads = a.get("pads", [0, 0, 0, 0])
        groups = a.get("group", 1)
        t = ff.conv2d(x, out_c, kh, kw, sh, sw, pads[0], pads[1],
                      groups=groups, use_bias=len(node.input) > 2,
                      name=node.name or None)
        self._stash_weight(ff, node, env)
        return t

    def handle_Gemm(self, ff, node, env):
        a = _attrs(node)
        x = env[node.input[0]]
        w = env[node.input[1]]
        out_dim = w.shape[0] if a.get("transB", 0) else w.shape[1]
        t = ff.dense(x, out_dim, use_bias=len(node.input) > 2,
                     name=node.name or None)
        self._stash_weight(ff, node, env, transpose=bool(a.get("transB", 0)))
        return t

    def handle_MatMul(self, ff, node, env):
        x = env[node.input[0]]
        w = env[node.input[1]]
        if isinstance(w, np.ndarray) and w.ndim == 2:
            t = ff.dense(x, w.shape[1], use_bias=False,
                         name=node.name or None)
            self._stash_weight(ff, node, env, transpose=False)
            return t
        return ff.batch_matmul(x, w, name=node.name or None)

    def handle_MaxPool(self, ff, node, env):
        a = _attrs(node)
        kh, kw = a["kernel_shape"]
        sh, sw = a.get("strides", [1, 1])
        pads = a.get("pads", [0, 0, 0, 0])
        return ff.pool2d(env[node.input[0]], kh, kw, sh, sw, pads[0],
                         pads[1], PoolType.POOL_MAX, name=node.name or None)

    def handle_AveragePool(self, ff, node, env):
        a = _attrs(node)
        kh, kw = a["kernel_shape"]
        sh, sw = a.get("strides", [1, 1])
        pads = a.get("pads", [0, 0, 0, 0])
        return ff.pool2d(env[node.input[0]], kh, kw, sh, sw, pads[0],
                         pads[1], PoolType.POOL_AVG, name=node.name or None)

    def handle_GlobalAveragePool(self, ff, node, env):
        x = env[node.input[0]]
        return ff.pool2d(x, x.shape[2], x.shape[3], 1, 1, 0, 0,
                         PoolType.POOL_AVG, name=node.name or None)

    def handle_BatchNormalization(self, ff, node, env):
        return ff.batch_norm(env[node.input[0]], relu=False,
                             name=node.name or None)

    def handle_Relu(self, ff, node, env):
        return ff.relu(env[node.input[0]], name=node.name or None)

    def handle_Sigmoid(self, ff, node, env):
        return ff.sigmoid(env[node.input[0]], name=node.name or None)

    def handle_Tanh(self, ff, node, env):
        return ff.tanh(env[node.input[0]], name=node.name or None)

    def handle_Elu(self, ff, node, env):
        return ff.elu(env[node.input[0]], name=node.name or None)

    def handle_Softmax(self, ff, node, env):
        a = _attrs(node)
        return ff.softmax(env[node.input[0]], a.get("axis", -1),
                          name=node.name or None)

    def handle_Dropout(self, ff, node, env):
        a = _attrs(node)
        return ff.dropout(env[node.input[0]], a.get("ratio", 0.5),
                          name=node.name or None)

    def handle_Flatten(self, ff, node, env):
        return ff.flat(env[node.input[0]], name=node.name or None)

    def handle_Add(self, ff, node, env):
        return self._binary(ff, ff.add, node, env)

    def handle_Sub(self, ff, node, env):
        return self._binary(ff, ff.subtract, node, env)

    def handle_Mul(self, ff, node, env):
        return self._binary(ff, ff.multiply, node, env)

    def handle_Div(self, ff, node, env):
        return self._binary(ff, ff.divide, node, env)

    def handle_Concat(self, ff, node, env):
        a = _attrs(node)
        return ff.concat([env[i] for i in node.input], a.get("axis", 0),
                         name=node.name or None)

    def handle_Split(self, ff, node, env):
        a = _attrs(node)
        sizes = a.get("split")
        axis = a.get("axis", 0)
        x = env[node.input[0]]
        if sizes is None:
            sizes = len(node.output)
        return ff.split(x, list(sizes) if not isinstance(sizes, int)
                        else sizes, axis, name=node.name or None)

    def handle_Reshape(self, ff, node, env):
        shape = env[node.input[1]]
        return ff.reshape(env[node.input[0]],
                          [int(s) for s in np.asarray(shape)],
                          name=node.name or None)

    def handle_Transpose(self, ff, node, env):
        a = _attrs(node)
        return ff.transpose(env[node.input[0]], list(a["perm"]),
                            name=node.name or None)

    def handle_Identity(self, ff, node, env):
        return env[node.input[0]]

    def handle_Cast(self, ff, node, env):
        return env[node.input[0]]  # dtype policy handled by the executor

    def handle_Constant(self, ff, node, env):
        a = _attrs(node)
        if "value" in a:
            v = a["value"]
            if isinstance(v, np.ndarray):   # wire-decoder path
                return v
            import onnx.numpy_helper as nh
            return nh.to_array(v)
        for k in ("value_float", "value_int"):  # scalar attribute forms
            if k in a:
                return np.asarray(a[k])
        raise NotImplementedError("Constant without tensor value")

    def handle_Dense(self, ff, node, env):
        # keras2onnx legacy spelling (reference handleDense): weight is
        # stored (in, out), optional bias third input
        w = env[node.input[1]]
        t = ff.dense(env[node.input[0]], w.shape[1],
                     use_bias=len(node.input) > 2, name=node.name or None)
        self._stash_weight(ff, node, env, transpose=False)
        return t

    def handle_Pad(self, ff, node, env):
        # zero padding is a no-op when all pads are 0 (the common
        # keras2onnx artifact the reference special-cases); real spatial
        # padding folds into the consuming conv/pool's pad attributes
        a = _attrs(node)
        pads = a.get("pads")
        if pads is None and len(node.input) > 1:
            pads = np.asarray(env[node.input[1]]).tolist()
        if pads and any(int(p) for p in pads):
            raise NotImplementedError(
                "explicit non-zero Pad: fold pads into the consumer")
        return env[node.input[0]]

    def handle_Range(self, ff, node, env):
        start, limit, delta = (np.asarray(env[i]).item()
                               for i in node.input)
        return np.arange(start, limit, delta)

    def handle_Unsqueeze(self, ff, node, env):
        a = _attrs(node)
        axes = a.get("axes")
        if axes is None and len(node.input) > 1:
            axes = np.asarray(env[node.input[1]]).tolist()
        if axes is None:  # required by the ONNX spec in every opset
            raise ValueError(f"Unsqueeze node {node.name!r} has no axes")
        x = env[node.input[0]]
        if isinstance(x, np.ndarray):
            return np.expand_dims(x, tuple(int(ax) for ax in axes))
        return ff.unsqueeze(x, [int(ax) for ax in axes],
                            name=node.name or None)

    def handle_Squeeze(self, ff, node, env):
        a = _attrs(node)
        axes = a.get("axes")
        if axes is None and len(node.input) > 1:
            axes = np.asarray(env[node.input[1]]).tolist()
        x = env[node.input[0]]
        if axes is None:  # spec-legal: squeeze every size-1 dim
            axes = [d for d, s in enumerate(x.shape) if s == 1]
        if isinstance(x, np.ndarray):
            return np.squeeze(x, tuple(int(ax) for ax in axes))
        return ff.squeeze(x, [int(ax) for ax in axes],
                          name=node.name or None)

    # ------------------------------------------------------------------
    def _binary(self, ff, builder, node, env):
        a, b = env[node.input[0]], env[node.input[1]]
        if isinstance(b, np.ndarray) and b.size == 1:
            sc = {ff.add: ff.scalar_add, ff.subtract: ff.scalar_sub,
                  ff.multiply: ff.scalar_multiply,
                  ff.divide: ff.scalar_true_divide}[builder]
            return sc(a, float(b), name=node.name or None)
        return builder(a, b, name=node.name or None)

    def _stash_weight(self, ff, node, env, transpose: bool = True):
        """Record initializer values for post-compile weight transfer."""
        layer = ff.layers[-1]
        w = env.get(node.input[1])
        if isinstance(w, np.ndarray):
            pend = getattr(ff, "_pending_onnx_weights", {})
            kernel = w.T if (transpose and w.ndim == 2) else w
            entry = {"kernel": kernel}
            if len(node.input) > 2 and \
                    isinstance(env.get(node.input[2]), np.ndarray):
                entry["bias"] = env[node.input[2]]
            pend[layer.name] = entry
            ff._pending_onnx_weights = pend

    def copy_weights(self, ff: FFModel):
        """Apply stashed initializer weights after ff.compile()."""
        for lname, ws in getattr(ff, "_pending_onnx_weights", {}).items():
            if lname in ff.params:
                for wname, arr in ws.items():
                    if wname in ff.params[lname]:
                        ff.set_weights(lname, wname, arr)
