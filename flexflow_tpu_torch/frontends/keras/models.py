"""Keras-style Model/Sequential with compile/fit/evaluate.

The port of ``flexflow_tpu/frontends/keras/models.py``. ``compile``
builds ``FFModel(config)``, so the model runs on ``config.device`` (the
card unless the config asks for the CPU); ``predict`` returns numpy.
Reference parity: ``python/flexflow/keras/models/base_model.py:128,198`` —
``compile`` lowers the layer graph onto an FFModel; ``fit`` drives the
training loop with callbacks (including ``VerifyMetrics``, which the
reference's CI uses as its accuracy assertion mechanism).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...config import FFConfig
from ...model import FFModel
from ...runtime.optimizers import AdamOptimizer, SGDOptimizer
from .layers import Input, KerasTensor, Layer


class Model:
    """Functional-API model: Model(inputs=[...], outputs=[...])."""

    def __init__(self, inputs=None, outputs=None, name: str = "model"):
        self.name = name
        self.inputs: List[Input] = (
            [inputs] if isinstance(inputs, (Input, KerasTensor))
            else list(inputs or []))
        self.inputs = [i.layer if isinstance(i, KerasTensor) else i
                       for i in self.inputs]
        out = outputs if outputs is not None else []
        self.outputs: List[KerasTensor] = (
            [out] if isinstance(out, KerasTensor) else list(out))
        self.ffmodel: Optional[FFModel] = None
        self._ff_outputs = None

    # ------------------------------------------------------------------
    def _topo_layers(self) -> List[Layer]:
        seen, order = set(), []

        def visit(kt: KerasTensor):
            layer = kt.layer
            if id(layer) in seen or isinstance(layer, Input):
                return
            seen.add(id(layer))
            for parent in layer.inbound:
                visit(parent)
            order.append(layer)

        for o in self.outputs:
            visit(o)
        return order

    def compile(self, optimizer="sgd", loss=None, metrics=None,
                config: Optional[FFConfig] = None, batch_size: int = 64,
                **kwargs):
        cfg = config or FFConfig()
        cfg.batch_size = batch_size
        ff = FFModel(cfg)
        ff_env: Dict[int, object] = {}
        for inp in self.inputs:
            t = ff.create_tensor((batch_size,) + tuple(inp.shape),
                                 inp.dtype, name=inp.name)
            ff_env[id(inp)] = t
        for layer in self._topo_layers():
            ins = []
            for kt in layer.inbound:
                src = kt.layer
                v = ff_env[id(src)]
                ins.append(v[kt.idx] if isinstance(v, list) else v)
            out = layer.to_ff(ff, ins)
            ff_env[id(layer)] = out
        last = self.outputs[0]
        ff_out = ff_env[id(last.layer)]
        if isinstance(ff_out, list):
            ff_out = ff_out[last.idx]
        if isinstance(optimizer, str):
            optimizer = {"sgd": SGDOptimizer(cfg.learning_rate),
                         "adam": AdamOptimizer()}[optimizer.lower()]
        elif isinstance(optimizer, dict):  # keras config dict
            otype = optimizer.get("type", "sgd")
            lr = optimizer.get("lr", 0.01)
            optimizer = SGDOptimizer(lr) if otype == "sgd" \
                else AdamOptimizer(lr)
        ff.compile(optimizer, loss, metrics, output_tensor=ff_out, **kwargs)
        self.ffmodel = ff
        self._ff_outputs = ff_out
        return self

    # ------------------------------------------------------------------
    def fit(self, x=None, y=None, batch_size=None, epochs: int = 1,
            callbacks=None, verbose=True):
        if self.ffmodel is None:
            raise ValueError("call compile() first")
        cbs = callbacks or []
        for cb in cbs:
            cb.set_model(self)
            cb.on_train_begin()
        hist = self.ffmodel.fit(x, y, batch_size, epochs,
                                callbacks=[_FFCallbackAdapter(cb)
                                           for cb in cbs],
                                verbose=verbose)
        for cb in cbs:
            cb.on_train_end()
        return hist

    def evaluate(self, x=None, y=None, batch_size=None, verbose=False):
        return self.ffmodel.eval(x, y, batch_size, verbose=verbose)

    def predict(self, x, batch_size=None):
        ff = self.ffmodel
        fwd = ff.executor.make_forward()
        arrays = x if isinstance(x, (list, tuple)) else [x]
        batch = {t.name: np.ascontiguousarray(a)
                 for t, a in zip(ff.graph_inputs, arrays)}
        out = fwd(ff.params, ff.state, batch)
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()

    def summary(self) -> str:
        lines = [f"Model: {self.name}"]
        if self.ffmodel:
            for l in self.ffmodel.layers:
                lines.append(f"  {l.name:30s} {l.op_type.name:24s} "
                             f"out={[t.shape for t in l.outputs]}")
        return "\n".join(lines)


class Sequential(Model):
    def __init__(self, layers: Optional[Sequence[Layer]] = None,
                 name: str = "sequential"):
        super().__init__(name=name)
        self._layers: List[Layer] = []
        for l in layers or []:
            self.add(l)

    def add(self, layer: Layer):
        if isinstance(layer, Input):
            self.inputs = [layer]
            self._last = layer.tensor
            return
        if not self.inputs:
            raise ValueError("Sequential needs an Input layer first")
        self._last = layer(self._last)
        self._layers.append(layer)
        self.outputs = [self._last]


class _FFCallbackAdapter:
    """Adapts keras-style callbacks to FFModel.fit's epoch hook (and
    surfaces early-stop requests)."""

    def __init__(self, cb):
        self.cb = cb
        self.stop_requested = False

    def on_epoch_end(self, epoch, logs, ff):
        self.cb.on_epoch_end(epoch, logs)
        if getattr(self.cb, "stopped_epoch", None) is not None:
            self.stop_requested = True
