"""Executor: runs a layer graph on one device, eagerly.

The port of ``flexflow_tpu/executor.py`` for the serving slice: the graph
is interpreted op by op on torch tensors (``GraphProgram.emit``) under
``torch.inference_mode()``. There is no ``jit``: PyTorch dispatches each
op's kernels as it goes. Banks, place groups, sharding constraints,
pipelines and rematerialization belong to the JAX package's multi-device
lowerings and come with the slices that port them; the train and eval
steps come with the training slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from .core.layer import Layer
from .core.tensor import Tensor
from .dtypes import to_torch
from .ffconst import LossType, MetricsType
from .ops import EmitCtx, ensure_weight_specs, get_op_def
from .runtime.initializers import initialize
from .runtime.optimizers import Optimizer


class GraphProgram:
    """Topologically-ordered emission plan for a layer graph."""

    def __init__(self, layers: Sequence[Layer], input_tensors: Sequence[Tensor],
                 output_tensors: Sequence[Tensor]):
        self.layers = list(layers)
        self.input_tensors = list(input_tensors)
        self.output_tensors = list(output_tensors)

    def init_env(self, inputs: Dict[str, Any],
                 device: torch.device) -> Dict[int, Any]:
        """Graph inputs by tensor guid: the batch's arrays (numpy or
        torch) on ``device`` in each tensor's declared dtype, and the
        attached constants."""
        env: Dict[int, Any] = {}
        for t in self.input_tensors:
            if t.name in inputs:
                value = inputs[t.name]
            elif t.get_tensor() is not None:
                value = t.get_tensor()
            else:
                raise KeyError(f"missing input {t.name}")
            if isinstance(value, np.ndarray):
                value = torch.from_numpy(np.ascontiguousarray(value))
            env[t.guid] = value.to(device=device, dtype=to_torch(t.dtype))
        return env

    def emit_layers(self, layers: Sequence[Layer], env: Dict[int, Any],
                    params: Dict[str, Dict[str, Any]], ctx: EmitCtx) -> None:
        bf16_act = bool(getattr(ctx.config, "bf16_activations", False)) \
            if ctx.config is not None else False
        for layer in layers:
            op = get_op_def(layer.op_type)
            ins = [env[t.guid] for t in layer.inputs]
            outs = op.emit(layer.params, ins, params.get(layer.name, {}),
                           ctx, layer.name)
            if len(outs) != len(layer.outputs):
                raise RuntimeError(
                    f"op {layer.name} emitted {len(outs)} outputs, "
                    f"expected {len(layer.outputs)}")
            for o, t in zip(outs, layer.outputs):
                if bf16_act and o.dtype == torch.float32:
                    # end-to-end bf16 activations (weights stay f32)
                    o = o.to(torch.bfloat16)
                env[t.guid] = o

    def emit(self, params: Dict[str, Dict[str, Any]], inputs: Dict[str, Any],
             ctx: EmitCtx, device: torch.device) -> List[Any]:
        """Interpret the graph on ``inputs``; returns the output tensors."""
        env = self.init_env(inputs, device)
        self.emit_layers(self.layers, env, params, ctx)
        return [env[t.guid] for t in self.output_tensors]


class Executor:
    def __init__(self, program: GraphProgram, config, device: torch.device,
                 optimizer: Optimizer, loss_type: LossType,
                 metrics: Sequence[MetricsType], seed: int = 0):
        self.program = program
        self.config = config
        self.device = device
        self.optimizer = optimizer
        self.loss_type = LossType(loss_type)
        self.metrics = list(metrics)
        self.seed = seed
        # the adopted per-op kernel impls (kernels/registry.py), set by
        # FFModel._plan_kernels; empty = default impls everywhere
        self._kernel_impls: Dict[str, str] = {}
        self._forward_fn = None

    def init_params_and_state(self):
        """Materialize every layer's WeightSpecs on the device, each from
        a generator keyed by (seed, 1, layer index, weight index), the
        JAX package's key path. No op of this slice carries state."""
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for li, layer in enumerate(self.program.layers):
            specs = ensure_weight_specs(layer)
            if specs:
                params[layer.name] = {
                    spec.name: initialize(spec, (self.seed, 1, li, wi),
                                          to_torch(spec.dtype), self.device)
                    for wi, spec in enumerate(specs)}
        return params, {}

    def _attach_kernel_ctx(self, ctx: EmitCtx) -> None:
        """Thread the adopted kernel tier into an EmitCtx."""
        if self._kernel_impls:
            ctx.kernel_impls = self._kernel_impls

    def _forward(self, params, state, batch, training: bool, step=0):
        if training:
            raise NotImplementedError(
                "training forwards come with the training slice of the "
                "port")
        ctx = EmitCtx(training=False, state=state, config=self.config)
        self._attach_kernel_ctx(ctx)
        outs = self.program.emit(params, batch, ctx, self.device)
        new_state = dict(state)
        new_state.update(ctx.new_state)
        return outs, new_state, ctx.aux_losses

    def make_forward(self):
        """Inference-only forward (no label): ``fwd(params, state, batch)``
        runs the graph under ``torch.inference_mode()`` and returns the
        output tensor (a list when the graph has several). Cached."""
        if self._forward_fn is not None:
            return self._forward_fn

        def fwd(params, state, batch):
            with torch.inference_mode():
                outs, _, _ = self._forward(params, state, batch, False)
            return outs[0] if len(outs) == 1 else outs

        self._forward_fn = fwd
        return fwd
