"""Executor: runs a layer graph on one device, eagerly.

The port of ``flexflow_tpu/executor.py`` on one device: the graph is
interpreted op by op on torch tensors (``GraphProgram.emit``). There is no
``jit``: PyTorch dispatches each op's kernels as it goes, and autograd
takes the place of ``jax.grad``. ``make_forward`` serves under
``torch.inference_mode()``; ``make_train_step`` runs forward, backward
(``torch.autograd.grad`` over the parameters, with gradient accumulation
over micro-batches) and the optimizer update, fused or not;
``make_eval_step`` computes the loss and metrics; ``scored_forward``,
``kv_prefill`` and ``kv_decode_step`` serve generation. Banks, place groups,
sharding constraints, pipelines, rematerialization and the multi-device
train-step branches (overlap, quantized sync, ZeRO) belong to the JAX
package's multi-device lowerings and come with the slices that port them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.layer import Layer
from .core.tensor import Tensor
from .dtypes import to_torch
from .ffconst import LossType, MetricsType, OperatorType
from .ops import EmitCtx, LayerRng, ensure_weight_specs, get_op_def
from .runtime import losses as losses_mod
from .runtime import metrics as metrics_mod
from .runtime.initializers import initialize
from .runtime.optimizers import Optimizer, tree_leaves


def _needs_rng(layer: Layer) -> bool:
    if layer.op_type == OperatorType.OP_DROPOUT:
        return True
    if layer.op_type == OperatorType.OP_MULTIHEAD_ATTENTION:
        return layer.params.get("dropout", 0.0) > 0.0
    return False


def _as_tensor(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.to(device)


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

    def _frees(self, layers: Sequence[Layer]) -> List[List[int]]:
        """For each layer, the env entries that die after it runs: the
        tensors it is the last reader (or, unread, the producer) of, other
        than the graph's outputs."""
        keep = {t.guid for t in self.output_tensors}
        last: Dict[int, int] = {}
        for i, layer in enumerate(layers):
            for t in layer.outputs:
                last[t.guid] = i
            for t in layer.inputs:
                last[t.guid] = i
        frees: List[List[int]] = [[] for _ in layers]
        for guid, i in last.items():
            if guid not in keep:
                frees[i].append(guid)
        return frees

    def emit_layers(self, layers: Sequence[Layer], env: Dict[int, Any],
                    params: Dict[str, Dict[str, Any]], ctx: EmitCtx,
                    capture: Optional[int] = None) -> Any:
        """Emit ``layers`` in order over ``env`` (tensor guid -> value).
        Returns the value of the op output whose guid is ``capture`` (None
        when none is asked for or none runs). When autograd records nothing
        (serving, the KV prefill, the re-forward), each env entry is
        dropped after its last reader, so the peak holds only the live
        activations and the graph's outputs. Training keeps them all:
        autograd holds what the backward reads either way."""
        bf16_act = bool(getattr(ctx.config, "bf16_activations", False)) \
            if ctx.config is not None else False
        frees = None if torch.is_grad_enabled() else self._frees(layers)
        captured = None
        for li, layer in enumerate(layers):
            op = get_op_def(layer.op_type)
            ins = [env[t.guid] for t in layer.inputs]
            outs = op.emit(layer.params, ins, params.get(layer.name, {}),
                           ctx, layer.name)
            del ins
            if len(outs) != len(layer.outputs):
                raise RuntimeError(
                    f"op {layer.name} emitted {len(outs)} outputs, "
                    f"expected {len(layer.outputs)}")
            for o, t in zip(outs, layer.outputs):
                if t.guid == capture:
                    # the pre-bf16-cast value: the CE-on-logits loss reads
                    # full-precision logits from here
                    captured = o
                if bf16_act and o.dtype == torch.float32:
                    # end-to-end bf16 activations (weights stay f32)
                    o = o.to(torch.bfloat16)
                env[t.guid] = o
            del outs
            if frees is not None:
                for guid in frees[li]:
                    env.pop(guid, None)
        return captured

    def emit(self, params: Dict[str, Dict[str, Any]], inputs: Dict[str, Any],
             ctx: EmitCtx, device: torch.device,
             capture: Optional[int] = None) -> Tuple[List[Any], Any]:
        """Interpret the graph on ``inputs``; returns the output tensors
        and the value of output ``capture`` (``emit_layers``)."""
        env = self.init_env(inputs, device)
        captured = self.emit_layers(self.layers, env, params, ctx, capture)
        return [env[t.guid] for t in self.output_tensors], captured


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
        self._train_step = None
        self._eval_step = None
        # (batch, seq) shapes at which KV-cache generation failed (auto
        # mode then goes straight to the re-forward path)
        self._kv_failed_shapes: set = set()
        # CE-on-logits: if the final op is Softmax, the loss takes its
        # input as logits (the gradient is the reference's
        # (probs - labels) / batch)
        self._logits_tensor: Optional[Tensor] = None
        if losses_mod.wants_logits(self.loss_type) \
                and self.program.output_tensors:
            prod = self.program.output_tensors[0].owner_layer
            if prod is not None and prod.op_type == OperatorType.OP_SOFTMAX:
                self._logits_tensor = prod.inputs[0]

    def init_params_and_state(self):
        """Materialize every layer's WeightSpecs on the device, each from
        a generator keyed by (seed, 1, layer index, weight index), the
        JAX package's key path, and the state of every op that declares a
        ``state_spec`` (Cache): zeros, except an entry named ``var``,
        which starts at ones."""
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        state: Dict[str, Dict[str, torch.Tensor]] = {}
        for li, layer in enumerate(self.program.layers):
            specs = ensure_weight_specs(layer)
            if specs:
                params[layer.name] = {
                    spec.name: initialize(spec, (self.seed, 1, li, wi),
                                          to_torch(spec.dtype), self.device)
                    for wi, spec in enumerate(specs)}
            state_spec = getattr(get_op_def(layer.op_type), "state_spec",
                                 None)
            ss = state_spec(layer.params, [t.shape for t in layer.inputs],
                            [t.dtype for t in layer.inputs]) \
                if state_spec is not None else None
            if ss:
                state[layer.name] = {
                    sname: (torch.ones if sname == "var" else torch.zeros)(
                        sshape, dtype=to_torch(sdt), device=self.device)
                    for sname, (sshape, sdt) in ss.items()}
        return params, state

    def _rngs_for_step(self, step: int) -> Dict[str, LayerRng]:
        """Each dropout layer's randomness for one (sub-)step, keyed by
        (seed + 1, step, layer index) like the JAX package's
        ``fold_in(fold_in(key(seed + 1), step), layer index)``."""
        return {layer.name: LayerRng((self.seed + 1, int(step), li))
                for li, layer in enumerate(self.program.layers)
                if _needs_rng(layer)}

    def _attach_kernel_ctx(self, ctx: EmitCtx) -> None:
        """Thread the adopted kernel tier into an EmitCtx."""
        if self._kernel_impls:
            ctx.kernel_impls = self._kernel_impls

    def _logits_guid(self) -> Optional[int]:
        """The op output a forward captures: the logits that the loss and
        the generation scores read (``_logits_tensor``), or none."""
        lt = self._logits_tensor
        return None if lt is None else lt.guid

    def _forward(self, params, state, batch, training: bool, step=0,
                 capture: bool = True):
        """``capture``: also return the logits the loss and the scores read
        (``_logits_guid``; None without them); serving passes False."""
        rngs = self._rngs_for_step(step) if training else {}
        ctx = EmitCtx(training=training, rngs=rngs, state=state,
                      config=self.config)
        self._attach_kernel_ctx(ctx)
        outs, logits = self.program.emit(
            params, batch, ctx, self.device,
            self._logits_guid() if capture else None)
        new_state = dict(state)
        new_state.update(ctx.new_state)
        return outs, new_state, ctx.aux_losses, logits

    def _loss_and_metrics(self, outs, logits, label, aux_losses):
        pred = outs[0]
        label = _as_tensor(label, self.device)
        if self._logits_tensor is not None:
            loss = losses_mod.compute_loss(self.loss_type, logits, label,
                                           logits=True)
        else:
            loss = losses_mod.compute_loss(self.loss_type, pred, label)
        for al in aux_losses:
            loss = loss + al
        bm = metrics_mod.compute_batch_metrics(self.metrics, pred, label,
                                               self.loss_type)
        bm["loss"] = loss
        return loss, bm

    def _refuse_multi_device_options(self) -> None:
        """The overlap, quantized-sync and ZeRO branches of the JAX train
        step are multi-device; asking for one here is an error, not a
        silent serial step."""
        cfg = self.config
        asked = []
        if str(getattr(cfg, "overlap", "auto")).lower() not in (
                "auto", "off", "none", "0", "false"):
            asked.append(f"overlap={cfg.overlap!r}")
        if str(getattr(cfg, "quantized_collectives", "off")).lower() not in (
                "off", "disable", "auto"):
            asked.append(f"quantized_collectives="
                         f"{cfg.quantized_collectives!r}")
        if getattr(cfg, "shard_optimizer_states", False) or str(
                getattr(cfg, "zero_policy", "off")).lower() in (
                "memory", "all"):
            asked.append("ZeRO (shard_optimizer_states / zero_policy)")
        if str(getattr(cfg, "remat", "none")).lower() not in ("none", "off"):
            asked.append(f"remat={cfg.remat!r}")
        if asked:
            raise NotImplementedError(
                "the port's train step runs on one device; not ported yet: "
                + ", ".join(asked))

    def _grads(self, params, state, batch, step: int):
        """Gradients of the mean loss with respect to every parameter
        leaf, by ``torch.autograd.grad``; unused leaves get zeros.
        Returns (grads, new_state, detached batch metrics)."""
        names = [(ln, wn) for ln, wn, _ in tree_leaves(params)]
        leaves = [t.detach().requires_grad_(True)
                  for _, _, t in tree_leaves(params)]
        live: Dict[str, Dict[str, torch.Tensor]] = {}
        for (ln, wn), t in zip(names, leaves):
            live.setdefault(ln, {})[wn] = t
        with torch.enable_grad():
            outs, new_state, aux, logits = self._forward(
                live, state, batch, True, step)
            loss, bm = self._loss_and_metrics(outs, logits, batch["label"],
                                              aux)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (ln, wn), t, g in zip(names, leaves, gs):
            grads.setdefault(ln, {})[wn] = \
                torch.zeros_like(t) if g is None else g
        return grads, new_state, {k: v.detach() for k, v in bm.items()}

    def make_train_step(self):
        """The train step ``step_fn(params, opt_state, state, step, batch)
        -> (params, opt_state, state, metrics)``: forward, backward and
        the optimizer update (in place, fused under ``opt_update:
        fused``). ``step`` is the 0-based host step count; metrics are
        0-dim device tensors, with the loss-only ``all_finite`` flag.
        Cached."""
        if self._train_step is not None:
            return self._train_step
        self._refuse_multi_device_options()
        accum = max(getattr(self.config, "gradient_accumulation_steps", 1),
                    1)
        if self.config.batch_size % accum != 0:
            raise ValueError(
                f"--gradient-accumulation-steps {accum} must divide "
                f"the batch size {self.config.batch_size}")

        def reduce_metric(k, vs):
            v = torch.stack(vs)
            if k in metrics_mod.COUNT_KEYS:
                return v.sum(dim=0)
            if k in metrics_mod.RMS_KEYS:
                return torch.sqrt((v * v).mean(dim=0))
            return v.mean(dim=0)

        def step_fn(params, opt_state, state, step, batch):
            step = int(step)
            if accum <= 1:
                grads, state, bm = self._grads(params, state, batch, step)
            else:
                # gradient accumulation: A micro-batches, grads summed
                # (mean losses => mean of micro grads == full-batch
                # grad), one optimizer update per step
                n = next(iter(batch.values())).shape[0]
                if n % accum != 0:
                    raise ValueError(
                        f"batch dim {n} not divisible into {accum} "
                        f"accumulation micro-batches")
                mbn = n // accum
                grads, bms = None, []
                for i in range(accum):
                    mb = {k: v[i * mbn:(i + 1) * mbn]
                          for k, v in batch.items()}
                    g, state, bm_i = self._grads(params, state, mb,
                                                 step * accum + i)
                    bms.append(bm_i)
                    if grads is None:
                        grads = g
                    else:
                        for ln, wn, t in tree_leaves(grads):
                            t.add_(g[ln][wn])
                for _, _, t in tree_leaves(grads):
                    t.div_(accum)
                bm = {k: reduce_metric(k, [b[k] for b in bms])
                      for k in bms[0]}
            # the loss-only NaN screen flag, checked by the host at
            # MetricsBuffer flushes instead of reading the loss each step
            bm["all_finite"] = torch.isfinite(bm["loss"]).all()
            if self._kernel_impls.get("opt_update") == "fused":
                from .runtime.optimizers import fused_adam_tree_update
                params, opt_state = fused_adam_tree_update(
                    self.optimizer, params, grads, opt_state, step + 1)
            else:
                params, opt_state = self.optimizer.update(
                    params, grads, opt_state, step + 1)
            return params, opt_state, state, bm

        self._train_step = step_fn
        return step_fn

    def make_eval_step(self):
        """``step_fn(params, state, batch) -> (output, metrics)`` under
        ``torch.inference_mode()``. Cached."""
        if self._eval_step is not None:
            return self._eval_step

        def step_fn(params, state, batch):
            with torch.inference_mode():
                outs, _, aux, logits = self._forward(params, state, batch,
                                                     False)
                _, bm = self._loss_and_metrics(outs, logits,
                                               batch["label"], aux)
            return outs[0], bm

        self._eval_step = step_fn
        return step_fn

    def make_forward(self):
        """Inference-only forward (no label): ``fwd(params, state, batch)``
        runs the graph under ``torch.inference_mode()`` and returns the
        output tensor (a list when the graph has several). Cached."""
        if self._forward_fn is not None:
            return self._forward_fn

        def fwd(params, state, batch):
            with torch.inference_mode():
                outs, _, _, _ = self._forward(params, state, batch, False,
                                              capture=False)
            return outs[0] if len(outs) == 1 else outs

        self._forward_fn = fwd
        return fwd

    # ------------------------------------------------------------------
    # generation support
    # ------------------------------------------------------------------
    def _scores(self, outs, logits):
        """Log-domain next-token scores: the pre-softmax logits when the
        graph ends in Softmax (exact), else log of the clipped output
        probabilities."""
        if logits is not None:
            return logits
        return torch.log(torch.clamp(outs[0], min=1e-20))

    def _kv_ctx(self, mode: str, state) -> EmitCtx:
        ctx = EmitCtx(training=False, rngs={}, state=state,
                      config=self.config)
        self._attach_kernel_ctx(ctx)
        ctx.kv_mode = mode
        return ctx

    def scored_forward(self, params, state, batch):
        """Forward returning log-domain next-token scores (B, L, V), under
        ``torch.inference_mode()``."""
        with torch.inference_mode():
            outs, _, _, logits = self._forward(params, state, batch, False)
            return self._scores(outs, logits)

    def _kv_layers(self) -> List[Layer]:
        """The layers the attention layers' K/V depend on, in graph
        order."""
        by_guid = {t.guid: l for l in self.program.layers for t in l.outputs}
        need = set()
        stack = [l for l in self.program.layers
                 if l.op_type == OperatorType.OP_MULTIHEAD_ATTENTION]
        while stack:
            layer = stack.pop()
            if layer.name in need:
                continue
            need.add(layer.name)
            stack.extend(by_guid[t.guid] for t in layer.inputs
                         if t.guid in by_guid)
        return [l for l in self.program.layers if l.name in need]

    def kv_prefill(self, params, state, batch, prefill_len=None):
        """Full-sequence forward of the layers the attention layers' K/V
        depend on, under ``torch.inference_mode()``; returns every
        attention layer's K/V buffers, the decode cache seed.
        ``prefill_len`` (an int) counts the real prompt positions;
        sliding-window layers seed their O(window) ring-buffer cache from
        it. The JAX package's ``kv_prefill`` also returns the graph's
        outputs, which no caller reads and XLA drops; run eagerly, the LM
        head and the vocabulary softmax after the last attention layer
        would cost a (B, L, V) pass each, so they are not run."""
        ctx = self._kv_ctx("prefill", state)
        ctx.kv_prefill_len = prefill_len
        with torch.inference_mode():
            env = self.program.init_env(batch, self.device)
            self.program.emit_layers(self._kv_layers(), env, params, ctx)
        if not ctx.new_kv:
            raise ValueError("graph has no multihead-attention layers to "
                             "cache (KV decode unsupported)")
        return ctx.new_kv

    def kv_decode_step(self, params, state, batch, cache, index):
        """One-token forward (inputs (B, 1)) against the KV cache at query
        position ``index`` (an int, or a (B,) tensor for ragged prompts),
        under ``torch.inference_mode()``. The attention layers write this
        position's K/V into ``cache``'s buffers in place. Returns
        (scores_row (B, V), new_cache); cache layers that did not run
        keep their buffers."""
        ctx = self._kv_ctx("decode", state)
        ctx.kv_cache = cache
        ctx.kv_index = index
        with torch.inference_mode():
            outs, logits = self.program.emit(params, batch, ctx,
                                             self.device, self._logits_guid())
            scores = self._scores(outs, logits)
        new_cache = dict(cache)
        new_cache.update(ctx.new_kv)
        return scores[:, 0, :], new_cache
