"""Executor: runs a layer graph on one device, eagerly.

The port of ``flexflow_tpu/executor.py`` on one device: the graph is
interpreted op by op on torch tensors (``GraphProgram.emit``). There is no
``jit``: PyTorch dispatches each op's kernels as it goes, and autograd
takes the place of ``jax.grad``. ``make_forward`` serves under
``torch.inference_mode()``; ``make_train_step`` runs forward, backward
(``torch.autograd.grad`` over the parameters, with gradient accumulation
over micro-batches) and the optimizer update, fused or not;
``make_eval_step`` computes the loss and metrics; ``scored_forward``,
``kv_prefill`` and ``kv_decode_step`` serve generation. ``remat="blocks"``
recomputes each repeated block in the backward pass
(``torch.utils.checkpoint``, one region per block). Banks, place groups,
sharding constraints, pipelines and the multi-device train-step branches
(overlap, quantized sync, ZeRO) belong to the JAX package's multi-device
lowerings and come with the slices that port them.
Each step function is wrapped by :func:`_instrument_step`, which records
the ``executor.<name>_step`` spans when tracing is on.
"""
from __future__ import annotations

import itertools
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.layer import Layer
from .core.tensor import Tensor
from .dtypes import to_torch
from .ffconst import LossType, MetricsType, OperatorType
from .obs import events as obs_events
from .ops import EmitCtx, LayerRng, ensure_weight_specs, get_op_def
from .runtime import losses as losses_mod
from .runtime import metrics as metrics_mod
from .runtime.initializers import initialize
from .runtime.optimizers import Optimizer, tree_leaves


def _trace_sync_on() -> bool:
    """``FF_TRACE_SYNC=1``: synchronize the card inside the step span so
    it measures the step's device latency instead of the host's enqueue
    time (eager PyTorch returns as soon as the step's kernels are
    queued). Read per call — only on the traced path — so a debug
    session can toggle it between steps."""
    return obs_events._env_on(os.environ.get("FF_TRACE_SYNC"))


def _instrument_step(fn, name: str):
    """Wrap a step function with per-step telemetry: a span per call,
    ``phase="compile"`` on the first call and ``"steady"`` after it, and
    a step counter. PyTorch compiles nothing, so the first call's
    "compile" is warm-up: library initialisation (cuBLAS handles, the
    kernels' first load) and the first launches. Without
    ``FF_TRACE_SYNC=1`` a span times the host's enqueue of the step, not
    the device's execution.

    Disabled-mode cost is one flag check plus an int increment (the JAX
    package pins it at <= 3% of a train step); the raw step stays
    reachable as ``wrapped.__wrapped__`` so that cost can be timed on
    both sides of exactly this wrapper."""
    # itertools.count: serving instance clones share one forward across
    # scheduler workers, and next() is atomic under the GIL — a
    # read-modify-write int would double-label "compile"
    calls = itertools.count()

    def wrapped(*args, **kwargs):
        n = next(calls)
        if not obs_events.enabled():
            return fn(*args, **kwargs)
        obs_events.counter(f"executor.{name}_steps")
        with obs_events.span(f"executor.{name}_step",
                             phase="compile" if n == 0 else "steady",
                             step=n):
            out = fn(*args, **kwargs)
            if _trace_sync_on() and torch.cuda.is_available() \
                    and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            return out

    wrapped.__wrapped__ = fn
    return wrapped


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
        # attached constants on the device, by tensor guid: (the host
        # array they were copied from, the device asked for, the tensor
        # there). The device is kept as asked ("cuda"), since the
        # tensor's own device names the index ("cuda:0")
        self._staged: Dict[int, Tuple[Any, torch.device,
                                      torch.Tensor]] = {}

    @staticmethod
    def _to_device(value, t: Tensor, device: torch.device) -> torch.Tensor:
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        return value.to(device=device, dtype=to_torch(t.dtype))

    def stage_consts(self, device: torch.device) -> None:
        """Copy every attached constant (``Tensor.set_tensor``: folded
        positions and masks of an imported graph, ``create_constant``) to
        ``device`` once, so that no call copies it again. A constant
        whose host value is replaced later is copied again at its next
        use."""
        with torch.inference_mode(False):
            for t in self.input_tensors:
                src = t.get_tensor()
                if src is not None and not self._is_staged(t, device):
                    self._staged[t.guid] = (
                        src, device, self._to_device(src, t, device))

    def _is_staged(self, t: Tensor, device: torch.device) -> bool:
        hit = self._staged.get(t.guid)
        return hit is not None and hit[0] is t.get_tensor() \
            and hit[1] == device

    def init_env(self, inputs: Dict[str, Any],
                 device: torch.device) -> Dict[int, Any]:
        """Graph inputs by tensor guid: the batch's arrays (numpy or
        torch) on ``device`` in each tensor's declared dtype, and the
        attached constants, staged on the device (``stage_consts``)."""
        env: Dict[int, Any] = {}
        for t in self.input_tensors:
            if t.name in inputs:
                env[t.guid] = self._to_device(inputs[t.name], t, device)
            elif t.get_tensor() is not None:
                if not self._is_staged(t, device):
                    self.stage_consts(device)
                env[t.guid] = self._staged[t.guid][2]
            else:
                raise KeyError(f"missing input {t.name}")
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


def _find_remat_blocks(layers):
    """Block boundaries for ``remat="blocks"``: the maximal repeated-block
    run, each block single-input/single-output, containing no stateful or
    aux-loss-emitting ops (their side-channel writes cannot cross a
    checkpoint boundary). Returns ``(start, unit, reps, entry_guids,
    exit_guids)`` or None."""
    from .parallel.pipeline_lowering import (_has_state, chunk_boundaries,
                                             find_repeated_run)
    run = find_repeated_run(list(layers), 1)
    if run is None:
        return None
    total, start, unit = run
    reps = total // unit
    layers = list(layers)
    region = layers[start:start + total]
    # ops whose emit writes ctx side-channels (aux losses / state) cannot
    # sit inside a checkpoint boundary; AggregateSpec inherits
    # Aggregate's aux-loss emit
    aux_ops = {OperatorType.OP_AGGREGATE, OperatorType.OP_AGG_SPEC}
    if any(_has_state(l) or l.op_type in aux_ops for l in region):
        return None
    entries = chunk_boundaries(layers, start, unit, reps)
    if entries is None:
        return None
    exits = entries[1:] + [region[-1].outputs[0].guid]
    return start, unit, reps, entries, exits


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
        # remat="blocks": per-block checkpointing over the repeated-block
        # run (device memory for recomputed FLOPs)
        self._remat = None
        remat = str(getattr(config, "remat", "none") or "none").lower()
        if remat not in ("none", "off", "blocks"):
            raise ValueError(f"remat must be 'none' or 'blocks', "
                             f"got {remat!r}")
        if remat == "blocks":
            self._remat = _find_remat_blocks(program.layers)
            if self._remat is None:
                import logging
                logging.getLogger("flexflow_tpu_torch").warning(
                    "remat='blocks' requested but the graph has no "
                    "eligible repeated-block region (needs >= 2 identical "
                    "single-crossing blocks without stateful/aux-loss "
                    "ops); running without rematerialization")
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
        cap = self._logits_guid() if capture else None
        # checkpointing only matters under differentiation: eval and
        # serving forwards skip the remat path
        if self._remat is not None and training:
            outs, logits = self._emit_remat(params, batch, ctx, cap)
        else:
            outs, logits = self.program.emit(params, batch, ctx,
                                             self.device, cap)
        new_state = dict(state)
        new_state.update(ctx.new_state)
        return outs, new_state, ctx.aux_losses, logits

    def _emit_remat(self, params, batch, ctx: EmitCtx,
                    capture: Optional[int]):
        """Forward with each repeated block under
        ``torch.utils.checkpoint`` (non-reentrant): block-internal
        activations are recomputed in the backward pass instead of
        living in device memory for the whole step, so each block's
        forward kernels launch twice per step. The recomputation draws
        the same dropout masks: each layer's mask is a function of its
        (seed + 1, step, layer index) key (``LayerRng``) and the flash
        kernel's of the seed drawn from it, so no generator state needs
        saving; ``preserve_rng_state`` is off."""
        from torch.utils.checkpoint import checkpoint
        start, unit, reps, entries, exits = self._remat
        layers = self.program.layers
        env = self.program.init_env(batch, self.device)
        captured = self.program.emit_layers(layers[:start], env, params,
                                            ctx, capture)
        x = env[entries[0]]
        for b in range(reps):
            block = layers[start + b * unit:start + (b + 1) * unit]

            def block_fn(x_, p_, _block=block, _entry=entries[b],
                         _exit=exits[b]):
                benv = {_entry: x_}
                bctx = EmitCtx(training=ctx.training, rngs=ctx.rngs,
                               state=ctx.state, config=self.config)
                self._attach_kernel_ctx(bctx)
                self.program.emit_layers(_block, benv, p_, bctx)
                if bctx.new_state or bctx.aux_losses:
                    raise RuntimeError(
                        "stateful/aux op inside a rematted block")
                return benv[_exit]

            bp = {l.name: params[l.name] for l in block if l.name in params}
            x = checkpoint(block_fn, x, bp, use_reentrant=False,
                           preserve_rng_state=False)
            env[exits[b]] = x
            if exits[b] == capture:
                captured = x
        tail = self.program.emit_layers(layers[start + reps * unit:], env,
                                        params, ctx, capture)
        if tail is not None:
            captured = tail
        return [env[t.guid] for t in self.program.output_tensors], captured

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

        self._train_step = _instrument_step(step_fn, "train")
        return self._train_step

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

        self._eval_step = _instrument_step(step_fn, "eval")
        return self._eval_step

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

        self._forward_fn = _instrument_step(fwd, "forward")
        return self._forward_fn

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
