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
(``torch.utils.checkpoint``, one region per block).

Over a world of ranks (``attach_world``: a live mesh and its strategy)
every value is a DTensor with its global logical shape, as under GSPMD,
so each op's ``emit`` runs unchanged: parameters are placed per
``weight_sharding`` (``reshard.place_host``), inputs per
``input_sharding`` (each rank keeps its rows), and each op's output goes
through ``reshard.constrain_output``. The loss and metrics read the
outputs replicated, so every rank reports the same values; each
gradient is reduced to its parameter's layout (a replicated leaf's over
the data-parallel axes) and the optimizer updates each rank's blocks.
The train step's multi-device branches are the JAX package's: ZeRO-1
(moments sharded over the axes their weight is replicated on,
``runtime/zero.py``: reduce-scatter of the gradient, the update on each
rank's blocks, all-gather of the weight), the bucketed overlap of the
gradient sync with backward (``runtime/overlap.py``) and the quantized
gradient sync with error feedback (``ops/quantized_collectives.py``).
A pipeline region (``strategy.pipeline``) runs over the ranks of its pp
axis: the layers before and after it as sharded ops on every rank, the
region's stages on plain tensors, each rank its own stage's blocks of
the stacked ``pp::`` leaves, by the schedules of ``parallel/pipeline.py``
(``_pipe_run``, ``_pipe_grads``). A bank's or a place group's members run
together, each rank computing only its own (``parallel/banks.py``).
Each step function is wrapped by :func:`_instrument_step`, which records
the ``executor.<name>_step`` spans when tracing is on.
"""
from __future__ import annotations

import contextlib
import functools
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
from .ops.registry import pad_rows
from .runtime import losses as losses_mod
from .runtime import metrics as metrics_mod
from .runtime.initializers import initialize
from .runtime.optimizers import Optimizer, tree_leaves


# rows of every product and norm of a KV decode step: one GEMM tile.
# Padding 1 ... 8 rows to it costs the device little, since each weight
# is read once whatever the row count (PERF.md sec. 6).
DECODE_ROW_CHUNK = 64


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
        # over a live mesh, the strategy that lays the values out
        # (Executor.attach_world); None on one device
        self.strategy = None
        # gradient-accumulation micro-batches a step's batch is cut into
        # while it runs: an input's global rows are the compile batch's
        # share of one micro-batch
        self.micro_batches = 1

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

    def init_env(self, inputs: Dict[str, Any], device: torch.device,
                 whole: bool = False) -> Dict[int, Any]:
        """Graph inputs by tensor guid: the batch's arrays (numpy or
        torch) on ``device`` in each tensor's declared dtype, and the
        attached constants, staged on the device (``stage_consts``).
        ``whole``: over a live mesh every array is the whole global
        value, whatever its rows (generation's batches), never a rank's
        own rows."""
        env: Dict[int, Any] = {}
        for t in self.input_tensors:
            if t.name in inputs:
                if self.strategy is not None:
                    env[t.guid] = self._place_input(inputs[t.name], t,
                                                    device, whole)
                else:
                    env[t.guid] = self._to_device(inputs[t.name], t, device)
            elif t.get_tensor() is not None:
                if not self._is_staged(t, device):
                    self.stage_consts(device)
                env[t.guid] = self._staged[t.guid][2]
                if self.strategy is not None:
                    env[t.guid] = self._replicated(env[t.guid])
            else:
                raise KeyError(f"missing input {t.name}")
        return env

    def _place_input(self, value, t: Tensor, device: torch.device,
                     whole: bool = False):
        """A graph input over the live mesh, laid out per the strategy's
        ``input_sharding``: from the whole global batch (each rank keeps
        its block) or, unless ``whole``, from this rank's own rows (a
        loader that read only ``local_row_range``)."""
        from .parallel.distributed import put_global
        from .parallel.strategy import spec_placements
        st = self.strategy
        pl = spec_placements(st.input_sharding(t.name), st.dmesh,
                             len(t.shape))
        shape = tuple(value.shape)
        if not whole and shape[1:] == tuple(t.shape[1:]):
            shape = (t.shape[0] // self.micro_batches,) + tuple(t.shape[1:])
        return put_global(value, st.dmesh.mesh, pl, device=device,
                          dtype=to_torch(t.dtype), global_shape=shape)

    def _replicated(self, x: torch.Tensor):
        from torch.distributed.tensor import Replicate
        from .parallel.local_ops import from_local
        mesh = self.strategy.dmesh.mesh
        return from_local(x, mesh, [Replicate()] * mesh.ndim, x.shape)

    def _frees(self, layers: Sequence[Layer], keep=()) -> List[List[int]]:
        """For each layer, the env entries that die after it runs: the
        tensors it is the last reader (or, unread, the producer) of, other
        than the graph's outputs and ``keep`` (what later layers read)."""
        keep = {t.guid for t in self.output_tensors} | set(keep)
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
                    capture: Optional[int] = None, keep=()) -> Any:
        """Emit ``layers`` in order over ``env`` (tensor guid -> value).
        Returns the value of the op output whose guid is ``capture`` (None
        when none is asked for or none runs). When autograd records nothing
        (serving, the KV prefill, the re-forward), each env entry is
        dropped after its last reader (other than the guids in ``keep``,
        which later layers read), so the peak holds only the live
        activations and the graph's outputs. Training keeps them all:
        autograd holds what the backward reads either way. Over a live
        mesh the members of a bank or a place group (``strategy.banks``,
        ``strategy.place_groups``) run together at the first member's
        position (``parallel/banks.py``)."""
        bf16_act = bool(getattr(ctx.config, "bf16_activations", False)) \
            if ctx.config is not None else False
        frees = None if torch.is_grad_enabled() \
            else self._frees(layers, keep)
        st = self.strategy
        replicate_consts = contextlib.nullcontext
        grouped: Dict[str, Any] = {}
        grouped_out: Dict[str, Any] = {}
        if st is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication as replicate_consts
            from .parallel.reshard import constrain_output
            ctx.strategy = st
            present = {l.name for l in layers}
            for grp in list(st.banks or ()) + list(st.place_groups or ()):
                if set(grp.members) <= present:
                    for m in grp.members:
                        grouped[m] = grp
        captured = None
        for li, layer in enumerate(layers):
            op = get_op_def(layer.op_type)
            if layer.name in grouped:
                if layer.name not in grouped_out:
                    grouped_out.update(self._emit_group(
                        grouped[layer.name], layers, env, params, ctx))
                outs = [grouped_out.pop(layer.name)]
            else:
                ins = [env[t.guid] for t in layer.inputs]
                # over a live mesh a plain tensor an op makes (a position
                # range, a mask) is the same on every rank: replicated
                with replicate_consts():
                    outs = op.emit(layer.params, ins,
                                   params.get(layer.name, {}), ctx,
                                   layer.name)
                del ins
            if len(outs) != len(layer.outputs):
                raise RuntimeError(
                    f"op {layer.name} emitted {len(outs)} outputs, "
                    f"expected {len(layer.outputs)}")
            for oi, (o, t) in enumerate(zip(outs, layer.outputs)):
                if st is not None:
                    o = constrain_output(o, st.output_sharding(
                        layer.name, oi), st, layer)
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

    def _emit_group(self, grp, layers, env, params, ctx) -> Dict[str, Any]:
        """The outputs of a bank's or a place group's members, by layer
        name: each rank computes its own members (``parallel/banks.py``).
        A bank's members run with the weight-sizing params of the largest
        (a padded bank's weights are zero-padded to it)."""
        from .parallel.banks import (_PAD_FREE_PARAMS, BankSpec, emit_bank,
                                     emit_place_group)
        by_name = {l.name: l for l in layers}
        members = [by_name[n] for n in grp.members]
        for m in members:
            if len(m.inputs) != 1 or len(m.outputs) != 1:
                raise ValueError(f"placed member {m.name} must be "
                                 f"1-in/1-out")
            if _needs_rng(m):
                raise ValueError(f"placed member {m.name} uses rng (not "
                                 f"supported)")
        xs = [env[m.inputs[0].guid] for m in members]
        mesh = self.strategy.dmesh.mesh
        local = EmitCtx(training=ctx.training, rngs={}, state={},
                        config=ctx.config)
        local.kernel_impls = ctx.kernel_impls
        if isinstance(grp, BankSpec):
            op = get_op_def(members[0].op_type)
            eparams = dict(members[0].params)
            if getattr(grp, "padded", False):
                for key in _PAD_FREE_PARAMS.get(members[0].op_type, ()):
                    eparams[key] = max(m.params[key] for m in members)
            outs = emit_bank(
                grp, members, xs, params.get(grp.param_name, {}),
                lambda k, x, w: op.emit(eparams, [x], w, local,
                                        members[0].name)[0], mesh)
        else:
            ops = [get_op_def(m.op_type) for m in members]
            for m, op in zip(members, ops):
                ss = getattr(op, "state_spec", None)
                if ss is not None and ss(m.params,
                                         [t.shape for t in m.inputs],
                                         [t.dtype for t in m.inputs]):
                    raise ValueError(f"stateful op {m.name} cannot join a "
                                     f"place group")
            outs = emit_place_group(
                grp, members, xs, [params.get(m.name, {}) for m in members],
                lambda i, x, w: ops[i].emit(members[i].params, [x], w,
                                            local, members[i].name)[0],
                mesh)
        return {m.name: o for m, o in zip(members, outs)}

    def emit(self, params: Dict[str, Dict[str, Any]], inputs: Dict[str, Any],
             ctx: EmitCtx, device: torch.device,
             capture: Optional[int] = None,
             whole: bool = False) -> Tuple[List[Any], Any]:
        """Interpret the graph on ``inputs``; returns the output tensors
        and the value of output ``capture`` (``emit_layers``)."""
        env = self.init_env(inputs, device, whole)
        captured = self.emit_layers(self.layers, env, params, ctx, capture)
        return [env[t.guid] for t in self.output_tensors], captured


def _local_tree(tree):
    """A nested dict of tensors with each DTensor leaf replaced by its
    local block (the same storage: an in-place update of the block updates
    the DTensor)."""
    from .parallel.local_ops import is_dtensor
    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    return tree.to_local() if is_dtensor(tree) else tree


# Megatron tp split of stacked stage weights: role -> weight name -> dim
# index (within the weight's own shape) sharded over the tp axis. None =
# replicated (biases applied once, after the all-reduce).
_TP_WEIGHT_DIMS = {
    "attn": {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0,
             "wo": 0, "bo": None},
    "col": {"kernel": 1, "bias": 0},
    "row": {"kernel": 0, "bias": None},
}


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
        # over a world of ranks: the strategy and its live mesh
        self.strategy = None
        # the pipeline region (parallel/pipeline_lowering.PipelineRegion)
        # the strategy carries; its stages run over the pp ranks
        self.pipe = None
        # ZeRO-1 (runtime/zero.py): the placements of every optimizer-
        # state leaf, set by FFModel.compile when it shards the moments;
        # the ZeRO split of each sharded leaf is derived from them lazily
        self.opt_state_constraints = None
        self._zero_layouts = None
        # the bucketed grad-sync schedule (runtime/overlap.py), or None:
        # the serial step; its runtime over a world (BucketedSync)
        self._overlap_schedule = None
        self._bucketed = None
        # the quantized-sync schedule (ops/quantized_collectives.py)
        self._qsync = None
        # the mesh's seq group (kernels/ring_attention.SeqGroup), which
        # ring attention runs over; None without a seq axis
        self._seq_ring = None
        if losses_mod.wants_logits(self.loss_type) \
                and self.program.output_tensors:
            prod = self.program.output_tensors[0].owner_layer
            if prod is not None and prod.op_type == OperatorType.OP_SOFTMAX:
                self._logits_tensor = prod.inputs[0]

    def attach_world(self, strategy) -> None:
        """Run over ``strategy``'s live mesh (``DeviceMesh.live``): the
        values become DTensors laid out by the strategy."""
        if not strategy.dmesh.live:
            raise ValueError("attach_world needs a strategy over a live "
                             "mesh")
        self.strategy = strategy
        self.program.strategy = strategy
        self.pipe = getattr(strategy, "pipeline", None)
        if self.pipe is not None:
            self._attach_pipeline()
        self._seq_ring = strategy.dmesh.seq_group()

    def attach_overlap(self, strategy) -> None:
        """Build the bucketed grad-sync schedule for ``strategy`` (None
        where overlap is off or a pipeline owns the schedule) and record
        it on the strategy as ``strategy.overlap``."""
        from .runtime import overlap as overlap_mod
        sched = overlap_mod.build_overlap_schedule(self.program, strategy,
                                                   self.config)
        self._overlap_schedule = sched
        self._bucketed = None
        self._train_step = None
        if sched is not None:
            strategy.overlap = sched.record()
            obs_events.counter("overlap.schedules_built")

    def attach_qsync(self, strategy=None) -> None:
        """(Re)resolve the strategy's quantized-sync plan into an
        executable schedule (None keeps the full-precision sync), and
        drop the cached train step when it changes."""
        from .ops import quantized_collectives as qsync_mod
        st = strategy if strategy is not None else self.strategy
        sched = None
        if st is not None and st.dmesh.live:
            sched = qsync_mod.runtime_schedule(self.program, st,
                                               self.config, st.dmesh)
        if (sched is None) != (self._qsync is None):
            self._train_step = None
        self._qsync = sched
        if sched is not None:
            obs_events.counter("qsync.schedules_built")

    def _no_grad(self):
        """``torch.inference_mode()`` on one device; ``torch.no_grad()``
        over a live mesh, where DTensor computes ``a & b`` of two boolean
        DTensors wrongly under inference mode (MoE's dispatch mask
        parted from the one-device run's)."""
        return torch.no_grad() if self.strategy is not None \
            else torch.inference_mode()

    def _unplace(self, x):
        """A value as the host sees it: the whole tensor on every rank (a
        gather where it is sharded); a plain tensor unchanged."""
        from .parallel.local_ops import is_dtensor
        if not is_dtensor(x):
            return x
        from torch.distributed.tensor import Replicate
        mesh = x.device_mesh
        return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()

    def init_params_and_state(self):
        """Materialize every layer's WeightSpecs on the device, each from
        a generator keyed by (seed, 1, layer index, weight index), the
        JAX package's key path, and the state of every op that declares a
        ``state_spec`` (Cache): zeros, except an entry named ``var``,
        which starts at ones."""
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        state: Dict[str, Dict[str, torch.Tensor]] = {}
        region = self._region_names()
        banks = self._kept_banks()
        members: Dict[str, Dict[str, torch.Tensor]] = {}
        in_bank = {n for bk in banks for n in bk.members}
        if self.pipe is not None:
            params.update(self._init_pipeline_params())
        for li, layer in enumerate(self.program.layers):
            specs = ensure_weight_specs(layer)
            if specs and layer.name not in region:
                # a bank member's weights take the keys of the unbanked
                # run, so banked and unbanked runs start alike
                (members if layer.name in in_bank else params)[
                    layer.name] = {
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
                if layer.name in in_bank:
                    raise ValueError(f"stateful op {layer.name} cannot be "
                                     f"banked")
        from .parallel.banks import stack_members
        for bk in banks:
            if all(m in members for m in bk.members):
                params[bk.param_name] = stack_members(
                    [members[m] for m in bk.members],
                    getattr(bk, "padded", False))
        if self.strategy is not None:
            params, state = self.place_tree(params), self.place_state(state)
        return params, state

    def _kept_banks(self) -> List:
        """The strategy's banks whose members are all in this program (a
        stale import against a renamed model drops the others, with a
        warning, as the JAX package does)."""
        st = self.strategy
        banks = list(getattr(st, "banks", None) or []) if st is not None \
            else []
        names = {l.name for l in self.program.layers}
        kept = [bk for bk in banks if set(bk.members) <= names]
        if len(kept) != len(banks):
            import logging
            logging.getLogger("flexflow_tpu_torch").warning(
                "dropping %d bank placement(s) whose members are not in "
                "this program", len(banks) - len(kept))
            st.banks = kept
        return kept

    def leaf_spec(self, layer_name: str, weight_name: str):
        """The spec a parameter leaf is laid out by over the live mesh: a
        pipeline region's stacked leaves (``pp::<template layer>``) over
        the pp axis (and the tp axis by their Megatron role), a bank's
        stacked members over its bank axes, any other weight per the
        strategy's ``weight_sharding``."""
        from .parallel.strategy import P
        pipe = self.pipe
        if pipe is not None and layer_name.startswith("pp::"):
            return self._pipe_leaf_spec(layer_name, weight_name)
        for bk in getattr(self.strategy, "banks", None) or ():
            if bk.param_name == layer_name:
                ax = bk.axes[0] if len(bk.axes) == 1 else tuple(bk.axes)
                return P(ax)
        return self.strategy.weight_sharding(layer_name, weight_name)

    def place_state(self, state):
        """Every op state entry replicated over the live mesh."""
        return {ln: {k: self.program._replicated(v) for k, v in d.items()}
                for ln, d in state.items()}

    # ------------------------------------------------------------------
    # the pipeline region over the pp ranks (parallel/pipeline.py)
    # ------------------------------------------------------------------
    def _region_names(self) -> set:
        pipe = self.pipe
        if pipe is None:
            return set()
        return {l.name for l in self.program.layers[pipe.start:pipe.end]}

    def _attach_pipeline(self) -> None:
        """The layer split around the region, the mesh dims of its axes
        and the point-to-point route of its hand-offs."""
        from .parallel.distributed import Handoff, p2p_route
        pipe, layers = self.pipe, self.program.layers
        if self._remat is not None:
            import logging
            logging.getLogger("flexflow_tpu_torch").warning(
                "remat='blocks' is skipped when a pipeline region is "
                "active: its stages recompute nothing, and the layers "
                "before and after the region are never rematerialized")
            self._remat = None
        self._pre_layers = [] if pipe.prologue else layers[:pipe.start]
        self._post_layers = layers[pipe.end + len(pipe.epilogue or ()):]
        after = list(layers[pipe.start:]) + list(pipe.epilogue or ())
        self._pre_keep = {t.guid for l in after for t in l.inputs}
        names = list(self.strategy.dmesh.mesh.mesh_dim_names)
        self._pp_dim = names.index(pipe.pp_axis)
        self._tp_dim = names.index(pipe.tp_axis) \
            if pipe.tp_axis is not None else None
        self._dp_dims = [names.index(a) for a in pipe.dp_axes]
        self._handoff = Handoff(self.strategy.dmesh.mesh, self._pp_dim,
                                p2p_route(self.device.type))
        self._template_of = {pipe.param_name(l): l for l in pipe.template}

    def _init_pipeline_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The region's stacked parameters, whole: for each template
        layer's weight one leaf in the region's layout
        (``PipelineRegion.stack_blocks``), keyed ``pp::<template
        layer>``, each block drawn from its own key (the JAX package's
        key path)."""
        pipe = self.pipe
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for lj, layer in enumerate(pipe.template):
            specs = ensure_weight_specs(layer)
            if not specs:
                continue
            lp = {}
            for wi, spec in enumerate(specs):
                dt = to_torch(spec.dtype)
                # the ragged run's blocks take the JAX package's ragged
                # key path, the uniform run's chunks the uniform one's
                path = 3 if pipe.counts is not None else 2
                lp[spec.name] = pipe.stack_blocks([initialize(
                    spec, (self.seed, path, 7000 + (lj << 12) + wi, b), dt,
                    self.device)
                    for b in range(len(pipe.stage_layer_names))])
            out[pipe.param_name(layer)] = lp
        return out

    def _pipe_leaf_spec(self, key: str, wname: str):
        """A stacked leaf's spec: the stage dim over the pp axis, and,
        under in-stage tp, the dim its Megatron role splits over the tp
        axis (``_TP_WEIGHT_DIMS``)."""
        from .parallel.strategy import P
        pipe = self.pipe
        tl = self._template_of[key]
        spec = next(w for w in ensure_weight_specs(tl) if w.name == wname)
        lead = [None] * (2 if pipe.counts is not None
                         or pipe.n_chunks > 1 else 1)
        lead[pipe.stage_dim] = pipe.pp_axis
        dims = [None] * len(spec.shape)
        role = pipe.tp_roles.get(tl.name) if pipe.tp_axis else None
        if role is not None:
            d = _TP_WEIGHT_DIMS[role].get(wname)
            if d is not None:
                dims[d] = pipe.tp_axis
        return P(*lead, *dims)

    def _pipe_local_keys(self) -> List[str]:
        """The parameter keys the region uses on each rank's own blocks:
        the stacked leaves, and the ragged prologue's and epilogue's
        layers."""
        pipe = self.pipe
        keys = [pipe.param_name(l) for l in pipe.template]
        keys += [l.name for l in list(pipe.prologue or ())
                 + list(pipe.epilogue or ())]
        return keys

    def _pipe_locals(self, params, training: bool):
        """This rank's blocks of the region's parameters, as leaves of
        their own when training."""
        out = {}
        for key in self._pipe_local_keys():
            if key in params:
                out[key] = {wn: t.to_local().detach().requires_grad_(True)
                            if training else t.to_local()
                            for wn, t in params[key].items()}
        return out

    def _tensor_by_guid(self, guid: int) -> Tensor:
        for l in self.program.layers:
            for t in list(l.outputs) + list(l.inputs):
                if t.guid == guid:
                    return t
        for t in self.program.input_tensors:
            if t.guid == guid:
                return t
        raise KeyError(guid)

    def _act_dtype(self, t: Tensor) -> torch.dtype:
        dt = to_torch(t.dtype)
        if dt == torch.float32 and getattr(self.config, "bf16_activations",
                                           False):
            return torch.bfloat16
        return dt

    def _emit_local(self, layers, env, weights_of, ctx: EmitCtx,
                    roles=None) -> None:
        """Emit ``layers`` on plain tensors (a stage's own rows and
        blocks). ``roles[j]`` is layer j's Megatron role under in-stage
        tp: "attn" / "col" take their inputs through ``tp_copy``; "attn"
        / "row" hold their bias back, sum their partial output over the
        tp group (``tp_reduce``) and add it once; "attn" attends its
        heads at their global indices (``EmitCtx.head_block``)."""
        from .parallel.pipeline import tp_copy, tp_reduce
        bf16_act = bool(getattr(self.config, "bf16_activations", False))
        group = self._tp_group if roles else None
        for j, layer in enumerate(layers):
            op = get_op_def(layer.op_type)
            ins = [env[t.guid] for t in layer.inputs]
            w = weights_of(j, layer)
            role = roles[j] if roles else None
            if role in ("attn", "col"):
                seen: Dict[int, torch.Tensor] = {}
                ins = [seen.setdefault(id(x), tp_copy(x, group))
                       for x in ins]
            if role == "attn":
                h = layer.params["num_heads"]
                tp = self._tp_size
                ctx.head_block = (h, self._tp_rank * (h // tp))
            if role in ("attn", "row"):
                w = dict(w)
                bias = w.pop("bo" if role == "attn" else "bias", None)
                outs = op.emit(layer.params, ins, w, ctx, layer.name)
                y = tp_reduce(outs[0], group)
                if bias is not None:
                    y = (y + bias).to(outs[0].dtype)
                outs = [y]
            else:
                outs = op.emit(layer.params, ins, w, ctx, layer.name)
            ctx.head_block = None
            for o, t in zip(outs, layer.outputs):
                if bf16_act and o.dtype == torch.float32:
                    o = o.to(torch.bfloat16)
                env[t.guid] = o

    def _pipe_run(self, params, state, batch, training: bool, step,
                  capture: bool = True, leaves=None) -> Dict[str, Any]:
        """The forward of a pipelined program on this rank: the layers
        before the region as sharded ops, the region's schedule on this
        rank's stage (``parallel/pipeline.gpipe``; each microbatch's
        dropout masks the serial step's on its rows), the region's output
        made whole over the pp and tp axes, then the layers after it.
        ``leaves``: this rank's blocks of the region's parameters
        (``_pipe_locals``). Returns the outputs, the new op state, the
        aux losses, the captured logits and what the backward needs."""
        from .parallel.distributed import mesh_group
        from .parallel.pipeline import gpipe
        from .parallel.pipeline_lowering import (region_entry_transition,
                                                 region_exit_transition)
        pipe, prog = self.pipe, self.program
        mesh = self.strategy.dmesh.mesh
        coord = mesh.get_coordinate()
        S, M, v = pipe.n_stages, pipe.n_microbatches, pipe.n_chunks
        s = coord[self._pp_dim]
        self._tp_rank = coord[self._tp_dim] if self._tp_dim is not None \
            else 0
        if self._tp_dim is not None:
            self._tp_group, self._tp_size, _ = mesh_group(mesh,
                                                          [self._tp_dim])
        _, dp_n, dp_i = mesh_group(mesh, self._dp_dims) if self._dp_dims \
            else (None, 1, 0)
        rngs = self._rngs_for_step(step) if training else {}
        ctx = EmitCtx(training=training, rngs=rngs, state=state,
                      config=self.config)
        self._attach_kernel_ctx(ctx)
        cap = self._logits_guid() if capture else None
        env = prog.init_env(batch, self.device)
        captured = prog.emit_layers(self._pre_layers, env, params, ctx, cap,
                                    keep=self._pre_keep)
        entry_t = self._tensor_by_guid(pipe.entry_guid)
        B = int(entry_t.shape[0])
        if B % (dp_n * M):
            raise ValueError(
                f"batch {B} does not split into {M} microbatches over "
                f"{dp_n} data-parallel rank(s)")
        rows = B // dp_n
        mbl, r0 = rows // M, dp_i * rows
        local = leaves if leaves is not None \
            else self._pipe_locals(params, False)
        x_loc = x_leaf = None
        if pipe.prologue:
            raw = {}
            for t in pipe.prologue_inputs:
                a = batch[t.name]
                if int(a.shape[0]) == B:
                    a = a[r0:r0 + rows]
                raw[t.guid] = _as_tensor(a, self.device).to(
                    to_torch(t.dtype))
        else:
            x_loc = region_entry_transition(env[pipe.entry_guid], pipe,
                                            mesh)
            x_leaf = x_loc.detach().requires_grad_(training)

        def lctx(m: int) -> EmitCtx:
            c = EmitCtx(training=training, rngs=rngs, state={},
                        config=self.config)
            self._attach_kernel_ctx(c)
            c.local_shape, c.local_rows = True, (B, r0 + m * mbl)
            return c

        def first_in(m: int):
            if pipe.prologue:
                penv = {g: a[m * mbl:(m + 1) * mbl] for g, a in raw.items()}
                self._emit_local(pipe.prologue, penv,
                                 lambda j, l: local.get(l.name, {}),
                                 lctx(m))
                return penv[pipe.entry_guid]
            return x_leaf[m * mbl:(m + 1) * mbl]

        layers = prog.layers
        unit = len(pipe.template)
        keys = [pipe.param_name(l) for l in pipe.template]
        roles = [pipe.tp_roles.get(l.name) for l in pipe.template] \
            if pipe.tp_axis is not None else None

        def block(b: int, x, ctx_, pick):
            blk = layers[pipe.start + b * unit:pipe.start + (b + 1) * unit]
            benv = {pipe.chunk_entries[b]: x}
            self._emit_local(
                blk, benv, lambda j, l: {wn: pick(t) for wn, t in
                                         local.get(keys[j], {}).items()},
                ctx_, roles)
            return benv[blk[-1].outputs[0].guid]

        def run_slot(k: int, m: int, x):
            c = lctx(m)
            if pipe.counts is None:
                return block(k * S + s, x, c,
                             lambda t: t[pipe.local_index(k)])
            first = sum(pipe.counts[:s])
            for i in range(pipe.counts[s]):
                x = block(first + i, x, c,
                          lambda t, i=i: t[pipe.local_index(0, i)])
            if s == S - 1 and pipe.epilogue:
                eenv = {pipe.exit_guid: x}
                self._emit_local(pipe.epilogue, eenv,
                                 lambda j, l: local.get(l.name, {}), c)
                x = eenv[pipe.epilogue_exit_guid]
            return x

        act_shape = (mbl,) + tuple(entry_t.shape[1:])
        outputs, saved = gpipe(run_slot, first_in, self._handoff, s, S, M,
                               v, act_shape, self._act_dtype(entry_t),
                               self.device, training)
        out_t = self._tensor_by_guid(pipe.region_out_guid)
        out_dt = self._act_dtype(out_t)
        if s == S - 1 and self._tp_rank == 0:
            y = torch.cat([outputs[m].detach() for m in range(M)]).to(out_dt)
        else:
            y = torch.zeros((rows,) + tuple(out_t.shape[1:]), dtype=out_dt,
                            device=self.device)
        y_dt, y_leaf = region_exit_transition(
            y, pipe, mesh, (B,) + tuple(out_t.shape[1:]))
        env[pipe.region_out_guid] = y_dt
        if cap == pipe.region_out_guid:
            captured = y_dt
        tail = prog.emit_layers(self._post_layers, env, params, ctx, cap)
        if tail is not None:
            captured = tail
        new_state = dict(state)
        new_state.update(ctx.new_state)
        return {"outs": [env[t.guid] for t in prog.output_tensors],
                "new_state": new_state, "aux": ctx.aux_losses,
                "logits": captured, "saved": saved, "x_loc": x_loc,
                "x_leaf": x_leaf, "y_leaf": y_leaf, "mbl": mbl, "stage": s}

    def _pipe_grads(self, params, state, batch, step: int):
        """Gradients of a pipelined program's mean loss, each laid out as
        its leaf: the loss's backward through the layers after the region
        (every rank), the schedule's backward on this rank's stage, then
        the backward of the layers before the region from the entry's
        cotangent (summed over the pp and tp axes, one rank
        contributing). The region's gradients are summed over the dp
        axes (the prologue's and epilogue's over the pp axis too): each
        counted once. Returns (grads, new_state, detached batch
        metrics)."""
        import torch.distributed as dist
        from .parallel.distributed import mesh_group
        from .parallel.local_ops import from_local
        from .parallel.pipeline import gpipe_backward
        pipe = self.pipe
        mesh = self.strategy.dmesh.mesh
        local_keys = set(self._pipe_local_keys())
        live: Dict[str, Dict[str, Any]] = {}
        for ln, wn, t in tree_leaves(params):
            if ln not in local_keys:
                live.setdefault(ln, {})[wn] = t.detach().requires_grad_(True)
        locs = self._pipe_locals(params, True)
        with torch.enable_grad():
            run = self._pipe_run(live, state, batch, True, step, True, locs)
            loss, bm = self._loss_and_metrics(run["outs"], run["logits"],
                                              batch["label"], run["aux"])
            torch.autograd.backward(loss, retain_graph=True)
            g_y = run["y_leaf"].grad
            if g_y is None:
                g_y = torch.zeros_like(run["y_leaf"])
            mbl, s = run["mbl"], run["stage"]
            gpipe_backward(run["saved"],
                           lambda m: g_y[m * mbl:(m + 1) * mbl].to(
                               run["y_leaf"].dtype),
                           self._handoff, s, pipe.n_stages,
                           pipe.n_microbatches, pipe.n_chunks)
            new_state = run["new_state"]
            x_loc = run["x_loc"]
            if x_loc is not None and x_loc.requires_grad:
                gx = run["x_leaf"].grad
                if gx is None or s != 0 or self._tp_rank != 0:
                    gx = torch.zeros_like(run["x_leaf"])
                rest = [d for d in range(mesh.ndim)
                        if d not in self._dp_dims]
                if rest:
                    gx = gx.contiguous()
                    dist.all_reduce(gx, group=mesh_group(mesh, rest)[0])
                torch.autograd.backward(x_loc, gx.to(x_loc.dtype))
        del run
        grads: Dict[str, Dict[str, Any]] = {}
        for ln, ws in live.items():
            for wn, leaf in ws.items():
                t = params[ln][wn]
                g = leaf.grad
                if g is None:
                    g = torch.zeros_like(t)
                elif list(g.placements) != list(t.placements):
                    g = g.redistribute(t.device_mesh, t.placements)
                grads.setdefault(ln, {})[wn] = g
        by_group: Dict[tuple, List[tuple]] = {}
        stacked = {pipe.param_name(l) for l in pipe.template}
        for key, ws in locs.items():
            dims = tuple(self._dp_dims) if key in stacked else tuple(
                sorted(set(self._dp_dims) | {self._pp_dim}))
            for wn, leaf in ws.items():
                by_group.setdefault(dims, []).append((key, wn))
        for dims, kw in by_group.items():
            gs = [locs[k][w].grad if locs[k][w].grad is not None
                  else torch.zeros_like(locs[k][w]) for k, w in kw]
            if dims:
                from .parallel.banks import _flat_all_reduce
                gs = _flat_all_reduce(gs, mesh_group(mesh, list(dims))[0])
            for (k, w), g in zip(kw, gs):
                t = params[k][w]
                grads.setdefault(k, {})[w] = from_local(
                    g.to(t.dtype), t.device_mesh, t.placements, t.shape)
        grads = {ln: {wn: grads[ln][wn] for wn in params[ln]}
                 for ln in params}
        return grads, new_state, {k: v.detach() for k, v in bm.items()}

    def place_tree(self, params):
        """Every parameter laid out per its ``leaf_spec``
        over the live mesh (``reshard.place_host``: each rank keeps its
        block of the whole array, which every rank holds alike)."""
        from .parallel.reshard import place_host
        st = self.strategy
        return {ln: {wn: place_host(t, st.dmesh, self.leaf_spec(ln, wn),
                                    device=self.device)
                     for wn, t in ws.items()}
                for ln, ws in params.items()}

    def _rngs_for_step(self, step: int) -> Dict[str, LayerRng]:
        """Each dropout layer's randomness for one (sub-)step, keyed by
        (seed + 1, step, layer index) like the JAX package's
        ``fold_in(fold_in(key(seed + 1), step), layer index)``."""
        return {layer.name: LayerRng((self.seed + 1, int(step), li))
                for li, layer in enumerate(self.program.layers)
                if _needs_rng(layer)}

    def _attach_kernel_ctx(self, ctx: EmitCtx) -> None:
        """Thread the adopted kernel tier and the mesh's seq group (the
        ranks ring attention runs over) into an EmitCtx."""
        if self._kernel_impls:
            ctx.kernel_impls = self._kernel_impls
        ctx.seq_ring = self._seq_ring

    def _logits_guid(self) -> Optional[int]:
        """The op output a forward captures: the logits that the loss and
        the generation scores read (``_logits_tensor``), or none."""
        lt = self._logits_tensor
        return None if lt is None else lt.guid

    def _forward(self, params, state, batch, training: bool, step=0,
                 capture: bool = True,
                 local_rows: Optional[Tuple[int, int]] = None,
                 whole: bool = False):
        """``capture``: also return the logits the loss and the scores read
        (``_logits_guid``; None without them); serving passes False.
        ``local_rows`` = (global batch, first row) marks a rank's forward
        on its own rows with local weights (the quantized sync):
        ``EmitCtx.local_shape`` (a reshape to a global batch shape takes
        the rank's rows) and the global step's dropout masks, cut to the
        rows. (The JAX package draws each shard's masks from its own key
        there; these are the serial step's.) ``whole``: the batch's
        arrays are whole global values (``GraphProgram.init_env``)."""
        if self.pipe is not None:
            run = self._pipe_run(params, state, batch, training, step,
                                 capture)
            return run["outs"], run["new_state"], run["aux"], run["logits"]
        rngs = self._rngs_for_step(step) if training else {}
        ctx = EmitCtx(training=training, rngs=rngs, state=state,
                      config=self.config)
        ctx.local_shape = local_rows is not None
        ctx.local_rows = local_rows
        self._attach_kernel_ctx(ctx)
        cap = self._logits_guid() if capture else None
        # checkpointing only matters under differentiation: eval and
        # serving forwards skip the remat path
        if self._remat is not None and training:
            outs, logits = self._emit_remat(params, batch, ctx, cap)
        else:
            outs, logits = self.program.emit(params, batch, ctx,
                                             self.device, cap, whole)
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

    def _loss_and_metrics(self, outs, logits, label, aux_losses,
                          local: bool = False):
        if self.strategy is not None and not local:
            outs, logits, label, aux_losses = self._replicate_for_loss(
                outs, logits, label, aux_losses)
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

    def _replicate_for_loss(self, outs, logits, label, aux_losses):
        """The loss's operands over a live mesh, whole on every rank: the
        outputs and logits gathered (the gradient flows back to each
        rank's block), and the labels too where the batch came as this
        rank's rows, so that every rank computes the same loss and
        metrics."""
        from .parallel.distributed import put_global
        outs = [self._unplace(o) for o in outs]
        logits = None if logits is None else self._unplace(logits)
        aux_losses = [self._unplace(a) for a in aux_losses]
        rows = outs[0].shape[0]
        if label is not None and label.shape[0] != rows:
            t = self.program.output_tensors[0]
            spec = self.strategy.output_sharding(t.owner_layer.name,
                                                 t.owner_idx) \
                if t.owner_layer is not None else None
            from .parallel.strategy import spec_placements
            dm = self.strategy.dmesh
            pl = spec_placements(spec[:1] if spec else None, dm,
                                 len(label.shape))
            label = self._unplace(put_global(
                label, dm.mesh, pl, device=self.device,
                global_shape=(rows, *label.shape[1:])))
        return outs, logits, label, aux_losses

    def _refuse_multi_device_options(self) -> None:
        """A per-parameter ZeRO plan (``zero_policy`` auto / memory / all)
        needs the ZeRO planner, ``search/zero_plan.py``: an error, not a
        silent replicated state."""
        policy = str(getattr(self.config, "zero_policy", "off")).lower()
        if policy in ("auto", "memory", "all") and not getattr(
                self.config, "shard_optimizer_states", False):
            raise NotImplementedError(
                f"zero_policy={policy!r} needs the ZeRO planner "
                f"(search/zero_plan.py), not ported yet (ROADMAP queue 1 "
                f"item 5); --zero shards every moment")

    def _backward(self, params, state, batch, step: int, hook=None,
                  local_rows: Optional[Tuple[int, int]] = None):
        """Forward and ``torch.autograd.grad`` of the mean loss with
        respect to every parameter leaf. ``hook(i)`` (when given) makes
        the hook registered on leaf ``i`` before backward. Returns
        ``(names, leaves, gs, new_state, detached batch metrics)``, ``gs``
        None where a leaf is unused."""
        names = [(ln, wn) for ln, wn, _ in tree_leaves(params)]
        leaves = [t.detach().requires_grad_(True)
                  for _, _, t in tree_leaves(params)]
        if hook is not None:
            for i, t in enumerate(leaves):
                t.register_hook(hook(i))
        live: Dict[str, Dict[str, torch.Tensor]] = {}
        for (ln, wn), t in zip(names, leaves):
            live.setdefault(ln, {})[wn] = t
        with torch.enable_grad():
            outs, new_state, aux, logits = self._forward(
                live, state, batch, True, step, local_rows=local_rows)
            loss, bm = self._loss_and_metrics(outs, logits, batch["label"],
                                              aux,
                                              local=local_rows is not None)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return names, leaves, gs, new_state, \
            {k: v.detach() for k, v in bm.items()}

    def _grads(self, params, state, batch, step: int):
        """Gradients of the mean loss with respect to every parameter
        leaf, by ``torch.autograd.grad``; unused leaves get zeros. Over a
        world each is reduced to its leaf's layout. Returns (grads,
        new_state, detached batch metrics)."""
        if self.pipe is not None:
            return self._pipe_grads(params, state, batch, step)
        names, leaves, gs, new_state, bm = self._backward(params, state,
                                                          batch, step)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (ln, wn), t, g in zip(names, leaves, gs):
            if g is None:
                g = torch.zeros_like(t)
            elif self.strategy is not None \
                    and list(g.placements) != list(t.placements):
                # a partial sum (a replicated leaf's, over the data-
                # parallel axes) reduced to the leaf's own layout
                g = g.redistribute(t.device_mesh, t.placements)
            grads.setdefault(ln, {})[wn] = g
        return grads, new_state, bm

    def _local_grads(self, params, state, batch, step: int,
                     local_rows: Tuple[int, int]):
        """One rank's gradients on its own rows (``local_rows`` = (global
        batch, first row)) with local (plain) weights, unreduced: the
        quantized sync's backward. Returns (grads, detached local batch
        metrics)."""
        st = self.program.strategy
        self.program.strategy = None
        try:
            names, leaves, gs, _, bm = self._backward(
                params, _local_tree(state), batch, step,
                local_rows=local_rows)
        finally:
            self.program.strategy = st
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (ln, wn), t, g in zip(names, leaves, gs):
            grads.setdefault(ln, {})[wn] = torch.zeros_like(t) \
                if g is None else g
        return grads, bm

    # ------------------------------------------------------------------
    # the update over a world: ZeRO blocks, serial and bucketed sync
    # ------------------------------------------------------------------
    def _zero_layout_map(self, params, opt_state) -> Dict[tuple, Any]:
        """(layer, weight) -> ZeroLeaf of every ZeRO-sharded leaf (its
        first moment laid out other than its weight), computed once."""
        if self._zero_layouts is None:
            from .runtime.zero import ZeroLeaf
            out = {}
            slots = [s for s in (opt_state or {})
                     if isinstance(opt_state[s], dict)]
            if self.opt_state_constraints is not None and slots:
                slot = opt_state[slots[0]]
                for ln, wn, w in tree_leaves(params):
                    m = slot.get(ln, {}).get(wn)
                    if m is not None and tuple(m.placements) != tuple(
                            w.placements):
                        out[(ln, wn)] = ZeroLeaf(w, m)
            self._zero_layouts = out
        return self._zero_layouts

    def _sync_serial(self, params, names, raw, placements, zl):
        """Each leaf's gradient in its update layout from its local
        partial sum ``raw[i]`` (None: unused) laid out as
        ``placements[i]``: reduced to the leaf's layout (DTensor's
        redistribute, one collective a leaf), or under ZeRO
        reduce-scattered to this rank's block, one flat collective for
        the leaves of the same mesh dims (in runs of at most
        ``ZERO_CHUNK_BYTES``). ``raw`` is consumed."""
        from torch.distributed.tensor import Partial
        from .parallel.distributed import SYNC_STATS, mesh_group
        from .parallel.local_ops import from_local
        from .runtime.zero import chunks, reduce_scatter_blocks
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        scatter: Dict[tuple, List[int]] = {}
        for i, (ln, wn) in enumerate(names):
            w = params[ln][wn]
            wp, z = tuple(w.placements), zl.get((ln, wn))
            local = raw[i]
            if local is None:
                local = torch.zeros_like(w.to_local())
                gp = wp
            else:
                gp = tuple(placements[i])
            if z is not None and all(
                    isinstance(gp[d], Partial) for d in z.mesh_dims) and all(
                    gp[d] == wp[d] for d in range(len(wp))
                    if d not in z.mesh_dims):
                scatter.setdefault(z.mesh_dims, []).append(i)
                continue
            if gp != wp:
                SYNC_STATS.add(local)
                local = from_local(local, w.device_mesh, gp, w.shape) \
                    .redistribute(w.device_mesh, w.placements).to_local()
            grads.setdefault(ln, {})[wn] = local if z is None \
                else z.own(local).contiguous()
        mesh = self.strategy.dmesh.mesh
        for dims, idx in scatter.items():
            group = mesh_group(mesh, dims)[0]
            for part in chunks(idx, lambda i: raw[i].numel()
                               * raw[i].element_size()):
                _, blocks = reduce_scatter_blocks(
                    [raw[i] for i in part], [zl[names[i]] for i in part],
                    group)
                for i, blk in zip(part, blocks):
                    grads.setdefault(names[i][0], {})[names[i][1]] = blk
                    raw[i] = None   # the partial sum is spent
        return grads

    def _zero_update(self, params, grads, opt_state, step: int, update,
                     keys=None) -> None:
        """The update of the leaves ``keys`` (all by default) on each
        rank's blocks, in place: ``grads`` holds each leaf's gradient in
        its update layout (whole, or the rank's ZeRO block); each ZeRO
        leaf's weight block is updated in a flat buffer (made for the
        update, so no copy of the blocks outlives it), then one all-gather
        per mesh-dim group (in runs of at most ``ZERO_CHUNK_BYTES``
        gathered) writes the weights back whole."""
        from .parallel.distributed import mesh_group
        from .runtime.zero import block_buffer, chunks, gather_blocks
        zl = self._zero_layout_map(params, opt_state)
        keys = [(ln, wn) for ln, wn, _ in tree_leaves(params)] \
            if keys is None else list(keys)
        ps: Dict[str, Dict[str, torch.Tensor]] = {}
        gs: Dict[str, Dict[str, torch.Tensor]] = {}
        groups: Dict[tuple, List[tuple]] = {}
        for ln, wn in keys:
            gs.setdefault(ln, {})[wn] = grads[ln][wn]
            z = zl.get((ln, wn))
            if z is None:
                ps.setdefault(ln, {})[wn] = params[ln][wn].to_local()
            else:
                groups.setdefault(z.mesh_dims, []).append((ln, wn))
        held = []
        runs = [(dims, part) for dims, ks in groups.items()
                for part in chunks(ks, lambda k: zl[k].numel * zl[k].size
                                   * params[k[0]][k[1]].element_size())]
        for dims, ks in runs:
            flat, views = block_buffer([zl[k] for k in ks],
                                       params[ks[0][0]][ks[0][1]].to_local())
            for (ln, wn), v in zip(ks, views):
                v.copy_(zl[(ln, wn)].own(params[ln][wn].to_local()))
                ps.setdefault(ln, {})[wn] = v
            held.append((dims, ks, flat))
        state = {slot: {ln: {wn: layers[ln][wn].to_local()
                             for wn in gs[ln]} for ln in gs}
                 for slot, layers in opt_state.items()}
        update(ps, gs, state, step)
        mesh = self.strategy.dmesh.mesh
        for dims, ks, flat in held:
            _, finish = gather_blocks(
                flat, [zl[k] for k in ks],
                [params[ln][wn].to_local() for ln, wn in ks],
                mesh_group(mesh, dims)[0])
            finish()

    def _bucketed_sync(self, params, opt_state):
        """The overlap schedule's runtime over this world, built once."""
        if self._bucketed is None:
            from .runtime.overlap import BucketedSync, bucket_names
            zl = self._zero_layout_map(params, opt_state)
            keys = [(ln, wn) for ln, wn, _ in tree_leaves(params)]
            pos = {k: i for i, k in enumerate(keys)}
            buckets = [[pos[(ln, wn)] for ln in names
                        for wn in params[ln]]
                       for names in bucket_names(self._overlap_schedule,
                                                 params)]
            self._bucketed = BucketedSync(
                [(ln, wn, params[ln][wn], zl.get((ln, wn)))
                 for ln, wn in keys], buckets, self.strategy.dmesh.mesh,
                self._overlap_schedule.zero_prefetch)
        return self._bucketed

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

        def micro_batches(batch):
            if accum <= 1:
                return [batch]
            n = next(iter(batch.values())).shape[0]
            if n % accum != 0:
                raise ValueError(
                    f"batch dim {n} not divisible into {accum} "
                    f"accumulation micro-batches")
            mbn = n // accum
            return [{k: v[i * mbn:(i + 1) * mbn] for k, v in batch.items()}
                    for i in range(accum)]

        def updater():
            if self._kernel_impls.get("opt_update") == "fused":
                from .runtime.optimizers import fused_adam_tree_update
                return functools.partial(fused_adam_tree_update,
                                         self.optimizer)
            return self.optimizer.update

        def one_device(params, opt_state, state, step, batch):
            grads, bms = None, []
            for i, mb in enumerate(micro_batches(batch)):
                g, state, bm_i = self._grads(params, state, mb,
                                             step * accum + i
                                             if accum > 1 else step)
                bms.append(bm_i)
                if grads is None:
                    grads = g
                else:
                    for ln, wn, t in tree_leaves(grads):
                        t.add_(g[ln][wn])
            if accum > 1:
                # mean losses => mean of micro grads == full-batch grad
                for _, _, t in tree_leaves(grads):
                    t.div_(accum)
            if self._overlap_schedule is not None:
                from .runtime.overlap import overlapped_update
                overlapped_update(updater(), params, grads, opt_state,
                                  step + 1, self._overlap_schedule)
            else:
                updater()(params, grads, opt_state, step + 1)
            return state, bms

        def world(params, opt_state, state, step, batch):
            """The step over a world: backward per micro-batch (each
            rank's local partial sums added up), then the serial sync or
            the bucketed one, then the update on each rank's blocks."""
            zl = self._zero_layout_map(params, opt_state)
            bucketed = self._bucketed_sync(params, opt_state) \
                if self._overlap_schedule is not None else None
            mbs = micro_batches(batch)
            acc: Optional[List[Optional[torch.Tensor]]] = None
            bms = []
            self.program.micro_batches = len(mbs)
            try:
                for i, mb in enumerate(mbs):
                    hook = None
                    if bucketed is not None and i == len(mbs) - 1:
                        bucketed.begin(params, acc)
                        hook = bucketed.hook
                    names, _, gs, state, bm_i = self._backward(
                        params, state, mb,
                        step * accum + i if accum > 1 else step, hook=hook)
                    bms.append(bm_i)
                    if hook is not None:
                        del gs
                        bucketed.finish()
                        break
                    locs = [None if g is None else g.to_local() for g in gs]
                    placements = [None if g is None else g.placements
                                  for g in gs]
                    del gs
                    acc = locs if acc is None else [
                        b if a is None else a if b is None else a + b
                        for a, b in zip(acc, locs)]
                    del locs
            finally:
                self.program.micro_batches = 1
            if bucketed is not None:
                bucketed.drain(updater(), opt_state, step + 1, accum)
                return state, bms
            grads = self._sync_serial(params, names, acc, placements, zl)
            if accum > 1:
                for _, _, t in tree_leaves(grads):
                    t.div_(accum)
            self._zero_update(params, grads, opt_state, step + 1, updater())
            return state, bms

        def quantized(params, opt_state, state, step, batch):
            """The quantized sync (accumulation is ineligible): synced
            local gradients, then the update, bucket by bucket under the
            overlap schedule."""
            from .ops import quantized_collectives as qsync_mod
            residual, opt_state = qsync_mod.strip_residual(opt_state)
            grads, bm = qsync_mod.sharded_grads(self, params, state, batch,
                                                step, residual)
            zl = self._zero_layout_map(params, opt_state)
            for (ln, wn), z in zl.items():
                grads[ln][wn] = z.own(grads[ln][wn]).contiguous()
            if self._overlap_schedule is None:
                self._zero_update(params, grads, opt_state, step + 1,
                                  updater())
            else:
                from .runtime.overlap import bucket_names
                for names in bucket_names(self._overlap_schedule, params):
                    self._zero_update(params, grads, opt_state, step + 1,
                                      updater(),
                                      keys=[(ln, wn) for ln in names
                                            for wn in params[ln]])
            return state, [bm]

        def pipelined(params, opt_state, state, step, batch):
            """The pipeline's step: the schedule's forward and backward
            (``_pipe_grads``), then the update of this rank's leaves."""
            grads, state, bm = self._pipe_grads(params, state, batch, step)
            local = {ln: {wn: g.to_local() for wn, g in ws.items()}
                     for ln, ws in grads.items()}
            del grads
            self._zero_update(params, local, opt_state, step + 1, updater())
            return state, [bm]

        if self.pipe is not None and accum > 1:
            raise ValueError(
                "--gradient-accumulation-steps does not compose with a "
                "pipeline region: its microbatches split the batch "
                "already (--pipeline-microbatches)")

        def step_fn(params, opt_state, state, step, batch):
            step = int(step)
            if self.pipe is not None:
                state, bms = pipelined(params, opt_state, state, step,
                                       batch)
            elif self.strategy is None:
                state, bms = one_device(params, opt_state, state, step,
                                        batch)
            elif self._qsync is not None:
                state, bms = quantized(params, opt_state, state, step,
                                       batch)
            else:
                state, bms = world(params, opt_state, state, step, batch)
            bm = bms[0] if len(bms) == 1 else \
                {k: reduce_metric(k, [b[k] for b in bms]) for k in bms[0]}
            # the loss-only NaN screen flag, checked by the host at
            # MetricsBuffer flushes instead of reading the loss each step
            bm["all_finite"] = torch.isfinite(bm["loss"]).all()
            return params, opt_state, state, bm

        self._train_step = _instrument_step(step_fn, "train")
        return self._train_step

    def make_eval_step(self):
        """``step_fn(params, state, batch) -> (output, metrics)`` under
        ``torch.inference_mode()``. Cached."""
        if self._eval_step is not None:
            return self._eval_step

        def step_fn(params, state, batch):
            with self._no_grad():
                outs, _, aux, logits = self._forward(params, state, batch,
                                                     False)
                _, bm = self._loss_and_metrics(outs, logits,
                                               batch["label"], aux)
            return self._unplace(outs[0]), bm

        self._eval_step = _instrument_step(step_fn, "eval")
        return self._eval_step

    def make_forward(self):
        """Inference-only forward (no label): ``fwd(params, state, batch)``
        runs the graph under ``torch.inference_mode()`` and returns the
        output tensor (a list when the graph has several). Over a live
        mesh the batch is whole, whatever its rows (a serving bucket's),
        and so is the output on every rank. Cached."""
        if self._forward_fn is not None:
            return self._forward_fn

        def fwd(params, state, batch):
            with self._no_grad():
                outs, _, _, _ = self._forward(params, state, batch, False,
                                              capture=False, whole=True)
                outs = [self._unplace(o) for o in outs]
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
        if mode == "decode":
            ctx.row_chunk = DECODE_ROW_CHUNK
        return ctx

    def scored_forward(self, params, state, batch):
        """Forward returning log-domain next-token scores (B, L, V), under
        ``torch.inference_mode()`` (``torch.no_grad()`` over a live mesh,
        where the batch is whole and the scores come back whole on every
        rank)."""
        with self._no_grad():
            outs, _, _, logits = self._forward(params, state, batch, False,
                                               whole=True)
            return self._unplace(self._scores(outs, logits))

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
        would cost a (B, L, V) pass each, so they are not run.

        Over a live mesh (``torch.no_grad()``) the batch is the whole
        global one, the layers run under the strategy's placements, and
        the cache is each rank's own block: its rows over the batch's
        mesh dims, its kv heads over the head dims."""
        ctx = self._kv_ctx("prefill", state)
        ctx.kv_prefill_len = prefill_len
        if self.strategy is not None:
            names = {t.name for t in self.program.input_tensors}
            self._row_split(next(int(v.shape[0]) for k, v in batch.items()
                                 if k in names))
        with self._no_grad():
            env = self.program.init_env(batch, self.device, whole=True)
            self.program.emit_layers(self._kv_layers(), env, params, ctx)
        if not ctx.new_kv:
            raise ValueError("graph has no multihead-attention layers to "
                             "cache (KV decode unsupported)")
        return ctx.new_kv

    def _row_layout(self):
        """Over the live mesh, how the graph inputs' rows lie: their
        placements on the batch dim alone (every row input must be laid
        out alike), and the count of blocks the mesh dims that shard it
        cut a batch into (1 where none does)."""
        from torch.distributed.tensor import Replicate, Shard
        from .parallel.strategy import spec_placements
        st = self.strategy
        mesh = st.dmesh.mesh
        split = [Replicate()] * mesh.ndim
        seen = None
        for t in self.program.input_tensors:
            if t.get_tensor() is not None:
                continue
            pl = [p if isinstance(p, Shard) and p.dim % len(t.shape) == 0
                  else Replicate() for p in spec_placements(
                      st.input_sharding(t.name), st.dmesh, len(t.shape))]
            if seen is not None and pl != split:
                raise ValueError(
                    f"the graph inputs' rows are laid out unlike each "
                    f"other ({seen}: {split}, {t.name}: {pl})")
            split, seen = pl, t.name
        n = 1
        for m, p in enumerate(split):
            if isinstance(p, Shard):
                n *= mesh.size(m)
        return split, n

    def row_blocks(self) -> int:
        """The count of blocks a batch's rows split into over the live
        mesh (the data-parallel degree of the inputs); 1 on one device.
        A batch that generation or serving runs over the world has a
        multiple of it rows (``InferenceSession`` pads to one)."""
        return 1 if self.strategy is None else self._row_layout()[1]

    def _row_split(self, rows: int) -> Tuple[int, int, int]:
        """``(n, lo, hi)``: the row blocks of a batch of ``rows`` rows
        (``row_blocks``) and this rank's rows [lo, hi) of it."""
        from .parallel.distributed import shard_bounds
        split, n = self._row_layout()
        if rows % n:
            raise ValueError(
                f"a batch of {rows} rows does not split into the "
                f"strategy's {n} data-parallel blocks of rows: pad it to "
                f"a multiple of {n} (InferenceSession does)")
        (lo, hi), = shard_bounds((rows,), self.strategy.dmesh.mesh, split)
        return n, lo, hi

    def kv_gather(self, cache, src: torch.Tensor, rows_before: int):
        """The cache with its rows picked by ``src`` (B',), row indices
        into the batch of ``rows_before`` rows it holds (beam search's
        reorder). Over a live mesh each rank picks its own rows of the
        new batch from its own block of the old one, which holds them
        when every picked row lies in the rank's block: beam search keeps
        each prompt's beams together, so a batch that splits over the
        ranks into whole prompts keeps them on their rank."""
        if self.strategy is not None:
            _, lo, hi = self._row_split(int(src.shape[0]))
            _, old_lo, _ = self._row_split(rows_before)
            src = src[lo:hi] - old_lo
        return {n: {k: t.index_select(0, src) for k, t in c.items()}
                for n, c in cache.items()}

    def kv_decode_step(self, params, state, batch, cache, index):
        """One-token forward (inputs (B, 1)) against the KV cache at query
        position ``index`` (an int, or a (B,) tensor for ragged prompts),
        under ``torch.inference_mode()``. The attention layers write this
        position's K/V into ``cache``'s buffers in place. Returns
        (scores_row (B, V), new_cache); cache layers that did not run
        keep their buffers.

        The step pads its inputs once with zero rows to a multiple of
        ``EmitCtx.row_chunk`` (``DECODE_ROW_CHUNK``), and every product
        and norm runs on blocks of that many rows, so a row's scores do
        not depend on the rows that share its batch: the premise of the
        continuous batcher's per-sequence contract. The attention layers
        cut to the real rows around the cache; the graph's other ops work
        row by row. A context with ``row_chunk`` 0 runs the batch's own
        rows.

        Over a live mesh (``torch.no_grad()``) the batch and ``index`` are
        whole and the cache is each rank's block (``kv_prefill``); the
        padding goes into each rank's block of rows, so a rank with 4 of
        8 rows runs its 4 in blocks of the chunk, as one card runs them.
        ``EmitCtx.kv_rows`` and a ragged ``kv_index`` are the rank's. The
        scores come back whole on every rank."""
        ctx = self._kv_ctx("decode", state)
        ctx.kv_cache = cache
        ctx.kv_index = index
        with self._no_grad():
            if self.strategy is None:
                env = self.program.init_env(batch, self.device)
                rows = next(iter(cache.values()))["k"].shape[0]
                if ctx.row_chunk:
                    ctx.kv_rows = rows
                    padded = -(-rows // ctx.row_chunk) * ctx.row_chunk
                    for t in self.program.input_tensors:
                        x = env[t.guid]
                        if t.name in batch and x.shape[0] == rows:
                            env[t.guid] = pad_rows(x, padded)
                real_rows = lambda x: x[:rows]  # noqa: E731
            else:
                env, real_rows = self._world_decode_env(batch, ctx)
            logits = self.program.emit_layers(self.program.layers, env,
                                              params, ctx,
                                              self._logits_guid())
            outs = [env[t.guid] for t in self.program.output_tensors]
            scores = real_rows(self._scores(outs, logits))
        new_cache = dict(cache)
        new_cache.update(ctx.new_kv)
        return scores[:, 0, :], new_cache

    def _world_decode_env(self, batch, ctx):
        """The decode step's graph inputs over the live mesh: each rank's
        block of the batch's rows padded to the row chunk, the stream a
        global batch of those blocks (``EmitCtx.kv_rows`` and a ragged
        ``kv_index`` cut to the rank's rows); and what takes the
        stream's scores whole and back to the batch's rows."""
        names = {t.name for t in self.program.input_tensors}
        rows = next(int(v.shape[0]) for k, v in batch.items() if k in names)
        n, lo, hi = self._row_split(rows)
        real = hi - lo
        chunk = ctx.row_chunk
        block = -(-real // chunk) * chunk if chunk else real
        if chunk:
            ctx.kv_rows = real
        idx = ctx.kv_index
        if torch.is_tensor(idx) and idx.dim() == 1:
            ctx.kv_index = idx[lo:hi]
        padded = {}
        for k, x in batch.items():
            x = _as_tensor(x, self.device)
            if block != real and x.shape[0] == rows:
                tail = tuple(x.shape[1:])
                buf = x.new_zeros((n, block) + tail)
                buf[:, :real] = x.reshape((n, real) + tail)
                x = buf.reshape((n * block,) + tail)
            padded[k] = x

        def real_rows(scores):
            scores = self._unplace(scores)
            tail = tuple(scores.shape[1:])
            return scores.reshape((n, block) + tail)[:, :real].reshape(
                (rows,) + tail)
        return self.program.init_env(padded, self.device, whole=True), \
            real_rows
