"""FFModel: the model-building API and compile, on one device.

The port of ``flexflow_tpu/model.py`` on one device: the layer builders
BERT uses (same names, params and auto-naming as the JAX package, so the
two graphs of one model line up layer for layer), ``compile`` without
search or mesh (parameters and optimizer state materialized), the forced
path of the kernel tier, and the training loop (``fit``, ``eval``, the
phase-API no-ops). The other builders, the strategy search, generation,
and fit's fault hooks, callbacks, telemetry and checkpoint saves come
with later slices.

The model runs on ``config.device`` ("cuda" by default) unless the
caller passes ``device``; asking for CUDA where there is none raises.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import FFConfig
from .core.layer import Layer
from .core.tensor import Tensor
from .executor import Executor, GraphProgram
from .ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType,
                      MetricsType, OperatorType)
from .kernels import registry as kreg
from .ops import get_op_def
from .runtime.dataloader import SingleDataLoader
from .runtime.metrics import PerfMetrics
from .runtime.metrics_buffer import MetricsBuffer
from .runtime.optimizers import AdamOptimizer, Optimizer, SGDOptimizer

_LOSS_NAMES = {
    "categorical_crossentropy": LossType.LOSS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "identity": LossType.LOSS_IDENTITY,
}

_METRIC_NAMES = {
    "accuracy": MetricsType.METRICS_ACCURACY,
    "categorical_crossentropy": MetricsType.METRICS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.METRICS_MEAN_ABSOLUTE_ERROR,
}


def resolve_device(device) -> torch.device:
    """``torch.device`` for "cuda"/"cpu"; raises when CUDA is asked for
    and absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None, device=None):
        self.config = config or FFConfig()
        self.device = resolve_device(device or self.config.device)
        self.layers: List[Layer] = []
        self.input_tensors: List[Tensor] = []
        self.graph_inputs: List[Tensor] = []
        self.const_inputs: List[Tensor] = []
        self.optimizer: Optional[Optimizer] = None
        self.loss_type: Optional[LossType] = None
        self.metrics: List[MetricsType] = []
        self.label_tensor: Optional[Tensor] = None
        self.executor: Optional[Executor] = None
        self.params = None
        self.state = None
        self.opt_state = None
        self._output_tensor: Optional[Tensor] = None
        self._step = 0
        self._dataloaders: List[Any] = []
        self._current_metrics: Dict[str, float] = {}

    # ==================================================================
    # graph construction helpers
    # ==================================================================
    def _add_layer(self, op_type: OperatorType, inputs: Sequence[Tensor],
                   params: Dict[str, Any], name: Optional[str] = None
                   ) -> Layer:
        if name is None:
            # per-model naming by layer index, as in the JAX package
            name = f"{OperatorType(op_type).name.lower()}_{len(self.layers)}"
        used = {l.name for l in self.layers}
        base, k = name, 1
        while name in used:
            name = f"{base}_{k}"
            k += 1
        layer = Layer(op_type, name, list(inputs), params)
        op = get_op_def(op_type)
        in_shapes = [t.shape for t in inputs]
        in_dtypes = [t.dtype for t in inputs]
        for i, (shape, dt) in enumerate(op.infer(layer.params, in_shapes,
                                                 in_dtypes)):
            layer.outputs.append(Tensor(shape, dt, layer, i,
                                        name=f"{layer.name}:out{i}"))
        layer.weights = op.weights(layer.params, in_shapes, in_dtypes)
        self.layers.append(layer)
        return layer

    def _unary(self, op_type: OperatorType, x: Tensor, name=None, **params
               ) -> Tensor:
        return self._add_layer(op_type, [x], params, name).outputs[0]

    def _binary(self, op_type: OperatorType, a: Tensor, b: Tensor, name=None
                ) -> Tensor:
        return self._add_layer(op_type, [a, b], {}, name).outputs[0]

    def create_tensor(self, dims: Sequence[int],
                      dtype: DataType = DataType.DT_FLOAT,
                      create_grad: bool = True, name: Optional[str] = None
                      ) -> Tensor:
        t = Tensor(dims, dtype, None, 0, name=name, create_grad=create_grad)
        self.input_tensors.append(t)
        return t

    # ==================================================================
    # layer builders
    # ==================================================================
    def dense(self, input: Tensor, out_dim: int,
              activation: ActiMode = ActiMode.AC_MODE_NONE,
              use_bias: bool = True,
              datatype: Optional[DataType] = None,
              kernel_initializer=None, bias_initializer=None,
              kernel_regularizer=None, name: Optional[str] = None) -> Tensor:
        params = {"out_dim": out_dim, "activation": ActiMode(activation),
                  "use_bias": use_bias}
        if datatype is not None:
            params["dtype"] = DataType(datatype)
        if kernel_initializer is not None:
            params["kernel_initializer"] = kernel_initializer
        return self._add_layer(OperatorType.OP_LINEAR, [input], params,
                               name).outputs[0]

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.AGGR_MODE_NONE,
                  dtype: DataType = DataType.DT_FLOAT,
                  shared_op=None, kernel_initializer=None,
                  name: Optional[str] = None) -> Tensor:
        params = {"num_entries": num_entries, "out_dim": out_dim,
                  "aggr": AggrMode(aggr), "dtype": DataType(dtype)}
        if kernel_initializer is not None:
            params["kernel_initializer"] = kernel_initializer
        return self._add_layer(OperatorType.OP_EMBEDDING, [input], params,
                               name).outputs[0]

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int,
                            kdim: int = 0, vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, add_bias_kv: bool = False,
                            add_zero_attn: bool = False, causal: bool = False,
                            num_kv_heads: int = 0,
                            kernel_initializer=None,
                            name: Optional[str] = None) -> Tensor:
        params = {"embed_dim": embed_dim, "num_heads": num_heads,
                  "kdim": kdim, "vdim": vdim, "dropout": dropout,
                  "bias": bias, "add_bias_kv": add_bias_kv,
                  "add_zero_attn": add_zero_attn, "causal": causal}
        if num_kv_heads and num_kv_heads != num_heads:
            # grouped-query attention: k/v projections carry kv heads
            if num_heads % num_kv_heads != 0:
                raise ValueError(
                    f"num_kv_heads {num_kv_heads} must divide "
                    f"num_heads {num_heads}")
            params["num_kv_heads"] = int(num_kv_heads)
        return self._add_layer(OperatorType.OP_MULTIHEAD_ATTENTION,
                               [query, key, value], params, name).outputs[0]

    def layer_norm(self, input: Tensor, axes: Sequence[int],
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_LAYERNORM, input, name,
                           axes=list(axes),
                           elementwise_affine=elementwise_affine, eps=eps)

    def softmax(self, input: Tensor, axis: int = -1,
                name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_SOFTMAX, input, name, axis=axis)

    def dropout(self, input: Tensor, rate: float = 0.5, seed: int = 0,
                name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_DROPOUT, input, name, rate=rate,
                           seed=seed)

    def reshape(self, input: Tensor, shape: Sequence[int],
                name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_RESHAPE, input, name,
                           shape=list(shape))

    def add(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_ADD, x, y, name)

    def slice_tensor(self, x: Tensor, starts: Sequence[int],
                     ends: Sequence[int], axes: Optional[Sequence[int]] = None,
                     name=None):
        return self._unary(OperatorType.OP_SLICE, x, name,
                           starts=list(starts), ends=list(ends),
                           axes=list(axes) if axes is not None else
                           list(range(len(starts))))

    # ==================================================================
    # compile
    # ==================================================================
    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: Union[LossType, str, None] = None,
                metrics: Optional[Sequence[Union[MetricsType, str]]] = None,
                comp_mode: CompMode = CompMode.COMP_MODE_TRAINING,
                output_tensor: Optional[Tensor] = None):
        """Lower the graph to an executor on ``self.device``, adopt the
        forced kernel impls, and materialize the parameters and the
        optimizer state. One device, data-parallel by construction: a
        search budget is refused rather than ignored."""
        if self.config.search_budget > 0 \
                and not self.config.only_data_parallel:
            raise NotImplementedError(
                "the strategy search is not ported yet; compile with "
                "only_data_parallel or no search budget")
        if optimizer is not None:
            self.optimizer = optimizer
        if self.optimizer is None:
            self.optimizer = SGDOptimizer(lr=self.config.learning_rate)
        if isinstance(loss_type, str):
            loss_type = _LOSS_NAMES[loss_type.lower()]
        self.loss_type = LossType(loss_type) if loss_type is not None \
            else LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
        self.metrics = [
            _METRIC_NAMES[m.lower()] if isinstance(m, str) else MetricsType(m)
            for m in (metrics or [])]
        self._output_tensor = output_tensor or self.layers[-1].outputs[0]

        # created tensors split into graph inputs (consumed by a layer),
        # attached constants, and the label tensor (created, unconsumed)
        consumed = {t.guid for l in self.layers for t in l.inputs}
        self.graph_inputs = [t for t in self.input_tensors
                             if t.guid in consumed
                             and t.get_tensor() is None]
        self.const_inputs = [t for t in self.input_tensors
                             if t.guid in consumed
                             and t.get_tensor() is not None]
        unconsumed = [t for t in self.input_tensors
                      if t.guid not in consumed
                      and t.get_tensor() is None]
        if self.label_tensor is None and len(unconsumed) == 1:
            self.label_tensor = unconsumed[0]

        program = GraphProgram(self.layers,
                               self.graph_inputs + self.const_inputs,
                               [self._output_tensor])
        self.executor = Executor(program, self.config, self.device,
                                 self.optimizer, self.loss_type,
                                 self.metrics, seed=self.config.seed)
        self._plan_kernels()
        self.params, self.state = self.executor.init_params_and_state()
        self.opt_state = self.optimizer.init_state(self.params)

    def _plan_kernels(self):
        """Adopt the forced per-op kernel impls (``kernel_impls``,
        ``--kernel-impl``, ``FF_KERNEL_IMPL``, the deprecated
        ``use_flash_attention`` shim), each predicate-checked: a forced
        impl that cannot run on these shapes is a compile-time error
        naming the layer. Without forcing, the defaults stand (the
        searched choice comes with the search)."""
        cfg = self.config
        policy = str(getattr(cfg, "kernel_impls", "auto") or "auto").lower()
        if policy in ("off", "none"):
            return
        forced = kreg.resolve_forced(cfg)
        if not forced:
            return
        backend = self.device.type
        plan: Dict[str, str] = {}
        f_attn = forced.get(kreg.ATTENTION)
        if f_attn is not None:
            for layer in self.executor.program.layers:
                if layer.op_type != OperatorType.OP_MULTIHEAD_ATTENTION:
                    continue
                q_len = int(layer.inputs[0].shape[1])
                kv_len = int(layer.inputs[1].shape[1])
                ctx = kreg.attention_ctx(layer.params, q_len, kv_len,
                                         backend=backend)
                reason = kreg.get_impl(kreg.ATTENTION, f_attn).available(ctx)
                if reason is not None:
                    raise ValueError(
                        f"{layer.name}: forced kernel impl "
                        f"attention:{f_attn} is not available on this "
                        f"device/shapes: {reason}")
                plan[layer.name] = f_attn
        f_opt = forced.get(kreg.OPT_UPDATE)
        if f_opt is not None:
            opt_kind = "adam" if isinstance(self.optimizer, AdamOptimizer) \
                else type(self.optimizer).__name__.lower()
            reason = kreg.get_impl(kreg.OPT_UPDATE, f_opt).available(
                {"backend": backend, "optimizer": opt_kind})
            if reason is not None:
                raise ValueError(
                    f"forced kernel impl opt_update:{f_opt} is not "
                    f"available here: {reason}")
            if f_opt != kreg.DEFAULT_IMPLS[kreg.OPT_UPDATE]:
                plan[kreg.OPT_UPDATE] = f_opt
        if cfg.profiling:
            logging.getLogger("flexflow_tpu_torch").info(
                "kernel plan (%s): %s", policy, plan)
        self.executor._kernel_impls = plan

    # ==================================================================
    # training loop
    # ==================================================================
    def create_data_loader(self, tensor: Tensor, data: np.ndarray):
        """Reference ``FFModel.create_data_loader`` parity: registers the
        full array for one tensor; fit() takes batches from it."""
        data = np.ascontiguousarray(data)
        self._dataloaders.append((tensor, data))
        return (tensor, data)

    def _combined_loader(self, x=None, y=None,
                         batch_size: Optional[int] = None,
                         shuffle: bool = True) -> SingleDataLoader:
        bs = batch_size or self.config.batch_size
        arrays: Dict[str, np.ndarray] = {}
        if x is not None or y is not None:
            xs = x if isinstance(x, (list, tuple)) else [x]
            if len(xs) != len(self.graph_inputs):
                raise ValueError(f"{len(xs)} arrays for "
                                 f"{len(self.graph_inputs)} inputs")
            for t, arr in zip(self.graph_inputs, xs):
                arrays[t.name] = np.ascontiguousarray(arr)
            arrays["label"] = np.ascontiguousarray(y)
        else:
            gi_guids = {t.guid for t in self.graph_inputs}
            for t, arr in self._dataloaders:
                is_label = (t is self.label_tensor
                            or t.guid not in gi_guids)
                arrays["label" if is_label else t.name] = arr
        return SingleDataLoader(arrays, bs, self.device, shuffle=shuffle,
                                seed=self.config.seed,
                                prefetch=self.config.prefetch_batches)

    def _run_train_step(self, step_fn, batch):
        self.params, self.opt_state, self.state, bm = step_fn(
            self.params, self.opt_state, self.state, self._step, batch)
        self._step += 1
        return bm

    def fit(self, x=None, y=None, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, callbacks=None, verbose=True):
        """Training loop (reference ``flexflow_cffi.py:2062-2104``).

        Per-step metrics stay on the device in a :class:`MetricsBuffer`
        and are read back in one copy at ``print_freq`` and at the end of
        each epoch, where the NaN screen runs; a bounded in-flight window
        (``config.async_dispatch_steps``) keeps the host from racing
        ahead. Returns one report per epoch (the metrics, ``epoch_time_s``
        and ``samples_per_sec``)."""
        if self.executor is None:
            raise ValueError("call compile() first")
        if callbacks:
            raise NotImplementedError("fit callbacks are not ported yet")
        epochs = epochs or self.config.epochs
        loader = self._combined_loader(x, y, batch_size)
        history = []
        for epoch in range(epochs):
            step_fn = self.executor.make_train_step()
            pm = PerfMetrics()
            buf = MetricsBuffer.for_config(self.config, pm=pm)
            t0 = time.perf_counter()
            nb = 0
            for batch in loader:
                bm = self._run_train_step(step_fn, batch)
                buf.push(self._step - 1, bm,
                         next(iter(batch.values())).shape[0])
                nb += 1
                pf = self.config.print_freq
                if pf > 0 and nb % pf == 0:
                    # print_freq is the metric-fetch cadence, whether or
                    # not anything is printed
                    buf.flush()
                    if verbose:
                        msg = " ".join(f"{k}={v:.4f}"
                                       for k, v in pm.report().items())
                        print(f"epoch {epoch} iter "
                              f"{nb}/{loader.num_batches} {msg}")
            buf.flush()
            dt = time.perf_counter() - t0
            rep = pm.report()
            rep["epoch_time_s"] = dt
            rep["samples_per_sec"] = pm.train_all / dt if dt > 0 else 0.0
            history.append(rep)
            if verbose:
                msg = " ".join(f"{k}={v:.4f}" for k, v in rep.items())
                print(f"epoch {epoch} done: {msg}")
        self._current_metrics = history[-1] if history else {}
        return history

    # phase-level API parity (forward/backward/update as in model.cc)
    def zero_gradients(self):
        pass  # grads are computed afresh each step

    def backward(self, seq_length: int = -1):
        pass  # part of the train step (torch.autograd.grad)

    def update(self):
        pass  # part of the train step

    def eval(self, x=None, y=None, batch_size: Optional[int] = None,
             verbose: bool = False) -> Dict[str, float]:
        loader = self._combined_loader(x, y, batch_size, shuffle=False)
        step_fn = self.executor.make_eval_step()
        pm = PerfMetrics()
        buf = MetricsBuffer(window=self.config.async_dispatch_steps, pm=pm)
        for batch in loader:
            _, bm = step_fn(self.params, self.state, batch)
            buf.push(0, bm, next(iter(batch.values())).shape[0])
        buf.flush()
        rep = pm.report()
        self._current_metrics = rep
        if verbose:
            print("eval:", rep)
        return rep

    def get_perf_metrics(self):
        return self._current_metrics
