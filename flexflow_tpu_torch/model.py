"""FFModel: the model-building API and compile, on one device.

The port of ``flexflow_tpu/model.py`` on one device: the layer builders
of every model of the zoo (same names, params and auto-naming as the
JAX package, so the two graphs of one model line up layer for layer),
constants (``create_constant``), ``compile`` without search or mesh
(parameters, op state and optimizer state materialized), the forced path
of the kernel tier, the training loop (``fit``, ``eval``, ``forward``,
the phase-API no-ops), generation (``generate`` over a KV cache or by
full re-forwards, greedy or sampled, ragged prompts, eos;
``generate_beam``) and the weight and state accessors. The strategy
search, checkpoints, ``recompile_on_condition``, and the fault hooks,
callbacks and telemetry of ``fit`` come with later slices.

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
from .dtypes import to_torch
from .executor import Executor, GraphProgram
from .ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType,
                      MetricsType, OperatorType, PoolType)
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

    def create_constant(self, dims: Sequence[int], value: float,
                        dtype: DataType = DataType.DT_FLOAT) -> Tensor:
        """A tensor holding ``value`` everywhere, fed to the graph on every
        call (not a parameter). Kept on the host in numpy (f32 for the
        float types numpy lacks) and cast to ``dtype`` as it enters."""
        np_dt = {torch.bool: np.bool_, torch.int8: np.int8,
                 torch.int32: np.int32}.get(to_torch(dtype), np.float32)
        t = self.create_tensor(dims, dtype, create_grad=False)
        t.set_tensor(np.full(tuple(dims), value, dtype=np_dt))
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

    def conv2d(self, input: Tensor, out_channels: int,
               kernel_h: int, kernel_w: int, stride_h: int, stride_w: int,
               padding_h: int, padding_w: int,
               activation: ActiMode = ActiMode.AC_MODE_NONE,
               groups: int = 1, use_bias: bool = True,
               kernel_initializer=None, name: Optional[str] = None) -> Tensor:
        params = {"out_channels": out_channels, "kernel_h": kernel_h,
                  "kernel_w": kernel_w, "stride_h": stride_h,
                  "stride_w": stride_w, "padding_h": padding_h,
                  "padding_w": padding_w, "activation": ActiMode(activation),
                  "groups": groups, "use_bias": use_bias}
        if kernel_initializer is not None:
            params["kernel_initializer"] = kernel_initializer
        return self._add_layer(OperatorType.OP_CONV2D, [input], params,
                               name).outputs[0]

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               pool_type: PoolType = PoolType.POOL_MAX,
               activation: ActiMode = ActiMode.AC_MODE_NONE,
               name: Optional[str] = None) -> Tensor:
        params = {"kernel_h": kernel_h, "kernel_w": kernel_w,
                  "stride_h": stride_h, "stride_w": stride_w,
                  "padding_h": padding_h, "padding_w": padding_w,
                  "pool_type": PoolType(pool_type),
                  "activation": ActiMode(activation)}
        return self._add_layer(OperatorType.OP_POOL2D, [input], params,
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
                            rope: bool = False, rope_theta: float = 10000.0,
                            num_kv_heads: int = 0,
                            sliding_window: int = 0,
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
        if sliding_window:
            # Mistral-family local attention: queries see the last
            # `sliding_window` positions only
            if not causal:
                raise ValueError("sliding_window requires causal "
                                 "attention")
            if sliding_window <= 0:
                raise ValueError(
                    f"sliding_window must be positive, "
                    f"got {sliding_window}")
            params["sliding_window"] = int(sliding_window)
        if rope:
            # rotary embeddings in the op (LLaMA family): the flash and
            # KV-decode paths stay open to RoPE models
            params["rope"] = True
            params["rope_theta"] = float(rope_theta)
        return self._add_layer(OperatorType.OP_MULTIHEAD_ATTENTION,
                               [query, key, value], params, name).outputs[0]

    def batch_norm(self, input: Tensor, relu: bool = True,
                   eps: float = 1e-5, momentum: float = 0.1,
                   name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_BATCHNORM, input, name, relu=relu,
                           eps=eps, momentum=momentum)

    def layer_norm(self, input: Tensor, axes: Sequence[int],
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_LAYERNORM, input, name,
                           axes=list(axes),
                           elementwise_affine=elementwise_affine, eps=eps)

    def rms_norm(self, input: Tensor, eps: float = 1e-6,
                 name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_RMSNORM, input, name, eps=eps)

    def lstm(self, input: Tensor, hidden_size: int, num_layers: int = 1,
             name: Optional[str] = None) -> Tensor:
        """Multi-layer LSTM over (batch, seq, features)
        (``ops/rnn_ops.py``)."""
        return self._unary(OperatorType.OP_LSTM, input, name,
                           hidden_size=hidden_size, num_layers=num_layers)

    def batch_matmul(self, a: Tensor, b: Tensor,
                     a_seq_length_dim: int = -1, b_seq_length_dim: int = -1,
                     name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.OP_BATCHMATMUL, [a, b],
                               {"a_seq_length_dim": a_seq_length_dim,
                                "b_seq_length_dim": b_seq_length_dim},
                               name).outputs[0]

    def softmax(self, input: Tensor, axis: int = -1,
                name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_SOFTMAX, input, name, axis=axis)

    def dropout(self, input: Tensor, rate: float = 0.5, seed: int = 0,
                name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_DROPOUT, input, name, rate=rate,
                           seed=seed)

    def flat(self, input: Tensor, name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_FLAT, input, name)

    def reshape(self, input: Tensor, shape: Sequence[int],
                name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_RESHAPE, input, name,
                           shape=list(shape))

    def concat(self, tensors: Sequence[Tensor], axis: int,
               name: Optional[str] = None) -> Tensor:
        return self._add_layer(OperatorType.OP_CONCAT, list(tensors),
                               {"axis": axis}, name).outputs[0]

    def split(self, input: Tensor, sizes: Union[int, Sequence[int]],
              axis: int, name: Optional[str] = None) -> List[Tensor]:
        if isinstance(sizes, int):
            n = input.shape[axis % len(input.shape)] // sizes
            sizes = [n] * sizes
        return self._add_layer(OperatorType.OP_SPLIT, [input],
                               {"sizes": list(sizes), "axis": axis},
                               name).outputs

    def transpose(self, input: Tensor, perm: Sequence[int],
                  name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_TRANSPOSE, input, name,
                           perm=list(perm))

    def reverse(self, input: Tensor, axis: int,
                name: Optional[str] = None) -> Tensor:
        return self._unary(OperatorType.OP_REVERSE, input, name, axis=axis)

    # ---- elementwise binary ----
    def add(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_ADD, x, y, name)

    def subtract(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_SUB, x, y, name)

    def multiply(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_MUL, x, y, name)

    def divide(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_DIV, x, y, name)

    def max(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_MAX, x, y, name)

    def equal(self, x, y, name=None):
        """Elementwise equality (DT_BOOLEAN output, broadcasting)."""
        return self._binary(OperatorType.OP_EW_EQUAL, x, y, name)

    def greater(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_GREATER, x, y, name)

    def less(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_LESS, x, y, name)

    def min(self, x, y, name=None):
        return self._binary(OperatorType.OP_EW_MIN, x, y, name)

    # ---- elementwise unary ----
    def relu(self, x, name=None):
        return self._unary(OperatorType.OP_RELU, x, name)

    def sigmoid(self, x, name=None):
        return self._unary(OperatorType.OP_SIGMOID, x, name)

    def tanh(self, x, name=None):
        return self._unary(OperatorType.OP_TANH, x, name)

    def elu(self, x, name=None):
        return self._unary(OperatorType.OP_ELU, x, name)

    def gelu(self, x, name=None):
        return self._unary(OperatorType.OP_GELU, x, name)

    def identity(self, x, name=None):
        return self._unary(OperatorType.OP_IDENTITY, x, name)

    def exp(self, x, name=None):
        return self._unary(OperatorType.OP_EXP, x, name)

    def log(self, x, name=None):
        return self._unary(OperatorType.OP_LOG, x, name)

    def sqrt(self, x, name=None):
        return self._unary(OperatorType.OP_SQRT, x, name)

    def rsqrt(self, x, name=None):
        return self._unary(OperatorType.OP_RSQRT, x, name)

    def sin(self, x, name=None):
        return self._unary(OperatorType.OP_SIN, x, name)

    def cos(self, x, name=None):
        return self._unary(OperatorType.OP_COS, x, name)

    def pow(self, x, exponent: float, name=None):
        return self._unary(OperatorType.OP_POW, x, name, scalar=exponent)

    def scalar_multiply(self, x, scalar: float, inplace=False, name=None):
        return self._unary(OperatorType.OP_SCALAR_MULTIPLY, x, name,
                           scalar=scalar)

    def scalar_add(self, x, scalar: float, inplace=False, name=None):
        return self._unary(OperatorType.OP_SCALAR_ADD, x, name, scalar=scalar)

    def scalar_sub(self, x, scalar: float, inplace=False, name=None):
        return self._unary(OperatorType.OP_SCALAR_SUB, x, name, scalar=scalar)

    def scalar_true_divide(self, x, scalar: float, inplace=False, name=None):
        return self._unary(OperatorType.OP_SCALAR_TRUE_DIV, x, name,
                           scalar=scalar)

    def cast(self, x, dtype: DataType, name=None):
        return self._unary(OperatorType.OP_CAST, x, name,
                           dtype=DataType(dtype))

    def mean(self, x, dims: Sequence[int], keepdims: bool = False, name=None):
        return self._unary(OperatorType.OP_MEAN, x, name, axes=list(dims),
                           keepdims=keepdims)

    def reduce_sum(self, x, axes: Sequence[int], keepdims: bool = False,
                   name=None):
        return self._unary(OperatorType.OP_REDUCE_SUM, x, name,
                           axes=list(axes), keepdims=keepdims)

    def slice_tensor(self, x: Tensor, starts: Sequence[int],
                     ends: Sequence[int], axes: Optional[Sequence[int]] = None,
                     name=None):
        return self._unary(OperatorType.OP_SLICE, x, name,
                           starts=list(starts), ends=list(ends),
                           axes=list(axes) if axes is not None else
                           list(range(len(starts))))

    def squeeze(self, x: Tensor, axes: Sequence[int], name=None):
        return self._unary(OperatorType.OP_SQUEEZE, x, name, axes=list(axes))

    def unsqueeze(self, x: Tensor, axes: Sequence[int], name=None):
        return self._unary(OperatorType.OP_UNSQUEEZE, x, name,
                           axes=list(axes))

    def pad(self, x: Tensor, pads: Sequence[Sequence[int]],
            value: float = 0.0, name=None):
        return self._unary(OperatorType.OP_PAD, x, name,
                           pads=[tuple(p) for p in pads], value=value)

    def gather(self, x: Tensor, index: Tensor, dim: int = 0, name=None):
        return self._add_layer(OperatorType.OP_GATHER, [x, index],
                               {"dim": dim}, name).outputs[0]

    def top_k(self, input: Tensor, k: int, sorted: bool = False,
              name: Optional[str] = None) -> List[Tensor]:
        return self._add_layer(OperatorType.OP_TOPK, [input],
                               {"k": k, "sorted": sorted}, name).outputs

    # ---- MoE family (reference src/ops/moe.cc:20-44) ----
    def group_by(self, input: Tensor, assign: Tensor, n: int,
                 alpha: float = 1.0, name: Optional[str] = None
                 ) -> List[Tensor]:
        return self._add_layer(OperatorType.OP_GROUP_BY, [input, assign],
                               {"n": n, "alpha": alpha}, name).outputs

    def aggregate(self, inputs: Sequence[Tensor], n: int,
                  lambda_bal: float = 0.0, name: Optional[str] = None
                  ) -> Tensor:
        return self._add_layer(OperatorType.OP_AGGREGATE, list(inputs),
                               {"n": n, "lambda_bal": lambda_bal},
                               name).outputs[0]

    def aggregate_spec(self, inputs: Sequence[Tensor], n: int,
                       lambda_bal: float = 0.0, name: Optional[str] = None
                       ) -> Tensor:
        return self._add_layer(OperatorType.OP_AGG_SPEC, list(inputs),
                               {"n": n, "lambda_bal": lambda_bal},
                               name).outputs[0]

    def cache(self, input: Tensor, num_batches: int, score_fn=None,
              name: Optional[str] = None) -> Tensor:
        if score_fn is not None:
            raise NotImplementedError(
                "cache(score_fn=...) drives the recompile hook of "
                "runtime/recompile.py, which is not ported yet")
        return self._unary(OperatorType.OP_CACHE, input, name,
                           num_batches=num_batches)

    def moe(self, input: Tensor, num_exp: int, num_select: int,
            expert_hidden_size: int, alpha: float = 1.0,
            lambda_bal: float = 0.0) -> Tensor:
        """MoE composite, wired as the reference ``FFModel::moe``
        (``src/ops/moe.cc:20-44``): a ReLU gate, top-k, group_by, one
        dense expert per group, aggregate."""
        gate_preds = self.dense(input, num_exp, ActiMode.AC_MODE_RELU)
        topk_out = self.top_k(gate_preds, num_select, False)
        exp_tensors = self.group_by(input, topk_out[1], num_exp, alpha)
        agg_inputs = [self.softmax(topk_out[0]), topk_out[1], topk_out[1],
                      gate_preds]
        for i in range(num_exp):
            exp_pred = self.dense(exp_tensors[i], expert_hidden_size,
                                  ActiMode.AC_MODE_RELU)
            agg_inputs.append(self.softmax(exp_pred))
        return self.aggregate(agg_inputs, num_exp, lambda_bal)

    # ==================================================================
    # compile
    # ==================================================================
    def set_optimizer(self, optimizer: Optimizer):
        self.optimizer = optimizer

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
    def forward(self, batch=None, seq_length: int = -1):
        """The inference forward on ``batch`` (by default the first batch
        of the registered data loaders); returns and keeps its output."""
        fwd = self.executor.make_forward()
        if batch is None:
            batch = self._peek_batch()
        self._last_fwd = fwd(self.params, self.state, batch)
        return self._last_fwd

    def _peek_batch(self):
        loader = self._combined_loader()
        loader.reset()
        return loader.next_batch()

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

    def get_layer_by_name(self, name: str) -> Optional[Layer]:
        for l in self.layers:
            if l.name == name:
                return l
        return None

    def get_layers(self) -> Dict[int, Layer]:
        return dict(enumerate(self.layers))

    # weights access (reference Parameter.get/set_weights NumPy round trip)
    def get_weights(self, layer_name: str, weight_name: str = "kernel"
                    ) -> np.ndarray:
        t = self.params[layer_name][weight_name].detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def set_weights(self, layer_name: str, weight_name: str,
                    value: np.ndarray):
        _replace_leaf(self.params, "weight", layer_name, weight_name, value)

    def set_state(self, layer_name: str, key: str, value: np.ndarray):
        """Overwrite one non-trainable state entry (e.g. batch-norm
        running mean/var imported from a trained model)."""
        _replace_leaf(self.state, "state", layer_name, key, value)

    @property
    def label_tensor_for_loaders(self) -> Tensor:
        if self.label_tensor is None:
            out = self._output_tensor or self.layers[-1].outputs[0]
            self.label_tensor = Tensor(out.shape, DataType.DT_INT32,
                                       name="label")
        return self.label_tensor

    # ==================================================================
    # generation
    # ==================================================================
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _ids(self, prompt_ids) -> torch.Tensor:
        """(batch, seq_len) ids, numpy or torch, as int32 on the model's
        device."""
        if not torch.is_tensor(prompt_ids):
            prompt_ids = torch.as_tensor(np.asarray(prompt_ids))
        return prompt_ids.to(device=self.device, dtype=torch.int32)

    def _plen(self, prompt_len):
        """The prompt length as the decode loops index with it: an int,
        or a (B,) int64 tensor on the device for ragged prompts."""
        if np.ndim(prompt_len) > 0:
            return torch.as_tensor(prompt_len, dtype=torch.int64,
                                   device=self.device)
        return prompt_len

    def _positions(self, b: int, L: int) -> torch.Tensor:
        return torch.arange(L, dtype=torch.int32,
                            device=self.device)[None].expand(b, L)

    def generate(self, prompt_ids, prompt_len: "int | np.ndarray",
                 max_new_tokens: int, temperature: float = 0.0,
                 seed: int = 0, extra_inputs=None,
                 eos_token_id: Optional[int] = None,
                 kv_cache: Union[bool, str] = "auto",
                 top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
        """Autoregressive generation for causal LMs (GPT-2 and the
        transformer-LM family).

        ``prompt_ids``: (batch, seq_len) integer ids (numpy or torch), the
        prompt in columns [0, prompt_len) and anything (e.g. zeros) after.
        ``prompt_len`` may be a (batch,) int array for RAGGED prompts:
        each row decodes from its own length. ``temperature`` 0 = greedy
        argmax; > 0 = sampling from the pre-softmax logits after the
        top-k and top-p filters (:func:`filter_logits`), drawn from a
        ``torch.Generator`` on the model's device seeded by ``seed``.
        ``eos_token_id``: rows that emit it keep emitting it for the
        remaining steps. Returns the completed (batch, seq_len) int32 ids
        on the model's device.

        ``kv_cache``: "auto" (default) decodes incrementally against a
        per-layer K/V cache (one prefill forward, then one length-1
        forward per token) when the graph supports it (causal
        multihead-attention layers, inputs limited to input_ids /
        position_ids), and falls back, with a warning and a count in
        ``_kv_fallback_count``, to the exact full re-forward path
        otherwise. True forces the KV path (raises when unsupported),
        False forces the re-forward oracle."""
        if self.executor is None:
            raise ValueError("call compile() first")
        ids0 = self._ids(prompt_ids)
        b, L = ids0.shape
        if torch.is_tensor(prompt_len):
            prompt_len = prompt_len.cpu().numpy()
        if np.ndim(prompt_len) > 0:
            # ragged prompts: one length per batch row
            prompt_len = np.asarray(prompt_len, np.int32)
            if prompt_len.shape != (b,):
                raise ValueError(
                    f"ragged prompt_len must have shape ({b},), got "
                    f"{prompt_len.shape}")
            if not ((prompt_len >= 1).all()
                    and (prompt_len + max_new_tokens <= L).all()):
                raise ValueError(
                    f"each prompt_len must satisfy 1 <= len and "
                    f"len + max_new_tokens <= {L}; got {prompt_len} "
                    f"with max_new_tokens={max_new_tokens}")
        else:
            prompt_len = int(prompt_len)
            if prompt_len < 1:
                raise ValueError(
                    "prompt_len must be >= 1 (the first token "
                    "conditions decode)")
            if prompt_len + max_new_tokens > L:
                raise ValueError(
                    f"prompt_len {prompt_len} + max_new_tokens "
                    f"{max_new_tokens} exceeds the sequence length {L}")
        names = {t.name for t in self.graph_inputs}
        # the other graph inputs, numpy or torch (GraphProgram.init_env
        # moves them to the device)
        fixed = dict(extra_inputs or {})
        if "position_ids" in names and "position_ids" not in fixed:
            fixed["position_ids"] = self._positions(b, L)

        # failed KV attempts are remembered per (batch, seq) shape, so
        # repeated auto-mode requests at a failing shape don't re-pay the
        # attempt while other shapes still get the KV path
        failed = self.executor._kv_failed_shapes
        want_kv = kv_cache if isinstance(kv_cache, bool) \
            else (self._kv_decode_eligible(names, extra_inputs)
                  and (b, L) not in failed)
        if want_kv:
            try:
                return self._generate_kv(ids0, prompt_len, max_new_tokens,
                                         temperature, seed, eos_token_id,
                                         top_k, top_p)
            except Exception:
                if kv_cache is True:
                    raise
                failed.add((b, L))
                # the fallback is exact but O(L) per token: a deployment
                # quietly riding it is a performance fault, so it is
                # counted and logged, not silent
                self._kv_fallback_count = getattr(
                    self, "_kv_fallback_count", 0) + 1
                logging.getLogger("flexflow_tpu_torch").warning(
                    "KV-cache decode failed for this graph at shape "
                    "(%d, %d); falling back to full re-forward "
                    "generation (cached: subsequent auto-mode calls at "
                    "this shape skip the KV attempt)", b, L,
                    exc_info=True)
        return self._generate_reforward(ids0, prompt_len, max_new_tokens,
                                        temperature, seed, eos_token_id,
                                        fixed, top_k, top_p)

    def _kv_decode_eligible(self, names, extra_inputs) -> bool:
        """KV decode needs inputs limited to input_ids (+position_ids)
        and every attention layer a causal OP_MULTIHEAD_ATTENTION."""
        if extra_inputs:
            return False
        if not names <= {"input_ids", "position_ids"}:
            return False
        mha = [l for l in self.executor.program.layers
               if l.op_type == OperatorType.OP_MULTIHEAD_ATTENTION]
        return bool(mha) and all(l.params.get("causal", False)
                                 for l in mha)

    def _sampling_generator(self, temperature: float, seed: int):
        if temperature <= 0.0:
            return None
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _generate_kv(self, ids0, prompt_len, max_new_tokens, temperature,
                     seed, eos_token_id, top_k=0, top_p=1.0):
        """Incremental decode: one full-sequence prefill builds the
        per-layer K/V cache, then each generated token is one length-1
        forward, whose cost does not grow with the tokens generated (the
        re-forward path is O(L) per token). Prefill and decode are timed
        apart (each ends in a device sync) into ``_decode_measured``: per
        batch size, the least prefill time and per-token decode-step time
        seen."""
        ex = self.executor
        b, L = ids0.shape
        dev = self.device
        has_pos = "position_ids" in {t.name for t in self.graph_inputs}
        ragged = np.ndim(prompt_len) > 0
        plen = self._plen(prompt_len)
        gen = self._sampling_generator(temperature, seed)
        with torch.inference_mode():
            batch = {"input_ids": ids0}
            if has_pos:
                batch["position_ids"] = self._positions(b, L)
            t0 = time.perf_counter()
            # ragged prompts keep the full cache (the ring-buffer seed
            # needs one shared prompt length); masks stay per-row exact
            cache = ex.kv_prefill(self.params, self.state, batch,
                                  prefill_len=None if ragged else plen)
            self._sync()
            t1 = time.perf_counter()
            ids = ids0.clone()
            done = torch.zeros(b, dtype=torch.bool, device=dev)
            for i in range(max_new_tokens):
                cur = plen + i         # the index being generated
                sb = {"input_ids": self._read_token_row(ids, cur, ragged)}
                if has_pos:
                    sb["position_ids"] = (cur - 1)[:, None] if ragged \
                        else torch.full((b, 1), cur - 1, dtype=torch.int32,
                                        device=dev)
                row, cache = ex.kv_decode_step(self.params, self.state, sb,
                                               cache, cur - 1)
                nxt, done = self._sample_next(row, gen, temperature,
                                              eos_token_id, done, top_k,
                                              top_p)
                self._write_token(ids, nxt, cur, ragged)
            self._sync()
            t2 = time.perf_counter()
        step_s = (t2 - t1) / max(int(max_new_tokens), 1)
        rec = getattr(self, "_decode_measured", None)
        if rec is None:
            rec = self._decode_measured = {}
        old = rec.get(b)
        rec[b] = {
            "prefill_s": (t1 - t0) if old is None
            else min(old["prefill_s"], t1 - t0),
            "decode_step_s": step_s if old is None
            else min(old["decode_step_s"], step_s),
            "n": 1 if old is None else old["n"] + 1,
        }
        return ids

    def generate_beam(self, prompt_ids, prompt_len: int,
                      max_new_tokens: int, num_beams: int = 4,
                      eos_token_id: Optional[int] = None) -> torch.Tensor:
        """Beam-search decoding over the KV cache (deterministic; no
        length penalty: scores are summed token log-probs). Requires a
        KV-decode-eligible graph (see ``_kv_decode_eligible``). Beams
        live on the batch dim (b*K rows) and the cache is gathered by
        source beam each step; a finished beam continues with eos only,
        at no cost. Returns the best (batch, seq_len) int32 ids on the
        model's device."""
        if self.executor is None:
            raise ValueError("call compile() first")
        ids0 = self._ids(prompt_ids)
        b, L = ids0.shape
        K = int(num_beams)
        if K < 1:
            raise ValueError(f"num_beams must be >= 1, got {K}")
        if np.ndim(prompt_len) > 0:
            raise ValueError("generate_beam needs one scalar prompt_len "
                             "(per-row prompt lengths are unsupported "
                             "for beam search)")
        plen = int(prompt_len)
        if plen < 1:
            raise ValueError("prompt_len must be >= 1")
        if plen + max_new_tokens > L:
            raise ValueError(
                f"prompt_len {plen} + max_new_tokens "
                f"{max_new_tokens} exceeds the sequence length {L}")
        names = {t.name for t in self.graph_inputs}
        if not self._kv_decode_eligible(names, None):
            raise ValueError("generate_beam requires a KV-decode-"
                             "eligible graph (causal fused attention)")
        ex = self.executor
        dev = self.device
        NEG = -1e30

        def gather(cache, src):
            return {n: {k: t.index_select(0, src) for k, t in c.items()}
                    for n, c in cache.items()}

        with torch.inference_mode():
            batch = {"input_ids": ids0}
            if "position_ids" in names:
                batch["position_ids"] = self._positions(b, L)
            cache = ex.kv_prefill(self.params, self.state, batch,
                                  prefill_len=plen)
            # beams on the batch dim: row r's beams are rows r*K..r*K+K-1
            rep = torch.arange(b, device=dev).repeat_interleave(K)
            ids = ids0.index_select(0, rep)
            cache = gather(cache, rep)
            # all beams start identical: only beam 0 is live, so the
            # first step picks the row's top-K distinct tokens
            scores = torch.where(torch.arange(K, device=dev) == 0, 0.0,
                                 NEG).repeat(b)
            done = torch.zeros(b * K, dtype=torch.bool, device=dev)
            for i in range(max_new_tokens):
                cur = plen + i
                sb = {"input_ids": ids[:, cur - 1:cur]}
                if "position_ids" in names:
                    sb["position_ids"] = torch.full(
                        (b * K, 1), cur - 1, dtype=torch.int32, device=dev)
                row, cache = ex.kv_decode_step(self.params, self.state, sb,
                                               cache, cur - 1)
                V = row.shape[-1]
                logp = torch.log_softmax(row.float(), dim=-1)
                if eos_token_id is not None:
                    eos_only = torch.where(
                        torch.arange(V, device=dev) == eos_token_id, 0.0,
                        NEG)
                    logp = torch.where(done[:, None], eos_only[None], logp)
                flat = (scores[:, None] + logp).reshape(b, K * V)
                # the first K of a stable descending sort: the lower index
                # first among equal scores, as jax.lax.top_k orders them
                top_s, top_i = torch.sort(flat, dim=-1, descending=True,
                                          stable=True)
                top_s, top_i = top_s[:, :K], top_i[:, :K]
                beam = torch.div(top_i, V, rounding_mode="floor")
                token = (top_i % V).to(torch.int32).reshape(-1)
                src = (torch.arange(b, device=dev)[:, None] * K
                       + beam).reshape(-1)
                ids = ids.index_select(0, src)
                cache = gather(cache, src)
                done = done.index_select(0, src)
                scores = top_s.reshape(-1)
                if eos_token_id is not None:
                    token = torch.where(done, torch.full_like(
                        token, eos_token_id), token)
                    done = done | (token == eos_token_id)
                ids[:, cur] = token
            best = torch.argmax(scores.reshape(b, K), dim=-1)
            return ids.reshape(b, K, L)[torch.arange(b, device=dev), best]

    @staticmethod
    def _read_token_row(arr, cur, ragged):
        """Row at position cur-1 of each batch row, (B, 1, ...): cur is
        an int (shared position) or a (B,) tensor (ragged)."""
        if ragged:
            idx = (cur - 1)[:, None]
            if arr.dim() == 2:      # ids (B, L)
                return torch.gather(arr, 1, idx)
            return torch.gather(
                arr, 1, idx[:, :, None].expand(-1, 1, arr.shape[-1]))
        return arr[:, cur - 1:cur]

    @staticmethod
    def _write_token(ids, nxt, cur, ragged) -> None:
        """Write nxt at column cur of ids, in place (per row when
        ragged)."""
        if ragged:
            ids[torch.arange(ids.shape[0], device=ids.device), cur] = nxt
        else:
            ids[:, cur] = nxt

    def _sample_next(self, row, gen, temperature, eos_token_id, done,
                     top_k: int = 0, top_p: float = 1.0):
        """Shared sampling step: ``row`` is (B, V) log-domain scores.
        Greedy takes the first maximum; sampling takes the Gumbel-max of
        the filtered logits (one uniform draw per entry from ``gen``),
        which draws from their softmax. Returns (next ids int32, done)."""
        if temperature > 0.0:
            logits = filter_logits(row.float(), temperature, top_k, top_p)
            u = torch.rand(logits.shape, generator=gen,
                           device=logits.device)
            u = u.clamp_min(torch.finfo(torch.float32).tiny)
            nxt = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        else:
            nxt = torch.argmax(row, dim=-1)
        nxt = nxt.to(torch.int32)
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        return nxt, done

    def _generate_reforward(self, ids0, prompt_len, max_new_tokens,
                            temperature, seed, eos_token_id, fixed,
                            top_k=0, top_p=1.0):
        """Exact oracle path: one full forward per token; the causal mask
        guarantees positions < t ignore columns >= t."""
        ex = self.executor
        b, _ = ids0.shape
        ragged = np.ndim(prompt_len) > 0
        plen = self._plen(prompt_len)
        gen = self._sampling_generator(temperature, seed)
        with torch.inference_mode():
            ids = ids0.clone()
            done = torch.zeros(b, dtype=torch.bool, device=self.device)
            for i in range(max_new_tokens):
                scores = ex.scored_forward(self.params, self.state,
                                           {"input_ids": ids, **fixed})
                cur = plen + i
                row = self._read_token_row(scores, cur, ragged)[:, 0, :]
                nxt, done = self._sample_next(row, gen, temperature,
                                              eos_token_id, done, top_k,
                                              top_p)
                self._write_token(ids, nxt, cur, ragged)
            return ids


def _replace_leaf(tree, what: str, layer_name: str, key: str, value):
    """Put the array ``value`` in ``tree[layer_name][key]``, on the old
    leaf's device and in its dtype; a shape other than the old leaf's
    raises."""
    cur = tree[layer_name][key]
    if tuple(cur.shape) != tuple(np.shape(value)):
        raise ValueError(f"{what} {layer_name}/{key} has shape "
                         f"{tuple(cur.shape)}, got {tuple(np.shape(value))}")
    tree[layer_name][key] = torch.as_tensor(np.asarray(value)).to(
        device=cur.device, dtype=cur.dtype)


def filter_logits(row: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """The logits that sampling draws from: ``row`` (B, V) log-domain
    scores over ``temperature``, then top-k, then top-p (nucleus: the
    smallest prefix of tokens in descending probability whose cumulative
    probability reaches ``top_p``), from ONE descending sort; the
    filtered entries are -inf. The JAX package's ``_sample_next``
    filter, op for op."""
    logits = row / temperature
    V = logits.shape[-1]
    use_k = bool(top_k) and 0 < top_k < V
    if use_k or top_p < 1.0:
        ninf = float("-inf")
        desc = torch.sort(logits, dim=-1, descending=True).values
        if use_k:
            # the kth value is desc[:, k-1]; masking the tail keeps the
            # survivors' descending order for the nucleus scan
            kth = desc[:, top_k - 1:top_k]
            logits = logits.masked_fill(logits < kth, ninf)
            desc = desc.masked_fill(
                torch.arange(V, device=desc.device)[None, :] >= top_k, ninf)
        if top_p < 1.0:
            probs = torch.softmax(desc, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            excluded = cum - probs > top_p   # the prefix before reached p
            thresh = desc.masked_fill(excluded, float("inf")).amin(
                dim=-1, keepdim=True)
            logits = logits.masked_fill(logits < thresh, ninf)
    return logits
