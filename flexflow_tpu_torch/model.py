"""FFModel: the model-building API and compile, on one device.

The port of ``flexflow_tpu/model.py`` on one device: the layer builders
of every model of the zoo (same names, params and auto-naming as the
JAX package, so the two graphs of one model line up layer for layer),
constants (``create_constant``), ``compile`` (the machine model and its
one-device mesh, the strategy search under a budget, the measured kernel
plan, parameters, op state and optimizer state materialized), the
training loop (``fit`` with its epoch-callback and
``recompile_on_condition`` hooks, ``eval``, ``forward``, the phase-API
no-ops), generation
(``generate`` over a KV cache or by full re-forwards, greedy or sampled,
ragged prompts, eos; ``generate_beam``) and the weight and state
accessors; checkpoints (``save_checkpoint`` / ``restore_checkpoint``),
the fault-injection sites of the train step and the telemetry of
``compile``, ``fit`` and ``generate`` (``obs``). A strategy over more
devices than the process has (a described machine) is searched and
exported, and ``compile`` refuses to run it.

The model runs on ``config.device`` ("cuda" by default) unless the
caller passes ``device``; asking for CUDA where there is none raises.
"""
from __future__ import annotations

import logging
import os
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
from .obs import events as obs_events
from .obs import request_trace
from .obs.metrics_registry import DECODE_STEP_BUCKETS, REGISTRY
from .ops import get_op_def
from .parallel.distributed import (maybe_initialize, process_count,
                                   rank_device)
from .parallel.machine import DeviceMesh, MachineSpec
from .parallel.strategy import ShardingStrategy
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
        # the MetricsBuffer of the running fit / Supervisor epoch, which
        # save_checkpoint flushes and NaN-screens first
        self._metrics_buffer: Optional[MetricsBuffer] = None

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
        """A tensor holding ``value`` everywhere, an input of the graph
        (not a parameter). Kept on the host in numpy (f32 for the float
        types numpy lacks); ``compile`` puts it on the device in
        ``dtype`` once (``GraphProgram.stage_consts``)."""
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
        """``score_fn`` is accepted and ignored, as in the JAX package:
        the recompile hook is ``recompile_on_condition``."""
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
                machine_spec: Optional[MachineSpec] = None,
                strategy: Optional[ShardingStrategy] = None,
                output_tensor: Optional[Tensor] = None,
                search_budget: Optional[int] = None):
        """Lower the graph to an executor on ``self.device``: the machine
        model (``machine_spec``, the config's machine-model file clamped
        to the one device, or ``MachineSpec.detect``) and its mesh, the
        strategy (given, imported, searched under a budget, or data
        parallel), the kernel plan, then the parameters, op state and
        optimizer state. In a world of ranks (``parallel/distributed.py``:
        ``FF_COORDINATOR_ADDRESS`` / ``FF_NUM_PROCESSES`` /
        ``FF_PROCESS_ID`` or the config's flags), one device each, the
        mesh is live and the strategy runs over it (``--tp`` / ``--sp``
        build the Megatron preset, ``--only-data-parallel`` data
        parallelism, a budget the search; ``--seq-parallel N`` reserves a
        trailing ``seq`` axis of N ranks that nothing shards over and
        ring attention runs on, and refuses ``--pp`` / ``--tp``). A mesh
        of more devices than
        the world has is searched and exported, then refused
        (``NotImplementedError``).
        Applies the config's tracing choice (``obs.events.configure``)
        and records the ``model.compile`` span and the
        ``ff_model_compiles_total`` counter."""
        obs_events.configure(self.config)
        compile_t0 = time.perf_counter()
        cfg = self.config
        if optimizer is not None:
            self.optimizer = optimizer
        if self.optimizer is None:
            self.optimizer = SGDOptimizer(lr=cfg.learning_rate)
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

        pp = max(int(cfg.pipeline_stages), 1)
        pp_tp = max(int(cfg.pipeline_tp), 1)
        seq_par = max(int(getattr(cfg, "seq_parallel_degree", 0) or 0), 0)
        if seq_par > 1 and (pp > 1 or cfg.tensor_parallel > 1):
            raise ValueError(
                "--seq-parallel (the reserved ring-attention axis) does "
                "not compose with --pp/--tp presets; use the search")
        if pp_tp > 1 and pp <= 1:
            raise ValueError(
                f"--pp-tp {pp_tp} requires --pp > 1 (stage-internal "
                f"tensor parallelism only exists inside a pipeline); "
                f"for tp without pipelining use a transformer_strategy "
                f"or the search")
        if pp > 1 and max(cfg.tensor_parallel, 1) > 1:
            raise ValueError(
                "--tp does not compose with --pp directly; use --pp-tp "
                "for Megatron tp inside pipeline stages")
        if maybe_initialize(cfg, self.device.type):
            # a world of ranks: start the failure-detection layer
            # (per-rank heartbeats + bounded barriers) beside it — every
            # later cross-rank wait of the resilience layer goes through it
            from .resilience import coord
            c = coord.ensure_started(cfg)
            try:
                # clock handshake for cross-rank trace alignment
                # (tools/fftrace.py): one bounded barrier, every rank
                # anchors its monotonic clock at the release instant.
                # Unconditional — every rank reaches compile, so the
                # rendezvous can never depend on per-rank trace flags
                c.clock_sync("compile")
            except Exception:  # noqa: BLE001 — alignment is best-effort
                pass
        world = process_count()
        if machine_spec is not None:
            spec = machine_spec
        elif cfg.machine_model_file:
            # the described machine drives the cost model; execution is
            # clamped to the live devices (one per rank)
            spec = MachineSpec.from_file(cfg.machine_model_file)
            spec.num_devices = min(spec.num_devices, world)
        else:
            spec = MachineSpec.detect(self.device)
        mesh_shape = cfg.mesh_shape
        if mesh_shape is None and strategy is None and pp > 1:
            # dp x pp (x tp) mesh: the middle axis carries the pipeline
            # stages, the trailing one the stage-internal tensor split
            nd = spec.num_devices
            if nd % (pp * pp_tp) != 0:
                raise ValueError(f"--pp {pp} x --pp-tp {pp_tp} does not "
                                 f"divide {nd} devices")
            mesh_shape = tuple(
                d for d in (nd // (pp * pp_tp), pp, pp_tp) if d > 1)
        if mesh_shape is None and strategy is None and pp <= 1 \
                and cfg.machine_model_file \
                and not cfg.import_strategy_file \
                and getattr(spec, "ici_shape", None) \
                and int(np.prod(spec.ici_shape)) == spec.num_devices:
            mesh_shape = tuple(spec.ici_shape)
        devices = [rank_device(self.device.type, r) for r in range(world)]
        self.dmesh = DeviceMesh(spec, devices=devices,
                                mesh_shape=mesh_shape, seq=seq_par)
        if search_budget is not None:
            cfg.search_budget = search_budget
        if strategy is None:
            strategy = self._tp_preset(spec, mesh_shape)
        if strategy is None and pp > 1:
            strategy = self._pipeline_preset(pp, pp_tp)

        exec_layers, exec_outputs = self.layers, [self._output_tensor]
        # seconds by compile phase; the search adds its own parts
        # (calibrate_s, unity_s / mcmc_s, floor_guard_s)
        self._compile_phases = {}
        if strategy is not None:
            self.strategy = strategy
        else:
            t0 = time.perf_counter()
            self.strategy, program_info = self._optimize_strategy()
            self._compile_phases["search_s"] = round(
                time.perf_counter() - t0, 3)
            if program_info is not None:
                # the search rewrote the graph (inserted parallel ops)
                exec_layers = program_info.layers
                exec_outputs = program_info.output_tensors
                self._output_tensor = exec_outputs[0]
        if self.dmesh.described:
            raise NotImplementedError(
                f"the strategy spans {self.dmesh.num_devices} devices and "
                f"the world has {world} rank(s), one device each: run it "
                f"over a world of {self.dmesh.num_devices} ranks (ROADMAP "
                f"queue 1 item 4.1, parallel/distributed.py); the search "
                f"ran and exported it")
        grouped = getattr(self.strategy, "pipeline", None) is not None \
            or getattr(self.strategy, "banks", None) \
            or getattr(self.strategy, "place_groups", None)
        if grouped and not self.dmesh.live:
            raise ValueError(
                "a pipeline region, a bank or a place group runs over a "
                "world of ranks (one per device of its mesh); this "
                "compile has one device")
        if getattr(self.strategy, "pipeline", None) is not None and \
                cfg.shard_optimizer_states:
            raise NotImplementedError(
                "--zero over a pipeline region: the moments of a stage's "
                "leaves would shard over its dp ranks, not ported; run "
                "the pipeline without --zero")
        if self.dmesh.live:
            _same_on_every_rank(self.strategy, exec_layers)
        prebuilt = getattr(self, "_prebuilt_executor", None)
        self._prebuilt_executor = None
        if prebuilt is not None and prebuilt[0] is self.strategy \
                and prebuilt[1] is not None:
            # the floor guard already built this exact program: adopt
            # its executor (params are re-initialized below)
            self.executor = prebuilt[1]
        else:
            program = GraphProgram(exec_layers,
                                   self.graph_inputs + self.const_inputs,
                                   exec_outputs)
            self.executor = Executor(program, cfg, self.device,
                                     self.optimizer, self.loss_type,
                                     self.metrics, seed=cfg.seed)
            program.stage_consts(self.device)
        if self.dmesh.live:
            self.executor.attach_world(self.strategy)
        self.executor.attach_overlap(self.strategy)
        self._plan_zero()
        self._plan_qsync()
        self._plan_kernels()
        self.params, self.state = self.executor.init_params_and_state()
        self.opt_state = self.optimizer.init_state(self.params)
        self._place_optimizer_state()
        self._step = 0
        self._compile_phases["compile_s"] = round(
            time.perf_counter() - compile_t0, 6)
        REGISTRY.counter(
            "ff_model_compiles_total",
            "Model program compiles (trace + XLA build events)").inc(
            model=getattr(self, "_model_name", "") or "<unnamed>")
        obs_events.record_span("model.compile", compile_t0,
                               time.perf_counter() - compile_t0,
                               n_devices=self.dmesh.num_devices,
                               n_layers=len(self.layers))

    def _place_optimizer_state(self) -> None:
        """Over a world: the ZeRO-1 layout of the optimizer state (the
        uniform ``--zero`` or the strategy's imported assignment,
        ``runtime/zero.py``), whose placements the executor keeps; and
        the zero error-feedback residuals of the quantized sync under
        their reserved slot."""
        ex = self.executor
        if ex.strategy is None:
            return
        zero = getattr(self.strategy, "zero", None)
        if self.opt_state and (self.config.shard_optimizer_states or zero):
            from .runtime.zero import shard_optimizer_state, \
                state_constraints
            self.opt_state = shard_optimizer_state(
                self.opt_state, self.strategy,
                None if self.config.shard_optimizer_states else zero)
            ex.opt_state_constraints = state_constraints(self.opt_state)
            ex._zero_layouts = None
        if ex._qsync is not None and isinstance(self.opt_state, dict):
            from .ops import quantized_collectives as qsync_mod
            res = qsync_mod.init_residuals(ex._qsync, ex.program,
                                           self.dmesh, self.device)
            if res:
                self.opt_state[qsync_mod.RESIDUAL_SLOT] = res

    def _annotate_export(self, block: str, value) -> None:
        """Rewrite one block of the exported strategy file (the search
        exported before this plan existed), so an import round-trips
        it."""
        import json
        path = self.config.export_strategy_file
        if not path:
            return
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):   # nothing was exported
            return
        doc[block] = value
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)

    def _plan_zero(self):
        """The ZeRO assignment: the uniform ``--zero`` flag bypasses
        planning (``strategy.zero`` = None; every moment takes its
        ``zero_spec``), an assignment on the strategy (an import) is
        honored verbatim, and ``zero_policy`` ``auto`` / ``memory`` /
        ``all`` needs the ZeRO planner (``search/zero_plan.py``, ROADMAP
        queue 1 item 5)."""
        if self.strategy is None:
            return
        if self.config.shard_optimizer_states:
            self.strategy.zero = None
            return
        if getattr(self.strategy, "zero", None) is not None:
            return
        policy = str(getattr(self.config, "zero_policy", "off")
                     or "off").lower()
        if policy in ("off", "false", "no", ""):
            return
        if policy not in ("auto", "memory", "all"):
            raise ValueError(f"unknown zero_policy {policy!r} "
                             f"(expected off/auto/memory/all)")
        from .runtime.zero import opt_slots
        if self.dmesh.num_devices <= 1 or opt_slots(self.optimizer) <= 0 \
                or getattr(self.strategy, "pipeline", None) is not None:
            return
        raise NotImplementedError(
            f"zero_policy={policy!r} needs the ZeRO planner "
            f"(search/zero_plan.py), not ported yet (ROADMAP queue 1 "
            f"item 5); --zero shards every moment")

    def _plan_qsync(self):
        """The quantized grad-sync plan (``FFConfig.quantized_collectives``,
        ``ops/quantized_collectives.py``): an imported plan is honored
        verbatim unless explicitly disabled (``--no-quantized-
        collectives`` / ``FF_QUANTIZED_COLLECTIVES=off`` strip it);
        otherwise, on a mode other than off over several devices, the
        cost model scores every replicated weight's sync and the plan is
        adopted, recorded in the audit and the exported file."""
        cfg = self.config
        if self.strategy is None:
            return
        from .ops.quantized_collectives import (audit_record, plan_qsync,
                                                qsync_disabled,
                                                resolve_qsync_mode,
                                                resolve_qsync_wire)
        if getattr(self.strategy, "qsync", None) is not None:
            if qsync_disabled(cfg):
                logging.getLogger("flexflow_tpu_torch").warning(
                    "stripping the imported strategy's quantized-"
                    "collectives plan (explicitly disabled)")
                self.strategy.qsync = None
            self.executor.attach_qsync(self.strategy)
            return
        mode = resolve_qsync_mode(cfg)
        if mode == "off" or self.dmesh.num_devices <= 1:
            return
        wire = resolve_qsync_wire(cfg)
        cost_model = getattr(self, "_search_cost_model", None)
        if cost_model is None or cost_model.spec is not self.dmesh.spec:
            from .search.costmodel import OpCostModel
            cost_model = OpCostModel(self.dmesh.spec)
        cost_model.attach_quantization(mode, wire)
        plan = plan_qsync(self.strategy, self.executor.program.layers,
                          self.dmesh, cost_model, mode=mode, wire=wire)
        self.strategy.qsync = plan
        self.executor.attach_qsync(self.strategy)
        if plan is None:
            return
        if not getattr(self.strategy, "axis_tiers", None):
            try:
                self.strategy.axis_tiers = dict(self.dmesh.axis_tiers)
            except Exception:  # noqa: BLE001 — tierless machine
                pass
        record = audit_record(plan)
        self._qsync_record = record
        audit_path = getattr(self, "_strategy_audit_path", None)
        if audit_path:
            from .obs.audit import annotate_strategy_audit
            annotate_strategy_audit(audit_path, {"quantized_sync": record})
        self._annotate_export("qsync", plan.to_json())

    def _pipeline_preset(self, pp: int, pp_tp: int) -> ShardingStrategy:
        """``--pp N`` (with ``--pp-tp``, ``--pipeline-chunks``,
        ``--pipeline-ragged``): the dp x pp (x tp) preset of
        ``presets.pipeline_strategy``, no search. On the mesh compile
        built, the axes bind by position (dp, pp, tp), since their sizes
        may tie; an explicit mesh shape binds them by size."""
        from .parallel.presets import pipeline_strategy
        cfg = self.config
        kw = {}
        if cfg.mesh_shape is None:
            nd = self.dmesh.num_devices
            sizes = (nd // (pp * pp_tp), pp, pp_tp)
            roles = [r for r, d in zip(("dp", "pp", "tp"), sizes) if d > 1]
            by_role = dict(zip(roles, self.dmesh.axis_names))
            kw = dict(pp_axis=by_role["pp"], tp_axis=by_role.get("tp"),
                      dp_axes=(by_role["dp"],) if "dp" in by_role else ())
        return pipeline_strategy(
            self.layers, self.graph_inputs, self.dmesh, n_stages=pp,
            n_microbatches=cfg.pipeline_microbatches,
            n_chunks=cfg.pipeline_chunks, tp=pp_tp,
            ragged=cfg.pipeline_ragged, **kw)

    def _tp_preset(self, spec, mesh_shape) -> Optional[ShardingStrategy]:
        """``--tp N`` (with ``--sp``): the Megatron dp x tp (x sp) preset
        over the mesh, no search, as in the JAX package. An explicit mesh
        shape is kept and validated; otherwise a (dp, tp) mesh is built.
        None without ``--tp``."""
        cfg = self.config
        tp_deg = max(cfg.tensor_parallel, 1)
        if cfg.sequence_parallel and tp_deg <= 1:
            raise ValueError(
                "--sp requires --tp N (N > 1): the sequence dim is "
                "sharded over the tensor-parallel axes")
        if tp_deg <= 1:
            return None
        from .parallel.presets import transformer_strategy
        nd = self.dmesh.num_devices
        if nd % tp_deg != 0:
            raise ValueError(f"--tp {tp_deg} does not divide {nd} devices")
        if mesh_shape is None:
            self.dmesh = DeviceMesh(
                spec, devices=self.dmesh.devices,
                mesh_shape=tuple(d for d in (nd // tp_deg, tp_deg)
                                 if d > 1))
        axes = self.dmesh.axis_names
        # trailing axes must realize exactly the requested degree
        tp_axes: list = []
        prod = 1
        for ax in reversed(axes):
            if prod == tp_deg:
                break
            tp_axes.insert(0, ax)
            prod *= self.dmesh.axis_sizes[ax]
        if prod != tp_deg:
            raise ValueError(
                f"--tp {tp_deg} not realizable from the trailing axes of "
                f"mesh {dict(self.dmesh.axis_sizes)} (they give {prod}); "
                f"pass a compatible --mesh-shape")
        dp_axes = tuple(a for a in axes if a not in tp_axes)
        return transformer_strategy(self.layers, self.input_tensors,
                                    self.dmesh, dp_axes=dp_axes,
                                    tp_axes=tuple(tp_axes),
                                    sp=cfg.sequence_parallel)

    def _optimize_strategy(self):
        """Strategy selection: search unless --only-data-parallel.
        Returns (strategy, program_info_or_None) — Unity search may
        rewrite the executable graph. On one device the search still
        runs when a budget is set explicitly: substitutions can rewrite
        the graph, and the kernel plan prices from its calibration. An
        ``import_strategy_file`` is imported on one device too (the JAX
        package drops it there unless a budget is set, so a serving
        plan's bucket strategies never reached a one-card model)."""
        single_no_budget = (self.dmesh.num_devices == 1
                            and self.config.search_budget <= 0
                            and not self.config.import_strategy_file)
        if self.config.only_data_parallel or single_no_budget \
                or self.config.search_algo == "dp":
            return ShardingStrategy.data_parallel(
                self.layers, self.graph_inputs, self.dmesh), None
        from .search.optimizer import optimize_strategy
        return optimize_strategy(self)

    def _plan_kernels(self):
        """Adopt per-op kernel implementations (kernels/registry.py):
        attention ``xla``/``flash``/``ring``, the optimizer update
        ``fused``/``unfused``. An assignment already on the strategy
        (an imported file) is honored verbatim; forced choices
        (``kernel_impls`` / ``--kernel-impl`` / ``FF_KERNEL_IMPL`` / the
        retired ``use_flash_attention`` shim) bypass scoring but are
        predicate-checked — a forced impl that cannot run on these
        shapes is a compile-time error naming the layer. Otherwise, with
        measured calibration evidence (``calibration_v2``), each
        attention op takes its cheapest available impl and the update
        the cheaper of fused / unfused, priced by the search's cost
        model (``OpCostModel.kernel_impl_cost``); the choice and its
        predicted saving land in ``self._kernel_record``, the strategy
        audit and an exported strategy file. Without evidence the
        defaults stand."""
        cfg = self.config
        if self.strategy is None or self.executor is None:
            return
        strat = self.strategy
        if getattr(strat, "kernel_impls", None):
            self.executor._kernel_impls = dict(strat.kernel_impls)
            return
        policy = str(getattr(cfg, "kernel_impls", "auto") or "auto").lower()
        if policy in ("off", "none"):
            return
        forced = kreg.resolve_forced(cfg)
        from .search.calibration import (calibrate_kernel_impls,
                                         calibrate_mesh,
                                         calibration_enabled)
        if not forced and not calibration_enabled(cfg):
            # no forced choices and no measured evidence to search on —
            # the defaults stand, at zero compile cost
            return
        backend = self.device.type
        seq_deg = int(getattr(self.dmesh, "seq_degree", 0) or 0)
        layers = self.executor.program.layers
        attn = [l for l in layers
                if l.op_type == OperatorType.OP_MULTIHEAD_ATTENTION]
        cost_model = getattr(self, "_search_cost_model", None)
        if cost_model is None or cost_model.spec is not self.dmesh.spec:
            # non-searched paths: a bare cost model, calibrated when the
            # opt-in is on
            from .search.costmodel import OpCostModel
            cost_model = OpCostModel(self.dmesh.spec)
            cost_model.device = self.device
            if calibration_enabled(cfg) and not cfg.machine_model_file:
                cost_model.attach_calibration(calibrate_mesh(self.dmesh))
        searchable = cost_model.calib is not None
        if searchable:
            # grow the impl-keyed rows (op_attention@<impl>); a warm
            # table makes this measurement-free
            calibrate_kernel_impls(self.dmesh, cost_model.calib.table)
        tier = None
        if self.dmesh.seq_axis:
            tier = self.dmesh.axis_tiers.get(self.dmesh.seq_axis)

        def _degrees(name):
            """Adopted (output shard degrees, weight shard degree)."""
            os_ = strat.ops.get(name)
            sd: Dict[int, int] = {}
            wdeg = 1
            if os_ is None:
                return sd, wdeg
            spec0 = os_.outputs[0] if os_.outputs else None
            for i, ax in enumerate(spec0 or ()):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, (tuple, list)) else (ax,)
                d = 1
                for a in axes:
                    d *= int(self.dmesh.axis_sizes.get(a, 1))
                if d > 1:
                    sd[i] = d
            for wspec in (os_.weights or {}).values():
                d = 1
                for ax in wspec or ():
                    if ax is None:
                        continue
                    axes = ax if isinstance(ax, (tuple, list)) else (ax,)
                    for a in axes:
                        d *= int(self.dmesh.axis_sizes.get(a, 1))
                wdeg = max(wdeg, d)
            return sd, wdeg

        plan: Dict[str, str] = {}
        audit_ops: List[Dict] = []
        f_attn = forced.get(kreg.ATTENTION)
        for layer in attn:
            q_len = int(layer.inputs[0].shape[1]) if layer.inputs else 0
            kv_len = int(layer.inputs[1].shape[1]) \
                if len(layer.inputs) > 1 else q_len
            ctx = kreg.attention_ctx(layer.params, q_len, kv_len,
                                     backend=backend, seq_degree=seq_deg)
            if f_attn is not None:
                reason = kreg.get_impl(kreg.ATTENTION,
                                       f_attn).available(ctx)
                if reason is not None:
                    raise ValueError(
                        f"{layer.name}: forced kernel impl "
                        f"attention:{f_attn} is not available on this "
                        f"device/shapes: {reason}")
                choice = f_attn
            elif searchable:
                sd, wdeg = _degrees(layer.name)
                best_t, choice = None, kreg.DEFAULT_IMPLS[kreg.ATTENTION]
                for name in kreg.available_impls(kreg.ATTENTION, ctx):
                    cm = cost_model.kernel_impl_cost(
                        layer, kreg.ATTENTION, name, sd, wdeg,
                        seq_degree=seq_deg if name == "ring" else 0,
                        tier=tier)
                    t = cm.forward_time + cm.backward_time
                    if best_t is None or t < best_t:
                        best_t, choice = t, name
            else:
                continue
            sd, wdeg = _degrees(layer.name)
            cm_x = cost_model.kernel_impl_cost(
                layer, kreg.ATTENTION, "xla", sd, wdeg)
            cm_c = cost_model.kernel_impl_cost(
                layer, kreg.ATTENTION, choice, sd, wdeg,
                seq_degree=seq_deg if choice == "ring" else 0, tier=tier)
            t_x = cm_x.forward_time + cm_x.backward_time
            t_c = cm_c.forward_time + cm_c.backward_time
            audit_ops.append({
                "name": layer.name, "op": kreg.ATTENTION,
                "impl": choice, "forced": f_attn is not None,
                "predicted_s": round(t_c, 9),
                "forced_xla_s": round(t_x, 9),
                "delta_s": round(t_x - t_c, 9)})
            plan[layer.name] = choice

        # optimizer update: one graph-wide choice (the fused multi-tensor
        # Adam kernel vs the per-leaf PyTorch update)
        f_opt = forced.get(kreg.OPT_UPDATE)
        opt_kind = "adam" if isinstance(self.optimizer, AdamOptimizer) \
            else type(self.optimizer).__name__.lower()
        octx = {"backend": backend, "optimizer": opt_kind}
        param_bytes = 0.0
        for l in layers:
            for w in l.weights or ():
                n = 1
                for d in w.shape:
                    n *= int(d)
                param_bytes += float(n) * 4.0
        if f_opt is not None:
            reason = kreg.get_impl(kreg.OPT_UPDATE, f_opt).available(octx)
            if reason is not None:
                raise ValueError(
                    f"forced kernel impl opt_update:{f_opt} is not "
                    f"available here: {reason}")
            o_choice = f_opt
        elif searchable and param_bytes:
            best_t, o_choice = None, kreg.DEFAULT_IMPLS[kreg.OPT_UPDATE]
            for name in kreg.available_impls(kreg.OPT_UPDATE, octx):
                cm = cost_model.kernel_impl_cost(
                    None, kreg.OPT_UPDATE, name, param_bytes=param_bytes)
                if best_t is None or cm.forward_time < best_t:
                    best_t, o_choice = cm.forward_time, name
        else:
            o_choice = None
        if o_choice is not None:
            cm_u = cost_model.kernel_impl_cost(
                None, kreg.OPT_UPDATE, "unfused", param_bytes=param_bytes)
            cm_c = cost_model.kernel_impl_cost(
                None, kreg.OPT_UPDATE, o_choice, param_bytes=param_bytes)
            audit_ops.append({
                "name": "__opt_update__", "op": kreg.OPT_UPDATE,
                "impl": o_choice, "forced": f_opt is not None,
                "predicted_s": round(cm_c.forward_time, 9),
                "forced_xla_s": round(cm_u.forward_time, 9),
                "delta_s": round(cm_u.forward_time
                                 - cm_c.forward_time, 9)})
            if o_choice != kreg.DEFAULT_IMPLS[kreg.OPT_UPDATE]:
                plan[kreg.OPT_UPDATE] = o_choice

        if not plan and not audit_ops:
            return
        strat.kernel_impls = plan
        self.executor._kernel_impls = dict(plan)
        n_nondefault = sum(
            1 for e in audit_ops
            if e["impl"] != kreg.DEFAULT_IMPLS[e["op"]])
        record = {"policy": policy, "backend": backend,
                  "seq_degree": seq_deg,
                  "n_ops": len(audit_ops),
                  "n_nondefault": n_nondefault,
                  "measured": bool(searchable),
                  "ops": audit_ops}
        self._kernel_record = record
        audit_path = getattr(self, "_strategy_audit_path", None)
        if audit_path:
            from .obs.audit import annotate_strategy_audit
            annotate_strategy_audit(audit_path, {"kernels": record})
        if cfg.export_strategy_file:
            # the search exported before the assignment existed: rewrite
            # the kernel_impls section so an import round-trips it
            import json
            try:
                with open(cfg.export_strategy_file) as f:
                    doc = json.load(f)
            except (OSError, ValueError):   # nothing was exported
                doc = None
            if doc is not None:
                doc["kernel_impls"] = dict(plan)
                with open(cfg.export_strategy_file, "w") as f:
                    json.dump(doc, f, indent=1)
        if cfg.profiling:
            tot = sum(e["delta_s"] for e in audit_ops)
            logging.getLogger("flexflow_tpu_torch").info(
                "kernel plan (%s): %d/%d ops off the default impl, "
                "predicted %+.3f ms/step vs forced-xla", policy,
                n_nondefault, len(audit_ops), tot * 1e3)

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
                                prefetch=self.config.prefetch_batches,
                                row_ranges=self._row_ranges(arrays, bs))

    def _row_ranges(self, arrays, bs: int):
        """Over a live mesh, the rows of each batch that this rank loads
        (``local_row_range`` of each input's ``input_sharding``; the
        labels take the first input's): each rank feeds its own rows.
        None on one device."""
        ex = self.executor
        if ex is None or ex.strategy is None:
            return None
        from .parallel.distributed import local_row_range
        from .parallel.strategy import spec_placements
        st = ex.strategy
        out = {}
        for t in self.graph_inputs:
            if t.name in arrays:
                pl = spec_placements(st.input_sharding(t.name), st.dmesh,
                                     len(t.shape))
                out[t.name] = local_row_range(st.dmesh.mesh, pl,
                                              (bs, *t.shape[1:]))
        if "label" in arrays and out:
            out["label"] = next(iter(out.values()))
        return out

    def _run_train_step(self, step_fn, batch):
        # fault-injection sites (resilience/faults.py): crash/device-loss
        # clauses fire BEFORE the step runs, NaN/Inf corruption clauses
        # poison the params after it; active() is one cached check, so
        # fault-free runs pay nothing measurable
        from .resilience import coord, faults
        coord.check()  # surface a detected peer-rank failure pre-step
        if faults.active():
            faults.raise_pending(self._step)
        self.params, self.opt_state, self.state, bm = step_fn(
            self.params, self.opt_state, self.state, self._step, batch)
        if faults.active():
            bad = faults.poison_value(self._step)
            if bad is not None:
                with torch.no_grad():
                    for ws in self.params.values():
                        for t in ws.values():
                            if t.is_floating_point():
                                t.mul_(bad)
                # the step's all_finite flag saw the CLEAN loss; the
                # poison must flip it or the deferred NaN screen would
                # wave the poisoned step through
                loss = bm["loss"]
                poison = torch.full_like(loss, bad)
                bm = dict(bm, loss=poison,
                          all_finite=torch.logical_and(
                              torch.as_tensor(bm.get("all_finite", True),
                                              device=loss.device),
                              torch.isfinite(poison)))
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
        and ``samples_per_sec``). After each epoch's report, every callback
        gets ``on_epoch_end(epoch, report, self)``; the loop stops when any
        has ``stop_requested`` set (the Keras adapter's early stop).

        Each epoch records a ``fit.epoch`` span and sets the
        ``ff_train_samples_per_sec`` gauge; at the end the trace goes to
        ``config.trace_export_file`` when tracing is on."""
        if self.executor is None:
            raise ValueError("call compile() first")
        epochs = epochs or self.config.epochs
        loader = self._combined_loader(x, y, batch_size)
        history = []
        # the buffer stays attached through the epoch-end callbacks
        # (their checkpoint saves screen through it) and is detached
        # when fit ends — INCLUDING on exceptions, or a stale poisoned
        # buffer would block save_checkpoint of later clean params
        try:
            for epoch in range(epochs):
                step_fn = self.executor.make_train_step()
                pm = PerfMetrics()
                buf = MetricsBuffer.for_config(self.config, pm=pm)
                self._metrics_buffer = buf
                t0 = time.perf_counter()
                nb = 0
                for batch in loader:
                    bm = self._run_train_step(step_fn, batch)
                    buf.push(self._step - 1, bm, loader.batch_rows(batch))
                    nb += 1
                    # dynamic recompilation hook (reference model.cc:2422)
                    rs = getattr(self, "_recompile_state", None)
                    if rs is not None and rs.step(self):
                        step_fn = self.executor.make_train_step()
                    pf = self.config.print_freq
                    if pf > 0 and nb % pf == 0:
                        # print_freq is the metric-fetch cadence, whether
                        # or not anything is printed
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
                rep["samples_per_sec"] = pm.train_all / dt if dt > 0 \
                    else 0.0
                obs_events.record_span("fit.epoch", t0, dt, epoch=epoch,
                                       batches=nb)
                REGISTRY.gauge(
                    "ff_train_samples_per_sec",
                    "Training throughput of the last completed epoch"
                ).set(rep["samples_per_sec"])
                history.append(rep)
                if verbose:
                    msg = " ".join(f"{k}={v:.4f}" for k, v in rep.items())
                    print(f"epoch {epoch} done: {msg}")
                if callbacks:
                    stop = False
                    for cb in callbacks:
                        cb.on_epoch_end(epoch, rep, self)
                        stop = stop or getattr(cb, "stop_requested", False)
                    if stop:
                        break
        finally:
            self._metrics_buffer = None
        self._current_metrics = history[-1] if history else {}
        if self.config.trace_export_file and obs_events.enabled():
            from .obs.trace_export import export_chrome_trace
            export_chrome_trace(self.config.trace_export_file)
        self._end_of_training_telemetry()
        return history

    def _end_of_training_telemetry(self) -> None:
        """End-of-training observability hook shared by :meth:`fit` and
        the resilience Supervisor: the per-rank ring dump that
        ``tools/fftrace.py`` merges, written in a process group of more
        than one rank or under ``FF_TRACE_DUMP=1``, strictly after the
        last step. The JAX package's attribution harness runs here too;
        in the port ``compile`` refuses an attribution request
        (``obs.events.refuse_attribution``)."""
        if not obs_events.enabled():
            return
        from .obs.trace_export import _world_size, dump_rank_trace
        if _world_size() > 1 \
                or obs_events._env_on(os.environ.get("FF_TRACE_DUMP")):
            dump_rank_trace()

    # dynamic recompilation (reference recompile_on_condition, model.cc:2422)
    def recompile_on_condition(self, trigger, alter):
        """Evaluate ``trigger(state)`` after every ``fit`` step; when it
        is true run ``alter(state)`` and rebuild the executor's steps
        (``runtime/recompile.py``). Returns the ``RecompileState``."""
        from .runtime.recompile import RecompileState
        rs = RecompileState(trigger, alter, ff=self)
        self._recompile_state = rs
        return rs

    # checkpoint / resume: the JAX package's files, either package's steps
    def save_checkpoint(self, directory: str, step: Optional[int] = None,
                        max_to_keep: int = 3):
        """Save params, optimizer state, op state and step to
        ``directory`` (``runtime/checkpoint.py``; over a world of ranks
        the two-phase multi-host format, a collective: every rank calls,
        and ``directory`` must be one that every rank reads). Inside
        ``fit`` (an epoch callback) the pending step metrics are flushed
        first, and a non-finite one raises ``NonFiniteMetrics``: a
        poisoned state never reaches a checkpoint."""
        from .runtime.checkpoint import save_model_checkpoint
        buf = self._metrics_buffer
        if buf is not None:
            buf.flush()
            buf.raise_if_poisoned()
        return save_model_checkpoint(self, directory, step, max_to_keep)

    def restore_checkpoint(self, directory: str,
                           step: Optional[int] = None) -> int:
        """Restore the newest valid step (or ``step``) of ``directory``
        into this compiled model, in place; returns the step. Over a
        world the default restore is collective (every rank adopts the
        newest step that every rank verifies)."""
        from .runtime.checkpoint import restore_model_checkpoint
        return restore_model_checkpoint(self, directory, step)

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
            buf.push(0, bm, loader.batch_rows(batch))
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
        if self.executor is not None and self.executor.strategy is not None:
            # the global array: a collective, so every rank calls it
            t = self.executor._unplace(t)
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
        False forces the re-forward oracle.

        Over a world of ranks every rank makes the same call: the prefill
        and each decode step run under the strategy, the scores come back
        whole on every rank, and every rank samples from them with the
        same seeded generator, so all write the same tokens. "auto" never
        falls back there (a failure on one rank would part it from its
        peers): it raises as True does."""
        if self.executor is None:
            raise ValueError("call compile() first")
        ids0 = self._ids(prompt_ids)
        b, L = ids0.shape
        prompt_len = check_prompt(b, L, prompt_len, max_new_tokens)
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
                # over a world of ranks a failure on one rank would send
                # it down another path than its peers': it raises
                if kv_cache is True or self.executor.strategy is not None:
                    raise
                failed.add((b, L))
                # the fallback is exact but O(L) per token: a deployment
                # quietly riding it is a performance fault, so it is
                # counted and logged, not silent
                self._kv_fallback_count = getattr(
                    self, "_kv_fallback_count", 0) + 1
                REGISTRY.counter(
                    "ff_kv_fallback_total",
                    "KV-cache decode attempts that fell back to the "
                    "full re-forward path").inc(
                        model=getattr(self, "_model_name", "")
                        or "<unnamed>")
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
        with ex._no_grad():
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
        # tag the phase spans with the ambient request trace (set by a
        # serving front) so a request's prefill/decode link into its
        # lifecycle; None outside a traced request — dropped by attrs
        tid = request_trace.current_id()
        span_attrs = {"trace": tid} if tid else {}
        obs_events.record_span("generate.prefill", t0, t1 - t0,
                               batch=b, seq=L, **span_attrs)
        obs_events.record_span("generate.decode", t1, t2 - t1,
                               batch=b, tokens=int(max_new_tokens),
                               **span_attrs)
        REGISTRY.histogram(
            "ff_decode_step_seconds",
            "Per-token decode-step latency by batch bucket",
            buckets=DECODE_STEP_BUCKETS).observe(step_s, bucket=str(b))
        REGISTRY.histogram(
            "ff_prefill_seconds",
            "Prompt prefill latency by batch bucket",
            buckets=DECODE_STEP_BUCKETS).observe(t1 - t0, bucket=str(b))
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
        model's device. Over a world of ranks each rank gathers its own
        rows of the cache (``Executor.kv_gather``): the beams of a prompt
        stay on the rank that holds the prompt's rows."""
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
        with ex._no_grad():
            batch = {"input_ids": ids0}
            if "position_ids" in names:
                batch["position_ids"] = self._positions(b, L)
            cache = ex.kv_prefill(self.params, self.state, batch,
                                  prefill_len=plen)
            # beams on the batch dim: row r's beams are rows r*K..r*K+K-1
            rep = torch.arange(b, device=dev).repeat_interleave(K)
            ids = ids0.index_select(0, rep)
            cache = ex.kv_gather(cache, rep, b)
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
                cache = ex.kv_gather(cache, src, b * K)
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
        with ex._no_grad():
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


def check_prompt(b: int, L: int, prompt_len, max_new_tokens: int):
    """The prompt length(s) of a generate call over ``b`` rows of ``L``
    positions as the decode loops take them, an int or (ragged prompts)
    a (b,) int32 array; ValueError unless every prompt holds at least one
    token and leaves room for ``max_new_tokens``."""
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
        return prompt_len
    prompt_len = int(prompt_len)
    if prompt_len < 1:
        raise ValueError(
            "prompt_len must be >= 1 (the first token "
            "conditions decode)")
    if prompt_len + max_new_tokens > L:
        raise ValueError(
            f"prompt_len {prompt_len} + max_new_tokens "
            f"{max_new_tokens} exceeds the sequence length {L}")
    return prompt_len


def _same_on_every_rank(strategy, layers) -> None:
    """Raise unless every rank of the world chose the same strategy for
    the same program: each rank searches on its own, and a rank whose
    measurements steered it elsewhere would run other collectives than
    its peers."""
    import hashlib

    import torch.distributed as dist
    text = strategy.describe() + "|" + ",".join(
        f"{l.name}:{l.op_type.name}" for l in layers)
    mine = hashlib.sha256(text.encode()).hexdigest()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if len(set(every)) != 1:
        raise RuntimeError(
            f"the ranks chose different strategies (digests {every}); "
            f"give every rank the same strategy (an exported strategy "
            f"file, a preset) or the same calibration")


def _replace_leaf(tree, what: str, layer_name: str, key: str, value):
    """Put a contiguous copy of the array ``value`` in
    ``tree[layer_name][key]``, on the old leaf's device and in its dtype
    (never a view of the caller's array: a transposed weight, as the
    frontends hand over, would stay strided, and the optimizers update
    leaves in place); a shape other than the old leaf's raises."""
    cur = tree[layer_name][key]
    if tuple(cur.shape) != tuple(np.shape(value)):
        raise ValueError(f"{what} {layer_name}/{key} has shape "
                         f"{tuple(cur.shape)}, got {tuple(np.shape(value))}")
    from .parallel.local_ops import is_dtensor
    if is_dtensor(cur):
        # over a world of ranks: this rank's block, laid out as the leaf
        from .parallel.distributed import put_global
        tree[layer_name][key] = put_global(
            torch.as_tensor(np.ascontiguousarray(value)).clone(),
            cur.device_mesh, cur.placements,
            device=cur.to_local().device, dtype=cur.dtype)
        return
    tree[layer_name][key] = torch.as_tensor(
        np.ascontiguousarray(value)).to(device=cur.device, dtype=cur.dtype,
                                        copy=True)


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
