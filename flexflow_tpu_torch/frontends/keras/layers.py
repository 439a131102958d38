"""Keras-style layer classes.

The port of ``flexflow_tpu/frontends/keras/layers.py``.
Reference parity: ``python/flexflow/keras/layers/`` — declarative layer
objects that map 1:1 onto FFModel builder calls at ``Model.compile`` time
(the reference does exactly this lowering in ``base_model.py``).
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

from ...ffconst import ActiMode, AggrMode, DataType, PoolType

_ACTI = {None: ActiMode.AC_MODE_NONE, "linear": ActiMode.AC_MODE_NONE,
         "relu": ActiMode.AC_MODE_RELU, "sigmoid": ActiMode.AC_MODE_SIGMOID,
         "tanh": ActiMode.AC_MODE_TANH, "gelu": ActiMode.AC_MODE_GELU}

_uid = itertools.count()


def _acti(activation):
    """An ActiMode from a Keras activation name (or None), or the mode
    given."""
    if isinstance(activation, (str, type(None))):
        return _ACTI[activation]
    return activation


class KerasTensor:
    """Symbolic handle produced by calling layers functionally."""

    def __init__(self, layer, idx=0):
        self.layer = layer
        self.idx = idx


class Layer:
    def __init__(self, name: Optional[str] = None):
        self.name = name or f"{type(self).__name__.lower()}_{next(_uid)}"
        self.inbound: List[KerasTensor] = []

    def __call__(self, inputs):
        self.inbound = [inputs] if isinstance(inputs, KerasTensor) \
            else list(inputs)
        return KerasTensor(self)

    # lowering: (ff, ff_inputs) -> ff tensor
    def to_ff(self, ff, ins):
        raise NotImplementedError


class Input(Layer):
    def __init__(self, shape: Sequence[int], dtype=DataType.DT_FLOAT,
                 name: Optional[str] = None):
        super().__init__(name)
        self.shape = tuple(shape)   # without batch dim
        self.dtype = dtype
        self.tensor = KerasTensor(self)

    def to_ff(self, ff, ins):
        raise RuntimeError("Input lowered specially")


class Dense(Layer):
    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 name=None, **kw):
        super().__init__(name)
        self.units = units
        self.activation = _acti(activation)
        self.use_bias = use_bias

    def to_ff(self, ff, ins):
        return ff.dense(ins[0], self.units, self.activation, self.use_bias,
                        name=self.name)


class Conv2D(Layer):
    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding="valid", activation=None, groups: int = 1,
                 use_bias: bool = True, name=None, **kw):
        super().__init__(name)
        self.filters = filters
        self.kernel = kernel_size if isinstance(kernel_size, tuple) \
            else (kernel_size, kernel_size)
        self.strides = strides if isinstance(strides, tuple) \
            else (strides, strides)
        self.padding = padding
        self.activation = _acti(activation)
        self.groups = groups
        self.use_bias = use_bias

    def to_ff(self, ff, ins):
        if self.padding == "same":
            ph, pw = self.kernel[0] // 2, self.kernel[1] // 2
        elif self.padding == "valid":
            ph = pw = 0
        else:
            ph, pw = self.padding
        return ff.conv2d(ins[0], self.filters, self.kernel[0],
                         self.kernel[1], self.strides[0], self.strides[1],
                         ph, pw, self.activation, self.groups,
                         self.use_bias, name=self.name)


class _Pool2D(Layer):
    pool_type = PoolType.POOL_MAX

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid",
                 name=None):
        super().__init__(name)
        self.pool = pool_size if isinstance(pool_size, tuple) \
            else (pool_size, pool_size)
        strides = strides or self.pool
        self.strides = strides if isinstance(strides, tuple) \
            else (strides, strides)
        self.padding = padding

    def to_ff(self, ff, ins):
        ph, pw = ((self.pool[0] // 2, self.pool[1] // 2)
                  if self.padding == "same" else (0, 0))
        return ff.pool2d(ins[0], self.pool[0], self.pool[1],
                         self.strides[0], self.strides[1], ph, pw,
                         self.pool_type, name=self.name)


class MaxPooling2D(_Pool2D):
    pool_type = PoolType.POOL_MAX


class AveragePooling2D(_Pool2D):
    pool_type = PoolType.POOL_AVG


class Flatten(Layer):
    def to_ff(self, ff, ins):
        return ff.flat(ins[0], name=self.name)


class Activation(Layer):
    def __init__(self, activation, name=None):
        super().__init__(name)
        self.activation = activation

    def to_ff(self, ff, ins):
        fn = {"relu": ff.relu, "sigmoid": ff.sigmoid, "tanh": ff.tanh,
              "gelu": ff.gelu, "softmax": ff.softmax,
              "elu": ff.elu}[self.activation]
        return fn(ins[0], name=self.name)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__(name)
        self.axis = axis

    def to_ff(self, ff, ins):
        return ff.softmax(ins[0], self.axis, name=self.name)


class Dropout(Layer):
    def __init__(self, rate: float, name=None):
        super().__init__(name)
        self.rate = rate

    def to_ff(self, ff, ins):
        return ff.dropout(ins[0], self.rate, name=self.name)


class BatchNormalization(Layer):
    def __init__(self, relu: bool = False, name=None, **kw):
        super().__init__(name)
        self.relu = relu

    def to_ff(self, ff, ins):
        return ff.batch_norm(ins[0], self.relu, name=self.name)


class LayerNormalization(Layer):
    def __init__(self, axis=-1, epsilon=1e-5, name=None):
        super().__init__(name)
        self.axis = axis if isinstance(axis, (list, tuple)) else [axis]
        self.epsilon = epsilon

    def to_ff(self, ff, ins):
        return ff.layer_norm(ins[0], list(self.axis), eps=self.epsilon,
                             name=self.name)


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, name=None, **kw):
        super().__init__(name)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def to_ff(self, ff, ins):
        return ff.embedding(ins[0], self.input_dim, self.output_dim,
                            AggrMode.AGGR_MODE_NONE, name=self.name)


class Concatenate(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__(name)
        self.axis = axis

    def to_ff(self, ff, ins):
        return ff.concat(list(ins), self.axis, name=self.name)


class Add(Layer):
    def to_ff(self, ff, ins):
        return ff.add(ins[0], ins[1], name=self.name)


class Subtract(Layer):
    def to_ff(self, ff, ins):
        return ff.subtract(ins[0], ins[1], name=self.name)


class Multiply(Layer):
    def to_ff(self, ff, ins):
        return ff.multiply(ins[0], ins[1], name=self.name)


class Maximum(Layer):
    def to_ff(self, ff, ins):
        return ff.max(ins[0], ins[1], name=self.name)


class Minimum(Layer):
    def to_ff(self, ff, ins):
        return ff.min(ins[0], ins[1], name=self.name)


class Reshape(Layer):
    def __init__(self, target_shape, name=None):
        super().__init__(name)
        self.target_shape = tuple(target_shape)

    def to_ff(self, ff, ins):
        batch = ins[0].shape[0]
        return ff.reshape(ins[0], (batch,) + self.target_shape,
                          name=self.name)


class Permute(Layer):
    def __init__(self, dims, name=None):
        super().__init__(name)
        self.dims = tuple(dims)  # keras: 1-indexed, excludes batch

    def to_ff(self, ff, ins):
        return ff.transpose(ins[0], (0,) + self.dims, name=self.name)


class MultiHeadAttention(Layer):
    def __init__(self, num_heads: int, key_dim: int, dropout=0.0, name=None):
        super().__init__(name)
        self.num_heads = num_heads
        self.key_dim = key_dim
        self.dropout = dropout

    def __call__(self, query, value, key=None):
        key = key if key is not None else value
        self.inbound = [query, key, value]
        return KerasTensor(self)

    def to_ff(self, ff, ins):
        q, k, v = ins
        embed = q.shape[-1]
        return ff.multihead_attention(q, k, v, embed, self.num_heads,
                                      dropout=self.dropout, name=self.name)
