"""Parameter initializers.

The port of ``flexflow_tpu/runtime/initializers.py``: the same kinds
(Glorot-uniform, zero, one, constant, uniform, normal) and fan rules,
drawn on the parameter's device from a ``torch.Generator`` seeded by the
weight's integer path (model seed, layer index, weight index). The bits
differ from the JAX package's; carry weights across with
``interop.load_reference_params`` where both must agree.
"""
from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple

import torch

from ..ffconst import InitializerType


def _fan_in_out(shape: Tuple[int, ...]) -> Tuple[int, int]:
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv OIHW: fan_in = I*kh*kw, fan_out = O*kh*kw
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


def generator_for(key_ints: Sequence[int], device) -> torch.Generator:
    """A generator on ``device`` seeded by a hash of the integer path."""
    digest = hashlib.blake2b(repr(tuple(int(k) for k in key_ints)).encode(),
                             digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") & (2 ** 63 - 1))
    return gen


def initialize(spec, key_ints: Sequence[int], dtype: torch.dtype,
               device) -> torch.Tensor:
    """Materialize one WeightSpec on ``device``."""
    kind = spec.initializer
    shape = tuple(spec.shape)
    args = spec.init_args
    if kind == InitializerType.ZERO:
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == InitializerType.ONE:
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == InitializerType.CONSTANT:
        return torch.full(shape, args.get("value", 0.0), dtype=dtype,
                          device=device)
    gen = generator_for(key_ints, device)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if kind == InitializerType.UNIFORM:
        out.uniform_(args.get("min", -0.05), args.get("max", 0.05),
                     generator=gen)
    elif kind == InitializerType.NORMAL:
        out.normal_(args.get("mean", 0.0), args.get("stddev", 0.05),
                    generator=gen)
    elif kind == InitializerType.GLOROT_UNIFORM:
        fan_in, fan_out = _fan_in_out(shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        out.uniform_(-limit, limit, generator=gen)
    else:
        raise ValueError(kind)
    return out.to(dtype)
