"""MLP (MLP_Unify), CANDLE-Uno, and the MoE encoder example.

The port of ``flexflow_tpu/models/misc.py`` (reference
``examples/cpp/{MLP_Unify,candle_uno,mixture_of_experts}``): the same
layer sequences, so each model lines up with the JAX package's layer for
layer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from ..ffconst import ActiMode
from ..model import FFModel


def build_mlp(ff: FFModel, batch_size: int, in_dim: int = 1024,
              hidden: Sequence[int] = (4096, 4096, 4096, 1024),
              num_classes: int = 10):
    """MLP benchmark (reference ``examples/cpp/MLP_Unify/mlp.cc``)."""
    x = ff.create_tensor((batch_size, in_dim), name="input")
    t = x
    for h in hidden:
        t = ff.dense(t, h, ActiMode.AC_MODE_RELU)
    t = ff.dense(t, num_classes)
    return ff.softmax(t)


@dataclasses.dataclass
class CandleConfig:
    """Reference defaults (``candle_uno.cc:26-47``)."""
    dense_layers: Sequence[int] = (4192,) * 2
    dense_feature_layers: Sequence[int] = (4192,) * 2
    feature_shapes: Dict[str, int] = dataclasses.field(default_factory=lambda: {
        "dose": 1, "cell.rnaseq": 942, "drug.descriptors": 5270,
        "drug.fingerprints": 2048})
    input_features: Dict[str, str] = dataclasses.field(default_factory=lambda: {
        "dose1": "dose", "dose2": "dose", "cell.rnaseq": "cell.rnaseq",
        "drug1.descriptors": "drug.descriptors",
        "drug1.fingerprints": "drug.fingerprints",
        "drug2.descriptors": "drug.descriptors",
        "drug2.fingerprints": "drug.fingerprints"})


def build_candle_uno(ff: FFModel, batch_size: int,
                     cfg: CandleConfig | None = None):
    """CANDLE-Uno (reference ``candle_uno.cc:49-130``): per-feature dense
    towers, concat, a deep dense stack, dense(1)."""
    cfg = cfg or CandleConfig()

    def feature_model(t, layers):
        for s in layers:
            t = ff.dense(t, s, ActiMode.AC_MODE_RELU, use_bias=False)
        return t

    encoded = []
    for name, feat in cfg.input_features.items():
        shape = cfg.feature_shapes[feat]
        inp = ff.create_tensor((batch_size, shape), name=name)
        if feat == "dose":
            encoded.append(inp)
        else:
            encoded.append(feature_model(inp, cfg.dense_feature_layers))
    t = ff.concat(encoded, axis=-1)
    for s in cfg.dense_layers:
        t = ff.dense(t, s, ActiMode.AC_MODE_RELU, use_bias=False)
    return ff.dense(t, 1)


@dataclasses.dataclass
class MoeConfig:
    """Reference ``examples/cpp/mixture_of_experts/moe.h`` defaults."""
    hidden_size: int = 64
    num_encoder_layers: int = 1
    num_attention_heads: int = 16
    num_exp: int = 32
    num_select: int = 2
    alpha: float = 2.0
    lambda_bal: float = 0.04
    in_dim: int = 784
    num_classes: int = 10

    @classmethod
    def tiny(cls):
        return cls(hidden_size=32, num_attention_heads=4, num_exp=4,
                   in_dim=64)


def build_moe_mnist(ff: FFModel, batch_size: int,
                    cfg: MoeConfig | None = None):
    """MoE classifier (reference ``moe.cc:100-140``): the FFModel.moe
    composite (gate, top-k, group_by, experts, aggregate) on flat input,
    then a classification head."""
    cfg = cfg or MoeConfig()
    x = ff.create_tensor((batch_size, cfg.in_dim), name="input")
    t = ff.moe(x, cfg.num_exp, cfg.num_select, cfg.hidden_size,
               cfg.alpha, cfg.lambda_bal)
    t = ff.dense(t, cfg.num_classes)
    return ff.softmax(t)
