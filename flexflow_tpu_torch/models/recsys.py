"""Recommender model zoo: DLRM and XDL.

The port of ``flexflow_tpu/models/recsys.py``: the reference's
``examples/cpp/DLRM/dlrm.cc`` and ``examples/cpp/XDL/xdl.cc``, embedding
tables (summed bags, dense gradients) with bottom/top MLPs and a concat
interaction, layer for layer as the JAX package builds them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from ..ffconst import ActiMode, AggrMode, DataType
from ..model import FFModel


@dataclasses.dataclass
class DLRMConfig:
    """Reference defaults (``dlrm.cc:26-42``)."""
    embedding_size: Sequence[int] = (1000000,) * 4
    sparse_feature_size: int = 64
    embedding_bag_size: int = 1
    mlp_bot: Sequence[int] = (4, 64, 64)
    mlp_top: Sequence[int] = (64, 64, 2)
    arch_interaction_op: str = "cat"


def _mlp(ff: FFModel, t, sizes: Sequence[int], sigmoid_last: bool = False):
    for i, s in enumerate(sizes[1:]):
        last = i == len(sizes) - 2
        act = (ActiMode.AC_MODE_SIGMOID if (last and sigmoid_last)
               else ActiMode.AC_MODE_RELU)
        t = ff.dense(t, s, act)
    return t


def build_dlrm(ff: FFModel, batch_size: int, cfg: DLRMConfig | None = None):
    """DLRM (reference ``dlrm.cc:103-190``): per-table embedding-bag sum,
    dense-feature bottom MLP, concat interaction, top MLP → 2-way softmax."""
    cfg = cfg or DLRMConfig()
    sparse_inputs = [
        ff.create_tensor((batch_size, cfg.embedding_bag_size),
                         DataType.DT_INT32, name=f"sparse_{i}")
        for i in range(len(cfg.embedding_size))]
    dense_input = ff.create_tensor((batch_size, cfg.mlp_bot[0]),
                                   name="dense_input")
    ly = [ff.embedding(s, n, cfg.sparse_feature_size,
                       AggrMode.AGGR_MODE_SUM, name=f"emb_{i}")
          for i, (s, n) in enumerate(zip(sparse_inputs, cfg.embedding_size))]
    x = _mlp(ff, dense_input, list(cfg.mlp_bot))
    if cfg.arch_interaction_op != "cat":
        raise ValueError(f"unsupported arch_interaction_op "
                         f"{cfg.arch_interaction_op!r} (only 'cat')")
    z = ff.concat([x] + ly, axis=-1)
    # last top-MLP layer uses sigmoid (reference dlrm.cc:165:
    # sigmoid_layer = mlp_top.size() - 2)
    t = _mlp(ff, z, [z.shape[-1]] + list(cfg.mlp_top)[1:],
             sigmoid_last=True)
    return ff.softmax(t)


@dataclasses.dataclass
class XDLConfig:
    """Reference defaults (``xdl.cc:26-32``)."""
    embedding_size: Sequence[int] = (1000000,) * 4
    sparse_feature_size: int = 64
    embedding_bag_size: int = 1
    mlp: Sequence[int] = (256, 128, 2)


def build_xdl(ff: FFModel, batch_size: int, cfg: XDLConfig | None = None):
    """XDL (reference ``xdl.cc``): embeddings concat → MLP → softmax."""
    cfg = cfg or XDLConfig()
    sparse_inputs = [
        ff.create_tensor((batch_size, cfg.embedding_bag_size),
                         DataType.DT_INT32, name=f"sparse_{i}")
        for i in range(len(cfg.embedding_size))]
    ly = [ff.embedding(s, n, cfg.sparse_feature_size,
                       AggrMode.AGGR_MODE_SUM, name=f"emb_{i}")
          for i, (s, n) in enumerate(zip(sparse_inputs, cfg.embedding_size))]
    z = ff.concat(ly, axis=-1)
    t = z
    for i, s in enumerate(cfg.mlp):
        act = (ActiMode.AC_MODE_NONE if i == len(cfg.mlp) - 1
               else ActiMode.AC_MODE_RELU)
        t = ff.dense(t, s, act)
    return ff.softmax(t)
