"""Hand-built strategy presets: data, tensor, sequence, pipeline and expert
parallel.

The port of ``flexflow_tpu/parallel/presets.py``: the canonical strategies
the search explores combinations of, as spec assignments
(``parallel/strategy.py``). They are also the golden strategies of the
numerics tests: a tensor-parallel run must equal the data-parallel one.

Megatron-style transformer sharding:
  - attention: the head axis of wq/wk/wv sharded (column-parallel), wo
    sharded on its head axis (row-parallel), one all-reduce per block;
  - FFN: column-parallel up-projection, row-parallel down-projection;
  - sequence parallelism (optional): activations outside the products
    sharded along the sequence dim over the tp axes.
Pipeline parallelism: the maximal repeated-block region split into stages
over a pp axis (``pipeline_lowering.py``), dp (and tp inside the stages)
around it. Expert parallelism: the expert Linears' weights sharded over
the ep axes on their output dim ("expert-slicing"), the group_by buffers
replicated.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

from ..ffconst import OperatorType
from .machine import DeviceMesh
from .strategy import P, ShardingStrategy

Axes = Union[str, Tuple[str, ...], None]


def _norm(axes) -> Axes:
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes
    axes = tuple(axes)
    if len(axes) == 0:
        return None
    return axes[0] if len(axes) == 1 else axes


def _size(dmesh: DeviceMesh, axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    s = 1
    for a in axes:
        s *= dmesh.axis_sizes[a]
    return s


def transformer_strategy(layers, input_tensors, dmesh: DeviceMesh,
                         dp_axes, tp_axes, sp: bool = False
                         ) -> ShardingStrategy:
    """Megatron-style dp x tp (+ optional sequence-parallel) strategy for
    transformer-shaped graphs built from MHA + Linear + norms."""
    dp, tp = _norm(dp_axes), _norm(tp_axes)
    tp_size = _size(dmesh, tp)
    st = ShardingStrategy(dmesh)
    for t in input_tensors:
        if t.shape and t.shape[0] % _size(dmesh, dp) == 0:
            st.inputs[t.name] = P(dp)

    prev_linear_col = False  # was the previous Linear column-parallel?
    for layer in layers:
        ot = layer.op_type
        rank = len(layer.outputs[0].shape) if layer.outputs else 0
        act_tail = [None] * max(rank - 1, 0)
        act_spec = P(dp, *act_tail) if rank >= 1 else P()
        seq_ok = (sp and rank >= 3 and layer.outputs
                  and layer.outputs[0].shape[1] % tp_size == 0)
        seq_spec = P(dp, tp, *act_tail[1:]) if seq_ok else act_spec
        if ot == OperatorType.OP_MULTIHEAD_ATTENTION:
            heads = layer.params["num_heads"]
            if heads % tp_size == 0:
                w = {"wq": P(None, tp, None), "wk": P(None, tp, None),
                     "wv": P(None, tp, None), "wo": P(tp, None, None),
                     "bq": P(tp, None), "bk": P(tp, None), "bv": P(tp, None),
                     "bo": P()}
            else:
                w = {}
            st.set_op(layer.name, [act_spec], w)
            prev_linear_col = False
        elif ot == OperatorType.OP_LINEAR:
            out_dim = layer.params["out_dim"]
            in_dim = layer.inputs[0].shape[-1]
            col = (out_dim % tp_size == 0 and not prev_linear_col)
            if col:
                w = {"kernel": P(None, tp), "bias": P(tp)}
                spec = P(dp, *act_tail[:-1], tp) if rank >= 2 else act_spec
                st.set_op(layer.name, [spec], w)
                prev_linear_col = True
            else:
                w = ({"kernel": P(tp, None), "bias": P()}
                     if in_dim % tp_size == 0 else {})
                st.set_op(layer.name, [act_spec], w)
                prev_linear_col = False
        elif ot == OperatorType.OP_EMBEDDING:
            # column-shard the table's feature dim over tp
            w = ({"kernel": P(None, tp)}
                 if layer.params["out_dim"] % tp_size == 0 else {})
            st.set_op(layer.name, [act_spec], w)
            prev_linear_col = False
        elif ot in (OperatorType.OP_LAYERNORM, OperatorType.OP_RMSNORM,
                    OperatorType.OP_DROPOUT, OperatorType.OP_EW_ADD):
            st.set_op(layer.name, [seq_spec], {})
            prev_linear_col = False
        else:
            st.set_op(layer.name,
                      [act_spec if o.shape and
                       o.shape[0] % _size(dmesh, dp) == 0 else None
                       for o in layer.outputs], {})
            prev_linear_col = False
    return st


def pipeline_strategy(layers, input_tensors, dmesh: DeviceMesh,
                      n_stages: int, n_microbatches: int = 0,
                      pp_axis: Optional[str] = None,
                      dp_axes: Optional[Sequence[str]] = None,
                      n_chunks: int = 1, tp: int = 1,
                      tp_axis: Optional[str] = None,
                      ragged: str = "auto"
                      ) -> ShardingStrategy:
    """dp×pp(×tp) strategy through the product path: the maximal
    repeated-block region (found by ``find_pipeline_region``) becomes
    ``n_stages`` GPipe stages over the ``pp`` mesh axis; everything
    outside the region is batch-sharded over the dp axes. With
    ``tp > 1`` stage-internal attention/FFN layers are Megatron-split
    over ``tp_axis`` (one psum per attention block + one per FFN pair,
    executed as explicit all-reduces over the tp ranks of each stage).
    Raises ValueError when the graph has no pipelinable region, no mesh
    axis of size ``n_stages``, or (tp > 1) no tp-able stage structure.

    The reference only reserves the enum for this (``ffconst.h:159``);
    here it composes with dp and tp (the analog of per-op machine-view
    composition, ``substitution.cc:1898``). The executor runs the region
    over the ranks of the pp axis (``parallel/pipeline.py``)."""
    from .pipeline_lowering import assign_tp_roles, find_pipeline_region
    used: list = []
    if pp_axis is None:
        pp_axis = next((a for a, s in dmesh.axis_sizes.items()
                        if s == n_stages), None)
        if pp_axis is None:
            raise ValueError(
                f"no mesh axis of size {n_stages} for pipeline stages "
                f"(mesh {dict(dmesh.axis_sizes)}); pass --mesh-shape")
    used.append(pp_axis)
    if tp > 1 and tp_axis is None:
        tp_axis = next((a for a, s in dmesh.axis_sizes.items()
                        if s == tp and a not in used), None)
        if tp_axis is None:
            raise ValueError(
                f"no free mesh axis of size {tp} for stage-internal "
                f"tensor parallelism (mesh {dict(dmesh.axis_sizes)})")
    if tp_axis is not None:
        used.append(tp_axis)
    if dp_axes is None:
        dp_axes = tuple(a for a in dmesh.axis_names if a not in used)
    dp = _norm(dp_axes)
    dp_size = _size(dmesh, dp)
    from .pipeline_lowering import find_ragged_pipeline_region
    if ragged == "force" and (n_chunks > 1 or tp > 1):
        raise ValueError(
            "--pipeline-ragged force does not compose with "
            "--pipeline-chunks > 1 or in-stage tp (v1); drop one")
    uniform = None
    if ragged != "force":
        uniform = find_pipeline_region(layers, n_stages, n_microbatches,
                                       n_chunks)
    rag = None
    if ragged in ("auto", "force") and n_chunks <= 1 and tp <= 1:
        # ragged schedule: unequal per-stage block counts, embedding/
        # head absorbed into stage 0 / S-1 (gpipe_ragged). Not composed
        # with interleaving or in-stage tp in v1.
        rag = find_ragged_pipeline_region(layers, n_stages,
                                          n_microbatches)
    if uniform is None:
        region = rag
    elif rag is None:
        region = uniform
    else:
        # auto: prefer ragged only when it pipelines MORE BLOCKS (the
        # uniform finder drops indivisible trailing blocks into
        # replicated pre/post execution). On a tie the uniform schedule
        # wins — it supports interleaving/tp and the established stacked
        # layout; ``ragged="force"`` still gets edge absorption alone.
        region = rag if (rag.end - rag.start) \
            > (uniform.end - uniform.start) else uniform
    if region is None:
        ragged_tried = ragged in ("auto", "force") \
            and n_chunks <= 1 and tp <= 1
        raise ValueError(
            f"graph has no repeated-block region divisible into "
            f"{n_stages} identical stages"
            + (f" x {n_chunks} chunks" if n_chunks > 1 else "")
            + (" (ragged fallback found none either)" if ragged_tried
               else " (ragged fallback not applicable with "
                    "interleaving/tp)" if ragged != "off" else ""))
    region.pp_axis = pp_axis
    region.dp_axes = tuple(dp_axes)
    if tp > 1:
        roles = assign_tp_roles(region.template, tp)
        if not roles:
            raise ValueError(
                "tp > 1 requested but the stage template has no "
                "Megatron-splittable structure (attention heads or "
                "paired Linears divisible by tp)")
        region.tp_axis = tp_axis
        region.tp_roles = roles
    st = ShardingStrategy(dmesh)
    st.pipeline = region
    for t in input_tensors:
        if t.shape and t.shape[0] % dp_size == 0:
            st.inputs[t.name] = P(dp)
    region_names = {l.name for l in layers[region.start:region.end]}
    for layer in layers:
        if layer.name in region_names:
            continue  # run by the pipeline engine, not by specs
        outs = [P(dp, *([None] * (len(o.shape) - 1)))
                if o.shape and o.shape[0] % dp_size == 0 else None
                for o in layer.outputs]
        st.set_op(layer.name, outs, {})
    return st


def expert_parallel_strategy(layers, input_tensors, dmesh: DeviceMesh,
                             dp_axes, ep_axes) -> ShardingStrategy:
    """DP + expert parallelism for MoE graphs built by ``FFModel.moe``:
    expert Linears' weights are sharded over the ep axes on the output dim
    (each device holds 1/ep of every expert), and group_by outputs stay
    replicated across dp so each expert shard sees all its tokens."""
    dp, ep = _norm(dp_axes), _norm(ep_axes)
    ep_size = _size(dmesh, ep)
    st = ShardingStrategy(dmesh)
    for t in input_tensors:
        if t.shape and t.shape[0] % _size(dmesh, dp) == 0:
            st.inputs[t.name] = P(dp)
    for layer in layers:
        rank = len(layer.outputs[0].shape) if layer.outputs else 0
        tail = [None] * max(rank - 1, 0)
        act_spec = P(dp, *tail) if rank >= 1 else P()
        if layer.op_type == OperatorType.OP_GROUP_BY:
            # expert buffers: replicated (each is (C, D), consumed by its
            # expert's dense)
            st.set_op(layer.name, [None] * len(layer.outputs), {})
        elif (layer.op_type == OperatorType.OP_LINEAR
              and layer.inputs[0].owner_layer is not None
              and layer.inputs[0].owner_layer.op_type
              == OperatorType.OP_GROUP_BY):
            out_dim = layer.params["out_dim"]
            w = {"kernel": P(None, ep), "bias": P(ep)} \
                if out_dim % ep_size == 0 else {}
            st.set_op(layer.name, [None], w)
        elif layer.op_type in (OperatorType.OP_AGGREGATE,
                               OperatorType.OP_AGG_SPEC):
            st.set_op(layer.name, [act_spec], {})
        else:
            st.set_op(layer.name,
                      [act_spec if o.shape and
                       o.shape[0] % _size(dmesh, dp) == 0 else None
                       for o in layer.outputs], {})
    return st
