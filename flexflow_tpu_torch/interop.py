"""Carry parameters and optimizer state from the JAX package's model into
the port's.

The two packages build the same graph layer for layer and declare the
same weight names and shapes (``OpDef.weights``), so a JAX ``ff.params``
tree, pulled to the host as nested dicts of numpy arrays, copies into a
port model one to one. Layers pair by POSITION: both packages name layers
by their index in the model, but a graph built twice, or an explicitly
named layer, must not be able to pair the wrong weights silently, so
every pair's op type, weight names and weight shapes are checked and any
mismatch raises. Every weight-bearing op copies this way, PReLU's
``alpha``, Mixtral's router and expert kernels and the MoE example's
expert layers included; constants (``create_constant``) are graph
inputs, not parameters, and are not copied. Op state (BatchNorm's
running mean and variance, Cache's slots) copies the same way, checked
against each op's ``state_spec``.

A port model that keeps layers in stacked leaves takes them either way:
a pipeline region's ``pp::<template layer>`` leaves (``(S, ...)``,
``(v, S, ...)`` interleaved, ``(S, cmax, ...)`` ragged) from a JAX
pipelined model's own, or stacked here from a plain JAX model's
per-layer weights; a bank's stacked members from a JAX banked model's
``param_name`` leaf, or stacked (and padded) from the plain members'.
Over a world each rank keeps its own block (its stage, its members).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from .dtypes import to_torch
from .ffconst import OperatorType
from .ops import get_op_def


def _state_specs(layer) -> Dict[str, Any]:
    """A layer's op state as ``{name: (shape, dtype)}`` (empty when its op
    keeps none)."""
    spec = getattr(get_op_def(layer.op_type), "state_spec", None)
    if spec is None:
        return {}
    return {k: (tuple(shape), dt) for k, (shape, dt) in spec(
        layer.params, [t.shape for t in layer.inputs],
        [t.dtype for t in layer.inputs]).items()}


def _weight_specs(layer) -> Dict[str, Any]:
    return {w.name: (tuple(w.shape), w.dtype) for w in layer.weights}


def _grouped(ff, ref_tree, ref_layer_names):
    """The reference tree's weights of the layers the port model keeps in
    stacked leaves, and the stacked leaves themselves, by the port's
    key: its pipeline region (``pp::<template layer>``) and its banks.
    Each stacked leaf is either the reference's own (a pipelined or
    banked JAX model: its ``pp::`` key by the template layer's position,
    its bank's ``param_name``) or stacked here from the reference's
    per-layer weights (a plain JAX model grafted: block c's layer j
    stacked in the region's layout, ``PipelineRegion.stack_blocks``; a
    bank's members by ``banks.stack_members``). Returns
    (names of the layers they cover, {key: {weight: (array, dtype)}}).
    """
    from .parallel.banks import stack_members
    ex = ff.executor
    ours = ex.program.layers
    covered, stacked = set(), {}
    pipe = getattr(ex, "pipe", None)

    def per_layer(i: int, wname: str):
        ref_name = ref_layer_names[i][0]
        arr = np.asarray(ref_tree.get(ref_name, {}).get(wname))
        if arr.dtype.kind == "V":
            arr = arr.astype(np.float32)
        return arr

    if pipe is not None:
        unit = len(pipe.template)
        covered |= {l.name for l in ours[pipe.start:pipe.end]}
        for j, tl in enumerate(pipe.template):
            key = pipe.param_name(tl)
            specs = _weight_specs(tl)
            if not specs:
                continue
            ref_key = "pp::" + ref_layer_names[pipe.start + j][0]
            if ref_key in ref_tree:
                stacked[key] = {w: (np.asarray(ref_tree[ref_key][w]), dt)
                                for w, (_, dt) in specs.items()}
                continue
            leaf = {}
            for w, (_, dt) in specs.items():
                blocks = [torch.from_numpy(np.ascontiguousarray(
                    per_layer(pipe.start + b * unit + j, w)))
                    for b in range(len(pipe.stage_layer_names))]
                leaf[w] = (pipe.stack_blocks(blocks).numpy(), dt)
            stacked[key] = leaf
    pos = {l.name: i for i, l in enumerate(ours)}
    for bk in getattr(ex.strategy, "banks", None) or ():
        covered |= set(bk.members)
        first = _weight_specs(ours[pos[bk.members[0]]])
        if bk.param_name in ref_tree:
            stacked[bk.param_name] = {
                w: (np.asarray(a), first[w][1])
                for w, a in ref_tree[bk.param_name].items()}
            continue
        members = [{w: torch.from_numpy(np.ascontiguousarray(
            per_layer(pos[m], w))) for w in first} for m in bk.members]
        leaf = {w: (t.numpy(), first[w][1]) for w, t in stack_members(
            members, getattr(bk, "padded", False)).items()}
        stacked[bk.param_name] = leaf
    return covered, stacked


def _paired_tree(ff, ref_tree: Mapping[str, Mapping[str, Any]],
                 ref_layer_names: Sequence[Tuple[str, Any]], dtype_of,
                 specs_of=_weight_specs, what: str = "weight"
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A tree in the port's layer names from a reference tree, layers
    paired by position and checked; ``specs_of(layer)`` gives each
    layer's ``{name: (shape, dtype)}`` and ``dtype_of(dtype, arr)`` picks
    each leaf's torch dtype. The weights of a pipeline region and of
    banks go to their stacked leaves (:func:`_grouped`), each checked
    against the port's leaf's shape."""
    ours = ff.executor.program.layers
    if len(ours) != len(ref_layer_names):
        raise ValueError(f"layer count differs: port {len(ours)}, "
                         f"reference {len(ref_layer_names)}")
    covered, stacked = set(), {}
    if what == "weight":
        covered, stacked = _grouped(ff, ref_tree, ref_layer_names)
    new: Dict[str, Dict[str, torch.Tensor]] = {}
    for i, (layer, (ref_name, ref_op)) in enumerate(zip(ours,
                                                        ref_layer_names)):
        if int(layer.op_type) != int(ref_op):
            raise ValueError(
                f"layer {i}: op type differs: port {layer.name} is "
                f"{layer.op_type.name}, reference {ref_name} is "
                f"{OperatorType(int(ref_op)).name}")
        if layer.name in covered:
            continue
        specs = specs_of(layer)
        ref_w = ref_tree.get(ref_name, {})
        if set(specs) != set(ref_w):
            raise ValueError(
                f"layer {i} ({layer.name} / {ref_name}): {what} names "
                f"differ: port {sorted(specs)}, reference {sorted(ref_w)}")
        if not specs:
            continue
        new[layer.name] = {}
        for wname, (shape, dt) in specs.items():
            arr = np.asarray(ref_w[wname])
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"layer {i} ({layer.name} / {ref_name}) {what} "
                    f"{wname}: shape differs: port {shape}, "
                    f"reference {tuple(arr.shape)}")
            dtype = dtype_of(dt, arr)
            if arr.dtype.kind == "V":      # ml_dtypes bfloat16
                arr = arr.astype(np.float32)
            new[layer.name][wname] = torch.tensor(arr, device=ff.device,
                                                  dtype=dtype)
    cur = ff.params or {}
    for key, leaf in stacked.items():
        new[key] = {}
        for wname, (arr, dt) in leaf.items():
            want = tuple(cur[key][wname].shape) if key in cur else None
            if want is not None and tuple(arr.shape) != want:
                raise ValueError(f"stacked leaf {key} {what} {wname}: shape "
                                 f"differs: port {want}, reference "
                                 f"{tuple(arr.shape)}")
            dtype = dtype_of(dt, arr)
            if arr.dtype.kind == "V":
                arr = arr.astype(np.float32)
            new[key][wname] = torch.tensor(arr, device=ff.device,
                                           dtype=dtype)
    return new


def load_reference_params(ff, ref_params: Mapping[str, Mapping[str, Any]],
                          ref_layer_names: Sequence[Tuple[str, Any]]
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Replace ``ff.params`` (a compiled port model) with the reference's.

    ``ref_params``: layer name -> weight name -> array (numpy, or anything
    ``np.asarray`` takes). ``ref_layer_names``: the reference model's
    layers in graph order as ``(name, op_type)`` pairs, e.g.
    ``[(l.name, l.op_type) for l in ref_ff.layers]``; ``op_type`` may be
    the enum or its int value (the two packages' enums agree).
    Raises ValueError on any disagreement. Returns the new params."""
    if ff.params is None:
        raise ValueError("compile() the port model first")
    new = _paired_tree(ff, ref_params, ref_layer_names,
                       lambda dt, arr: to_torch(dt))
    if ff.executor.strategy is not None:
        # over a world of ranks: each rank keeps its block of each leaf
        new = ff.executor.place_tree(new)
    ff.params = new
    return new


def load_reference_state(ff, ref_state: Mapping[str, Mapping[str, Any]],
                         ref_layer_names: Sequence[Tuple[str, Any]]
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Replace ``ff.state`` (the op state of a compiled port model, e.g.
    BatchNorm's running ``mean`` and ``var``) with the reference's
    ``ff.state``: layers paired by position, each layer's entry names and
    shapes checked against its op's ``state_spec``, as
    :func:`load_reference_params` checks weights. Returns the new
    state."""
    if ff.state is None:
        raise ValueError("compile() the port model first")
    new = _paired_tree(ff, ref_state, ref_layer_names,
                       lambda dt, arr: to_torch(dt), _state_specs, "state")
    if ff.executor.strategy is not None:
        new = ff.executor.place_state(new)
    ff.state = new
    return new


def load_reference_opt_state(ff, ref_opt_state: Mapping[str, Any],
                             ref_layer_names: Sequence[Tuple[str, Any]]
                             ) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """Replace ``ff.opt_state`` with the reference's optimizer state:
    Adam's ``m`` and ``v``, SGD-momentum's ``v``, or nothing for plain
    SGD, each slot a tree like the params. The slots must be the port
    optimizer's; every slot's layers pair and are checked as in
    :func:`load_reference_params`. A float32 array stays float32 (the
    JAX update promotes a bf16 weight's moments to f32); anything else
    takes the weight's dtype. Returns the new state."""
    if ff.opt_state is None:
        raise ValueError("compile() the port model first")
    if set(ref_opt_state) != set(ff.opt_state):
        raise ValueError(f"optimizer state slots differ: port "
                         f"{sorted(ff.opt_state)}, reference "
                         f"{sorted(ref_opt_state)}")

    def dtype_of(dt, arr):
        if arr.dtype == np.float32:
            return torch.float32
        return to_torch(dt)

    new = {slot: _paired_tree(ff, ref_opt_state[slot], ref_layer_names,
                              dtype_of)
           for slot in ref_opt_state}
    if ff.executor.strategy is not None:
        # each moment laid out as its parameter
        new = {slot: ff.executor.place_tree(t) for slot, t in new.items()}
    ff.opt_state = new
    return new
