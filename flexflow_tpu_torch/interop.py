"""Carry parameters and optimizer state from the JAX package's model into
the port's.

The two packages build the same graph layer for layer and declare the
same weight names and shapes (``OpDef.weights``), so a JAX ``ff.params``
tree, pulled to the host as nested dicts of numpy arrays, copies into a
port model one to one. Layers pair by POSITION: both packages name layers
by their index in the model, but a graph built twice, or an explicitly
named layer, must not be able to pair the wrong weights silently, so
every pair's op type, weight names and weight shapes are checked and any
mismatch raises.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from .dtypes import to_torch
from .ffconst import OperatorType


def _paired_tree(ff, ref_tree: Mapping[str, Mapping[str, Any]],
                 ref_layer_names: Sequence[Tuple[str, Any]], dtype_of
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A tree in the port's layer names from a reference tree, layers
    paired by position and checked; ``dtype_of(spec, arr)`` picks each
    leaf's torch dtype."""
    ours = ff.executor.program.layers
    if len(ours) != len(ref_layer_names):
        raise ValueError(f"layer count differs: port {len(ours)}, "
                         f"reference {len(ref_layer_names)}")
    new: Dict[str, Dict[str, torch.Tensor]] = {}
    for i, (layer, (ref_name, ref_op)) in enumerate(zip(ours,
                                                        ref_layer_names)):
        if int(layer.op_type) != int(ref_op):
            raise ValueError(
                f"layer {i}: op type differs: port {layer.name} is "
                f"{layer.op_type.name}, reference {ref_name} is "
                f"{OperatorType(int(ref_op)).name}")
        specs = {w.name: w for w in layer.weights}
        ref_w = ref_tree.get(ref_name, {})
        if set(specs) != set(ref_w):
            raise ValueError(
                f"layer {i} ({layer.name} / {ref_name}): weight names "
                f"differ: port {sorted(specs)}, reference {sorted(ref_w)}")
        if not specs:
            continue
        new[layer.name] = {}
        for wname, spec in specs.items():
            arr = np.asarray(ref_w[wname])
            if tuple(arr.shape) != spec.shape:
                raise ValueError(
                    f"layer {i} ({layer.name} / {ref_name}) weight "
                    f"{wname}: shape differs: port {spec.shape}, "
                    f"reference {tuple(arr.shape)}")
            dtype = dtype_of(spec, arr)
            if arr.dtype.kind == "V":      # ml_dtypes bfloat16
                arr = arr.astype(np.float32)
            new[layer.name][wname] = torch.tensor(arr, device=ff.device,
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
                       lambda spec, arr: to_torch(spec.dtype))
    ff.params = new
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

    def dtype_of(spec, arr):
        if arr.dtype == np.float32:
            return torch.float32
        return to_torch(spec.dtype)

    new = {slot: _paired_tree(ff, ref_opt_state[slot], ref_layer_names,
                              dtype_of)
           for slot in ref_opt_state}
    ff.opt_state = new
    return new
