"""Repeated-block detection over a layer list.

The helpers of ``flexflow_tpu/parallel/pipeline_lowering.py`` that the
strategy search (``search/unity.py``, its split positions) and block
rematerialization (``executor._find_remat_blocks``) share: the maximal
run of identical consecutive chunks and the single tensor entering each
chunk. The pipeline-region lowering itself (GPipe stages over a mesh
axis) is a multi-device lowering and is not ported (ROADMAP queue 1
item 4).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..core.layer import Layer, _hashable


def layer_signature(layer: Layer) -> Tuple:
    """Structural identity of a layer for repeated-block detection:
    op type + params + input/output shapes/dtypes (not names/guids)."""
    return (layer.op_type, _hashable(layer.params),
            tuple(t.shape for t in layer.inputs),
            tuple(t.dtype for t in layer.inputs),
            tuple(t.shape for t in layer.outputs))


def _single_crossing(layers: Sequence[Layer], cut: int,
                     region_end: int) -> Optional[int]:
    """If exactly one tensor produced by layers[:cut] (within the region
    under test) is consumed by layers[cut:region_end], return its guid."""
    produced = {t.guid for l in layers[:cut] for t in l.outputs}
    crossing = set()
    for l in layers[cut:region_end]:
        for t in l.inputs:
            if t.guid in produced:
                crossing.add(t.guid)
            elif t.owner_layer is not None and \
                    t.owner_layer not in layers[cut:region_end]:
                # produced outside the candidate window entirely
                return None
    if len(crossing) != 1:
        return None
    return next(iter(crossing))


def _has_state(layer: Layer) -> bool:
    from ..ops import get_op_def
    op = get_op_def(layer.op_type)
    state_spec = getattr(op, "state_spec", None)
    if state_spec is None:
        return False
    ss = state_spec(layer.params, [t.shape for t in layer.inputs],
                    [t.dtype for t in layer.inputs])
    return bool(ss)


def find_repeated_run(layers: Sequence[Layer], n_parts: int = 1
                      ) -> Optional[Tuple[int, int, int]]:
    """The maximal verified run of identical consecutive chunks whose
    repeat count is divisible by ``n_parts``. Returns
    ``(total_len, start, unit)`` or None."""
    layers = list(layers)
    n = len(layers)
    sigs = [layer_signature(l) for l in layers]
    best: Optional[Tuple[int, int, int]] = None  # (total_len, start, unit)
    for unit in range(1, n // max(n_parts, 2) + 1):
        for start in range(n - unit * 2 + 1):
            # count consecutive repeats of layers[start:start+unit]
            reps = 1
            while True:
                nxt = start + reps * unit
                if nxt + unit > n:
                    break
                if sigs[nxt:nxt + unit] != sigs[start:start + unit]:
                    break
                reps += 1
            reps -= reps % n_parts           # whole chunks only
            if reps >= max(n_parts, 2) and reps * unit > (best or (0,))[0]:
                # verify structure before accepting
                if _verify_run(layers, start, unit, reps):
                    best = (reps * unit, start, unit)
    return best


def chunk_boundaries(layers: Sequence[Layer], start: int, unit: int,
                     reps: int) -> Optional[List[int]]:
    """Entry-tensor guid of each of the ``reps`` unit chunks of the run,
    or None if any boundary crosses more than one tensor."""
    layers = list(layers)
    total = reps * unit
    region = layers[start:start + total]
    e0 = _single_crossing(layers[:start] + region, start, start + total)
    if e0 is None:
        return None
    out = [e0]
    for b in range(1, reps):
        g = _single_crossing(region, b * unit, total)
        if g is None:
            return None
        out.append(g)
    return out


def _verify_run(layers: Sequence[Layer], start: int, unit: int,
                reps: int) -> bool:
    """Cheap pre-check that consecutive unit chunks are chainable: each
    chunk's inputs come from itself or the previous chunk's outputs (or
    the tensor entering the first chunk)."""
    region = layers[start:start + unit * reps]
    internal = {t.guid for l in region for t in l.outputs}
    external = set()
    for l in region:
        for t in l.inputs:
            if t.guid not in internal:
                external.add(t.guid)
    return len(external) == 1
