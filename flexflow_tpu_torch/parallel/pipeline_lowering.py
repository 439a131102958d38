"""Pipeline lowering: find a repeated-block region in a layer graph and
the layout transitions at its edges.

The port of ``flexflow_tpu/parallel/pipeline_lowering.py``.
``FFConfig.pipeline_stages = k`` (or a strategy that carries a region)
partitions the *maximal repeated-block run* of the graph (transformer
blocks, residual MLP stacks) into k structurally identical stages
(``find_pipeline_region``; x ``n_chunks`` chunks a stage under the
interleaved schedule), or into stages of unequal block counts with the
embedding prologue and the head epilogue absorbed into the edge stages
(``find_ragged_pipeline_region``). ``assign_tp_roles`` marks the
Megatron roles of a stage template for tensor parallelism inside the
stages. The executor runs the region over the ranks of the ``pp`` mesh
axis (``parallel/pipeline.py``); layers before and after it run as
ordinary sharded ops. The search (``search/unity.py``, its split
positions) and block rematerialization (``executor._find_remat_blocks``)
share the repeated-run helpers.

Constraints (checked by ``find_pipeline_region``): the region must be a
chain of ``n_stages`` structurally identical single-input/single-output
chunks with shape-preserving boundaries, no stateful ops (BN running
stats), and no tensor from outside the region consumed inside it (other
than the boundary activation). Dropout inside the region draws the
serial step's masks on each microbatch's rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.layer import Layer, _hashable
from ..ffconst import OperatorType

__all__ = ["PipelineRegion", "assign_tp_roles", "find_pipeline_region",
           "find_ragged_pipeline_region", "layer_signature",
           "region_entry_transition", "region_exit_transition"]


def layer_signature(layer: Layer) -> Tuple:
    """Structural identity of a layer for repeated-block detection:
    op type + params + input/output shapes/dtypes (not names/guids)."""
    return (layer.op_type, _hashable(layer.params),
            tuple(t.shape for t in layer.inputs),
            tuple(t.dtype for t in layer.inputs),
            tuple(t.shape for t in layer.outputs))


@dataclasses.dataclass
class PipelineRegion:
    """A lowered pipeline region inside a layer program."""
    start: int                  # first region layer index in the program
    end: int                    # exclusive
    n_stages: int
    n_microbatches: int
    entry_guid: int             # activation entering stage 0
    exit_guid: int              # activation leaving stage n_stages-1
    template: List[Layer]       # chunk 0's layers (the chunk program)
    template_entry_guid: int
    # for global chunk c (= stage + k*n_stages under the interleaved
    # schedule; == stage when n_chunks == 1), layer j corresponds to
    # template[j]; stage_layer_names[c][j] is its original layer name,
    # used to initialize per-chunk weights before stacking
    stage_layer_names: List[List[str]]
    # interleaved (circular) schedule: chunks per stage. 1 = plain GPipe;
    # v > 1 splits the region into v*S chunks, device s owning chunks
    # {s + k*S} — the template then describes ONE CHUNK, not one stage.
    n_chunks: int = 1
    # mesh binding, filled in by parallel.presets.pipeline_strategy
    pp_axis: Optional[str] = None
    dp_axes: Tuple[str, ...] = ()
    # tensor parallelism INSIDE each stage (Megatron-style, composed with
    # dp x pp — the reference composes per-op machine views the same way,
    # substitution.cc:1898): template layer name -> "attn" | "col" | "row".
    # "attn": heads sharded over tp_axis, one psum after the out-proj;
    # "col"/"row": paired Linears (col shards the output dim, row shards
    # the input dim, one psum after row). None when tp is off.
    tp_axis: Optional[str] = None
    tp_roles: Dict[str, str] = dataclasses.field(default_factory=dict)
    # ---- ragged schedule (gpipe_ragged) ----
    # per-stage block counts (sum = number of region blocks); None =
    # uniform schedule. With counts set, the template describes ONE
    # BLOCK and stage s applies counts[s] of them per step (padded to
    # max(counts) and masked).
    counts: Optional[Tuple[int, ...]] = None
    # layers absorbed INTO stage 0 / stage S-1 (embedding prologue /
    # LM-head epilogue) — they execute inside the pipelined shard_map
    # instead of running replicated outside the region
    prologue: List[Layer] = dataclasses.field(default_factory=list)
    epilogue: List[Layer] = dataclasses.field(default_factory=list)
    # graph-input tensors the prologue consumes (microbatched raw feed)
    prologue_inputs: List[Any] = dataclasses.field(default_factory=list)
    # tensor guid the epilogue produces (the region's overall output;
    # == exit_guid when there is no epilogue)
    epilogue_exit_guid: Optional[int] = None
    # the tensor entering each chunk (uniform) or block (ragged) of the
    # run, in order: where the port's stages read a chunk's input
    chunk_entries: List[int] = dataclasses.field(default_factory=list)

    @property
    def is_ragged(self) -> bool:
        return self.counts is not None

    @property
    def region_out_guid(self) -> int:
        """guid of the tensor the pipelined apply produces overall."""
        return self.epilogue_exit_guid if self.epilogue \
            else self.exit_guid

    @property
    def template_exit_guid(self) -> int:
        return self.template[-1].outputs[0].guid

    @property
    def layers_per_stage(self) -> int:
        return len(self.template)

    def param_name(self, template_layer: Layer) -> str:
        """Key of the stacked parameter subtree in the params pytree."""
        return f"pp::{template_layer.name}"

    # ---- the stacked leaves' layout: one place for every reader ----
    # A template layer's weight is one leaf over all blocks of the run:
    # (S, ...) under GPipe, block c at [c]; (v, S, ...) under the
    # interleaved schedule, chunk c at [c // S, c % S] (stage s owns
    # column s); (S, cmax, ...) under the ragged one, stage s's i-th
    # block at [s, i], slots past counts[s] zero. The stage dim is the
    # one sharded over the pp axis.
    @property
    def stage_dim(self) -> int:
        return 1 if self.counts is None and self.n_chunks > 1 else 0

    def block_index(self, b: int) -> Tuple[int, ...]:
        """Where block ``b`` of the run (``stage_layer_names[b]``) lies in
        a stacked leaf."""
        if self.counts is not None:
            for s, c in enumerate(self.counts):
                if b < c:
                    return (s, b)
                b -= c
            raise IndexError("block past the ragged run")
        if self.n_chunks > 1:
            return (b // self.n_stages, b % self.n_stages)
        return (b,)

    def local_index(self, k: int, i: int = 0) -> Tuple[int, ...]:
        """Where chunk slot ``k`` (uniform) or block slot ``i`` (ragged)
        lies in a rank's own block of a stacked leaf (its stage dim cut
        to 1)."""
        if self.counts is not None:
            return (0, i)
        return (k, 0) if self.n_chunks > 1 else (0,)

    def stack_blocks(self, blocks: Sequence[Any]):
        """One stacked leaf from each block's weight (torch tensors, in
        run order)."""
        import torch
        if self.counts is None:
            out = torch.stack(list(blocks))
            return out.reshape((self.n_chunks, self.n_stages)
                               + tuple(out.shape[1:])) \
                if self.n_chunks > 1 else out
        out = blocks[0].new_zeros((self.n_stages, max(self.counts))
                                  + tuple(blocks[0].shape))
        for b, w in enumerate(blocks):
            out[self.block_index(b)] = w
        return out

    def unstack_blocks(self, leaf) -> List[Any]:
        """Each block's weight from a whole stacked leaf, in run order."""
        return [leaf[self.block_index(b)]
                for b in range(len(self.stage_layer_names))]


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


def _chunks_isomorphic(a: Sequence[Layer], b: Sequence[Layer],
                       a_entry: int, b_entry: int) -> bool:
    """Do chunks a and b compute the same function of their entry tensor?
    Layer-wise signature equality + input-wiring isomorphism."""
    guid_map = {a_entry: b_entry}
    for la, lb in zip(a, b):
        if layer_signature(la) != layer_signature(lb):
            return False
        if len(la.inputs) != len(lb.inputs) or \
                len(la.outputs) != len(lb.outputs):
            return False
        for ta, tb in zip(la.inputs, lb.inputs):
            if guid_map.get(ta.guid) != tb.guid:
                return False
        for ta, tb in zip(la.outputs, lb.outputs):
            guid_map[ta.guid] = tb.guid
    return True


def _has_state(layer: Layer) -> bool:
    from ..ops import get_op_def
    op = get_op_def(layer.op_type)
    state_spec = getattr(op, "state_spec", None)
    if state_spec is None:
        return False
    ss = state_spec(layer.params, [t.shape for t in layer.inputs],
                    [t.dtype for t in layer.inputs])
    return bool(ss)


def find_pipeline_region(layers: Sequence[Layer], n_stages: int,
                         n_microbatches: int = 0, n_chunks: int = 1
                         ) -> Optional[PipelineRegion]:
    """Find the maximal run of identical single-input/single-output chunks
    divisible into ``n_stages`` stages (x ``n_chunks`` chunks per stage
    for the interleaved schedule). Returns None when the graph has no
    such region (the caller falls back to non-pipelined execution)."""
    layers = list(layers)
    n_parts = n_stages * max(n_chunks, 1)   # total chunk count to divide by
    best = find_repeated_run(layers, n_parts)
    if best is None:
        return None
    total, start, unit = best
    reps = total // unit
    per_chunk = (reps // n_parts) * unit
    end = start + total
    region = layers[start:end]
    # chunk boundaries must each cross exactly one tensor
    boundaries = chunk_boundaries(layers, start, per_chunk, n_parts)
    if boundaries is None:
        return None
    entry = boundaries[0]
    exit_guid = region[-1].outputs[0].guid
    # chunk shape preservation: entry and exit tensors of each chunk match
    by_guid = {t.guid: t for l in layers for t in l.outputs}
    for l in layers:
        for t in l.inputs:
            by_guid.setdefault(t.guid, t)
    shapes = {tuple(by_guid[g].shape) for g in boundaries + [exit_guid]
              if g in by_guid}
    if len(shapes) != 1:
        return None
    # chunks must be isomorphic to chunk 0 and stateless
    template = region[:per_chunk]
    if any(_has_state(l) for l in template):
        return None
    for c in range(1, n_parts):
        chunk = region[c * per_chunk:(c + 1) * per_chunk]
        if not _chunks_isomorphic(template, chunk, boundaries[0],
                                  boundaries[c]):
            return None
    if n_microbatches <= 0:
        n_microbatches = 2 * n_stages
    elif max(n_chunks, 1) > 1 and n_microbatches % n_stages:
        # the circular schedule's round-robin needs M % S == 0; a
        # user-chosen M that violates it must fail loudly here, not at
        # the executor's batch-divisibility assert with a rounded M
        raise ValueError(
            f"interleaved schedule (n_chunks={n_chunks}) requires "
            f"n_microbatches % n_stages == 0, got M={n_microbatches} "
            f"S={n_stages}")
    return PipelineRegion(
        start=start, end=end, n_stages=n_stages,
        n_microbatches=n_microbatches, n_chunks=max(n_chunks, 1),
        entry_guid=entry,
        exit_guid=exit_guid, template=list(template),
        template_entry_guid=boundaries[0],
        stage_layer_names=[
            [l.name for l in region[c * per_chunk:(c + 1) * per_chunk]]
            for c in range(n_parts)],
        chunk_entries=list(boundaries))


def _absorbable_prologue(layers: Sequence[Layer], start: int, end: int,
                         entry_guid: int, entry_batch: int):
    """Can ``layers[:start]`` move inside stage 0? Yes iff every
    pre-layer input is a graph input whose leading dim IS the batch dim
    (``entry_batch`` — so microbatch slicing is meaningful) or
    pre-produced, nothing pre-produced is consumed at/after ``end``
    except via the region, the single region crossing is
    ``entry_guid``, and nothing is stateful. Returns
    ``(prologue_layers, raw_input_tensors)`` or ``(None, None)``."""
    pre = list(layers[:start])
    if not pre:
        return None, None
    produced = {t.guid for l in pre for t in l.outputs}
    raw_inputs = {}
    for l in pre:
        if _has_state(l):
            return None, None
        for t in l.inputs:
            if t.guid in produced:
                continue
            if t.owner_layer is not None:
                return None, None       # fed by a non-pre layer
            if not t.shape or t.get_tensor() is not None:
                return None, None       # const / shapeless: not feedable
            if t.shape[0] != entry_batch:
                # non-batch-led input (shared mask, (T,) positions):
                # microbatch slicing would silently hand each microbatch
                # 1/M of it — not absorbable
                return None, None
            raw_inputs[t.guid] = t
    # pre outputs consumed outside the region (post layers)?
    for l in layers[end:]:
        for t in l.inputs:
            if t.guid in produced:
                return None, None
    # region must consume exactly the entry from pre
    crossing = {t.guid for l in layers[start:end] for t in l.inputs
                if t.guid in produced}
    if crossing != {entry_guid}:
        return None, None
    # every pre output must be consumed by pre or the region: an
    # unconsumed pre tensor may be a graph OUTPUT (hidden-state export),
    # and absorbing its producer would strand it at trace time
    consumed = {t.guid for l in layers for t in l.inputs}
    for g in produced:
        if g not in consumed:
            return None, None
    return pre, list(raw_inputs.values())


def _absorbable_epilogue(layers: Sequence[Layer], end: int,
                         exit_guid: int, final_output_guid: int):
    """Maximal prefix of ``layers[end:]`` forming a chain off the region
    exit: each layer consumes only ``exit_guid`` or earlier epilogue
    outputs, is stateless, and produces one output. The final softmax is
    left OUTSIDE when it produces the graph output (so the executor's
    CE-on-logits fusion still sees the pre-softmax logits). Returns
    ``(epilogue_layers, epilogue_exit_guid)`` (possibly ``([], None)``)."""
    post = list(layers[end:])
    avail = {exit_guid}
    chain: List[Layer] = []
    out_guid = None
    for l in post:
        if _has_state(l) or len(l.outputs) != 1:
            break
        if not all(t.guid in avail for t in l.inputs):
            break
        g = l.outputs[0].guid
        if l.op_type == OperatorType.OP_SOFTMAX \
                and g == final_output_guid:
            break               # keep the CE-fusion producer outside
        chain.append(l)
        avail.add(g)
        out_guid = g
    if not chain:
        return [], None
    # the chain must hand exactly ONE tensor to whatever follows
    chain_guids = {l.outputs[0].guid for l in chain}
    consumed_later = set()
    for l in post[len(chain):]:
        for t in l.inputs:
            if t.guid in chain_guids:
                consumed_later.add(t.guid)
    if len(consumed_later) > 1:
        return [], None
    if consumed_later:
        out_guid = next(iter(consumed_later))
        # drop trailing chain layers past the handed-off tensor
        keep: List[Layer] = []
        for l in chain:
            keep.append(l)
            if l.outputs[0].guid == out_guid:
                break
        chain = keep
    # nothing after the absorbed chain may read a tensor the epilogue
    # swallowed: the executor exports ONLY out_guid from the region, so
    # any later read of exit_guid or an interior chain output would
    # KeyError at trace time — bail instead of absorbing
    internal = ({exit_guid} | {l.outputs[0].guid for l in chain}) \
        - {out_guid}
    for l in post[len(chain):]:
        for t in l.inputs:
            if t.guid in internal:
                return [], None
    # and every swallowed tensor must be consumed INSIDE the chain: an
    # unconsumed interior tensor may be a graph output (e.g. a
    # hidden-states export in a multi-output program) that tracing
    # would then fail to find in env
    chain_consumed = {t.guid for l in chain for t in l.inputs}
    for g in internal:
        if g not in chain_consumed:
            return [], None
    return chain, out_guid


def find_ragged_pipeline_region(layers: Sequence[Layer], n_stages: int,
                                n_microbatches: int = 0
                                ) -> Optional[PipelineRegion]:
    """Ragged variant of ``find_pipeline_region``: per-stage block
    counts may differ (no ``reps % n_stages`` requirement) and the
    layers before/after the repeated run are absorbed into stage 0 /
    stage S-1 when structurally possible (embedding and LM head
    pipelined end-to-end). Plain GPipe schedule only (no interleaving,
    no in-stage tp in v1)."""
    layers = list(layers)
    run = find_repeated_run(layers, 1)
    if run is None:
        return None
    total, start, unit = run
    reps = total // unit
    if reps < n_stages:
        return None
    end = start + total
    region = layers[start:end]
    boundaries = chunk_boundaries(layers, start, unit, reps)
    if boundaries is None:
        return None
    entry = boundaries[0]
    exit_guid = region[-1].outputs[0].guid
    by_guid = {t.guid: t for l in layers for t in l.outputs}
    for l in layers:
        for t in l.inputs:
            by_guid.setdefault(t.guid, t)
    shapes = {tuple(by_guid[g].shape) for g in boundaries + [exit_guid]
              if g in by_guid}
    if len(shapes) != 1:
        return None
    template = region[:unit]
    if any(_has_state(l) for l in template):
        return None
    for c in range(1, reps):
        chunk = region[c * unit:(c + 1) * unit]
        if not _chunks_isomorphic(template, chunk, boundaries[0],
                                  boundaries[c]):
            return None
    # ragged counts: extras go to interior stages (stage 0 carries the
    # prologue, stage S-1 the epilogue)
    base, extra = divmod(reps, n_stages)
    counts = [base] * n_stages
    order = list(range(1, n_stages - 1)) + [0, n_stages - 1] \
        if n_stages > 2 else list(range(n_stages))
    for i in range(extra):
        counts[order[i % len(order)]] += 1
    final_out = layers[-1].outputs[0].guid if layers else -1
    entry_batch = next(iter(shapes))[0] if shapes else 0
    prologue, pro_inputs = _absorbable_prologue(layers, start, end, entry,
                                                entry_batch)
    epilogue, epi_out = _absorbable_epilogue(layers, end, exit_guid,
                                             final_out)
    if n_microbatches <= 0:
        n_microbatches = 2 * n_stages
    return PipelineRegion(
        start=start, end=end, n_stages=n_stages,
        n_microbatches=n_microbatches, n_chunks=1,
        entry_guid=entry, exit_guid=exit_guid,
        template=list(template), template_entry_guid=boundaries[0],
        stage_layer_names=[
            [l.name for l in region[c * unit:(c + 1) * unit]]
            for c in range(reps)],
        counts=tuple(counts),
        prologue=list(prologue or []),
        epilogue=list(epilogue or []),
        prologue_inputs=list(pro_inputs or []),
        epilogue_exit_guid=epi_out,
        chunk_entries=list(boundaries))


def assign_tp_roles(template: Sequence[Layer], tp: int
                    ) -> Dict[str, str]:
    """Megatron-style tensor-parallel roles for a stage template:

    - every causal/bidirectional OP_MULTIHEAD_ATTENTION whose head count
      divides by ``tp`` -> "attn" (wq/wk/wv column-split over heads,
      wo row-split, one psum after the output projection);
    - every Linear pair d1 -> d2 where d2 consumes ONLY d1's output,
      d1's output feeds ONLY d2, d2 has no activation, and the shared
      hidden dim (d1's out_dim = d2's contraction dim) divides by
      ``tp`` -> d1 "col", d2 "row" (one psum after d2).

    Returns {} when the template has no tp-able structure (the caller
    treats tp > 1 as an error then). Layers without a role run fully
    replicated over the tp axis — correct for elementwise/norm layers
    whose activations are replicated between the psum points.
    """
    roles: Dict[str, str] = {}
    consumers: Dict[int, List[Layer]] = {}
    for l in template:
        for t in l.inputs:
            consumers.setdefault(t.guid, []).append(l)
    from ..ffconst import ActiMode
    for l in template:
        if l.op_type == OperatorType.OP_MULTIHEAD_ATTENTION:
            kvh = l.params.get("num_kv_heads", 0) \
                or l.params["num_heads"]
            if l.params["num_heads"] % tp == 0 and kvh % tp == 0:
                roles[l.name] = "attn"
        elif l.op_type == OperatorType.OP_LINEAR \
                and l.name not in roles:
            out = l.outputs[0]
            cons = consumers.get(out.guid, [])
            if len(cons) == 1 \
                    and cons[0].op_type == OperatorType.OP_LINEAR \
                    and cons[0].name not in roles:
                d2 = cons[0]
                d2_act = d2.params.get("activation", ActiMode.AC_MODE_NONE)
                if (d2.inputs[0].guid == out.guid
                        and d2_act == ActiMode.AC_MODE_NONE
                        and l.params["out_dim"] % tp == 0):
                    roles[l.name] = "col"
                    roles[d2.name] = "row"
    return roles


def find_repeated_run(layers: Sequence[Layer], n_parts: int = 1
                      ) -> Optional[Tuple[int, int, int]]:
    """The maximal verified run of identical consecutive chunks whose
    repeat count is divisible by ``n_parts``. Returns
    ``(total_len, start, unit)`` or None. Shared by the pipeline region
    finder and the block-rematerialization pass."""
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
    or None if any boundary crosses more than one tensor. Shared by the
    pipeline region finder and the block-rematerialization pass."""
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


# ---------------------------------------------------------------------------
# region-boundary layout transitions
# ---------------------------------------------------------------------------

def _dims(mesh, names) -> List[int]:
    order = list(mesh.mesh_dim_names)
    return [order.index(a) for a in names]


def region_entry_transition(x, region, mesh):
    """The activation entering the region (a DTensor over ``mesh``) as
    this rank's plain block: its rows of the batch over the dp axes,
    whole over the others. The JAX package gathers the entry to
    replicated and slices each microbatch's rows over dp; the port keeps
    each dp rank's own contiguous rows and cuts them into microbatches,
    which changes which rows share a microbatch and nothing else (the
    step's loss is a mean over every row, and the dropout masks are keyed
    by global row). The result stays in the autograd graph: its
    cotangent must be the same on every rank of the pp and tp axes."""
    from torch.distributed.tensor import Replicate, Shard
    dp = set(_dims(mesh, region.dp_axes))
    pl = [Shard(0) if d in dp else Replicate() for d in range(mesh.ndim)]
    if tuple(x.placements) != tuple(pl):
        x = x.redistribute(mesh, pl)
    return x.to_local()


def region_exit_transition(y, region, mesh, global_shape):
    """The region's output, ``y`` this rank's dp rows (the real values on
    the last stage's first tp rank, zeros on every other rank of the pp
    and tp axes), as a DTensor over ``mesh``: summed over the pp and tp
    axes (one all-reduce, exact, since one rank contributes) and laid out
    by rows over the dp axes. Returns ``(dtensor, leaf)``: the local leaf
    whose ``.grad`` receives the cotangent of the output after the
    backward of the layers past the region."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from .distributed import mesh_group
    from .local_ops import from_local
    dp = set(_dims(mesh, region.dp_axes))
    rest = [d for d in range(mesh.ndim) if d not in dp]
    y = y.detach().contiguous()
    if rest:
        dist.all_reduce(y, group=mesh_group(mesh, rest)[0])
    leaf = y.requires_grad_(True)
    pl = [Shard(0) if d in dp else Replicate() for d in range(mesh.ndim)]
    return from_local(leaf, mesh, pl, tuple(global_shape)), leaf
