"""The port's world of ranks on the CPU: rendezvous, placement of host
arrays, planned layout transitions, the parallel ops and products on
each rank's block, against numpy; the planner's step sequences and the
flash dropout hash's global indices against the JAX package.

Two worlds are launched (``tests/_torch_world.py``): two ranks on a mesh
(2,) with gloo's own functional all-gather, and four ranks on a mesh
(2, 2) with the one that ranks sharing one card take (the c10d
all-gather registered as the functional op's kernel,
``use_c10d_gather``).
"""
import importlib

import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import dropout_keep_mask as jax_keep_mask
from flexflow_tpu.parallel import reshard as jrs
from flexflow_tpu.parallel.machine import DeviceMesh as JaxDeviceMesh
from flexflow_tpu.parallel.machine import MachineSpec as JaxMachineSpec
from flexflow_tpu_torch.parallel import reshard as prs
from flexflow_tpu_torch.parallel.machine import DeviceMesh, MachineSpec
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.parallel.strategy import (ShardingStrategy,
                                                  spec_placements)

from _torch_world import run_world

fa = importlib.import_module("flexflow_tpu_torch.kernels.flash_attention")

RNG = np.random.default_rng(7)
A = RNG.standard_normal((8, 4, 6)).astype(np.float32)
W = RNG.standard_normal((8, 4, 6)).astype(np.float32)
MA = RNG.standard_normal((4, 6, 8)).astype(np.float32)
MB2 = RNG.standard_normal((8, 4)).astype(np.float32)
MB3 = RNG.standard_normal((4, 8, 2)).astype(np.float32)
MG2 = RNG.standard_normal((4, 6, 4)).astype(np.float32)
MG3 = RNG.standard_normal((4, 6, 2)).astype(np.float32)

# (name, spec) for a mesh (2,) and (2, 2)
SPECS = {(2,): {"rows": ("x0",), "cols": (None, "x0"), "rep": ()},
         (2, 2): {"rows": ("x0",), "rows2": (("x0", "x1"),),
                  "rows_cols": ("x0", None, "x1"), "rep": ()}}
PAIRS = {(2,): [((), ("x0",)), (("x0",), ()), (("x0",), (None, "x0")),
                ((None, "x0"), (None, None, "x0"))],
         (2, 2): [((), ("x0", None, "x1")), (("x0", None, "x1"), ()),
                  (("x0",), (None, "x0")), ((("x0", "x1"),), ("x0", "x1")),
                  (("x0", None, "x1"), (None, "x1", "x0")),
                  ((None, "x0"), (("x0", "x1"),))]}
OPS = {(2,): [("OP_REPARTITION", (), ("x0",)),
              ("OP_COMBINE", ("x0",), ()),
              ("OP_REPLICATE", ("x0",), ()),
              ("OP_REDUCTION", None, ("x0",)),
              ("OP_ALLTOALL", ("x0",), (None, "x0")),
              ("OP_FUSED_PARALLEL", (None, "x0"), ("x0",)),
              ("OP_PIPELINE", ("x0",), ("x0",))],
       (2, 2): [("OP_REPARTITION", (), ("x0", "x1")),
                ("OP_COMBINE", ("x0", "x1"), ()),
                ("OP_REPLICATE", ("x0",), ()),
                ("OP_REDUCTION", None, (None, "x1")),
                ("OP_ALLTOALL", ("x0", "x1"), ("x1", "x0")),
                ("OP_FUSED_PARALLEL", (("x0", "x1"),), (None, None, "x0")),
                ("OP_PIPELINE", ("x1",), ("x1",))]}
# (a placements, b placements) per mesh dim of the products a @ b:
# "R", "P" (Partial) or a sharded dim; 2-D b (k, n) then batched b
MM = {(2,): [(("0",), ("R",)), (("2",), ("0",)), (("R",), ("1",)),
             (("P",), ("R",)), (("1",), ("1",)), (("R",), ("P",))],
      (2, 2): [(("0", "2"), ("R", "0")), (("1", "R"), ("R", "1")),
               (("P", "0"), ("R", "R")), (("2", "2"), ("0", "0"))]}
MM3 = {(2,): [(("0",), ("0",)), (("1",), ("R",)), (("R",), ("2",)),
              (("2",), ("1",))],
       (2, 2): [(("0", "2"), ("0", "1"))]}


def _spec_block(arr, spec, mesh_shape, coord):
    """The block of ``arr`` a rank at ``coord`` holds under ``spec``
    (numpy, mesh axes x0, x1 ... in order, major first)."""
    names = [f"x{i}" for i in range(len(mesh_shape))]
    idx = []
    for d in range(arr.ndim):
        e = tuple(spec)[d] if d < len(tuple(spec)) else None
        axes = [] if e is None else [e] if isinstance(e, str) else list(e)
        lo, n = 0, arr.shape[d]
        for a in axes:
            m = names.index(a)
            n //= mesh_shape[m]
            lo += coord[m] * n
        idx.append(slice(lo, lo + n))
    return arr[tuple(idx)]


def _payload(mesh_shape, tmp_path):
    return {"mesh": mesh_shape, "A": A, "W": W, "cache": str(tmp_path),
            "specs": SPECS[mesh_shape], "pairs": PAIRS[mesh_shape],
            "ops": OPS[mesh_shape],
            "mm": [(MA, MB2, MG2, pa, pb) for pa, pb in MM[mesh_shape]]
            + [(MA, MB3, MG3, pa, pb) for pa, pb in MM3[mesh_shape]]}


_WORLDS = {}


def _world(mesh_shape, tmp_path_factory):
    """Both worlds' results, each launched once for the whole file."""
    if mesh_shape not in _WORLDS:
        n = int(np.prod(mesh_shape))
        payload = _payload(mesh_shape, tmp_path_factory.mktemp("plans"))
        payload["c10d_gather"] = n == 4
        _WORLDS[mesh_shape] = run_world("placement", n, payload)
    return _WORLDS[mesh_shape]


MESHES = [(2,), (2, 2)]


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_rendezvous_and_routes(mesh_shape, tmp_path_factory):
    ranks = _world(mesh_shape, tmp_path_factory)
    n = int(np.prod(mesh_shape))
    assert [r["rank"] for r in ranks] == list(range(n))
    assert all(r["world"] == n and r["live"] for r in ranks)
    # rank r sits at the row-major coordinate r
    assert [r["coord"] for r in ranks] == [
        list(np.unravel_index(i, mesh_shape)) for i in range(n)]
    gather = "gloo, c10d all_gather_into_tensor for the functional op" \
        if n == 4 else "gloo"
    assert all(r["routes"]["all_gather"] == gather for r in ranks)
    assert all(r["routes"]["all_reduce"] == "gloo" for r in ranks)
    # the registered route carried every functional all-gather of the
    # four-rank world
    assert all((r["functional_gathers"] > 0) == (n == 4) for r in ranks)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_local_row_range_put_global_and_place_host(mesh_shape,
                                                   tmp_path_factory):
    for r in _world(mesh_shape, tmp_path_factory):
        for name, spec in SPECS[mesh_shape].items():
            want = _spec_block(A, spec, mesh_shape, r["coord"])
            rows = _spec_block(np.broadcast_to(
                np.arange(8)[:, None, None], A.shape), spec, mesh_shape,
                r["coord"])
            assert tuple(r["rows"][name]) == (rows.min(), rows.max() + 1)
            whole, mine = r["put"][name]
            np.testing.assert_array_equal(whole, want)
            np.testing.assert_array_equal(mine, want)
            block, placed = r["place"][name]
            np.testing.assert_array_equal(block, want)
            assert placed == 1


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_planned_transitions_hold_numpy_and_the_jax_planner(
        mesh_shape, tmp_path_factory, tmp_path, monkeypatch):
    ranks = _world(mesh_shape, tmp_path_factory)
    monkeypatch.setattr(jrs, "_DEFAULT_DIR", str(tmp_path))
    jmesh = JaxDeviceMesh(JaxMachineSpec.detect(),
                          mesh_shape=mesh_shape + (8 // int(
                              np.prod(mesh_shape)),))
    jplanner = jrs.ReshardPlanner(jmesh, cache_dir=str(tmp_path),
                                  persist=False)
    for i, (src, dst) in enumerate(PAIRS[mesh_shape]):
        want_steps = jplanner.plan(src, dst, A.shape, 4).describe()
        for r in ranks:
            got = r["reshard"][i]
            np.testing.assert_array_equal(
                got["block"], _spec_block(A, dst, mesh_shape, r["coord"]))
            np.testing.assert_array_equal(got["grad"], W,
                                          err_msg=str((src, dst)))
            assert got["steps"] == want_steps, (src, dst)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_the_seven_parallel_ops(mesh_shape, tmp_path_factory):
    for r in _world(mesh_shape, tmp_path_factory):
        for i, (op, src, dst) in enumerate(OPS[mesh_shape]):
            got = r["ops"][i]
            np.testing.assert_allclose(got["whole"], A, rtol=1e-6,
                                       atol=1e-6, err_msg=op)
            np.testing.assert_allclose(
                got["block"], _spec_block(A, dst, mesh_shape, r["coord"]),
                rtol=1e-6, atol=1e-6, err_msg=op)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_products_on_blocks(mesh_shape, tmp_path_factory):
    """mm_f32 over DTensor operands of every layout pair: the product and
    both gradients against numpy (a Partial operand's value is the sum of
    the ranks' parts)."""
    ranks = _world(mesh_shape, tmp_path_factory)
    cases = [(MB2, MG2, np.einsum("bmk,bmn->kn", MA, MG2))
             for _ in MM[mesh_shape]] + \
        [(MB3, MG3, np.einsum("bmk,bmn->bkn", MA, MG3))
         for _ in MM3[mesh_shape]]
    for r in ranks:
        for i, (mb, mg, db) in enumerate(cases):
            got = r["mm"][i]
            np.testing.assert_allclose(got["whole"], MA @ mb, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got["grads"][0],
                                       mg @ np.swapaxes(mb, -1, -2),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["grads"][1], db, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_naive_reshard_counters_and_collective_rows(mesh_shape,
                                                    tmp_path_factory):
    ranks = _world(mesh_shape, tmp_path_factory)
    n = int(np.prod(mesh_shape))
    src, dst = PAIRS[mesh_shape][0]
    for r in ranks:
        np.testing.assert_array_equal(
            r["naive"]["block"], _spec_block(A, dst, mesh_shape, r["coord"]))
        assert r["naive"]["counted"] == 1
        assert any(m.startswith('ff_reshard_plans_total{kind="naive"}')
                   for m in r["naive"]["metrics"])
        assert any(m.startswith("ff_reshard_bytes_total")
                   for m in r["naive"]["metrics"])
        c = r["calib"]
        assert c["backend"] == "cpu+gloo"
        # the host's dispatch and bandwidth rows, then 4 collectives x 2
        # sizes at each degree: the first axis's and (on 4 ranks) the
        # world's; the second pass measures nothing
        degrees = sorted({mesh_shape[0], n})
        assert c["measured"] == 2 + 4 * 2 * len(degrees)
        assert c["again"] == 0
        assert {int(k.rsplit("|", 1)[1]) for k in c["keys"]} == \
            set(degrees)
        assert all(k.startswith("cpu+gloo|coll_") for k in c["keys"])
        assert c["all_reduce_4k"] > 0


def _specs(st, layers):
    """A strategy's inputs and per-layer (outputs, weights) specs as
    tuples, layers paired by position."""
    def t(spec):
        return None if spec is None else tuple(spec)
    return ({k: t(v) for k, v in st.inputs.items()},
            [([t(o) for o in st.ops[l.name].outputs],
              {w: t(v) for w, v in st.ops[l.name].weights.items()})
             if l.name in st.ops else None for l in layers])


@pytest.mark.parametrize("graph,preset,sp", [
    ("bert", "transformer", False), ("bert", "transformer", True),
    ("moe", "expert", False)])
def test_presets_match_jax(graph, preset, sp):
    """The port's presets assign the JAX package's specs, layer by layer,
    on the same graph and mesh axes."""
    import _torch_graphs as graphs
    from flexflow_tpu.parallel import presets as jpresets
    from flexflow_tpu_torch.parallel import presets as tpresets
    if graph == "bert":
        jff, tff = graphs.bert(batch=8, seq=16)
    else:
        def build(ff, m, b):
            m.build_moe_mnist(ff, b, m.MoeConfig.tiny())
        jff, tff = graphs._pair(build, batch=16)
    jm = JaxDeviceMesh(JaxMachineSpec.detect(), mesh_shape=(2, 4))
    tm = DeviceMesh(MachineSpec(num_devices=8, generation="cpu-sim"),
                    mesh_shape=(2, 4))
    outs = []
    for pkg, ff, dm in ((jpresets, jff, jm), (tpresets, tff, tm)):
        if preset == "transformer":
            st = pkg.transformer_strategy(ff.layers, ff.input_tensors, dm,
                                          dp_axes=("x0",), tp_axes=("x1",),
                                          sp=sp)
        else:
            st = pkg.expert_parallel_strategy(ff.layers, ff.input_tensors,
                                              dm, dp_axes=("x0",),
                                              ep_axes=("x1",))
        outs.append(_specs(st, ff.layers))
    assert outs[0] == outs[1]


def test_pipeline_strategy_builds_and_compile_refuses_it():
    """``pipeline_strategy`` finds the repeated blocks and batch-shards the
    rest, with in-stage tp roles where asked; a compile refuses a region
    on one device (the stages run over a world of ranks:
    ``tests/test_torch_pipeline.py``)."""
    import _torch_graphs as graphs
    from flexflow_tpu_torch.parallel.presets import pipeline_strategy
    _, tff = graphs.bert(batch=8, seq=16, layers=4)
    dm = DeviceMesh(MachineSpec(num_devices=4, generation="cpu-sim"),
                    mesh_shape=(2, 2))
    st = pipeline_strategy(tff.layers, tff.graph_inputs or
                           tff.input_tensors, dm, n_stages=2)
    region = st.pipeline
    assert region.n_stages == 2 and region.pp_axis == "x0"
    assert (region.end - region.start) % (2 * region.layers_per_stage) == 0
    inside = {l.name for l in tff.layers[region.start:region.end]}
    assert not inside & set(st.ops)
    with pytest.raises(ValueError, match="no mesh axis of size 3"):
        pipeline_strategy(tff.layers, tff.input_tensors, dm, n_stages=3)
    tp = pipeline_strategy(tff.layers, tff.input_tensors, dm, n_stages=2,
                           tp=2).pipeline
    assert tp.tp_axis == "x1" and sorted(set(tp.tp_roles.values())) == \
        ["attn", "col", "row"]
    # a strategy carrying a region, as a strategy file could
    st = ShardingStrategy(DeviceMesh(MachineSpec(num_devices=1,
                                                 generation="cpu-sim"),
                                     devices=["cpu"]))
    st.pipeline = region
    with pytest.raises(ValueError, match="world of ranks"):
        tff.compile(fft.SGDOptimizer(0.01),
                    "sparse_categorical_crossentropy", [], strategy=st)


def test_spec_placements_and_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    dm = DeviceMesh(MachineSpec(num_devices=4, generation="cpu-sim"),
                    mesh_shape=(2, 2))
    assert dm.described and not dm.live
    assert spec_placements(("x0", None, "x1"), dm, 3) == [Shard(0),
                                                         Shard(2)]
    assert spec_placements((("x0", "x1"),), dm, 2) == [Shard(0), Shard(0)]
    assert spec_placements(None, dm, 2) == [Replicate(), Replicate()]
    with pytest.raises(NotImplementedError, match="mesh order"):
        spec_placements((("x1", "x0"),), dm, 2)


@pytest.mark.parametrize("src,dst", [
    ((), ("x0", "x1")), (("x0",), (None, "x0")),
    (("x0", "x1"), ("x1", "x0")), ((("x0", "x1"), None), (None, "x2")),
    (("x0", None, ("x1", "x2")), (("x2", "x1"), "x0")),
    ((("x0", "x1", "x2"),), ("x2", "x1", "x0"))])
def test_candidate_steps_match_jax(src, dst):
    """The planner's greedy walks and its naive baseline, step for step,
    on a (2, 2, 2) mesh's layouts."""
    rank = 3
    s, d = prs.norm_spec(src, rank), prs.norm_spec(dst, rank)
    for prio in (("alltoall", "slice", "gather"),
                 ("alltoall", "gather", "slice"),
                 ("gather", "slice", "alltoall")):
        got = prs._candidate_steps(s, d, prio)
        want = jrs._candidate_steps(s, d, prio)
        assert (got is None) == (want is None)
        if got is not None:
            assert [x.to_json() for x in got] == [x.to_json() for x in want]
    assert [x.to_json() for x in prs._naive_steps(s, d)] == \
        [x.to_json() for x in jrs._naive_steps(s, d)]


@pytest.mark.parametrize("bh_map", [None, (8, 3, 4), (12, 0, 6),
                                    (4, 5, 0)])
def test_dropout_hash_at_global_indices_matches_the_jax_golden(bh_map):
    """A block of 2 rows and 4 (or fewer) heads placed by ``bh_map`` in a
    batch of 8 rows hashes as those rows and heads of the JAX package's
    whole-batch mask, bit for bit; no map is the whole batch."""
    b, h = 2, 4 if bh_map is None else min(4, bh_map[0] - bh_map[2])
    ht, b0, h0 = (h, 0, 0) if bh_map is None else bh_map
    whole = np.asarray(jax_keep_mask(b0 + b, ht, 24, 40, 0.1, 1234))
    got = fa.dropout_keep_mask(b, h, 24, 40, 0.1, 1234, bh_map=bh_map)
    np.testing.assert_array_equal(got.numpy(),
                                  whole[b0:b0 + b, h0:h0 + h])


def test_flash_block_with_bh_map_is_the_block_of_the_whole():
    """The flash wrapper's plain version on rows 2..3 and heads 4..7 of a
    (4, 8) batch, mapped, equals the whole batch's run cut to the block,
    forward and gradients, at dropout 0.1: a sharded run's masks are the
    one-device run's."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(4, 8, 16, 8, generator=g) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*leaves, dropout_rate=0.1, dropout_seed=77)
    grads = torch.autograd.grad(o, leaves, do)
    blk = (slice(2, 4), slice(4, 8))
    part = [t[blk].clone().requires_grad_() for t in (q, k, v)]
    ob = fa.flash_attention(*part, dropout_rate=0.1, dropout_seed=77,
                            bh_map=(8, 2, 4))
    gb = torch.autograd.grad(ob, part, do[blk])
    torch.testing.assert_close(ob, o[blk], rtol=0, atol=0)
    for got, want in zip(gb, grads):
        torch.testing.assert_close(got, want[blk], rtol=0, atol=0)
    unmapped = fa.flash_attention(*[t.detach() for t in part],
                                  dropout_rate=0.1, dropout_seed=77)
    assert not torch.equal(unmapped, ob.detach())
    with pytest.raises(ValueError, match="does not place"):
        fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=1,
                           bh_map=(4, 0, 2))


def test_no_world_is_configured_by_default(monkeypatch):
    from flexflow_tpu_torch.parallel import distributed as D
    for k in ("FF_COORDINATOR_ADDRESS", "FF_NUM_PROCESSES",
              "FF_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert D.maybe_initialize(device_type="cpu") is False
    assert not D.is_initialized()
    assert D.process_count() == 1 and D.process_index() == 0
    monkeypatch.setenv("FF_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("FF_NUM_PROCESSES", "2")
    monkeypatch.setenv("FF_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="FF_PROCESS_ID"):
        D.maybe_initialize(device_type="cpu")
