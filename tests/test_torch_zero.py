"""The port's ZeRO-1 (``runtime/zero.py``) against the JAX package's.

The shape-level core (``zero_spec``, ``ZeroAssignment``) is compared
with the JAX package's on the same inputs, equal. One world of two gloo
ranks (``tests/_torch_world.py``, mesh (2,)) trains BERT-tiny (f32,
dropout 0) under data parallelism with and without ``--zero``, with Adam
(the fused kernel's plain version) and with SGD momentum, from the JAX
package's weights: the ZeRO runs are bit-equal to the replicated dp-2
runs (weights after 4 steps, loss histories; also with the sync cut
into many small collectives), their moments stay sharded,
and against the JAX package's ``--zero`` run on a mesh of 2 CPU devices
the forward is within 2e-3, the first-step gradients within 1e-5 + 1e-4
relative, the loss histories within 1e-4. An imported per-parameter
assignment shards exactly the leaves it names; ``zero_policy`` memory is
refused, naming ROADMAP queue 1 item 5, and a world's checkpoint of
sharded moments saves (the multi-host format) and restores every weight
and moment block bit for bit.
"""
import json
import random
import types

import numpy as np
import pytest

import flexflow_tpu as ffj
from flexflow_tpu.runtime import zero as jzero
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.runtime import zero as tzero

from _torch_sync import (DP, assert_matches_jax, jax_run, payload_of,
                         same_weights)
from _torch_world import run_world

RUNS = [("dp", DP, "adam", "bert"), ("zero", DP + ["--zero"], "adam", "bert"),
        ("zero_chunked", DP + ["--zero"], "adam", "bert"),
        ("dp_sgd", DP, "sgdm", "bert"),
        ("zero_sgd", DP + ["--shard-optimizer-states"], "sgdm", "bert")]
# the chunked run cuts every reduce-scatter and all-gather at 16 KiB
CHUNK = 16 << 10
_CACHE = {}


def _refs():
    if not _CACHE:
        _CACHE["adam"] = jax_run("bert", ["--zero"], "adam")
        _CACHE["sgdm"] = jax_run("bert", ["--zero"], "sgdm",
                                 what="losses")
    return _CACHE


def _world():
    if "world" not in _CACHE:
        payload = {"bert": payload_of(_refs()["adam"]), "batch": 8,
                   "seq": 16, "runs": RUNS, "assign": ["kernel"],
                   "imports": [("assigned", "dp", [], "zero")],
                   "refuse": [("memory", DP + ["--zero-policy", "memory"])],
                   "save": ["zero"], "chunk_bytes": {"zero_chunked": CHUNK}}
        _CACHE["world"] = run_world("sync", 2, payload)
    return _CACHE["world"]


ZERO_SPEC_CASES = [
    ((), None, {"x0": 2, "x1": 4}),
    ((7, 5), None, {"x0": 2, "x1": 4}),
    ((8, 8), ("x0", "x1"), {"x0": 2, "x1": 4}),
    ((12, 8), None, {"a": 4, "b": 2}),
    ((8, 8), None, {"a": 2}),
    ((4, 8), None, {"a": 2}),
    ((8, 8), (None, "x1"), {"x0": 2, "x1": 4}),
    ((768, 3072), None, {"x0": 2}),
    ((3072,), None, {"x0": 2, "x1": 2}),
]


@pytest.mark.parametrize("shape,wspec,axes", ZERO_SPEC_CASES)
def test_zero_spec_edge_cases_match_jax(shape, wspec, axes):
    want = jzero.zero_spec(shape, wspec, axes)
    got = tzero.zero_spec(shape, wspec, axes)
    assert (got is None) == (want is None)
    if want is not None:
        assert tuple(got) == tuple(want)


def test_zero_spec_random_shapes_match_jax():
    rng = random.Random(7)
    sizes = {"x0": 2, "x1": 2, "x2": 3}
    names = list(sizes)
    for _ in range(300):
        rank = rng.randint(0, 3)
        shape = tuple(rng.choice((1, 2, 3, 4, 6, 7, 12))
                      for _ in range(rank))
        free, wspec = list(names), []
        for _ in range(rank):
            wspec.append(free.pop(rng.randrange(len(free)))
                         if free and rng.random() < 0.4 else None)
        want = jzero.zero_spec(shape, tuple(wspec), sizes)
        got = tzero.zero_spec(shape, tuple(wspec), sizes)
        assert (None if got is None else tuple(got)) == \
            (None if want is None else tuple(want)), (shape, wspec)
        assert tzero.spec_degree(got, sizes) == \
            jzero.spec_degree(want, sizes)


def test_assignment_and_slots_match_jax(tmp_path):
    meta = {"d1": {"kernel": (16, 64), "bias": (64,)},
            "d2": {"kernel": (64, 7), "bias": (7,)}}
    st = types.SimpleNamespace(ops={"d2": types.SimpleNamespace(
        weights={"kernel": (None, "x1")})})
    axes = {"x0": 2, "x1": 4}
    want = jzero.ZeroAssignment.uniform(meta, st, axes)
    got = tzero.ZeroAssignment.uniform(meta, st, axes)
    assert got.to_json() == want.to_json()
    assert got.summary() == want.summary()
    assert got.sharded_params() == want.sharded_params()
    # JSON round trip, and through the port's strategy file
    back = tzero.ZeroAssignment.from_json(json.loads(json.dumps(
        got.to_json())))
    assert back.to_json() == got.to_json() and bool(back)
    from flexflow_tpu_torch.parallel.machine import DeviceMesh, MachineSpec
    from flexflow_tpu_torch.parallel.strategy import ShardingStrategy
    from flexflow_tpu_torch.search.serialization import (load_strategy,
                                                         save_strategy)
    dm = DeviceMesh(MachineSpec(num_devices=8, generation="cpu-sim"),
                    mesh_shape=(2, 4))
    s = ShardingStrategy(dm)
    s.zero = got
    save_strategy(str(tmp_path / "z.json"), s)
    loaded = load_strategy(str(tmp_path / "z.json"), [], dm)
    assert isinstance(loaded.zero, tzero.ZeroAssignment)
    assert loaded.zero.to_json() == want.to_json()
    for opt in (fft.AdamOptimizer(), fft.SGDOptimizer(0.1),
                fft.SGDOptimizer(0.1, momentum=0.9), None):
        jopt = None if opt is None else (
            ffj.AdamOptimizer() if isinstance(opt, fft.AdamOptimizer)
            else ffj.SGDOptimizer(0.1, momentum=opt.momentum))
        assert tzero.opt_slots(opt) == jzero.opt_slots(jopt)


def test_zero_flag_spelling_matches_jax():
    for argv in (["--zero"], ["--shard-optimizer-states"]):
        assert fft.FFConfig.parse_args(argv).shard_optimizer_states
        assert ffj.FFConfig.parse_args(argv).shard_optimizer_states
    assert not fft.FFConfig.parse_args([]).shard_optimizer_states


@pytest.mark.parametrize("opt", ["adam", "sgdm"])
def test_zero_is_bit_equal_to_dp_and_matches_jax(opt):
    runs = _world()
    for rank in runs:
        r = rank["runs"]
        dp, zero = (r["dp"], r["zero"]) if opt == "adam" \
            else (r["dp_sgd"], r["zero_sgd"])
        assert zero["losses"] == dp["losses"]
        same_weights(zero["weights"], dp["weights"])
        # (the SGD run starts from the same weights: its forward and
        # first-step gradients are the Adam reference's)
        ref = dict(_refs()["adam"], losses=_refs()[opt]["losses"])
        assert_matches_jax(zero, ref)
    if opt == "adam":
        # one fused-Adam launch a step on the ZeRO blocks: ceil(40 / 384)
        assert runs[0]["runs"]["zero"]["adam_per_step"] == 1


def test_zero_collectives_in_chunks_are_bit_equal():
    """ZeRO's serial sync cut into runs of at most ``ZERO_CHUNK_BYTES``
    (here 16 KiB: many reduce-scatters and all-gathers a step, a leaf
    above the cap alone) is the one-collective run bit for bit."""
    for rank in _world():
        r = rank["runs"]
        assert r["zero_chunked"]["losses"] == r["zero"]["losses"]
        same_weights(r["zero_chunked"]["weights"], r["zero"]["weights"])
        assert r["zero"]["sync_calls"] == 2
        assert r["zero_chunked"]["sync_calls"] > 10


def test_zero_moments_sharded_and_stay_sharded():
    """After 4 steps each shardable moment holds half its weight on
    each rank; the replicated run's hold all of it."""
    r = _world()[0]["runs"]
    ref = _refs()["adam"]["ff"]
    for name in ("zero", "zero_sgd"):
        slots = r[name]["state_local"]
        assert set(slots) == ({"m", "v"} if name == "zero" else {"v"})
        n = 0
        for key, local in slots["v"].items():
            full = r["dp"]["state_local"]["v"][key]
            if local != full:
                assert np.prod(full) == 2 * np.prod(local), key
                n += 1
        # the checkpoint meta's record names each sharded moment's axis
        doc = r[name]["sharding_doc"]
        assert sum(1 for v in doc.values() if v and "x0" in v) == \
            (2 * n if name == "zero" else n)
        # the JAX package shards the same count of moments
        jn = sum(1 for ws in ref.opt_state["v"].values()
                 for leaf in ws.values()
                 if leaf.addressable_shards[0].data.size < leaf.size)
        assert n == jn and n >= 3


def test_imported_assignment_is_honored():
    imp = _world()[0]["imports"]["assigned"]
    assert imp["sharded"] == imp["assigned"] and imp["assigned"]
    assert all(k.endswith("/kernel") for k in imp["sharded"])
    assert np.isfinite(imp["loss"])


def test_unported_zero_options_are_refused():
    ref = _world()[0]["refused"]
    assert "item 5" in ref["memory"]
    # a ZeRO world's checkpoint is no longer refused: it saves in the
    # multi-host format and restores every weight and moment block
    assert ref["save_zero"] is None
    step, n, differ = _world()[0]["restored_zero"]
    assert step == 4 and n > 0 and differ == 0
    cfg = fft.FFConfig()
    cfg.device, cfg.pipeline_stages = "cpu", 2
    ff = fft.FFModel(cfg)
    x = ff.create_tensor((4, 8), name="x")
    ff.dense(x, 4)
    # a pipeline is ported: on one device its pp 2 mesh does not fit,
    # as in the JAX package
    with pytest.raises(ValueError, match="does not divide 1 devices"):
        ff.compile(fft.SGDOptimizer(0.1), "mean_squared_error", [])
