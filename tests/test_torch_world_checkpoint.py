"""The port's multi-host checkpoint (the two-phase commit, quorum restore,
shard ownership) held against the JAX package's, across worlds of any
size and across the two packages.

A 2-rank gloo world on the CPU (``tests/_torch_world.py``, scenario
``ckpt_world``) saves a ``Shard(0)`` DTensor, a bf16 one, a replicated one
and a plain scalar, and an MLP trained under ``--zero`` (replicated
weights, ``Shard(dim)`` Adam moments); each replicated block is written
once, by rank 0. The JAX package's ``CheckpointManager`` restores both
steps in this process and must find the same arrays; a 2-rank step
restores onto one rank and a 1-rank step onto two, bit-equal. The torn
drill (``crash_after_stage@2:1``: rank 1 dies between staging and the
commit) leaves ``tmp-2`` as debris while rank 0 exits the detector code
within its barrier bound, and a fresh world quorum-restores step 1;
``corrupt_shard@2:1`` makes the quorum fall back past step 2. A 2-process
JAX world's checkpoint (``tests/_torn_ckpt_worker.py``) restores in the
port.
"""
import json
import os
import sys
import time

import numpy as np
import pytest

import flexflow_tpu.runtime.checkpoint as jax_ckpt
import flexflow_tpu_torch.runtime.checkpoint as ckpt
from flexflow_tpu_torch.resilience.coord import EXIT_RANK_FAILURE
from flexflow_tpu_torch.resilience.faults import RANK_CRASH_EXIT

sys.path.insert(0, os.path.dirname(__file__))
from _torch_world import (ckpt_state, host_state, mlp_data,  # noqa: E402
                          mlp_model, run_world, run_world_raw)

#: tight bounds: a torn save must fail in seconds, not minutes (the JAX
#: package's torn-checkpoint worker's, with room for a loaded machine)
DRILL_ENV = {"FF_HB_INTERVAL_S": "0.1", "FF_HB_TIMEOUT_S": "5",
             "FF_BARRIER_TIMEOUT_S": "12"}


def _bf16(a) -> np.ndarray:
    """A bf16 array of either package (ml_dtypes, or the port's uint16
    payload) as float32."""
    import torch
    a = np.asarray(a)
    if a.dtype != np.uint16:
        a = a.view(np.uint16)
    return torch.from_numpy(a.view(np.int16)).view(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize("mod", [ckpt, jax_ckpt],
                         ids=["torch", "jax"])
def test_assemble_blocks_refuses_missing_coverage(mod):
    full = mod.ShardBlocks((4, 2), "float32",
                           [([[0, 2], [0, 2]], np.ones((2, 2), np.float32)),
                            ([[2, 4], [0, 2]],
                             2 * np.ones((2, 2), np.float32))])
    out = mod._assemble_blocks([full])
    assert out.shape == (4, 2) and out[0, 0] == 1.0 and out[3, 0] == 2.0
    torn = mod.ShardBlocks((4, 2), "float32",
                           [([[0, 2], [0, 2]], np.ones((2, 2), np.float32))])
    with pytest.raises(mod.CheckpointCorruption, match="missing shard"):
        mod._assemble_blocks([torn])


# ======================================================================
# one world: the format, ZeRO, and both directions of a world resize
# ======================================================================
_WORLD = {}


def _world(tmp_path_factory):
    """The ``ckpt_world`` scenario's results (launched once), with the
    one-rank MLP's state that it restored."""
    if not _WORLD:
        d = tmp_path_factory.mktemp("world_ckpt")
        one = mlp_model(["--only-data-parallel"], seed=3)
        xs, ys = mlp_data()
        one.fit(xs[:16], ys[:16], epochs=1, verbose=False)
        one.save_checkpoint(str(d / "single"))
        _WORLD.update(dir=d, single=host_state(one),
                      ranks=run_world("ckpt_world", 2, {
                          "dir": str(d), "single": str(d / "single")}))
    return _WORLD


def test_each_block_is_written_once(tmp_path_factory):
    ranks = _world(tmp_path_factory)["ranks"]
    b0, b1 = ranks[0]["blocks"], ranks[1]["blocks"]
    assert b0["w"] == [[[0, 4], [0, 4]]] and b1["w"] == [[[4, 8], [0, 4]]]
    assert b0["h"] == [[[0, 2], [0, 2]]] and b1["h"] == [[[2, 4], [0, 2]]]
    # the replicated leaf and the plain scalar: rank 0 alone
    assert b0["r"] == [[[0, 3]]] and b1["r"] == []
    assert b0["bias"] == [[]] and b1["bias"] == []
    # ZeRO: the weights are replicated (rank 0 writes them), each
    # moment is split between the ranks along its ZeRO dim
    z0, z1 = ranks[0]["zero_blocks"], ranks[1]["zero_blocks"]
    places = ranks[0]["zero_placements"]
    sharded = [k for k, v in places.items() if "Shard" in v]
    assert sharded and all(k.startswith("m/") for k in sharded)
    for key, blocks in z0.items():
        if key.startswith("params/"):
            assert len(blocks) == 1 and z1[key] == []
        elif f"m/{key.split('/', 2)[2]}" in sharded:
            assert len(blocks) == 1 and len(z1[key]) == 1
            assert blocks != z1[key]
    meta = ranks[0]["zero_meta"]
    assert meta["world_size"] == 2 and meta["strategy_ops"] >= 3
    assert any(v is not None for v in meta["opt_shardings"].values())


def test_quorum_restore_assembles_every_rank(tmp_path_factory):
    want = ckpt_state(2)
    for r in _world(tmp_path_factory)["ranks"]:
        step, tag, world, st = r["restored"]
        assert (step, tag, world) == (2, "two", 2)
        np.testing.assert_array_equal(st["w"], want["w"])
        np.testing.assert_array_equal(st["r"], want["r"])
        np.testing.assert_array_equal(_bf16(st["h"]), want["h"].float())
        assert st["bias"] == want["bias"]


def test_jax_restores_the_port_world_checkpoint(tmp_path_factory):
    w = _world(tmp_path_factory)
    state, meta = jax_ckpt.CheckpointManager(
        str(w["dir"] / "plain")).restore()
    want = ckpt_state(2)
    assert meta["step"] == 2 and meta["tag"] == "two"
    np.testing.assert_array_equal(np.asarray(state["w"]), want["w"])
    np.testing.assert_array_equal(np.asarray(state["r"]), want["r"])
    assert str(np.asarray(state["h"]).dtype) == "bfloat16"
    np.testing.assert_array_equal(_bf16(state["h"]), want["h"].float())
    zstate, zmeta = jax_ckpt.CheckpointManager(
        str(w["dir"] / "zero")).restore()
    saved = w["ranks"][0]["zero_state"]
    assert zmeta["step"] == 2
    for ln, ws in saved["params"].items():
        for wn, a in ws.items():
            np.testing.assert_array_equal(
                np.asarray(zstate["params"][ln][wn]), a)
            for slot in ("m", "v"):
                np.testing.assert_array_equal(
                    np.asarray(zstate["opt_state"][slot][ln][wn]),
                    saved[slot][ln][wn])


def test_zero_world_checkpoint_restores_bit_equal(tmp_path_factory):
    for r in _world(tmp_path_factory)["ranks"]:
        assert r["fresh_step"] == 2 and r["fresh_differ"] == []
    a, b = (r["zero_state"] for r in _world(tmp_path_factory)["ranks"])
    for slot in a:
        for ln in a[slot]:
            for wn in a[slot][ln]:
                np.testing.assert_array_equal(a[slot][ln][wn],
                                              b[slot][ln][wn])


def test_two_rank_checkpoint_restores_onto_one_rank(tmp_path_factory):
    w = _world(tmp_path_factory)
    one = mlp_model(["--only-data-parallel", "--zero"], seed=9)
    assert one.restore_checkpoint(str(w["dir"] / "zero")) == 2
    got, want = host_state(one), w["ranks"][0]["zero_state"]
    for slot in want:
        for ln in want[slot]:
            for wn in want[slot][ln]:
                np.testing.assert_array_equal(got[slot][ln][wn],
                                              want[slot][ln][wn])


def test_one_rank_checkpoint_restores_onto_two(tmp_path_factory):
    w = _world(tmp_path_factory)
    want = w["single"]
    for r in w["ranks"]:
        assert r["single_step"] == 2
        for slot in want:
            for ln in want[slot]:
                for wn in want[slot][ln]:
                    np.testing.assert_array_equal(
                        r["single_state"][slot][ln][wn],
                        want[slot][ln][wn])


# ======================================================================
# the torn and corrupt-shard drills
# ======================================================================
def _torn(d, mode, fault=""):
    env = dict(DRILL_ENV, FF_FAULT_PLAN=fault)
    return run_world_raw("torn", 2, {"dir": str(d), "mode": mode},
                         timeout=60.0, env=env)


def test_torn_world_checkpoint_restores_the_committed_step(tmp_path):
    """A rank crash BETWEEN shard staging and manifest commit fails the
    surviving rank's stage barrier within its bound with the dead rank
    attributed, and leaves step 2 as staging debris only — a fresh world
    restores step 1 on every rank, bit-equal."""
    d = tmp_path / "world_ckpt"
    t0 = time.monotonic()
    codes, res, logs = _torn(d, "train", "crash_after_stage@2:1")
    assert codes == [EXIT_RANK_FAILURE, RANK_CRASH_EXIT], (codes, logs)
    assert time.monotonic() - t0 < 45, "survivor wait was not bounded"
    assert "rank 1 failed" in logs[0], logs[0][-2000:]
    names = set(os.listdir(d))
    assert "1" in names and "2" not in names and "tmp-2" in names, names
    codes, res, logs = _torn(d, "restore")
    assert codes == [0, 0], logs
    assert [r["step"] for r in res] == [1, 1]
    assert res[0]["crc"] == res[1]["crc"]
    assert [r["bias"] for r in res] == [1.0, 1.0]
    assert [r["steps"] for r in res] == [[1], [1]]


def test_corrupt_shard_quorum_falls_back(tmp_path):
    """``corrupt_shard@2:1`` tears rank 1's shard of the COMMITTED step
    2: every rank's verification rejects it and the quorum lands on step
    1 (the multi-host analog of the single-process corrupt-latest
    fallback)."""
    d = tmp_path / "world_ckpt"
    codes, res, logs = _torn(d, "train", "corrupt_shard@2:1")
    assert codes == [0, 0] and res == ["TRAIN_OK"] * 2, logs
    codes, res, logs = _torn(d, "restore")
    assert codes == [0, 0], logs
    assert [r["step"] for r in res] == [1, 1]     # fell back past 2
    assert res[0]["crc"] == res[1]["crc"]
    assert [r["steps"] for r in res] == [[1, 2], [1, 2]]  # 2 listed


def test_port_restores_a_jax_world_checkpoint(tmp_path):
    """A 2-process JAX world's two-phase checkpoint (its shard leaves
    pickled as ``flexflow_tpu.runtime.checkpoint.ShardBlocks``) restores
    in the port, equal to the arrays the JAX worker built."""
    from _dist_worker import launch_world
    d = tmp_path / "jax_world_ckpt"
    worker = os.path.join(os.path.dirname(__file__), "_torn_ckpt_worker.py")
    rcs, outs, errs = launch_world(
        n_local=1, timeout=120, worker_path=worker, expect_ok=False,
        extra_env={"FF_TORN_CKPT_DIR": str(d), "FF_TORN_MODE": "train"})
    assert rcs == [0, 0], [e[-1500:] for e in errs]
    with open(d / "2" / "manifest.json") as f:
        assert json.load(f)["format"] == "multihost"
    mgr = ckpt.CheckpointManager(str(d))
    for step in (None, 1):
        state, meta = mgr.restore(step)
        s = meta["step"]
        assert s == (2 if step is None else 1)
        np.testing.assert_array_equal(
            state["w"], np.arange(32, dtype=np.float32).reshape(8, 4)
            * float(s + 1))
        assert float(state["bias"]) == float(s)
