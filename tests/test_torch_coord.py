"""The port's cross-process coordination layer held against the JAX
package's: heartbeats, bounded barriers, the world epoch, the epoch-0
fault plan, the shrink arithmetic and the WorldSupervisor's policy.

Every ``tests/test_coord.py`` scenario that runs on ``LocalKV`` runs here
against BOTH packages' ``Coordinator`` on the same scripted beats and
timeouts (two coordinators in one process play ranks 0 and 1), and each
outcome (the ``RankFailure``'s rank and reason, the ``status.snapshot()``
world fields, the epoch-scoped keys) must come out equal. The port's
coordinators then run the silent-peer and stale-barrier scenarios over a
real ``TCPStore`` (its ``StoreKV``), each also with the store's host,
rank 0, gone: the survivor names rank 0. The four scripted ``python -c``
world policies (relaunch, shrink, reaping a hung rank on the detector's
exit, giving up with a report) run under both packages'
``WorldSupervisor`` and must report the same epochs, world sizes, exit
codes and report lengths.
"""
import sys
import time
from datetime import timedelta

import pytest

import flexflow_tpu.obs.flight as jax_flight
import flexflow_tpu.resilience as jres
import flexflow_tpu_torch.obs.flight as flight
import flexflow_tpu_torch.resilience as tres
from flexflow_tpu.resilience import elastic as jax_elastic
from flexflow_tpu_torch.resilience import elastic
from flexflow_tpu_torch.resilience.coord import StoreKV

PKGS = {"jax": jres, "torch": tres}


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    # the flight records that failures and the WorldSupervisor write go
    # to this test's directory, never the packages' shared caches
    monkeypatch.setattr(jax_flight, "_DEFAULT_DIR", str(tmp_path / "jf"))
    monkeypatch.setattr(flight, "_DEFAULT_DIR", str(tmp_path / "tf"))
    for mod in PKGS.values():
        mod.coord.reset()
        mod.faults.install("")
        mod.status.reset()
    yield
    for mod in PKGS.values():
        mod.coord.reset()
        mod.faults.clear()
        mod.status.reset()


def _pair(mod, kv, **kw):
    """Two coordinators of ``mod`` sharing one KV: rank 0 and rank 1 of
    a 2-process world, in-process."""
    kw.setdefault("heartbeat_interval_s", 0.05)
    kw.setdefault("heartbeat_timeout_s", 0.3)
    kw.setdefault("barrier_timeout_s", 0.2)
    kw.setdefault("supervised", False)
    kw.setdefault("epoch", 0)
    return (mod.Coordinator(0, 2, kv=kv, **kw),
            mod.Coordinator(1, 2, kv=kv, **kw))


def _world(mod) -> dict:
    snap = mod.status.snapshot()
    return {k: snap[k] for k in ("world_epoch", "world_rank",
                                 "world_size", "rank_failures")} | {
        "last_rank_failure": (snap["last_rank_failure"] or "")[:40]}


def _wait_failure(c, limit_s: float = 3.0):
    deadline = time.monotonic() + limit_s
    while c.failure() is None and time.monotonic() < deadline:
        time.sleep(0.02)
    return c.failure()


def _failure(f) -> tuple:
    return (type(f).__name__, f.rank, f.epoch, f.reason) \
        if f is not None else None


# ======================================================================
# the LocalKV scenarios of tests/test_coord.py, on both packages
# ======================================================================
def silent_peer(mod, kv):
    c0, c1 = _pair(mod, kv)
    try:
        c0.start()
        # rank 1 beats for a while, then goes silent (crash/SIGSTOP)
        deadline = time.monotonic() + 0.2
        while time.monotonic() < deadline:
            c1.beat()
            time.sleep(0.05)
        f = _wait_failure(c0)
        with pytest.raises(mod.RankFailure):
            c0.check()
        return {"failure": _failure(f), "world": _world(mod)}
    finally:
        c0.stop()


def quiet_while_beating(mod, kv):
    c0, c1 = _pair(mod, kv)
    try:
        c0.start()
        deadline = time.monotonic() + 0.6  # 2x the 0.3s timeout
        while time.monotonic() < deadline:
            c1.beat()
            time.sleep(0.05)
        c0.check()
        return {"failure": _failure(c0.failure()), "world": _world(mod)}
    finally:
        c0.stop()


def world_facts(mod, kv):
    mod.Coordinator(1, 2, kv=kv, epoch=4, supervised=False)
    return {"world": _world(mod)}


def barrier_stale(mod, kv):
    c0, c1 = _pair(mod, kv, heartbeat_timeout_s=0.1)
    c1.beat()
    c0._scan_peers()        # observe rank 1's seq once...
    time.sleep(0.15)        # ...then let it go stale
    with pytest.raises(mod.RankFailure) as ei:
        c0.barrier("sync", timeout_s=0.01)
    # the failure is latched: every later wait fails fast
    with pytest.raises(mod.RankFailure):
        c0.check()
    reason = ei.value.reason
    return {"rank": ei.value.rank, "reason": reason[:reason.index("(")],
            "world": _world(mod)}


def barrier_unattributed(mod, kv):
    c0, c1 = _pair(mod, kv)
    c1.beat()
    c0._scan_peers()
    c1.beat()  # rank 1 is alive, just not at the barrier: a slow rank
    with pytest.raises(mod.RankFailure) as ei:
        c0.barrier("sync", timeout_s=0.01)
    return {"rank": ei.value.rank,
            "unknown": "unknown rank" in str(ei.value)}


def single_process(mod, kv):
    c = mod.Coordinator(0, 1, kv=kv, supervised=False)
    started = c.start() is c and c._thread is None
    c.barrier("anything", timeout_s=0.01)       # returns immediately
    c.check()
    c.stop()
    return {"started": started, "anchor": sorted(c.clock_sync())}


def module_level(mod, kv):
    none = mod.coord.get() is None
    mod.coord.check()
    mod.coord.barrier("x")  # single-process checkpoint path calls this
    c = mod.coord.ensure_started()
    return {"none": none, "world": c.world,
            "same": mod.coord.ensure_started() is c is mod.coord.get()}


def epoch_keys(mod, kv):
    old = mod.Coordinator(0, 2, kv=kv, epoch=0, supervised=False)
    old.beat()  # debris from the dead epoch
    new = mod.Coordinator(0, 2, kv=kv, epoch=1, supervised=False)
    new.beat()
    return {"new_sees": kv.dir_get(new._hb_prefix()),
            "prefixes": (old._hb_prefix(), new._hb_prefix()),
            "keys": sorted(k for k, _ in kv.dir_get("ff/"))}


SCENARIOS = [silent_peer, quiet_while_beating, world_facts, barrier_stale,
             barrier_unattributed, single_process, module_level,
             epoch_keys]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_coordinator_matches_jax_on_local_kv(scenario):
    got = {}
    for name, mod in PKGS.items():
        mod.status.reset()
        mod.coord.reset()
        got[name] = scenario(mod, mod.coord.LocalKV())
    assert got["torch"] == got["jax"]
    if scenario is silent_peer:
        assert got["torch"]["failure"][1] == 1   # attributed
        assert "rank=1" in got["torch"]["world"]["last_rank_failure"]
    if scenario is epoch_keys:
        assert got["torch"]["keys"] == ["ff/hb/e0/0", "ff/hb/e1/0"]


# ======================================================================
# the port's coordinator over a real TCPStore
# ======================================================================
def _store():
    """A TCPStore server in this process (rank 0's, in a world) and a
    port-side KV client for each of two ranks."""
    from torch.distributed import TCPStore
    server = TCPStore("127.0.0.1", 0, is_master=True,
                      wait_for_workers=False, timeout=timedelta(seconds=10))
    addr = f"127.0.0.1:{server.port}"
    return server, StoreKV(addr, 2, 5.0), StoreKV(addr, 2, 5.0)


@pytest.mark.parametrize("host_gone", [False, True],
                         ids=["store_up", "rank0_store_killed"])
def test_silent_peer_over_a_tcp_store(host_gone):
    server, kv0, kv1 = _store()
    kw = dict(heartbeat_interval_s=0.05, heartbeat_timeout_s=1.0,
              supervised=False, epoch=2)
    c0 = tres.Coordinator(0, 2, kv=kv0, **kw)
    c1 = tres.Coordinator(1, 2, kv=kv1, **kw)
    try:
        c0.start()
        c1.start()
        time.sleep(1.2)     # both beat past one timeout: no failure
        assert c0.failure() is None and c1.failure() is None
        assert [k for k, _ in kv0.dir_get("ff/hb/e2/")] == [
            "ff/hb/e2/0", "ff/hb/e2/1"]
        if host_gone:
            # rank 0 dies and takes the store with it: rank 1 names it
            c0.stop()
            del server
            f = _wait_failure(c1, 5.0)
            assert f.rank == 0 and "unreachable" in f.reason, f
            assert f.epoch == 2
        else:
            c1.stop()       # rank 1 falls silent; the store stays up
            f = _wait_failure(c0, 5.0)
            assert f.rank == 1 and f.reason.startswith("no heartbeat"), f
        snap = tres.status.snapshot()
        assert snap["rank_failures"] == 1
        assert f"rank={f.rank} epoch=2" in snap["last_rank_failure"]
    finally:
        c0.stop()
        c1.stop()


@pytest.mark.parametrize("host_gone", [False, True],
                         ids=["store_up", "rank0_store_killed"])
def test_barrier_timeout_over_a_tcp_store(host_gone):
    server, kv0, kv1 = _store()
    kw = dict(heartbeat_timeout_s=0.1, supervised=False, epoch=0)
    c0 = tres.Coordinator(0, 2, kv=kv0, **kw)
    c1 = tres.Coordinator(1, 2, kv=kv1, **kw)
    # a barrier both ranks reach passes
    import threading
    t = threading.Thread(target=c1.barrier, args=("meet",))
    t.start()
    c0.barrier("meet", timeout_s=5.0)
    t.join()
    if host_gone:
        c0.beat()
        c1._scan_peers()
        del server
        with pytest.raises(tres.RankFailure) as ei:
            c1.barrier("sync", timeout_s=0.2)
        assert ei.value.rank == 0
    else:
        c1.beat()
        c0._scan_peers()    # observe rank 1's seq once...
        time.sleep(0.15)    # ...then let it go stale
        t0 = time.monotonic()
        with pytest.raises(tres.RankFailure) as ei:
            c0.barrier("sync", timeout_s=0.2)
        assert ei.value.rank == 1
        assert time.monotonic() - t0 < 2.0   # bounded
        assert "1 of 2 ranks reached barrier 'ff:e0:sync'" \
            in ei.value.reason
    assert "barrier 'sync' timed out" in ei.value.reason
    with pytest.raises(tres.RankFailure):
        (c1 if host_gone else c0).check()


def test_collective_error_is_attributed_to_the_dead_peer():
    """A collective's error of a dead peer (gloo's words) waits for the
    heartbeats to name the rank; an ordinary error is not a peer's."""
    kv = tres.coord.LocalKV()
    c0, c1 = _pair(tres, kv, heartbeat_timeout_s=0.3)
    err = RuntimeError("[gloo/transport/tcp/pair.cc:553] Connection "
                       "closed by peer [127.0.0.1]:4242")
    try:
        c0.start()
        c1.beat()
        assert c0.attribute(ValueError("a bug of this rank")) is None
        t0 = time.monotonic()
        f = c0.attribute(err)
        assert f.rank == 1 and time.monotonic() - t0 < 1.5
        assert c0.attribute(err) is f    # latched
    finally:
        c0.stop()
    lone = tres.Coordinator(0, 2, kv=tres.coord.LocalKV(),
                            heartbeat_timeout_s=0.1, supervised=False)
    f = lone.attribute(err)              # nobody was attributed
    assert f.rank is None and "no peer was attributed" in f.reason


def _own_collective_errors():
    """Errors that a rank's own collective raises (gloo's checks of its
    arguments), taken from a one-rank gloo group in this process: their
    text names gloo, yet no peer went away."""
    import torch
    import torch.distributed as dist
    from torch._C._distributed_c10d import BroadcastOptions
    pg = dist.ProcessGroupGloo(dist.HashStore(), 0, 1)
    root = BroadcastOptions()
    root.rootRank = 3
    calls = (lambda: pg.allgather([[torch.zeros(3)]], [torch.ones(2)]),
             lambda: pg.broadcast([torch.ones(2)], root),
             lambda: pg.alltoall_base(torch.zeros(3), torch.ones(2), [],
                                      []))
    errs = []
    for call in calls:
        with pytest.raises(RuntimeError) as ei:
            call().wait()
        errs.append(ei.value)
    return errs


def test_own_collective_error_reaches_recover(tmp_path):
    """A rank's own error in a collective is not a dead peer's: it is
    not attributed (no wait for the heartbeats), ``run_world_member``
    re-raises it instead of exiting the detector code, and the
    Supervisor restores in-process, spending one restart."""
    import numpy as np

    import flexflow_tpu_torch as fft
    errs = _own_collective_errors()
    cfg = fft.FFConfig()
    cfg.batch_size = 8
    cfg.only_data_parallel = True
    cfg.seed = 7
    ff = fft.FFModel(cfg, device="cpu")
    ff.softmax(ff.dense(ff.create_tensor((8, 4), name="x"), 3))
    ff.compile(fft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
               [])
    c0, c1 = _pair(tres, tres.coord.LocalKV(), heartbeat_timeout_s=30.0)
    try:
        c0.start()
        c1.start()
        tres.coord._coord = c0          # this process is rank 0 of two
        t0 = time.monotonic()
        assert [c0.attribute(e) for e in errs] == [None] * len(errs)
        assert time.monotonic() - t0 < 0.5
        with pytest.raises(RuntimeError, match="ProcessGroupGloo"):
            tres.run_world_member(lambda: (_ for _ in ()).throw(errs[0]))
        step = ff._run_train_step
        raised = []

        def own_error_once(step_fn, batch):
            if ff._step == 2 and not raised:
                raised.append(ff._step)
                raise errs[0]
            return step(step_fn, batch)
        ff._run_train_step = own_error_once
        rng = np.random.default_rng(0)
        xs = rng.normal(size=(32, 4)).astype(np.float32)
        ys = rng.integers(0, 3, size=32).astype(np.int32)
        sup = tres.Supervisor(ff, str(tmp_path / "own"),
                              checkpoint_every=1, backoff_base_s=0.0)
        sup.run(xs, ys, epochs=1)
        assert raised == [2] and sup.restarts == 1
        assert c0.failure() is None
        assert tres.status.snapshot()["rank_failures"] == 0
    finally:
        c1.stop()


# ======================================================================
# the epoch-0 fault plan and the shrink arithmetic
# ======================================================================
@pytest.mark.parametrize("epoch", [None, "0", "1", "3"])
@pytest.mark.parametrize("plan,plan0", [
    ("", "rank_crash@3:1"), ("crash@2", "rank_crash@3:1;corrupt_shard@2:0"),
    ("nan@4", ""), ("", "")])
def test_fault_plan_epoch_gating_matches_jax(monkeypatch, epoch, plan,
                                            plan0):
    for var, val in (("FF_WORLD_EPOCH", epoch), ("FF_FAULT_PLAN", plan),
                     ("FF_FAULT_PLAN_EPOCH0", plan0)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    got = [[(f.kind, f.step, f.args) for f in mod.faults.FaultPlan
            .from_env().faults] for mod in (tres, jres)]
    assert got[0] == got[1]
    armed = epoch in (None, "0")
    assert len(got[0]) == len([c for c in (plan + ";" + plan0
                                           if armed else plan).split(";")
                               if c])


def test_shrink_arithmetic_matches_jax():
    for alive in range(0, 9):
        for batch in (0, 1, 2, 3, 6, 8, 12, 64):
            assert elastic.surviving_device_count(alive, max(batch, 1)) \
                == jax_elastic.surviving_device_count(alive, max(batch, 1))
            for per in (1, 2, 4):
                assert elastic.shrunken_world_size(alive, batch, per) \
                    == jax_elastic.shrunken_world_size(alive, batch, per)
    assert elastic.shrunken_world_size(3, 8) == 2


def test_shrunken_spec_drops_the_fabric():
    from flexflow_tpu_torch.parallel.machine import MachineSpec
    spec = MachineSpec(num_devices=8, generation="cpu-sim",
                       ici_shape=(2, 4), num_slices=2, num_hosts=2)
    small = elastic.shrunken_spec(spec, 3)
    assert (small.num_devices, small.ici_shape, small.num_slices,
            small.num_hosts, small.generation) == (3, None, 1, 1, "cpu-sim")


# ======================================================================
# the WorldSupervisor's policy (scripted subprocess workers)
# ======================================================================
def _ws(mod, body, nprocs=2, **kw):
    """A WorldSupervisor of ``mod`` over ``python -c`` workers; ``body``
    sees rank/epoch as argv[1]/argv[2]."""
    kw.setdefault("world_timeout_s", 60.0)
    kw.setdefault("poll_interval_s", 0.02)
    return mod.WorldSupervisor(
        [sys.executable, "-c", body, "{rank}", "{epoch}"],
        nprocs=nprocs, **kw)


_HUNG = ("import sys, time\n"
         "r, e = sys.argv[1:3]\n"
         "if e == '0':\n"
         "    time.sleep(600) if r == '1' else sys.exit(17)\n"
         "sys.exit(0)")

POLICIES = {
    # rank 1 hard-dies in epoch 0 only; the relaunch must succeed
    "relaunch": ("import sys; sys.exit(13 if sys.argv[1:3] == ['1', '0'] "
                 "else 0)", dict(max_world_restarts=1)),
    # rank 1 always dies: the world must shrink to the largest
    # batch-divisible survivor count (2 -> 1)
    "shrink": ("import sys; sys.exit(13 if sys.argv[1] == '1' else 0)",
               dict(max_world_restarts=0, policy="shrink", batch_size=8)),
    # rank 1 wedges; rank 0 detects and exits the detector code: the
    # supervisor kills the hung rank (no full-timeout wait) and shrinks
    "reap_hung": (_HUNG, dict(max_world_restarts=0, policy="shrink",
                              batch_size=8, world_timeout_s=120.0)),
    # every epoch fails: the budget runs out and the report says why
    "give_up": ("import sys; sys.exit(13)",
                dict(max_world_restarts=1, policy="relaunch")),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_world_supervisor_matches_jax(policy):
    body, kw = POLICIES[policy]
    got = {}
    for name, mod in PKGS.items():
        mod.status.reset()
        ws = _ws(mod, body, **kw)
        t0 = time.monotonic()
        try:
            records = ws.run()
            rcs, failed = [r["rc"] for r in records], None
        except mod.WorldFailure as e:
            rcs, failed = None, len(e.report)
        # a failed epoch's codes of ranks that exited on their own (a
        # sibling still running at the first failure is reaped, -9, or
        # got to exit 0 first: the launcher's race, not the policy's)
        got[name] = {"epoch": ws.epoch, "nprocs": ws.nprocs,
                     "restarts": ws.world_restarts, "shrinks": ws.shrinks,
                     "rcs": rcs, "failed_report": failed,
                     "report_rcs": [sorted({rc for rc in r["rcs"]
                                            if rc not in (0, -9)})
                                    for r in ws.report],
                     "report_len": len(ws.report),
                     "replans": mod.status.snapshot()["elastic_replans"],
                     "first_rcs": ws.report[0]["rcs"]}
        assert time.monotonic() - t0 < 60.0    # no unbounded wait
    if policy != "reap_hung":
        for g in got.values():
            g.pop("first_rcs")
    assert got["torch"] == got["jax"]
    want = {"relaunch": (1, 2, [0, 0], None), "shrink": (1, 1, [0], None),
            "reap_hung": (1, 1, [0], None), "give_up": (2, 2, None, 2)}
    t = got["torch"]
    assert (t["epoch"], t["nprocs"], t["rcs"], t["failed_report"]) \
        == want[policy]
    if policy == "reap_hung":
        # the wedged rank was killed (SIGKILL), never waited out
        assert t["first_rcs"] == [17, -9]


# rank 1 dies hard in epoch 0; rank 0 exits the detector code after
# NAP seconds (the heartbeats' detection), or never (wedged)
_SURVIVOR = ("import sys, time\n"
             "r, e = sys.argv[1:3]\n"
             "if e == '0':\n"
             "    sys.exit(13) if r == '1' else (time.sleep(NAP), "
             "sys.exit(17))\n"
             "sys.exit(0)")


@pytest.mark.parametrize("nap,rc0", [(0.5, 17), (600, -9)],
                         ids=["detector_exits", "survivor_wedged"])
def test_world_supervisor_waits_the_detection_bound(nap, rc0):
    """After a rank's hard death the port's WorldSupervisor gives the
    survivors the coordinator's detection bound, 2 x (FF_HB_TIMEOUT_S +
    2 beats) from the workers' environment, to exit the detector code on
    their own; one still running then is killed. The JAX package kills
    them at once (ROADMAP section 3)."""
    env = {"FF_HB_TIMEOUT_S": "1", "FF_HB_INTERVAL_S": "0.1"}
    bound = 2 * (1 + 2 * 0.1)
    assert tres.WorldSupervisor._detection_bound_s(env) == bound
    got = {}
    for name, mod in PKGS.items():
        ws = _ws(mod, _SURVIVOR.replace("NAP", str(nap)),
                 max_world_restarts=1, policy="relaunch", env=env)
        t0 = time.monotonic()
        assert [r["rc"] for r in ws.run()] == [0, 0]
        got[name] = (ws.report[0]["rcs"], time.monotonic() - t0)
    assert got["torch"][0] == [rc0, 13]
    assert got["jax"][0] == [-9, 13]
    if rc0 == -9:
        assert bound <= got["torch"][1] < bound + 10.0
