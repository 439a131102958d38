"""The port's batching scheduler (``serving/scheduler.py``) against the JAX
package's.

Each scenario runs against both packages' ``BatchScheduler`` with the
same plain-Python fake session (``_torch_serving.FixedSession``) and
returns what a client observes (exception types, counters, breaker
state); the two packages must observe the same. Timing only orders
events with wide margins (a step of 100 ms or more against deadlines of
50 ms or less, or an event-gated step), never bounds a latency. A tiny
BERT served through each package's scheduler gives the same rows (f32,
1e-5).
"""
import concurrent.futures as cf
import threading
import time

import numpy as np
import pytest

import flexflow_tpu.serving as jserving
import flexflow_tpu.serving.scheduler as jsched
import flexflow_tpu_torch.serving as tserving
import flexflow_tpu_torch.serving.scheduler as tsched

from _torch_serving import FixedSession, bert_pair, bert_requests, wait_idle

PKGS = (("jax", jsched), ("port", tsched))


def _both(scenario):
    out = {name: scenario(mod) for name, mod in PKGS}
    assert out["port"] == out["jax"], out
    return out["port"]


def _x(v=0.0, rows=1):
    return {"input": np.full((rows, 8), v, np.float32)}


def test_breaker_cycle_matches():
    def run(S):
        sched = S.BatchScheduler(FixedSession(fail_calls={0, 1, 2, 3}),
                                 max_batch=1, breaker_threshold=3,
                                 breaker_cooldown_s=0.2)
        trace = []
        try:
            for _ in range(3):
                with pytest.raises(RuntimeError, match="injected"):
                    sched.infer(_x())
            trace.append((sched.breaker.state,
                           sched.metrics.breaker_opens))
            with pytest.raises(S.CircuitOpenError) as ei:
                sched.infer(_x())
            trace.append(ei.value.retry_after_s > 0)
            time.sleep(0.3)          # half-open: the probe (call 3) fails
            with pytest.raises(RuntimeError, match="injected"):
                sched.infer(_x())
            trace.append((sched.breaker.state,
                          sched.metrics.breaker_opens))
            time.sleep(0.3)          # the next probe succeeds
            trace.append(sched.infer(_x()).shape)
            trace.append(sched.stats()["circuit"])
        finally:
            sched.close()
        return trace
    assert _both(run) == [("open", 1), True, ("open", 2), (1, 4),
                          "closed"]


def test_probe_slot_release_matches():
    def run(S):
        br = S.CircuitBreaker(threshold=1, cooldown_s=0.05)
        br.on_failure()
        time.sleep(0.08)
        first = br.allow()
        second = br.allow()[0]
        br.release_probe()
        third = br.allow()
        br.on_success()
        return first[0], first[2], second, third[0], third[2], br.state
    assert _both(run) == (True, True, False, True, True, "closed")


def test_batch_poison_isolation_matches():
    def run(S):
        sess = FixedSession()
        sched = S.BatchScheduler(sess, max_batch=8, max_delay_ms=250.0)
        results, errors = {}, {}

        def fire(key, v):
            try:
                results[key] = sched.infer(_x(v), timeout=15).shape
            except Exception as e:  # noqa: BLE001
                errors[key] = type(e).__name__
        try:
            ts = [threading.Thread(target=fire, args=a) for a in
                  (("g1", 0.0), ("bad", np.nan), ("g2", 1.0))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
            assert wait_idle(sched)
            m = sched.metrics
            return (sorted(results.items()), errors, m.completed,
                    m.failed, sched.breaker.state)
        finally:
            sched.close()
    assert _both(run) == ([("g1", (1, 4)), ("g2", (1, 4))],
                          {"bad": "RuntimeError"}, 2, 1, "closed")


def test_individual_retries_counted():
    """The port counts the batch-poison pass's device calls beside the
    batches (``individual_retries``): with ``batches`` they count every
    forward the workers ran, which is what the card check holds the
    flash launches to."""
    gate = threading.Event()
    sess = FixedSession(gate=gate)
    sched = tsched.BatchScheduler(sess, max_batch=8, max_delay_ms=500.0)
    try:
        with cf.ThreadPoolExecutor(3) as ex:
            futs = [ex.submit(sched.infer, _x(v), 15)
                    for v in (0.0, np.nan, 1.0)]
            time.sleep(0.2)
            gate.set()
            done = [f.exception(timeout=30) for f in futs]
        assert [type(e).__name__ if e else None for e in done] == \
            [None, "RuntimeError", None]
        st = sched.stats()
        assert st["batches"] == 1 and st["individual_retries"] == 3
        assert st["batches"] + st["individual_retries"] == sess.calls
    finally:
        sched.close()


def test_retry_skips_expired_members_matches():
    def run(S):
        sess = FixedSession(step_s=0.15, fail_calls={0})
        sched = S.BatchScheduler(sess, max_batch=8, max_delay_ms=80.0,
                                 breaker_threshold=10)
        errs = []

        def fire():
            try:
                sched.infer(_x(), deadline_ms=100.0)
            except Exception as e:  # noqa: BLE001
                errs.append(type(e).__name__)
        try:
            ts = [threading.Thread(target=fire) for _ in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
            assert wait_idle(sched)
            return (sorted(errs), sess.calls, sched.metrics.expired,
                    sched.breaker.state)
        finally:
            sched.close()
    assert _both(run) == (["DeadlineExceededError"] * 2, 1, 2, "closed")


def test_admission_validation_matches():
    def run(S):
        sched = S.BatchScheduler(FixedSession(), max_batch=4)
        out = []
        try:
            for bad in ({"wrong": np.zeros((2, 8), np.float32)},
                        {"input": np.zeros((2, 7), np.float32)},
                        {"input": np.zeros((2, 8), np.complex64)},
                        {"input": np.float32(3.0)},
                        {"input": np.zeros((0, 8), np.float32)},
                        {"input": np.zeros((2, 8), np.float32),
                         "extra": np.zeros((2, 8), np.float32)}):
                with pytest.raises(S.InvalidInputError) as ei:
                    sched.infer(bad)
                out.append(str(ei.value))
            # int32 widens to the model's float32: accepted
            out.append(sched.infer(
                {"input": np.zeros((2, 8), np.int32)}).shape)
        finally:
            sched.close()
        return out
    got = _both(run)
    assert got[-1] == (2, 4)


def test_expired_request_never_reaches_a_device_step():
    def run(S):
        # the first step is held until the late clients have given up:
        # a late request can never find the worker idle, however slowly
        # the threads are scheduled on a loaded machine
        gate = threading.Event()
        sess = FixedSession(step_s=0.15, gate=gate)
        sched = S.BatchScheduler(sess, max_batch=1)
        errs = {}

        def fire(v, dl_ms):
            try:
                sched.infer(_x(v), timeout=10, deadline_ms=dl_ms)
            except Exception as e:  # noqa: BLE001
                errs[v] = type(e).__name__
        try:
            first = threading.Thread(target=fire, args=(1.0, 5000.0))
            first.start()
            end = time.perf_counter() + 10
            while sess.calls < 1 and time.perf_counter() < end:
                time.sleep(0.005)     # the worker is inside the step
            late = [threading.Thread(target=fire, args=(v, 30.0))
                    for v in (2.0, 3.0, 4.0)]
            for t in late:
                t.start()
            for t in late:
                t.join(timeout=30)
            gate.set()
            first.join(timeout=30)
            assert wait_idle(sched)
            snap = sched.metrics.snapshot(0)
            return (errs, [v for v in (2.0, 3.0, 4.0) if v in sess.seen],
                    snap["expired"], snap["requests"],
                    snap["completed"] + snap["failed"] + snap["expired"])
        finally:
            gate.set()
            sched.close()
    errs, seen, expired, req, total = _both(run)
    assert errs == {v: "DeadlineExceededError" for v in (2.0, 3.0, 4.0)}
    assert seen == [] and expired == 3 and req == total == 4


def test_queue_full_drain_and_hot_swap_match():
    def run(S):
        gate = threading.Event()
        sess = FixedSession(gate=gate)
        sched = S.BatchScheduler(sess, max_batch=1, max_queue=1)
        out = []
        pool = cf.ThreadPoolExecutor(4)
        try:
            held = pool.submit(sched.infer, _x(1.0), 15)
            end = time.perf_counter() + 10
            while sess.calls < 1 and time.perf_counter() < end:
                time.sleep(0.005)
            queued = pool.submit(sched.infer, _x(2.0), 15)
            while sched._q.qsize() < 1 and time.perf_counter() < end:
                time.sleep(0.005)
            with pytest.raises(S.QueueFullError) as ei:
                sched.infer(_x(3.0))
            out.append(("full", ei.value.retry_after_s))
            # hot swap under the drain protocol: admission pauses, the
            # backlog flushes on the old instance, the new one serves
            new = FixedSession()
            swap = pool.submit(sched.hot_swap, new, 10.0)
            while not sched.stats()["draining"] \
                    and time.perf_counter() < end:
                time.sleep(0.005)
            with pytest.raises(S.DrainingError) as ei:
                sched.infer(_x(4.0))
            out.append(("swap-draining", ei.value.retry_after_s))
            gate.set()
            out.append(("swap", swap.result(timeout=15),
                        held.result(timeout=15).shape,
                        queued.result(timeout=15).shape))
            sched.infer(_x(5.0))
            out.append(("new-instance-calls", new.calls, sess.calls))
            # a drain with nothing in flight is clean; admission closes
            out.append(("drain", sched.drain(5.0)))
            with pytest.raises(S.DrainingError):
                sched.infer(_x(6.0))
        finally:
            gate.set()
            pool.shutdown(wait=True)
            sched.close()
        return out
    assert _both(run) == [("full", 1.0), ("swap-draining", 5.0),
                          ("swap", True, (1, 4), (1, 4)),
                          ("new-instance-calls", 1, 2), ("drain", True)]


def test_snapshot_and_stats_keys():
    """The port's snapshot is the JAX package's plus the
    ``individual_retries`` count; the counters feed the same registry
    families under the model label."""
    keys = {}
    for name, S in PKGS:
        sched = S.BatchScheduler(FixedSession(), max_batch=2,
                                 name=f"keys_{name}")
        try:
            sched.infer(_x())
            keys[name] = (set(sched.stats()),
                          set(sched.metrics.snapshot(0)))
        finally:
            sched.close()
    assert keys["port"][0] == keys["jax"][0] | {"individual_retries"}
    assert keys["port"][1] == keys["jax"][1] | {"individual_retries"}


def test_scheduled_bert_rows_match_jax():
    jff, tff = bert_pair()
    out = {}
    for name, pkg, ff in (("jax", jserving, jff), ("port", tserving, tff)):
        sess = pkg.InferenceSession(ff, batch_buckets=(4,))
        sched = pkg.BatchScheduler(sess, max_batch=4, max_delay_ms=20.0)
        try:
            with cf.ThreadPoolExecutor(6) as ex:
                out[name] = list(ex.map(
                    lambda i: sched.infer(bert_requests(1, seed=i),
                                          timeout=60), range(6)))
        finally:
            sched.close()
    for j, t in zip(out["jax"], out["port"]):
        assert t.shape == j.shape == (1, 2)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
