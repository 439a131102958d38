"""The port's fleet (``serving/fleet/router.py``, ``autoscale.py``,
``replica.py``) against the JAX package's.

Router behaviour runs in both packages against the same in-process fake
replica servers (real sockets, no child processes): candidate order,
deadline shrinking across a failover hop, transport death, the fleet SLO
dedupe, the fleet front's health, models and merged metrics; each
package must see the same. ``merge_replica_metrics`` gives identical
output on identical inputs, ``decide`` the same action over a grid of
signals, and the autoscaler's repair tick spawns through the router. One
test starts a real port replica process (``--device cpu --model
synthetic``), serves a request through it, drains it through stdin and
sees it exit 0; without ``--device cpu`` on a machine with no CUDA device
the replica refuses to start. Every server is shut down in a ``finally``
and every wait is bounded.
"""
import itertools
import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import flexflow_tpu.serving.fleet as jfleet
import flexflow_tpu_torch.serving.fleet as tfleet
from flexflow_tpu.obs.sketch import QuantileSketch as JSketch
from flexflow_tpu_torch.obs.sketch import QuantileSketch

from _torch_serving import get, infer_doc, post

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = (("jax", jfleet), ("port", tfleet))


def _fake_replica(wait_s=0.0, mode="echo", post_delay_s=0.0, model="m"):
    """One in-process replica endpoint: ``echo`` answers POSTs 200,
    ``shed`` 503, ``die`` drops the connection. Returns (server, url,
    received headers)."""
    received = []
    sk = QuantileSketch()
    sk.add(0.01)

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, doc):
            b = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(b)))
            self.end_headers()
            self.wfile.write(b)

        def do_GET(self):
            if self.path == "/v2/metrics":
                self._send(200, {"models": {model: {
                    "requests": len(received),
                    "completed": len(received), "queue_depth": 0,
                    "sketches": {"all": sk.to_dict()}}}})
                return
            self._send(200, {"status": "ok", "ready": True,
                             "serving": {model: {
                                 "estimated_wait_s": wait_s,
                                 "circuit": "closed",
                                 "queue_depth": 0}}})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0) or 0)
            self.rfile.read(n)
            received.append({k.lower(): v
                             for k, v in self.headers.items()})
            if post_delay_s:
                time.sleep(post_delay_s)
            if mode == "die":
                self.connection.close()
                return
            if mode == "shed":
                self._send(503, {"error": "queue full"})
                return
            self._send(200, {"ok": True})

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}", received


def _both(scenario):
    out = {}
    for name, F in PKGS:
        router = F.FleetRouter(poll_interval_s=60.0)
        try:
            out[name] = scenario(F, router)
        finally:
            router.close(drain_children=False)
    assert out["port"] == out["jax"], out
    return out["port"]


def test_candidates_order_and_rotation():
    def run(F, router):
        from importlib import import_module
        dead_after = import_module(F.__name__ + ".router").DEAD_AFTER

        def plant(name, wait, circuit="closed", draining=False,
                  dead=False):
            r = F.Replica(name, f"http://127.0.0.1:1/{name}")
            r.health = None if dead else {"serving": {"m": {
                "estimated_wait_s": wait, "circuit": circuit}}}
            if dead:
                r.consecutive_errors = dead_after
            r.draining = draining
            with router._lock:
                router._replicas.append(r)
        for args in (("slow", 0.5), ("fast", 0.01),
                     ("open", 0.0, "open"), ("drain", 0.0, "closed", True),
                     ("dead", 0.0, "closed", False, True)):
            plant(*args)
        order = [r.name for r in router.candidates("m")]
        with router._lock:
            router._replicas = router._replicas[:0]
        plant("t1", 0.0)
        plant("t2", 0.0)
        firsts = sorted({router.candidates("m")[0].name
                         for _ in range(6)})
        return order, router.candidates("nope"), firsts
    assert _both(run) == (["fast", "slow"], [], ["t1", "t2"])


def test_forward_deadline_failover_and_trace():
    def run(F, router):
        shed = _fake_replica(mode="shed")
        echo = _fake_replica(wait_s=1.0)
        try:
            router.adopt(shed[1], name="shed")
            router.adopt(echo[1], name="echo")
            code, out, hdrs = router.forward(
                "m", "/v2/models/m/infer", b"{}",
                {"x-ff-timeout-ms": "5000", "x-ff-trace-id": "tr1"})
            t_shed = float(shed[2][0]["x-ff-timeout-ms"])
            t_echo = float(echo[2][0]["x-ff-timeout-ms"])
            st = router.fleet_health()["fleet"]
            return (code, json.loads(out), hdrs, t_shed < 5000.0,
                    t_echo < t_shed, shed[2][0]["x-ff-trace-id"],
                    st["failovers"], st["routed"])
        finally:
            shed[0].shutdown()
            echo[0].shutdown()
    assert _both(run) == (200, {"ok": True}, {"x-ff-trace-id": "tr1"},
                          True, True, "tr1", 1, 1)


def test_transport_death_and_slo_dedupe():
    def run(F, router):
        die = _fake_replica(mode="die")
        echo = _fake_replica(wait_s=1.0)
        slow = _fake_replica(wait_s=2.0, post_delay_s=0.15)
        try:
            rd = router.adopt(die[1], name="die")
            router.adopt(echo[1], name="echo")
            a = router.forward("m", "/v2/models/m/infer", b"{}", {})[0]
            with router._lock:
                dead = rd.health is None
            # expired at the fleet: one violation, nothing dispatched
            n_echo = len(echo[2])
            b = router.forward("m", "/v2/models/m/infer", b"{}",
                               {"x-ff-timeout-ms": "0"})[0]
            n_echo2 = len(echo[2])
            st1 = dict(router.fleet_health()["fleet"])
            # a late answer from a replica that carried the deadline is
            # the replica's violation, not the fleet's
            router2 = F.FleetRouter(poll_interval_s=60.0)
            try:
                router2.adopt(slow[1], name="slowpoke")
                c = router2.forward("m", "/v2/models/m/infer", b"{}",
                                    {"x-ff-timeout-ms": "100"})[0]
                st2 = dict(router2.fleet_health()["fleet"])
            finally:
                router2.close(drain_children=False)
            # no replica: 503; an SLO violation only with a deadline
            router3 = F.FleetRouter(poll_interval_s=60.0)
            try:
                d = [router3.forward("m", "/v2/models/m/infer", b"{}",
                                     h)[0]
                     for h in ({}, {"x-ff-timeout-ms": "1000"})]
                st3 = dict(router3.fleet_health()["fleet"])
            finally:
                router3.close(drain_children=False)
            return (a, dead, b, n_echo == n_echo2, st1, c, st2, d, st3)
        finally:
            for s in (die, echo, slow):
                s[0].shutdown()
    out = _both(run)
    assert out[:4] == (200, True, 504, True)
    assert out[4]["failovers"] == 1 and out[4]["fleet_slo_violations"] == 1
    assert out[5] == 200 and out[6]["fleet_slo_violations"] == 0
    assert out[7] == [503, 503] and out[8]["no_replica"] == 2 \
        and out[8]["fleet_slo_violations"] == 1


def test_fleet_front_health_models_and_metrics():
    def run(F, router):
        r1, r2 = _fake_replica(wait_s=0.1), _fake_replica(wait_s=0.2)
        handle = F.serve_fleet(router)
        try:
            router.adopt(r1[1], name="r1")
            router.adopt(r2[1], name="r2")
            health = get(handle.url + "/healthz")[1]
            models = get(handle.url + "/v2/models")
            met = get(handle.url + "/v2/metrics")[1]
            code, doc, _ = post(handle.url + "/v2/models/m/infer", b"{}")
            nf = post(handle.url + "/v2/other", b"{}")[0]
            return (health["converged"], sorted(health["replicas"]),
                    models, met["models"]["m"]["replicas"],
                    sorted(met["replicas"]),
                    met["models"]["m"]["latency_ms"], code, doc, nf)
        finally:
            handle.stop(drain_children=False)
            r1[0].shutdown()
            r2[0].shutdown()
    out = _both(run)
    assert out[:5] == (True, ["r1", "r2"], (200, {"models": ["m"]}), 2,
                       ["r1", "r2"])
    assert out[6:] == (200, {"ok": True}, 404)


def test_merge_replica_metrics_identical():
    rng = np.random.RandomState(7)
    docs = []
    for scale, n in ((0.01, 400), (0.02, 300)):
        sk = QuantileSketch()
        for v in rng.gamma(2.0, scale, size=n):
            sk.add(float(v))
        docs.append(json.loads(json.dumps(sk.to_dict())))
    per_replica = {
        "r1": {"m": {"requests": 400, "completed": 400, "batches": 50,
                     "sketches": {"all": docs[0], "4": docs[0]}},
               "n": {"requests": 3, "failed": 1}},
        "r2": {"m": {"requests": 300, "completed": 299, "expired": 1,
                     "queue_depth": 2,
                     "sketches": {"all": docs[1], "8": docs[1]}}}}
    for sub in (per_replica, {"r1": per_replica["r1"]}, {}):
        t = tfleet.merge_replica_metrics(json.loads(json.dumps(sub)))
        j = jfleet.merge_replica_metrics(json.loads(json.dumps(sub)))
        assert json.dumps(t, sort_keys=True) == \
            json.dumps(j, sort_keys=True)
    m = tfleet.merge_replica_metrics(per_replica)["m"]
    union = JSketch.from_dict(docs[0]).merge(JSketch.from_dict(docs[1]))
    assert m["requests"] == 700 and m["replicas"] == 2
    assert m["latency_ms"]["all"]["p99"] == \
        round(union.quantile(0.99) * 1e3, 3)


def test_decide_table_matches():
    grid = itertools.product((1, 2, 3), (1, 4), (0, 2), (0, 1, 3, 9),
                             (0, 3, 12), (0, 1, 2, 4, 6))
    n = 0
    for lo, hi, sustain, hot, idle, alive in grid:
        for pending in (0, 1):
            tc = tfleet.AutoscalerConfig(min_replicas=lo, max_replicas=hi,
                                         sustain_polls=sustain,
                                         idle_polls=3)
            jc = jfleet.AutoscalerConfig(min_replicas=lo, max_replicas=hi,
                                         sustain_polls=sustain,
                                         idle_polls=3)
            assert tfleet.decide(tc, alive, pending, hot, idle) == \
                jfleet.decide(jc, alive, pending, hot, idle)
            n += 1
    assert n == 1440
    assert tfleet.AutoscalerConfig() == tfleet.AutoscalerConfig(
        **{f: getattr(jfleet.AutoscalerConfig(), f) for f in
           tfleet.AutoscalerConfig.__dataclass_fields__})


def _replica_argv(*extra):
    return [sys.executable, "-m", "flexflow_tpu_torch.serving.fleet.replica",
            "--port", "{port}", "--name", "{name}", *extra]


def _spawn_env():
    return {"PYTHONPATH": ROOT + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def test_autoscaler_repairs_through_the_router():
    """A retired (exited) replica is replaced by ``tick``'s repair, the
    spawned one comes up through the router's health poll, and the next
    tick holds."""
    router = tfleet.FleetRouter(
        spawn_argv=_replica_argv("--device", "cpu", "--model",
                                 "synthetic", "--synthetic-ms", "1"),
        spawn_env=_spawn_env(), poll_interval_s=0.1)
    try:
        gone = router.spawn("gone")
        gone.proc.kill()
        gone.proc.wait(timeout=30)
        scaler = tfleet.Autoscaler(router, tfleet.AutoscalerConfig(
            min_replicas=1, max_replicas=1))
        assert scaler.tick() == "repair"
        assert [r.name for r in router.replicas()] != ["gone"]
        end = time.monotonic() + 60
        while time.monotonic() < end:
            with router._lock:
                ready = [r for r in router._replicas
                         if r.ready_at is not None]
            if ready:
                break
            time.sleep(0.1)
        assert ready, "the replacement replica never came up"
        assert scaler.tick() == "hold"
        assert scaler.actions()[0]["dead"] == ["gone"]
    finally:
        router.close(drain_children=True, timeout_s=20)


def test_replica_process_serves_and_drains_on_stdin():
    port = tfleet.free_port()
    argv = [a.replace("{port}", str(port)).replace("{name}", "r")
            for a in _replica_argv("--device", "cpu", "--model",
                                   "synthetic", "--synthetic-ms", "1")]
    env = dict(os.environ)
    env.update(_spawn_env())
    proc = subprocess.Popen(argv, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY name=r") and "device=cpu" in line
        url = f"http://127.0.0.1:{port}"
        code, doc, _ = post(url + "/v2/models/synthetic/infer",
                            infer_doc({"x": np.zeros((2, 3),
                                                     np.float32)}))
        assert code == 200 and doc["outputs"][0]["shape"] == [2, 1]
        assert get(url + "/healthz")[1]["serving"]["synthetic"][
            "circuit"] == "closed"
        proc.stdin.write("drain\n")
        proc.stdin.flush()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_replica_refuses_cuda_without_a_card():
    import torch
    from flexflow_tpu_torch.serving.fleet import replica
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica.main(["--port", "0", "--model", "synthetic"])
