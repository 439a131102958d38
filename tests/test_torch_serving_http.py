"""The port's serving fronts (``serving/http_server.py``,
``serving/async_server.py``) and ``ModelRepository`` against the JAX
package's, over loopback.

Each test starts one front of each package on a free port (``port=0``)
and sends both the same bytes. Held equal: the output data of a tiny
BERT (2 layers, width 64, f32, the JAX weights carried into the port) and
of a tiny GPT-2's ``/generate`` (f32; 1e-5 and identical ids); the status
codes and ``Retry-After`` of the 400 / 404 / 503 / 504 paths (a
plain-Python session gated on an event, so the queue states are exact,
not timed); the ``/v2/models`` body, the ``/healthz`` keys and the metric
families ``/metrics`` renders for a model. Every client call has a socket
timeout and every server is stopped in a ``finally``.
"""
import json
import threading
import time

import numpy as np
import pytest

import flexflow_tpu as ffj
import flexflow_tpu.serving as jserving
import flexflow_tpu_torch as fft
import flexflow_tpu_torch.serving as tserving
from flexflow_tpu.resilience import status as jstatus
from flexflow_tpu_torch.resilience import status as tstatus

from _torch_serving import (FixedSession, bert_pair, bert_requests, get,
                            gpt2_pair, infer_doc, post)

PKGS = (("jax", jserving), ("port", tserving))


class _Front:
    """One running front of one package: ``url`` and ``stop()``."""

    def __init__(self, pkg, repo, kind, **kw):
        if kind == "http":
            self.h = pkg.serve_http(repo, port=0, block=False, **kw)
            port = self.h.server.server_address[1]
        else:
            self.h = pkg.serve_async(repo, port=0, block=False, **kw)
            port = self.h.port
        self.url = f"http://127.0.0.1:{port}"
        self.schedulers = self.h.schedulers if kind == "async" \
            else self.h[2]

    def stop(self):
        self.h.stop()


def _fronts(repos, kind, **kw):
    out = {}
    try:
        for name, pkg in PKGS:
            out[name] = _Front(pkg, repos[name], kind, **kw)
    except Exception:
        for f in out.values():
            f.stop()
        raise
    return out


@pytest.fixture(scope="module")
def bert_repos():
    jff, tff = bert_pair()
    repos = {}
    for (name, pkg), ff in zip(PKGS, (jff, tff)):
        repos[name] = pkg.ModelRepository()
        repos[name].register("bert", pkg.InferenceSession(
            ff, batch_buckets=(4,)))
    return repos


@pytest.mark.parametrize("kind", ["http", "async"])
def test_front_outputs_match_jax(bert_repos, kind):
    fronts = _fronts(bert_repos, kind, max_batch=4, max_delay_ms=2.0)
    try:
        for rows, seed in ((1, 3), (3, 4), (4, 5)):
            body = json.dumps(infer_doc(bert_requests(rows, seed=seed)))
            outs = {}
            for name, f in fronts.items():
                code, doc, _ = post(f.url + "/v2/models/bert/infer",
                                    body.encode())
                assert code == 200, doc
                o = doc["outputs"][0]
                outs[name] = np.asarray(o["data"], np.float32).reshape(
                    o["shape"])
            assert outs["port"].shape == outs["jax"].shape == (rows, 2)
            np.testing.assert_allclose(outs["port"], outs["jax"], rtol=0,
                                       atol=1e-5)
    finally:
        for f in fronts.values():
            f.stop()


def _codes_scenario(f, sched):
    """The 400 / 404 / 503 / 504 paths against one front whose model is
    a gated FixedSession with max_batch 1 and max_queue 2. Returns
    [(case, status, Retry-After)]."""
    url = f.url + "/v2/models/m/infer"
    ok = infer_doc({"input": np.zeros((1, 8), np.float32)})
    out = []

    def rec(case, r):
        out.append((case, r[0], r[2].get("Retry-After")))
    for bad in ("banana", "0", "-5", "inf", "nan"):
        rec(f"timeout={bad}", post(url, ok, {"x-ff-timeout-ms": bad}))
    rec("feature-shape", post(url, infer_doc(
        {"input": np.zeros((1, 7), np.float32)})))
    rec("unknown-input", post(url, infer_doc(
        {"input": np.zeros((1, 8), np.float32),
         "extra": np.zeros((1, 8), np.float32)})))
    rec("not-json", post(url, b"{nope"))
    rec("unknown-model", post(f.url + "/v2/models/nope/infer", ok))
    rec("no-route", post(f.url + "/v2/other", ok))
    # hold the worker's step, then one queued request whose deadline
    # passes in the queue (504, never executed; it keeps its queue slot
    # until the worker pops it), then a full queue: of two more, one
    # takes the last slot and one is shed (503), as is the next
    results = {}

    def bg(key, headers=None):
        results[key] = post(url, ok, headers)
    held = threading.Thread(target=bg, args=("held",))
    held.start()
    end = time.perf_counter() + 10
    while sched.session.calls < 1 and time.perf_counter() < end:
        time.sleep(0.005)
    rec("expired-in-queue", post(url, ok, {"x-ff-timeout-ms": "50"}))
    # one at a time, so that which of the two is shed is not a race
    q1 = threading.Thread(target=bg, args=("q1",))
    q1.start()
    while sched._q.qsize() < 2 and time.perf_counter() < end:
        time.sleep(0.005)
    q2 = threading.Thread(target=bg, args=("q2",))
    q2.start()
    q2.join(timeout=30)
    rec("queue-full", post(url, ok))
    sched.session.gate.set()
    for t in (held, q1, q2):
        t.join(timeout=30)
    out.append(("backlog", sorted(r[0] for r in results.values()), None))
    return out


@pytest.mark.parametrize("kind", ["http", "async"])
def test_status_codes_and_retry_after_match(kind):
    repos = {}
    for name, pkg in PKGS:
        repos[name] = pkg.ModelRepository()
        repos[name].register("m", FixedSession(gate=threading.Event()))
    fronts = _fronts(repos, kind, max_batch=1, max_queue=2)
    got = {}
    try:
        for name, f in fronts.items():
            got[name] = _codes_scenario(f, f.schedulers["m"])
            # draining: readiness 503, new work 503 + Retry-After
            f.h.state.draining = True
            code, _ = get(f.url + "/v2/health/ready")
            r = post(f.url + "/v2/models/m/infer",
                     infer_doc({"input": np.zeros((1, 8), np.float32)}))
            got[name] += [("ready-draining", code, None),
                          ("draining", r[0], r[2].get("Retry-After"))]
    finally:
        for f in fronts.values():
            f.stop()
    assert got["port"] == got["jax"]
    codes = {case: (c, ra) for case, c, ra in got["port"]}
    assert all(codes[f"timeout={b}"] == (400, None)
               for b in ("banana", "0", "-5", "inf", "nan"))
    assert codes["feature-shape"][0] == codes["unknown-input"][0] == 400
    assert codes["unknown-model"][0] == codes["no-route"][0] == 404
    assert codes["expired-in-queue"] == (504, None)
    assert codes["queue-full"] == (503, "1")
    assert codes["backlog"] == ([200, 200, 503], None)
    assert codes["draining"] == (503, "5")
    assert codes["ready-draining"][0] == 503


def _keys(doc):
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    return type(doc).__name__


def _families(text, model):
    fams = set()
    for ln in text.splitlines():
        if ln and not ln.startswith("#") and f'model="{model}"' in ln:
            name = ln.split("{")[0]
            for suf in ("_bucket", "_sum", "_count"):
                name = name.removesuffix(suf)
            fams.add(name)
    return fams


@pytest.mark.parametrize("kind", ["http", "async"])
def test_models_healthz_and_metric_families_match(kind):
    model = f"fam_{kind}"
    # /healthz carries resilience.checkpoint_age_s once a checkpoint was
    # saved in the process: start both packages' status from the
    # process-start state, whatever an earlier test on this worker saved
    jstatus.reset()
    tstatus.reset()
    repos = {}
    for name, pkg in PKGS:
        repos[name] = pkg.ModelRepository()
        repos[name].register(model, FixedSession())
        repos[name].register("other", FixedSession())
    fronts = _fronts(repos, kind, max_batch=2)
    docs = {}
    try:
        for name, f in fronts.items():
            for _ in range(3):
                r = post(f"{f.url}/v2/models/{model}/infer",
                         infer_doc({"input": np.zeros((1, 8),
                                                      np.float32)}))
                assert r[0] == 200, r
            docs[name] = {
                "models": get(f.url + "/v2/models"),
                "healthz": get(f.url + "/healthz"),
                "ready": get(f.url + "/v2/health/ready")[0],
                "metrics": get(f.url + "/metrics"),
                "v2metrics": get(f.url + "/v2/metrics")}
    finally:
        for f in fronts.values():
            f.stop()
    j, t = docs["jax"], docs["port"]
    assert t["models"] == j["models"] == (200, {"models": [model,
                                                           "other"]})
    assert t["ready"] == j["ready"] == 200
    assert _keys(t["healthz"][1]) == _keys(j["healthz"][1])
    assert t["healthz"][1]["serving"][model]["circuit"] == "closed"
    fams = _families(t["metrics"][1], model)
    assert fams == _families(j["metrics"][1], model)
    assert {"ff_requests_total", "ff_request_latency_seconds",
            "ff_queue_depth", "ff_scheduler_instances", "ff_circuit_state",
            "ff_request_latency_quantile"} <= fams
    jm, tm = j["v2metrics"][1]["models"][model], \
        t["v2metrics"][1]["models"][model]
    assert set(tm) == set(jm) | {"individual_retries"}
    for k in ("requests", "completed", "batches", "queue_depth",
              "instances", "circuit", "draining"):
        assert tm[k] == jm[k], k
    assert tm["sketches"]["all"]["count"] == jm["sketches"]["all"]["count"]


@pytest.fixture(scope="module")
def gpt2_repos():
    jff, tff = gpt2_pair(batch=4, seq=16)
    repos = {}
    for (name, pkg), ff in zip(PKGS, (jff, tff)):
        repos[name] = pkg.ModelRepository()
        repos[name].register("gpt", pkg.InferenceSession(
            ff, batch_buckets=(1, 4), decode_segment=4))
    return repos


@pytest.mark.parametrize("kind", ["http", "async"])
def test_generate_route_matches_jax(gpt2_repos, kind):
    rng = np.random.default_rng(11)
    ids = np.zeros((3, 16), np.int32)
    ids[:, :5] = rng.integers(1, 64, (3, 5))
    cases = [{"prompt_len": 5, "max_new_tokens": 6},
             {"prompt_len": [2, 5, 3], "max_new_tokens": 7,
              "eos_token_id": 7},
             {"max_new_tokens": 3}]                       # 400
    fronts = _fronts(gpt2_repos, kind)
    try:
        for params in cases:
            doc = infer_doc({"input_ids": ids})
            doc["parameters"] = params
            got = {n: post(f.url + "/v2/models/gpt/generate", doc)
                   for n, f in fronts.items()}
            assert got["port"][0] == got["jax"][0]
            if got["port"][0] != 200:
                assert got["port"][0] == 400
                continue
            assert got["port"][1] == got["jax"][1]
    finally:
        for f in fronts.values():
            f.stop()


def test_unload_route_matches():
    repos = {}
    for name, pkg in PKGS:
        repos[name] = pkg.ModelRepository()
        repos[name].register("m", FixedSession())
    fronts = _fronts(repos, "http")
    try:
        got = {}
        for name, f in fronts.items():
            ok = infer_doc({"input": np.zeros((1, 8), np.float32)})
            got[name] = [
                post(f.url + "/v2/repository/models/m/unload", b"")[:2],
                post(f.url + "/v2/repository/models/m/unload", b"")[0],
                post(f.url + "/v2/models/m/infer", ok)[0],
                get(f.url + "/v2/models")]
    finally:
        for f in fronts.values():
            f.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0] == (200, {"unloaded": "m"})


def test_repository_loaders_match_jax(tmp_path):
    """``load_graph`` (a graph file written by the JAX package's
    ``torch_to_file``) and ``load_onnx`` (wire-encoded bytes) in both
    packages; the port's loader compiles on the config's device (here
    the CPU), and the ONNX weights come from the initializers in both."""
    torch = pytest.importorskip("torch")
    from flexflow_tpu.frontends import onnx_wire as w
    from flexflow_tpu.frontends.torch_fx import PyTorchModel
    from flexflow_tpu_torch.interop import load_reference_params
    import jax

    m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                            torch.nn.Linear(16, 3)).eval()
    path = str(tmp_path / "g.json")
    cfg = ffj.FFConfig()
    cfg.only_data_parallel = True
    ff = ffj.FFModel(cfg)
    PyTorchModel(m).torch_to_file(ff, [ff.create_tensor((4, 8), name="x")],
                                  path)
    rng = np.random.default_rng(7)
    w1 = (rng.normal(size=(16, 8)) * 0.3).astype(np.float32)
    b1 = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(4, 16)) * 0.3).astype(np.float32)
    b2 = (rng.normal(size=(4,)) * 0.1).astype(np.float32)
    onnx_bytes = w.make_model(
        nodes=[w.make_node("Gemm", ["x", "w1", "b1"], ["h"], name="fc1",
                           transB=1),
               w.make_node("Relu", ["h"], ["hr"], name="relu1"),
               w.make_node("Gemm", ["hr", "w2", "b2"], ["y"], name="fc2",
                           transB=1)],
        inputs=[w.make_value_info("x", 1, [4, 8])],
        outputs=[w.make_value_info("y", 1, [4, 4])],
        initializers=[w.make_tensor("w1", w1), w.make_tensor("b1", b1),
                      w.make_tensor("w2", w2), w.make_tensor("b2", b2)])
    x = rng.normal(size=(2, 8)).astype(np.float32)
    out = {}
    for name, pkg, ffpkg in (("jax", jserving, ffj), ("port", tserving,
                                                     fft)):
        c = ffpkg.FFConfig()
        c.use_bf16_compute = False
        if name == "port":
            c.device = "cpu"
        repo = pkg.ModelRepository()
        g = repo.load_graph("net", path, input_shapes=[(4, 8)], config=c,
                            batch_buckets=(4,))
        o = repo.load_onnx("onnx", onnx_bytes, config=c,
                           batch_buckets=(4,), instances=2)
        assert len(repo.get_instances("onnx")) == 2
        out[name] = (g, repo)
    jg, tg = out["jax"][0], out["port"][0]
    assert tg.ff.device.type == "cpu"
    load_reference_params(tg.ff, jax.device_get(jg.ff.params),
                          [(l.name, l.op_type) for l in jg.ff.layers])
    np.testing.assert_allclose(tg.infer({"x": x}), jg.infer({"x": x}),
                               rtol=0, atol=1e-5)
    ref = np.maximum(x @ w1.T + b1, 0.0) @ w2.T + b2
    for name in ("jax", "port"):
        got = out[name][1].get("onnx").infer({"x": x})
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="not both"):
        tserving.ModelRepository()._load_with_builder(
            "m", None, (1,), None, strategy_file="a.json",
            instances=1, serving_strategy_file="b.json")
