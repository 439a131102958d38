"""Shared pieces of the serving-stack parity tests (``test_torch_scheduler``,
``test_torch_serving_http``, ``test_torch_serving_plan``,
``test_torch_continuous``, ``test_torch_fleet``): the same small models
built in both packages with the JAX package's weights carried into the
port (f32 compute, so outputs agree to summation order), fixed-latency
and fault-injecting fake sessions, and bounded HTTP helpers (every
client call carries a socket timeout)."""
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np

import flexflow_tpu as ffj
import flexflow_tpu.models as jmodels
import flexflow_tpu_torch as fft
import flexflow_tpu_torch.models as tmodels
from flexflow_tpu_torch.interop import load_reference_params

HTTP_TIMEOUT = 30.0


def _config(pkg, batch):
    cfg = pkg.FFConfig()
    cfg.batch_size = batch
    cfg.only_data_parallel = True
    cfg.use_bf16_compute = False
    return cfg


def _carry(jff, tff):
    load_reference_params(tff, jax.device_get(jff.params),
                          [(l.name, l.op_type) for l in jff.layers])
    return jff, tff


def bert_pair(batch=4, seq=16):
    """BERT at 2 layers and width 64 (``BertConfig.tiny()``), compiled at
    ``batch`` in both packages; the port holds the JAX weights. BERT's
    pooler reshapes to the compile batch, so its one bucket is
    ``batch``."""
    out = []
    for pkg, m, kw in ((ffj, jmodels, {}), (fft, tmodels,
                                          {"device": "cpu"})):
        ff = pkg.FFModel(_config(pkg, batch), **kw)
        c = m.BertConfig.tiny()
        c.max_position, c.dropout = seq, 0.0
        o = m.build_bert(ff, batch, seq, c)
        ff.compile(pkg.SGDOptimizer(0.0), "identity", [], output_tensor=o)
        out.append(ff)
    return _carry(*out)


def gpt2_pair(batch=4, seq=32, impl="xla"):
    """The reference tests' tiny GPT-2 (vocab 64, hidden 32, 2 layers, 4
    heads) compiled at ``batch`` x ``seq`` in both packages, weights
    carried."""
    out = []
    for pkg, m, kw in ((ffj, jmodels, {}), (fft, tmodels,
                                          {"device": "cpu"})):
        cfg = _config(pkg, batch)
        cfg.kernel_impls = f"attention:{impl}"
        ff = pkg.FFModel(cfg, **kw)
        g = m.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                        num_heads=4, max_position=seq, dropout=0.0)
        o = m.build_gpt2(ff, batch, seq, g)
        ff.compile(pkg.SGDOptimizer(0.0), "identity", [], output_tensor=o)
        out.append(ff)
    return _carry(*out)


def bert_requests(rows, seq=16, seed=0, vocab=1024):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, (rows, seq))
            .astype(np.int32),
            "position_ids": np.tile(np.arange(seq, dtype=np.int32),
                                    (rows, 1))}


class FixedSession:
    """A session whose every device step takes ``step_s`` and returns
    zeros (rows, 4); ``gate`` (a threading.Event), when given, holds
    each step until it is set. Counts calls and the rows it saw."""

    input_names = ["input"]
    input_signature = {"input": ((1, 8), np.dtype(np.float32))}

    def __init__(self, step_s=0.0, gate=None, fail_calls=()):
        self.step_s = step_s
        self.gate = gate
        self.fail_calls = set(fail_calls)
        self.calls = 0
        self.seen = []
        self._lock = threading.Lock()

    def infer(self, inputs):
        with self._lock:
            i = self.calls
            self.calls += 1
        x = np.asarray(inputs["input"])
        self.seen.extend(x[:, 0].tolist())
        if self.gate is not None:
            self.gate.wait(timeout=30)
        if self.step_s:
            time.sleep(self.step_s)
        if i in self.fail_calls or np.isnan(x).any():
            raise RuntimeError(f"injected session failure (call {i})")
        return np.zeros((x.shape[0], 4), np.float32)

    def clone(self):
        return self


def post(url, doc_or_bytes, headers=None, timeout=HTTP_TIMEOUT):
    """(status, body dict, headers) of one POST; HTTP errors included."""
    body = doc_or_bytes if isinstance(doc_or_bytes, bytes) \
        else json.dumps(doc_or_bytes).encode()
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            doc = json.loads(raw)
        except ValueError:
            doc = {"raw": raw.decode(errors="replace")}
        return e.code, doc, dict(e.headers)


def get(url, timeout=HTTP_TIMEOUT):
    """(status, body) of one GET: JSON as a dict, text as a str."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            raw, ctype, code = r.read(), r.headers.get("Content-Type"), \
                r.status
    except urllib.error.HTTPError as e:
        raw, ctype, code = e.read(), e.headers.get("Content-Type"), e.code
    if ctype and ctype.startswith("application/json"):
        return code, json.loads(raw)
    return code, raw.decode()


def infer_doc(inputs):
    return {"inputs": [{"name": k, "shape": list(v.shape),
                        "datatype": str(v.dtype).upper(),
                        "data": v.ravel().tolist()}
                       for k, v in inputs.items()]}


def wait_idle(sched, timeout_s=10.0):
    end = time.perf_counter() + timeout_s
    while time.perf_counter() < end:
        with sched._stat_lock:
            if sched._pending == 0:
                return True
        time.sleep(0.005)
    return False
