"""``recompile_on_condition`` (``runtime/recompile.py`` and ``fit``'s
hook) in the port against the JAX package.

``RecompileState`` evaluates its trigger once per step, runs the alter
and drops the cached step functions when it fires, and counts in the
same places (``recompilations``, the ``runtime.recompile`` instant, the
``executor.recompiles`` counter, ``ff_recompiles_total``). A ``fit``
whose trigger changes Adam's alpha once gives the JAX package's history
from the same weights (f32, 1e-5). The repair of ``FFModel.cache``: a
``score_fn`` is accepted and ignored, as in the JAX package.
"""
import os
import sys

import jax
import numpy as np

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.obs import events as jevents
from flexflow_tpu.obs.metrics_registry import REGISTRY as JREG
from flexflow_tpu.runtime.recompile import RecompileState as JState
from flexflow_tpu_torch.interop import load_reference_params
from flexflow_tpu_torch.obs import events as tevents
from flexflow_tpu_torch.obs.metrics_registry import REGISTRY as TREG
from flexflow_tpu_torch.runtime.recompile import RecompileState as TState

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_graphs as graphs  # noqa: E402


class _Exec:
    _train_step = _eval_step = _forward_fn = "cached"


class _FF:
    def __init__(self):
        self.executor = _Exec()
        self.altered = 0


def test_recompile_state_fires_and_counts_like_jax():
    out = {}
    for tag, cls, events, reg in (("jax", JState, jevents, JREG),
                                  ("port", TState, tevents, TREG)):
        ff = _FF()

        def alter(s, ff=ff):
            ff.altered += 1

        rs = cls(lambda s: s.iteration % 3 == 0, alter, ff=ff)
        before = reg.counter("ff_recompiles_total").value()
        events.enable()
        try:
            events.clear()
            fired = [rs.step(ff) for _ in range(7)]
            inst = [e for e in events.events()
                    if e["name"] == "runtime.recompile"]
            n_counter = events.counters().get("executor.recompiles", 0)
        finally:
            events.disable()
        out[tag] = (fired, rs.iteration, rs.recompilations, ff.altered,
                    reg.counter("ff_recompiles_total").value() - before,
                    len(inst), n_counter,
                    (ff.executor._train_step, ff.executor._eval_step,
                     ff.executor._forward_fn))
    assert out["port"] == out["jax"]
    assert out["port"][0] == [False, False, True, False, False, True,
                              False]
    assert out["port"][-1] == (None, None, None)


def _pair():
    jff, tff = graphs.bert(batch=4, seq=16, dropout=0.0,
                           use_bf16_compute=False, only_data_parallel=True)
    for ff, pkg in ((jff, ffj), (tff, fft)):
        ff.compile(pkg.AdamOptimizer(alpha=1e-3, epsilon=1e-4),
                   "sparse_categorical_crossentropy", ["accuracy"])
    load_reference_params(tff, jax.device_get(jff.params),
                          [(l.name, l.op_type) for l in jff.layers])
    return jff, tff


def test_fit_with_a_trigger_matches_jax():
    jff, tff = _pair()
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 1024, (12, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (12, 1))
    y = rng.integers(0, 2, (12, 1)).astype(np.int32)
    hist, states = {}, {}
    for tag, ff in (("jax", jff), ("port", tff)):
        rs = ff.recompile_on_condition(
            lambda s: s.iteration == 2,
            lambda s: setattr(s.ff.optimizer, "alpha", 1e-4))
        hist[tag] = ff.fit([ids, pos], y, epochs=2, verbose=False)
        states[tag] = (rs.recompilations, rs.iteration,
                       ff.optimizer.alpha, ff._step)
    assert states["port"] == states["jax"] == (1, 6, 1e-4, 6)
    for g, w in zip(hist["port"], hist["jax"]):
        np.testing.assert_allclose(g["loss"], w["loss"], atol=1e-5, rtol=0)
    jp = jax.device_get(jff.params)
    for ln, ws in tff.params.items():
        for wn, w in ws.items():
            np.testing.assert_allclose(w.numpy(), np.asarray(jp[ln][wn]),
                                       atol=1e-5, rtol=0)
