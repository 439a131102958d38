"""The port's DLRM and XDL against the JAX package, and the ``FFModel``
weight and state API: tiny tables (50/40/30/20 x 8) built through
``FFModel`` in both, the reference's weights carried into the port by
``interop``, the forward (embedding bags summed, the concat interaction,
the MLPs) and a loss history through ``fit`` with Adam (the port's fused
plan on its plain version); then ``get_weights`` / ``set_weights`` /
``set_state`` round trips and their shape checks, ``get_layer_by_name``,
``get_layers``, ``set_optimizer``, ``label_tensor_for_loaders`` and
``interop.load_reference_state``'s checks.

f32 throughout (``use_bf16_compute=False``): the two packages differ
only in the order of their f32 sums, and everything holds to 1e-5.
Adam runs at epsilon 1e-4, as in ``test_torch_train.py``.
"""
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu import models as jm
from flexflow_tpu_torch import models as tm
from flexflow_tpu_torch.interop import (load_reference_params,
                                        load_reference_state)
from flexflow_tpu_torch.kernels.opt_update import fused_adam_update

BATCH = 8
TABLES = (50, 40, 30, 20)
ATOL = 1e-5


def _dlrm_cfg(zoo):
    return zoo.DLRMConfig(embedding_size=TABLES, sparse_feature_size=8,
                          embedding_bag_size=3, mlp_bot=(4, 16, 8),
                          mlp_top=(40, 16, 2))


def _xdl_cfg(zoo):
    return zoo.XDLConfig(embedding_size=TABLES, sparse_feature_size=8,
                         embedding_bag_size=2, mlp=(16, 8, 2))


def _pair(build, cfg_of):
    models = []
    for pkg, zoo, extra in ((ffj, jm, {}), (fft, tm, {"device": "cpu"})):
        cfg = pkg.FFConfig()
        cfg.batch_size = BATCH
        cfg.only_data_parallel = True
        cfg.use_bf16_compute = False
        ff = pkg.FFModel(cfg, **extra)
        getattr(zoo, build)(ff, BATCH, cfg_of(zoo))
        ff.compile(pkg.AdamOptimizer(alpha=1e-2, epsilon=1e-4),
                   "sparse_categorical_crossentropy", ["accuracy"])
        models.append(ff)
    jff, ff = models
    load_reference_params(ff, jax.device_get(jff.params),
                          [(l.name, l.op_type) for l in jff.layers])
    ff.executor._kernel_impls["opt_update"] = "fused"
    return jff, ff


def _data(rows, bag, dense, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.integers(0, n, (rows, bag)).astype(np.int32) for n in TABLES]
    if dense:
        xs.append(rng.standard_normal((rows, 4)).astype(np.float32))
    y = rng.integers(0, 2, (rows, 1)).astype(np.int32)
    return xs, y


@pytest.mark.parametrize("build,cfg_of,bag,dense", [
    ("build_dlrm", _dlrm_cfg, 3, True), ("build_xdl", _xdl_cfg, 2, False)])
def test_forward_and_fit_history_match_jax(build, cfg_of, bag, dense):
    jff, ff = _pair(build, cfg_of)
    assert [t.name for t in ff.graph_inputs] == \
        [t.name for t in jff.graph_inputs]
    xs, y = _data(4 * BATCH, bag, dense)
    batch = {t.name: a[:BATCH] for t, a in zip(ff.graph_inputs, xs)}
    want = np.asarray(jff.executor.make_forward()(jff.params, jff.state,
                                                  batch))
    got = ff.executor.make_forward()(ff.params, ff.state, batch)
    assert tuple(got.shape) == (BATCH, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    before = fused_adam_update.plain_calls
    hist_t = ff.fit(xs, y, epochs=2, verbose=False)
    hist_j = jff.fit(xs, y, epochs=2, verbose=False)
    assert fused_adam_update.plain_calls - before == 8
    for g, w in zip(hist_t, hist_j):
        assert g["accuracy"] == w["accuracy"]
        np.testing.assert_allclose(g["loss"], w["loss"], atol=ATOL, rtol=0)
    jp = jax.device_get(jff.params)
    for ln, ws in ff.params.items():
        for wn, t in ws.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[ln][wn]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{ln}/{wn}")


def test_configs_default_to_the_reference_examples():
    for name in ("DLRMConfig", "XDLConfig"):
        assert dataclasses.asdict(getattr(tm, name)()) == \
            dataclasses.asdict(getattr(jm, name)())
    ff = fft.FFModel(fft.FFConfig(), device="cpu")
    tm.build_dlrm(ff, 2)
    n = sum(int(np.prod(w.shape)) for l in ff.layers for w in l.weights)
    # 4 tables of 1e6 x 64, the bottom MLP 4-64-64 (4,480) and the top
    # MLP over the 320-wide concat, 320-64-2 (20,674)
    assert n == 256_025_154


def test_models_export_the_jax_packages_names():
    import types

    def public(m):
        return {n for n in dir(m) if not n.startswith("_")
                and not isinstance(getattr(m, n), types.ModuleType)}
    assert public(tm) == public(jm)
    for name in public(jm):
        j, t = getattr(jm, name), getattr(tm, name)
        if dataclasses.is_dataclass(j):
            continue              # configs: test_configs_default_to_...
        assert inspect.signature(t) == inspect.signature(j), name


def test_dlrm_rejects_other_interactions_like_jax():
    for zoo, pkg, extra in ((jm, ffj, {}), (tm, fft, {"device": "cpu"})):
        cfg = _dlrm_cfg(zoo)
        cfg.arch_interaction_op = "dot"
        with pytest.raises(ValueError, match="only 'cat'"):
            zoo.build_dlrm(pkg.FFModel(pkg.FFConfig(), **extra), 2, cfg)


# ---------------------------------------------------------------------------
# the FFModel weight and state API
# ---------------------------------------------------------------------------
def _bn_model(pkg, accum=1, **extra):
    cfg = pkg.FFConfig()
    cfg.batch_size = 4
    cfg.use_bf16_compute = False
    cfg.gradient_accumulation_steps = accum
    ff = pkg.FFModel(cfg, **extra)
    x = ff.create_tensor((4, 3, 6, 6), name="input")
    t = ff.conv2d(x, 5, 3, 3, 1, 1, 1, 1, name="conv")
    t = ff.batch_norm(t, name="bn")
    t = ff.pool2d(t, 6, 6, 1, 1, 0, 0, ffj.PoolType.POOL_AVG)
    t = ff.flat(t)
    ff.softmax(ff.dense(t, 3, name="head"))
    ff.compile(pkg.SGDOptimizer(0.1), "sparse_categorical_crossentropy",
               ["accuracy"])
    return ff


def test_weight_and_state_round_trips_and_shape_checks():
    ff = _bn_model(fft, device="cpu")
    w = np.arange(15, dtype=np.float32).reshape(5, 3)
    with pytest.raises(ValueError, match="shape"):
        ff.set_weights("head", "kernel", w.T)
    ff.set_weights("head", "kernel", w)
    assert ff.params["head"]["kernel"].dtype == torch.float32
    np.testing.assert_array_equal(ff.get_weights("head", "kernel"), w)
    np.testing.assert_array_equal(ff.get_weights("conv"),
                                  ff.params["conv"]["kernel"].numpy())
    mean = np.linspace(-1, 1, 5).astype(np.float32)
    ff.set_state("bn", "mean", mean)
    np.testing.assert_array_equal(ff.state["bn"]["mean"].numpy(), mean)
    with pytest.raises(ValueError, match="shape"):
        ff.set_state("bn", "var", np.ones(4, np.float32))


def test_layer_lookup_optimizer_and_label_tensor_match_jax():
    jff, ff = _bn_model(ffj), _bn_model(fft, device="cpu")
    assert ff.get_layer_by_name("bn").op_type == fft.OperatorType.OP_BATCHNORM
    assert ff.get_layer_by_name("nope") is None
    assert [(i, l.name) for i, l in ff.get_layers().items()] == \
        [(i, l.name) for i, l in jff.get_layers().items()]
    lt, jlt = ff.label_tensor_for_loaders, jff.label_tensor_for_loaders
    assert (lt.shape, int(lt.dtype)) == (jlt.shape, int(jlt.dtype))
    assert ff.label_tensor_for_loaders is lt
    opt = fft.AdamOptimizer(1e-3)
    ff.set_optimizer(opt)
    assert ff.optimizer is opt


def test_load_reference_state_pairs_and_checks_like_params():
    jff, ff = _bn_model(ffj), _bn_model(fft, device="cpu")
    names = [(l.name, l.op_type) for l in jff.layers]
    st = jax.device_get(jff.state)
    st = {ln: {n: np.asarray(v) + 0.5 for n, v in d.items()}
          for ln, d in st.items()}
    load_reference_state(ff, st, names)
    np.testing.assert_array_equal(ff.state["bn"]["var"].numpy(),
                                  np.full(5, 1.5, np.float32))
    with pytest.raises(ValueError, match="state names differ"):
        load_reference_state(ff, {"bn": {"mean": st["bn"]["mean"]}}, names)
    with pytest.raises(ValueError, match="shape differs"):
        load_reference_state(ff, {"bn": {"mean": np.zeros(4),
                                         "var": st["bn"]["var"]}}, names)


@pytest.mark.parametrize("accum", [1, 2])
def test_batch_norm_state_is_written_once_per_micro_batch_like_jax(accum):
    """Two train steps: the running statistics are written back after
    each step and, with gradient accumulation, threaded through the
    micro-batches (each updates them once), as the JAX package's scan
    threads them."""
    jff, ff = _bn_model(ffj, accum), _bn_model(fft, accum, device="cpu")
    names = [(l.name, l.op_type) for l in jff.layers]
    load_reference_params(ff, jax.device_get(jff.params), names)
    for m in (jff, ff):
        step = m.executor.make_train_step()
        for i in range(2):
            batch = {"input": np.random.default_rng(i).standard_normal(
                         (4, 3, 6, 6)).astype(np.float32),
                     "label": np.array([[0], [1], [2], [1]], np.int32)}
            m._run_train_step(step, batch)
    js = jax.device_get(jff.state)
    for n in ("mean", "var"):
        np.testing.assert_allclose(ff.state["bn"][n].numpy(),
                                   np.asarray(js["bn"][n]), atol=ATOL,
                                   rtol=0)
    # 2 steps x accum micro-batches, each moving the state by momentum 0.1
    assert not np.allclose(ff.state["bn"]["var"].numpy(), 1.0)
