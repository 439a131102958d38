"""The port's vision slice against the JAX package: Conv2D, Pool2D, Flat
and BatchNorm op by op (outputs, running state, and ``jax.grad`` against
``torch.autograd.grad`` of a random projection of the outputs), then
AlexNet (CIFAR-10), ResNet-50, ResNeXt-50 and Inception-v3 built through
``FFModel`` in both packages at small images, the reference's weights
and BatchNorm state carried into the port by ``interop``.

f32 throughout (``use_bf16_compute=False``) unless a test says
otherwise: the two packages then differ only in the order of their f32
sums, and outputs, gradients and state hold to 1e-5. The bf16 conv path
rounds the convolution's result to bf16 in both; there the two may part
by one bf16 rounding (2**-8 of the value) where their f32 sums differ in
the last bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu import models as jm
from flexflow_tpu.ops import get_op_def as jax_op
from flexflow_tpu.ops.registry import EmitCtx as JaxCtx
from flexflow_tpu_torch import models as tm
from flexflow_tpu_torch.interop import (load_reference_opt_state,
                                        load_reference_params,
                                        load_reference_state)
from flexflow_tpu_torch.ops import get_op_def as torch_op
from flexflow_tpu_torch.ops.registry import EmitCtx as TorchCtx

TOL = dict(atol=1e-5, rtol=1e-5)
OT = ffj.OperatorType
ACT = ffj.ActiMode
BF16_ULP = 2.0 ** -8


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ctxs(training, state, bf16):
    cj, ct = ffj.FFConfig(), fft.FFConfig()
    for c in (cj, ct):
        c.use_bf16_compute = bf16
    st_t = {k: {n: torch.tensor(np.asarray(v)) for n, v in d.items()}
            for k, d in (state or {}).items()}
    return (JaxCtx(training, state=dict(state or {}), config=cj),
            TorchCtx(training, state=st_t, config=ct))


def _both(op_type, params, x, training=False, state=None, bf16=False,
          seed=0):
    """One op in both packages on ``x`` with weights drawn from the JAX
    specs. Returns (port out, JAX out, port grads, JAX grads, port new
    state, JAX new state); the grads are those of ``sum(out * ct)`` (a
    random cotangent) with respect to x and each weight, in that
    order."""
    op_j, op_t = jax_op(op_type), torch_op(int(op_type))
    specs = op_j.weights(params, [x.shape], [ffj.DataType.DT_FLOAT])
    assert [(s.name, s.shape) for s in specs] == \
        [(s.name, s.shape) for s in op_t.weights(
            params, [x.shape], [fft.DataType.DT_FLOAT])]
    rng = np.random.default_rng(seed)
    w = {s.name: (0.3 * rng.standard_normal(s.shape) + (
        1.0 if s.name == "scale" else 0.0)).astype(np.float32)
        for s in specs}
    cj, ct = _ctxs(training, state, bf16)
    (out_j,) = op_j.emit(params, [jnp.asarray(x)],
                         {k: jnp.asarray(v) for k, v in w.items()}, cj, "op")
    cot = rng.standard_normal(out_j.shape).astype(np.float32)

    def loss_j(xj, wj):
        (o,) = op_j.emit(params, [xj], wj, _ctxs(training, state, bf16)[0],
                         "op")
        return jnp.sum(o.astype(jnp.float32) * cot)

    gx, gw = jax.grad(loss_j, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()})
    xt = torch.tensor(x, requires_grad=True)
    wt = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    (out_t,) = op_t.emit(params, [xt], wt, ct, "op")
    assert tuple(out_t.shape) == out_j.shape
    gt = torch.autograd.grad((out_t.float() * torch.from_numpy(cot)).sum(),
                             [xt] + list(wt.values()))
    new_t = {k: {n: v.numpy() for n, v in d.items()}
             for k, d in ct.new_state.items()}
    new_j = {k: {n: np.asarray(v) for n, v in d.items()}
             for k, d in cj.new_state.items()}
    return (out_t.detach().float().numpy(), np.asarray(out_j, np.float32),
            [g.numpy() for g in gt],
            [np.asarray(gx)] + [np.asarray(gw[k]) for k in wt],
            new_t, new_j)


def _check(op_type, params, x, **kw):
    got, want, g_got, g_want, st_got, st_want = _both(op_type, params, x,
                                                      **kw)
    np.testing.assert_allclose(got, want, **TOL)
    for g, gw in zip(g_got, g_want):
        np.testing.assert_allclose(g, gw, **TOL)
    assert st_got.keys() == st_want.keys()
    for k in st_want:
        assert st_got[k].keys() == st_want[k].keys()
        for n in st_want[k]:
            np.testing.assert_allclose(st_got[k][n], st_want[k][n], **TOL)
    return got, st_got


def _conv(c_out, k, s, p, groups=1, bias=True, act=ACT.AC_MODE_NONE):
    return {"out_channels": c_out, "kernel_h": k[0], "kernel_w": k[1],
            "stride_h": s, "stride_w": s, "padding_h": p[0],
            "padding_w": p[1], "activation": act, "groups": groups,
            "use_bias": bias}


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("k,s,p", [((3, 3), 1, (1, 1)), ((5, 5), 2, (2, 2)),
                                   ((1, 7), 1, (0, 3)), ((3, 3), 2, (0, 0))])
def test_conv2d(groups, k, s, p):
    _check(OT.OP_CONV2D, _conv(8, k, s, p, groups), _x(2, 8, 9, 11))


@pytest.mark.parametrize("bias,act", [(False, ACT.AC_MODE_NONE),
                                      (True, ACT.AC_MODE_RELU),
                                      (True, ACT.AC_MODE_SIGMOID)])
def test_conv2d_bias_and_activation(bias, act):
    _check(OT.OP_CONV2D, _conv(6, (3, 3), 1, (1, 1), 1, bias, act),
           _x(2, 4, 7, 7))


def test_conv2d_bf16_rounds_its_result_once():
    """bf16 compute: the convolution returns bf16 in both packages, so
    the port's output (no bias) is bf16-representable and lies within one
    bf16 rounding of JAX's, gradients within two."""
    params = _conv(16, (3, 3), 2, (1, 1), 2, bias=False)
    x = _x(2, 8, 13, 13)
    got, want, g_got, g_want, _, _ = _both(OT.OP_CONV2D, params, x,
                                           bf16=True)
    t = torch.from_numpy(got)
    assert torch.equal(t, t.to(torch.bfloat16).float())
    f32 = _both(OT.OP_CONV2D, params, x)[0]
    assert np.abs(got - f32).max() > 0       # the rounding happened
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_ULP * np.abs(want).max())
    for g, gw in zip(g_got, g_want):
        np.testing.assert_allclose(g, gw, rtol=0,
                                   atol=2 * BF16_ULP * np.abs(gw).max())


@pytest.mark.parametrize("pool", [ffj.PoolType.POOL_MAX,
                                  ffj.PoolType.POOL_AVG])
@pytest.mark.parametrize("k,s,p", [((3, 3), 2, (1, 1)), ((3, 3), 1, (0, 0)),
                                   ((2, 3), 2, (1, 0)),
                                   # padding above half the window: the
                                   # port pads explicitly
                                   ((3, 3), 2, (2, 2))])
def test_pool2d(pool, k, s, p):
    params = {"kernel_h": k[0], "kernel_w": k[1], "stride_h": s,
              "stride_w": s, "padding_h": p[0], "padding_w": p[1],
              "pool_type": pool, "activation": ACT.AC_MODE_RELU}
    _check(OT.OP_POOL2D, params, _x(2, 3, 8, 9))


def test_global_avg_pool():
    params = {"kernel_h": 5, "kernel_w": 5, "stride_h": 1, "stride_w": 1,
              "padding_h": 0, "padding_w": 0,
              "pool_type": ffj.PoolType.POOL_AVG,
              "activation": ACT.AC_MODE_NONE}
    got, _ = _check(OT.OP_POOL2D, params, _x(2, 6, 5, 5))
    assert got.shape == (2, 6, 1, 1)


def test_flat():
    got, _ = _check(OT.OP_FLAT, {}, _x(2, 3, 4, 5))
    assert got.shape == (2, 60)


def _bn_state(c, seed=3):
    rng = np.random.default_rng(seed)
    return {"op": {"mean": rng.standard_normal(c).astype(np.float32),
                   "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}


@pytest.mark.parametrize("relu", [True, False])
def test_batch_norm_training_output_and_running_state(relu):
    """Training: batch statistics normalise (biased variance) and update
    the running state with momentum 0.1, the biased variance too."""
    x = 2.0 + 3.0 * _x(4, 5, 3, 3)
    st = _bn_state(5)
    got, new = _check(OT.OP_BATCHNORM, {"relu": relu, "eps": 1e-5,
                                        "momentum": 0.1}, x,
                      training=True, state=st)
    biased = x.astype(np.float64).var(axis=(0, 2, 3))
    np.testing.assert_allclose(new["op"]["var"],
                               0.9 * st["op"]["var"] + 0.1 * biased,
                               rtol=1e-5)
    assert (got >= 0).all() == relu


@pytest.mark.parametrize("relu", [True, False])
def test_batch_norm_eval_reads_the_running_state(relu):
    got, new = _check(OT.OP_BATCHNORM, {"relu": relu}, _x(3, 5, 4, 4),
                      training=False, state=_bn_state(5))
    assert new == {}


def test_batch_norm_without_state_uses_batch_statistics():
    _check(OT.OP_BATCHNORM, {}, _x(3, 4, 2, 2), training=False)


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_2d_input(training):
    _check(OT.OP_BATCHNORM, {"relu": False}, 1.0 + _x(6, 7),
           training=training, state=_bn_state(7))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
def _pair(build, batch, opt=None, loss="sparse_categorical_crossentropy",
          **kw):
    """The same model in both packages (f32), the JAX params and state
    carried into the port."""
    models = []
    for pkg, zoo, extra in ((ffj, jm, {}), (fft, tm, {"device": "cpu"})):
        cfg = pkg.FFConfig()
        cfg.batch_size = batch
        cfg.only_data_parallel = True
        cfg.use_bf16_compute = False
        ff = pkg.FFModel(cfg, **extra)
        out = getattr(zoo, build)(ff, batch, **kw)
        ff.compile(opt(pkg) if opt else pkg.SGDOptimizer(0.01), loss, [],
                   output_tensor=out)
        models.append(ff)
    jff, ff = models
    names = [(l.name, l.op_type) for l in jff.layers]
    load_reference_params(ff, jax.device_get(jff.params), names)
    load_reference_state(ff, jax.device_get(jff.state), names)
    return jff, ff


def _images(n, hw, seed=0):
    return _x(n, 3, hw, hw, seed=seed)


def _forward_matches(jff, ff, x, atol=1e-5):
    want = np.asarray(jff.executor.make_forward()(jff.params, jff.state,
                                                  {"input": x}))
    got = ff.executor.make_forward()(ff.params, ff.state, {"input": x})
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    return want


def _grads_match(jff, ff, batch, atol=1e-5):
    """Gradients of the training loss (and the new op state) from one
    training forward in both."""
    ex = jff.executor

    def loss_fn(p):
        outs, new_state, aux, cap = ex._forward(p, jff.state, batch, True, 0)
        return ex._loss_and_metrics(outs, cap, batch["label"], aux)[0], \
            new_state

    gj, st_j = jax.grad(loss_fn, has_aux=True)(jff.params)
    gt, st_t, _ = ff.executor._grads(ff.params, ff.state, batch, 0)
    gj = jax.device_get(gj)
    for ln, ws in gt.items():
        for wn, g in ws.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(gj[ln][wn]),
                                       atol=atol, rtol=1e-4,
                                       err_msg=f"{ln}/{wn}")
    for ln, d in jax.device_get(st_j).items():
        for n, v in d.items():
            np.testing.assert_allclose(st_t[ln][n].numpy(), np.asarray(v),
                                       **TOL, err_msg=f"{ln}/{n}")


def test_alexnet_cifar10_forward_and_grads():
    jff, ff = _pair("build_alexnet_cifar10", 2)
    x = _images(2, 32)
    probs = _forward_matches(jff, ff, x)
    assert probs.shape == (2, 10)
    y = np.array([[3], [7]], np.int32)
    _grads_match(jff, ff, {"input": x, "label": y})


def test_alexnet_builds_the_jax_graph_at_its_published_image_size():
    graphs = []
    for pkg, zoo, extra in ((ffj, jm, {}), (fft, tm, {"device": "cpu"})):
        ff = pkg.FFModel(pkg.FFConfig(), **extra)
        zoo.build_alexnet(ff, 2, num_classes=1000)
        graphs.append([(l.name, int(l.op_type), l.outputs[0].shape)
                       for l in ff.layers])
    assert graphs[0] == graphs[1]
    assert graphs[1][-1][2] == (2, 1000)


def test_alexnet_forward_matches_jax():
    jff, ff = _pair("build_alexnet", 2, image_hw=67)
    assert _forward_matches(jff, ff, _images(2, 67)).shape == (2, 10)


def _adam(pkg):
    return pkg.AdamOptimizer(alpha=1e-3, epsilon=1e-4)


def _random_state(jff, seed=4):
    """A non-trivial running mean and variance for every BatchNorm."""
    rng = np.random.default_rng(seed)
    for ln, d in jax.device_get(jff.state).items():
        c = np.shape(d["mean"])
        jff.set_state(ln, "mean", (0.2 * rng.standard_normal(c)).astype(
            np.float32))
        jff.set_state(ln, "var", rng.uniform(0.5, 2.0, c).astype(
            np.float32))


def test_resnet50_eval_forward_reads_the_carried_running_state():
    """ResNet-50 at 32x32: the eval forward normalises with the running
    statistics, here random ones carried over from the JAX model."""
    jff, ff = _pair("build_resnet50", 2, image_hw=32)
    _random_state(jff)
    load_reference_state(ff, jax.device_get(jff.state),
                         [(l.name, l.op_type) for l in jff.layers])
    _forward_matches(jff, ff, _images(2, 32))


def test_resnet50_adam_steps_loss_and_running_state():
    """Three Adam steps of ResNet-50 at 32x32, each from the reference's
    weights, optimizer state and running state of that step: each step's
    loss and the running state it writes (53 BatchNorms, once per step),
    then the eval forward on the trained state.

    Each step starts from the reference's values because ResNet-50
    training at initialisation is chaotic in f32
    (``tools/resnet50_f32_sensitivity.py``): the JAX package's own eager
    and jitted gradients differ by up to 25% of a leaf's largest
    gradient, and JAX from weights moved by one ulp reaches a second-step
    loss 0.52 away (Adam 1e-3, batch 8). A free-running history compares
    that noise, not the port. What each step computes from equal inputs
    (the training forward's loss and batch statistics) holds to 1e-4:
    training-mode BatchNorm over a few values per channel amplifies f32
    rounding through the depth (2.4e-5 measured on the first loss).
    Batch 8, not 2: the last stage's maps are 1x1, so at batch 2 its
    BatchNorms normalise 2 values per channel to +-1 whatever they are
    and their true gradient is exactly 0."""
    jff, ff = _pair("build_resnet50", 8, opt=_adam, image_hw=32)
    names = [(l.name, l.op_type) for l in jff.layers]
    rng = np.random.default_rng(5)
    jstep = jff.executor.make_train_step()
    tstep = ff.executor.make_train_step()
    for i in range(3):
        batch = {"input": _images(8, 32, seed=10 + i),
                 "label": rng.integers(0, 10, (8, 1)).astype(np.int32)}
        load_reference_params(ff, jax.device_get(jff.params), names)
        load_reference_opt_state(ff, jax.device_get(jff.opt_state), names)
        before = load_reference_state(ff, jax.device_get(jff.state), names)
        before = {ln: {n: v.clone() for n, v in d.items()}
                  for ln, d in before.items()}
        ff._step = jff._step
        got = float(ff._run_train_step(tstep, batch)["loss"])
        want = float(np.asarray(jff._run_train_step(jstep, batch)["loss"]))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        js = jax.device_get(jff.state)
        assert len(ff.state) == 53
        for ln, d in ff.state.items():
            for n, v in d.items():
                assert not torch.equal(v, before[ln][n]), (i, ln, n)
                np.testing.assert_allclose(
                    v.numpy(), np.asarray(js[ln][n]), rtol=0,
                    atol=1e-4 * max(1.0, np.abs(np.asarray(js[ln][n])).max()),
                    err_msg=f"step {i} {ln}/{n}")
    load_reference_params(ff, jax.device_get(jff.params), names)
    load_reference_state(ff, jax.device_get(jff.state), names)
    _forward_matches(jff, ff, _images(8, 32))


def test_resnext50_forward():
    jff, ff = _pair("build_resnext50", 2, image_hw=32)
    groups = {l.params["groups"] for l in ff.layers
              if l.op_type == fft.OperatorType.OP_CONV2D}
    assert groups == {1, 32}
    _forward_matches(jff, ff, _images(2, 32))


def test_inception_v3_forward():
    jff, ff = _pair("build_inception_v3", 2, image_hw=75)
    assert len(ff.state) == 94
    _forward_matches(jff, ff, _images(2, 75))
