"""The port's remaining element and tensor operators and the MoE operator
family against the JAX package: each op's ``emit`` on the same numpy
inputs and weights in both, outputs and gradients (``jax.grad`` against
``torch.autograd.grad`` of the same random projection of the outputs,
the ops' auxiliary losses included); TopK under forced ties, GroupBy's
capacity overflow, Aggregate's load-balance loss, Cache's state over two
calls; the new ``FFModel`` builders in one graph; and
``build_moe_mnist`` trained through ``fit`` in both, the port's fused
Adam on its plain version.

Everything runs in f32 (``use_bf16_compute=False``), so the two differ
only in the order of their f32 sums: values and gradients hold to atol =
rtol = 2e-5 (the op tests of ``test_torch_ops.py``), integer outputs
(indices, shapes, casts) exactly, and loss histories to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.models.misc import MoeConfig as JaxMoeConfig
from flexflow_tpu.models.misc import build_moe_mnist as jax_build_moe
from flexflow_tpu.ops import get_op_def as jax_op
from flexflow_tpu.ops.registry import EmitCtx as JaxCtx
from flexflow_tpu_torch.interop import load_reference_params
from flexflow_tpu_torch.models import MoeConfig, build_moe_mnist
from flexflow_tpu_torch.ops import get_op_def as torch_op
from flexflow_tpu_torch.ops.moe_ops import dropped_slots
from flexflow_tpu_torch.ops.registry import EmitCtx as TorchCtx

TOL = dict(atol=2e-5, rtol=2e-5)
ATOL = 1e-5
OT = ffj.OperatorType
DT = ffj.DataType


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ctxs(training=False, state=None):
    cj, ct = ffj.FFConfig(), fft.FFConfig()
    for c in (cj, ct):
        c.use_bf16_compute = False
    return (JaxCtx(training, state=state, config=cj),
            TorchCtx(training, state=state and {
                k: {n: torch.tensor(np.asarray(v)) for n, v in d.items()}
                for k, d in state.items()}, config=ct))


def _both(op_type, params, inputs, in_dtypes=None, seed=0):
    """Emit one op in both packages on ``inputs`` (numpy) and weights drawn
    from the JAX specs; the loss ``sum(out_i * ct_i)`` over the float
    outputs (random cotangents) plus the ops' auxiliary losses is
    differentiated with respect to the float inputs and the weights.
    Returns ((port outputs, JAX outputs), (port grads, JAX grads))."""
    op_j, op_t = jax_op(op_type), torch_op(int(op_type))
    dts = in_dtypes or [DT.DT_FLOAT] * len(inputs)
    shapes = [x.shape for x in inputs]
    specs = op_j.weights(params, shapes, dts)
    assert [(s.name, s.shape) for s in specs] == \
        [(s.name, s.shape) for s in op_t.weights(
            params, shapes, [fft.DataType(int(d)) for d in dts])]
    rng = np.random.default_rng(seed)
    w = {s.name: (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
         for s in specs}
    diff = [i for i, x in enumerate(inputs) if x.dtype == np.float32]
    cj, ct = _ctxs()
    out_j = op_j.emit(params, [jnp.asarray(x) for x in inputs],
                      {k: jnp.asarray(v) for k, v in w.items()}, cj, "op")
    cots = [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in out_j]

    def loss_j(xs, ws):
        full = [jnp.asarray(x) for x in inputs]
        for i, v in zip(diff, xs):
            full[i] = v
        c = _ctxs()[0]
        outs = op_j.emit(params, full, ws, c, "op")
        tot = sum((jnp.sum(o * cot) for o, cot in zip(outs, cots)
                   if jnp.issubdtype(o.dtype, jnp.floating)),
                  jnp.float32(0.0))
        return tot + sum(c.aux_losses)

    gj = jax.grad(loss_j, argnums=(0, 1))(
        [jnp.asarray(inputs[i]) for i in diff],
        {k: jnp.asarray(v) for k, v in w.items()})
    xs_t = [torch.tensor(x, requires_grad=i in diff)
            for i, x in enumerate(inputs)]
    ws_t = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    out_t = op_t.emit(params, xs_t, ws_t, ct, "op")
    leaves = [xs_t[i] for i in diff] + list(ws_t.values())
    tot = sum((o * torch.from_numpy(cot)).sum()
              for o, cot in zip(out_t, cots) if o.is_floating_point())
    tot = tot + sum(ct.aux_losses)
    gt = []
    if leaves and torch.is_tensor(tot) and tot.requires_grad:
        gt = [torch.zeros_like(t) if g is None else g for t, g in zip(
            leaves, torch.autograd.grad(tot, leaves, allow_unused=True))]
    want_g = list(gj[0]) + [gj[1][k] for k in ws_t]
    assert len(out_t) == len(out_j)
    for o, oj in zip(out_t, out_j):
        assert tuple(o.shape) == np.shape(oj)
    return ([o.detach().numpy() for o in out_t],
            [np.asarray(o) for o in out_j]), \
        ([g.numpy() for g in gt], [np.asarray(g) for g in want_g])


def _check(op_type, params, inputs, in_dtypes=None, exact=False):
    (got, want), (g_got, g_want) = _both(op_type, params, inputs,
                                         in_dtypes)
    for o, w in zip(got, want):
        if exact or not np.issubdtype(w.dtype, np.floating):
            assert o.dtype == w.dtype, (o.dtype, w.dtype)
            np.testing.assert_array_equal(o, w)
        else:
            np.testing.assert_allclose(o, w, **TOL)
    if g_got:
        assert len(g_got) == len(g_want)
        for g, w in zip(g_got, g_want):
            np.testing.assert_allclose(g, w, **TOL)
    return got, want


def _ties(*shape, seed=1):
    """Values with exact ties: integers in [-2, 2], as floats."""
    return np.random.default_rng(seed).integers(-2, 3, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# element_ops
# ---------------------------------------------------------------------------
def test_leaky_relu_takes_the_identity_branch_at_zero():
    x = _ties(3, 8)
    assert (x == 0).any()
    _check(OT.OP_LEAKYRELU, {"negative_slope": 0.2}, [x])


def test_prelu_with_its_alpha_weight():
    x = _ties(3, 8, seed=2) + 0.5 * _x(3, 8)
    x[0, :3] = 0.0
    _check(OT.OP_PRELU, {}, [x])
    spec = torch_op(int(OT.OP_PRELU)).weights({}, [(3, 8)],
                                              [fft.DataType.DT_FLOAT])[0]
    assert spec.name == "alpha" and spec.init_args == {"value": 0.25}


@pytest.mark.parametrize("src,dst", [("f32", DT.DT_INT32),
                                     ("f32", DT.DT_FLOAT),
                                     ("f32", DT.DT_BOOLEAN),
                                     ("i32", DT.DT_FLOAT),
                                     ("bool", DT.DT_FLOAT)])
def test_cast(src, dst):
    x = 2.5 * _ties(3, 8) + _x(3, 8)
    x[0, :2] = 0.0
    x = {"f32": x, "i32": x.astype(np.int32), "bool": x > 0}[src]
    in_dt = {"f32": DT.DT_FLOAT, "i32": DT.DT_INT32,
             "bool": DT.DT_BOOLEAN}[src]
    _check(OT.OP_CAST, {"dtype": dst}, [x], [in_dt])


@pytest.mark.parametrize("cond_kind", ["bool", "float"])
def test_where(cond_kind):
    c = _ties(4, 6, seed=3)
    cond = c > 0 if cond_kind == "bool" else c
    dts = [DT.DT_BOOLEAN if cond_kind == "bool" else DT.DT_FLOAT,
           DT.DT_FLOAT, DT.DT_FLOAT]
    if cond_kind == "float":
        # a float condition is data, not a differentiable input
        (got, want), _ = _both(OT.OP_WHERE, {}, [cond, _x(4, 6), _x(6)],
                               dts)
        np.testing.assert_array_equal(got[0], want[0])
        return
    _check(OT.OP_WHERE, {}, [cond, _x(4, 6), _x(6, seed=2)], dts)


REDUCE_OPS = ["OP_REDUCE_SUM", "OP_REDUCE_MEAN", "OP_MEAN", "OP_REDUCE_MAX",
              "OP_REDUCE_MIN", "OP_REDUCE_PROD"]


@pytest.mark.parametrize("op", REDUCE_OPS)
@pytest.mark.parametrize("axes,keep", [([1], False), ([0, 2], True),
                                       ([-1], True), (None, False)])
def test_reduce(op, axes, keep):
    """Ties in the input (integers) check that max/min split the gradient
    evenly among them, as jnp.max does."""
    x = _ties(3, 4, 5) + (0.0 if "MAX" in op or "MIN" in op
                          else 0.25 * _x(3, 4, 5))
    params = {"keepdims": keep}
    if axes is not None:
        params["axes"] = axes
    _check(OT[op], params, [x])


@pytest.mark.parametrize("op", ["OP_REDUCE_ARGMAX", "OP_REDUCE_ARGMIN"])
@pytest.mark.parametrize("axis,keep", [(1, False), (-1, True)])
def test_arg_reduce_is_int32_first_of_ties(op, axis, keep):
    got, _ = _check(OT[op], {"axes": [axis], "keepdims": keep},
                    [_ties(4, 5, 6)])
    assert got[0].dtype == np.int32
    for pkg_op in (jax_op(OT[op]), torch_op(int(OT[op]))):
        with pytest.raises(ValueError, match="exactly one axis"):
            x = np.zeros((2, 3), np.float32)
            pkg_op.emit({"axes": [0, 1]},
                        [jnp.asarray(x) if pkg_op is jax_op(OT[op])
                         else torch.from_numpy(x)], {}, None, "op")


def test_reduce_infer_matches_jax():
    for op in REDUCE_OPS + ["OP_REDUCE_ARGMAX"]:
        for params in ({"axes": [0, -1], "keepdims": True},
                       {"axes": [1]}):
            args = (params, [(3, 4, 5)], [DT.DT_FLOAT])
            want = jax_op(OT[op]).infer(*args)
            got = torch_op(int(OT[op])).infer(*args)
            assert [(s, int(d)) for s, d in got] == \
                [(s, int(d)) for s, d in want]


# ---------------------------------------------------------------------------
# tensor_ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,sorted_", [(1, True), (2, False), (3, True)])
def test_top_k_keeps_lax_order_under_ties(k, sorted_):
    """A ReLU of small integers is mostly ties (the zeros of FFModel.moe's
    gate): the indices must be jax.lax.top_k's, lower index first."""
    x = np.maximum(_ties(6, 7, seed=5), 0.0)
    top = np.sort(x, -1)[:, -(k + 1):]
    assert (np.diff(top, axis=-1) == 0).any()       # ties at the cut
    got, want = _check(OT.OP_TOPK, {"k": k, "sorted": sorted_}, [x])
    assert got[1].dtype == np.int32


def test_top_k_of_distinct_values():
    _check(OT.OP_TOPK, {"k": 2, "sorted": False}, [_x(2, 3, 9)])


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_gather(dim):
    x = _x(4, 5, 6)
    rng = np.random.default_rng(7)
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = 3
    idx = rng.integers(-n, n, shape).astype(np.int32)
    _check(OT.OP_GATHER, {"dim": dim}, [x, idx], [DT.DT_FLOAT, DT.DT_INT32])


@pytest.mark.parametrize("sizes,axis", [([2, 3], 1), ([1, 1, 2], 0),
                                        ([4, 2], -1)])
def test_split(sizes, axis):
    x = _x(4, 5, 6)
    got, _ = _check(OT.OP_SPLIT, {"sizes": sizes, "axis": axis}, [x])
    assert len(got) == len(sizes)


@pytest.mark.parametrize("axes", [[1], [1, 3], [-1]])
def test_squeeze(axes):
    _check(OT.OP_SQUEEZE, {"axes": axes}, [_x(2, 1, 3, 1)])


@pytest.mark.parametrize("axes", [[0], [0, 2], [3], [1, 2]])
def test_unsqueeze_axes_are_output_positions(axes):
    got, _ = _check(OT.OP_UNSQUEEZE, {"axes": axes}, [_x(2, 3, 4)])
    shape = torch_op(int(OT.OP_UNSQUEEZE)).infer(
        {"axes": axes}, [(2, 3, 4)], [fft.DataType.DT_FLOAT])[0][0]
    assert got[0].shape == shape


@pytest.mark.parametrize("pads,value", [([(1, 2), (0, 1), (2, 0)], 0.0),
                                        ([(0, 0), (3, 1), (0, 2)], 0.5)])
def test_pad_in_numpy_dim_order(pads, value):
    _check(OT.OP_PAD, {"pads": pads, "value": value}, [_x(2, 3, 4)])


@pytest.mark.parametrize("axis", [1, -1, (0, 2)])
def test_reverse(axis):
    _check(OT.OP_REVERSE, {"axis": axis}, [_x(2, 3, 4)])


@pytest.mark.parametrize("op", ["OP_SHAPE", "OP_SIZE"])
def test_shape_and_size_are_int32(op):
    got, want = _check(OT[op], {}, [_x(2, 3, 4)], exact=True)
    assert got[0].dtype == np.int32


@pytest.mark.parametrize("op", ["OP_NOOP", "OP_INPUT", "OP_WEIGHT"])
def test_noop_family(op):
    _check(OT[op], {}, [_x(2, 3)])


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic",
                                    "lanczos3"])
@pytest.mark.parametrize("size", [(2, 3, 16, 12), (2, 3, 5, 3),
                                  (2, 3, 12, 5), (1, 3, 8, 8)])
def test_resize_is_jax_image_resize(method, size):
    """Half-pixel centres, and the antialiasing filter where a kernel
    method shrinks a dim (F.interpolate's defaults do neither); shrinking
    the batch dim too."""
    _check(OT.OP_RESIZE, {"size": size, "method": method}, [_x(2, 3, 8, 8)])


# ---------------------------------------------------------------------------
# moe_ops
# ---------------------------------------------------------------------------
def _assign(b, k, n, seed=8):
    """(b, k) distinct expert ids per row, skewed to experts 0 and 1 so
    that a small capacity overflows."""
    rng = np.random.default_rng(seed)
    p = np.array([0.4, 0.3] + [0.3 / (n - 2)] * (n - 2))
    return np.stack([rng.choice(n, k, replace=False, p=p)
                     for _ in range(b)]).astype(np.int32)


@pytest.mark.parametrize("alpha", [1.0, 2.0, 0.5])
def test_group_by_dispatch_and_capacity_overflow(alpha):
    b, k, n, d = 12, 2, 4, 5
    assign = _assign(b, k, n)
    got, _ = _check(OT.OP_GROUP_BY, {"n": n, "alpha": alpha},
                    [_x(b, d), assign], [DT.DT_FLOAT, DT.DT_INT32])
    c = int(np.ceil(alpha * k * b / n))
    assert len(got) == n and got[0].shape == (c, d)
    counts = np.bincount(assign.reshape(-1), minlength=n)
    want_dropped = int(np.maximum(counts - c, 0).sum())
    assert dropped_slots(torch.from_numpy(assign), n, c) == want_dropped
    if alpha == 0.5:
        assert want_dropped > 0


def _agg_inputs(b=12, k=2, n=4, c=6, do=5):
    assign = _assign(b, k, n, seed=9)
    return [np.abs(_x(b, k, seed=2)), assign, assign, _x(b, n, seed=3)] + \
        [_x(c, do, seed=10 + e) for e in range(n)]


@pytest.mark.parametrize("op", ["OP_AGGREGATE", "OP_AGG_SPEC"])
@pytest.mark.parametrize("lam,c", [(0.0, 6), (0.04, 6), (0.04, 3)])
def test_aggregate_and_its_aux_loss(op, lam, c):
    """The combine, and the lambda_bal loss's value (below) and gradient
    (in _both's loss) into full_gate_preds; c = 3 drops slots."""
    ins = _agg_inputs(c=c)
    dts = [DT.DT_FLOAT, DT.DT_INT32, DT.DT_INT32, DT.DT_FLOAT] + \
        [DT.DT_FLOAT] * 4
    _check(OT[op], {"n": 4, "lambda_bal": lam}, ins, dts)
    cj, ct = _ctxs()
    jax_op(OT[op]).emit({"n": 4, "lambda_bal": lam},
                        [jnp.asarray(x) for x in ins], {}, cj, "op")
    torch_op(int(OT[op])).emit({"n": 4, "lambda_bal": lam},
                               [torch.from_numpy(x) for x in ins], {}, ct,
                               "op")
    assert len(ct.aux_losses) == len(cj.aux_losses) == (1 if lam else 0)
    if lam:
        np.testing.assert_allclose(float(ct.aux_losses[0]),
                                   float(cj.aux_losses[0]), **TOL)


@pytest.mark.parametrize("training", [False, True])
def test_cache_state_over_two_calls(training):
    """The first call stores its input in the new state; the second, with
    use_cached, serves the stored value outside training and its own
    input in training; the stored state carries no gradient."""
    params = {"num_batches": 2, "use_cached": True}
    x1, x2 = _x(3, 4, seed=1), _x(3, 4, seed=2)
    state = {"op": {"cached": np.zeros((3, 4), np.float32)}}
    spec = torch_op(int(OT.OP_CACHE)).state_spec(params, [(3, 4)],
                                                 [fft.DataType.DT_FLOAT])
    assert spec == {"cached": ((3, 4), fft.DataType.DT_FLOAT)}
    outs = {}
    for pkg in ("jax", "torch"):
        st = state
        seen = []
        for x in (x1, x2):
            cj, ct = _ctxs(training, st)
            if pkg == "jax":
                out = jax_op(OT.OP_CACHE).emit(params, [jnp.asarray(x)], {},
                                               cj, "op")[0]
                st = {k: {n: np.asarray(v) for n, v in d.items()}
                      for k, d in cj.new_state.items()}
            else:
                xt = torch.tensor(x, requires_grad=True)
                out = torch_op(int(OT.OP_CACHE)).emit(params, [xt], {}, ct,
                                                      "op")[0]
                assert not ct.new_state["op"]["cached"].requires_grad
                st = {k: {n: v.numpy() for n, v in d.items()}
                      for k, d in ct.new_state.items()}
                out = out.detach()
            seen.append((np.asarray(out), st["op"]["cached"]))
        outs[pkg] = seen
    for (o_t, s_t), (o_j, s_j) in zip(outs["torch"], outs["jax"]):
        np.testing.assert_array_equal(o_t, o_j)
        np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(outs["torch"][1][0],
                                  x2 if training else x1)


# ---------------------------------------------------------------------------
# the builders in one graph, and the executor's op state
# ---------------------------------------------------------------------------
def _graph(pkg, **model_kw):
    cfg = pkg.FFConfig()
    cfg.batch_size = 4
    cfg.use_bf16_compute = False
    ff = pkg.FFModel(cfg, **model_kw)
    x = ff.create_tensor((4, 6), name="x")
    idx = ff.create_tensor((4, 2), pkg.DataType.DT_INT32, name="idx")
    one = ff.create_constant((1,), 1.0, pkg.DataType.DT_INT32)
    half = ff.create_constant((6,), 0.5)
    h = ff._unary(pkg.OperatorType.OP_PRELU, ff.dense(x, 8, name="d0"))
    a, b = ff.split(h, [3, 5], axis=1)
    a = ff.reverse(ff.pad(a, [(0, 0), (1, 1)], value=0.25), 1)
    vals, top = ff.top_k(h, 3, True)
    hit = ff.cast(ff.equal(top, one), pkg.DataType.DT_FLOAT)
    g = ff.gather(b, idx, dim=1)
    m = ff.mean(ff.unsqueeze(a, [1]), [1, 2], keepdims=False)
    s = ff.reduce_sum(ff.squeeze(ff.unsqueeze(hit, [2]), [2]), [1],
                      keepdims=True)
    c = ff.cache(ff.multiply(x, half), 1)
    out = ff.concat([vals, hit, g, ff.reshape(m, (4, 1)), s,
                     ff.dense(c, 2, name="d1")], axis=1)
    ff.compile(pkg.SGDOptimizer(0.1), "mean_squared_error", [],
               output_tensor=out)
    return ff


def test_new_builders_build_the_jax_graph():
    jff, tff = _graph(ffj), _graph(fft, device="cpu")
    assert [(l.name, int(l.op_type)) for l in tff.layers] == \
        [(l.name, int(l.op_type)) for l in jff.layers]
    names = [(l.name, l.op_type) for l in jff.layers]
    # PReLU's alpha (0.25 from its initializer) copies with the dense
    # kernels; the two constants are inputs, not parameters
    load_reference_params(tff, jax.device_get(jff.params), names)
    assert "alpha" in tff.params["op_prelu_1"]
    assert len(tff.const_inputs) == 2
    # the Cache op's state: zeros of its input's shape, in both
    assert set(tff.state) == set(jff.state) == {"op_cache_15"}
    cache = "op_cache_15"
    np.testing.assert_array_equal(tff.state[cache]["cached"].numpy(),
                                  np.asarray(jff.state[cache]["cached"]))
    batch = {"x": _x(4, 6), "idx": np.random.default_rng(1).integers(
        -5, 5, (4, 2)).astype(np.int32)}
    got = tff.forward(batch)
    want = np.asarray(jff.forward(batch))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the train step threads the state: the cache holds this batch
    batch["label"] = _x(*want.shape, seed=4)
    for ff in (jff, tff):
        ff._run_train_step(ff.executor.make_train_step(), batch)
    np.testing.assert_allclose(tff.state[cache]["cached"].numpy(),
                               np.asarray(jff.state[cache]["cached"]),
                               **TOL)
    np.testing.assert_allclose(tff.state[cache]["cached"].numpy(),
                               0.5 * batch["x"], **TOL)


def test_cache_score_fn_needs_the_recompile_hook():
    """``cache(score_fn=...)`` is accepted and ignored, as in the JAX
    package (its recompile hook is ``recompile_on_condition``): the same
    Cache layer in both packages, and the port's runs."""
    built = []
    for pkg, kw in ((ffj, {}), (fft, {"device": "cpu"})):
        cfg = pkg.FFConfig()
        cfg.batch_size = 2
        ff = pkg.FFModel(cfg, **kw)
        x = ff.create_tensor((2, 3), name="x")
        out = ff.cache(x, 2, score_fn=lambda *a: 0.0)
        built.append((ff, out))
    (jff, jout), (tff, tout) = built
    assert [(l.name, l.op_type.name, l.params) for l in tff.layers] == \
        [(l.name, l.op_type.name, l.params) for l in jff.layers]
    assert tout.shape == jout.shape
    tff.compile(fft.SGDOptimizer(0.01), "mean_squared_error", [],
                output_tensor=tout)
    fwd = tff.executor.make_forward()
    y = fwd(tff.params, tff.state, {"x": np.ones((2, 3), np.float32)})
    assert tuple(y.shape) == (2, 3)


def test_split_into_equal_parts():
    ff = fft.FFModel(fft.FFConfig(), device="cpu")
    parts = ff.split(ff.create_tensor((2, 6), name="x"), 3, axis=1)
    assert [p.shape for p in parts] == [(2, 2)] * 3


# ---------------------------------------------------------------------------
# build_moe_mnist trained through fit
# ---------------------------------------------------------------------------
BATCH = 8


def _moe_model(pkg, cfg_cls, builder, **model_kw):
    cfg = pkg.FFConfig()
    cfg.batch_size = BATCH
    cfg.only_data_parallel = True
    cfg.use_bf16_compute = False
    ff = pkg.FFModel(cfg, **model_kw)
    builder(ff, BATCH, cfg_cls.tiny())
    ff.compile(pkg.AdamOptimizer(alpha=1e-2, epsilon=1e-4),
               "sparse_categorical_crossentropy", ["accuracy"])
    return ff


def test_moe_config_defaults_are_the_reference_example():
    mc = MoeConfig()
    assert (mc.num_exp, mc.num_select, mc.hidden_size, mc.alpha,
            mc.lambda_bal, mc.in_dim, mc.num_classes) == \
        (32, 2, 64, 2.0, 0.04, 784, 10)
    assert vars(mc) == vars(JaxMoeConfig())
    assert vars(MoeConfig.tiny()) == vars(JaxMoeConfig.tiny())


def test_moe_mnist_fit_matches_jax_with_the_fused_adam():
    """Two shuffled epochs of two batches each: the per-epoch loss and
    accuracy, and the final weights. The port runs its fused Adam plan
    (the kernel's plain version on the CPU), the JAX package its Adam."""
    from flexflow_tpu_torch.kernels.opt_update import fused_adam_update
    jff = _moe_model(ffj, JaxMoeConfig, jax_build_moe)
    ff = _moe_model(fft, MoeConfig, build_moe_mnist, device="cpu")
    load_reference_params(ff, jax.device_get(jff.params),
                          [(l.name, l.op_type) for l in jff.layers])
    ff.executor._kernel_impls["opt_update"] = "fused"
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2 * BATCH, 64)).astype(np.float32)
    y = rng.integers(0, 10, (2 * BATCH, 1)).astype(np.int32)
    before = fused_adam_update.plain_calls
    got = ff.fit(x, y, epochs=2, verbose=False)
    want = jff.fit(x, y, epochs=2, verbose=False)
    assert fused_adam_update.plain_calls - before == 4
    for g, w in zip(got, want):
        assert g["accuracy"] == w["accuracy"]
        np.testing.assert_allclose(g["loss"], w["loss"], atol=ATOL, rtol=0)
    jp = jax.device_get(jff.params)
    for ln, ws in ff.params.items():
        for wn, t in ws.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[ln][wn]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{ln}/{wn}")


def test_moe_mnist_train_steps_match_jax_with_sgd():
    """Four SGD steps on one batch: each step's loss, the aux loss in it."""
    def model(pkg, cfg_cls, builder, **kw):
        cfg = pkg.FFConfig()
        cfg.batch_size = BATCH
        cfg.use_bf16_compute = False
        ff = pkg.FFModel(cfg, **kw)
        builder(ff, BATCH, cfg_cls.tiny())
        ff.compile(pkg.SGDOptimizer(0.05), "sparse_categorical_crossentropy",
                   [])
        return ff

    jff = model(ffj, JaxMoeConfig, jax_build_moe)
    ff = model(fft, MoeConfig, build_moe_mnist, device="cpu")
    load_reference_params(ff, jax.device_get(jff.params),
                          [(l.name, l.op_type) for l in jff.layers])
    rng = np.random.default_rng(12)
    batch = {"input": rng.standard_normal((BATCH, 64)).astype(np.float32),
             "label": rng.integers(0, 10, (BATCH, 1)).astype(np.int32)}
    hist = {}
    for name, m in (("jax", jff), ("port", ff)):
        step = m.executor.make_train_step()
        hist[name] = [float(np.asarray(m._run_train_step(step, batch)
                                       ["loss"])) for _ in range(4)]
    np.testing.assert_allclose(hist["port"], hist["jax"], rtol=1e-5,
                               atol=0)
