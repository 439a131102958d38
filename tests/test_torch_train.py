"""The port's training slice end to end against the JAX package: a tiny
BERT built through ``FFModel`` in both, the reference's weights (and
optimizer state) carried into the port by ``interop``, then train steps,
``fit`` and ``eval`` compared.

Everything runs in f32 with dropout 0 (the two packages draw different
random bits by design), so the graphs agree op for op and differ only in
f32 summation order: loss histories and final weights hold to atol 1e-5.
Adam runs with epsilon 1e-4: a weight whose true gradient is zero (the
key bias, since a softmax ignores a shift of all its scores) gets f32
noise as its gradient in both packages, and Adam at epsilon 1e-8 turns
noise of any size into a full +-alpha step, in directions that differ
between the two; epsilon 1e-4 keeps such a step at noise level while
gradients of real weights keep their size. The fused Adam plan is set
on the port's executor directly, because its predicate refuses the CPU;
on the CPU it runs the kernel's plain version, which is the unfused
update's math for f32 weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.models import BertConfig as JaxBertConfig
from flexflow_tpu.models import build_bert as jax_build_bert
from flexflow_tpu.runtime import losses as jax_losses
from flexflow_tpu.runtime import metrics as jax_metrics
from flexflow_tpu.runtime.dataloader import \
    SingleDataLoader as JaxSingleDataLoader
from flexflow_tpu_torch.ffconst import LossType, MetricsType
from flexflow_tpu_torch.interop import (load_reference_opt_state,
                                        load_reference_params)
from flexflow_tpu_torch.models import BertConfig, build_bert
from flexflow_tpu_torch.ops.registry import mm_f32
from flexflow_tpu_torch.runtime import losses, metrics
from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader
from flexflow_tpu_torch.runtime.metrics_buffer import (MetricsBuffer,
                                                       NonFiniteMetrics)

BATCH, SEQ, STEPS = 4, 16, 5
ATOL = 1e-5


def _optimizer(pkg, kind):
    if kind == "sgd":
        return pkg.SGDOptimizer(lr=0.05, momentum=0.9, weight_decay=0.01)
    return pkg.AdamOptimizer(alpha=1e-3, weight_decay=0.01, epsilon=1e-4)


def _bert(pkg, cfg_cls, builder, kind, impl, accum=1, **model_kw):
    cfg = pkg.FFConfig()
    cfg.batch_size = BATCH
    cfg.only_data_parallel = True
    cfg.use_bf16_compute = False
    cfg.kernel_impls = f"attention:{impl}"
    cfg.gradient_accumulation_steps = accum
    ff = pkg.FFModel(cfg, **model_kw)
    bcfg = cfg_cls.tiny()
    bcfg.max_position = SEQ
    bcfg.dropout = 0.0
    out = builder(ff, BATCH, SEQ, bcfg)
    ff.compile(_optimizer(pkg, kind), "sparse_categorical_crossentropy",
               ["accuracy"], output_tensor=out)
    return ff, bcfg


def _jax_model(kind="adam", impl="xla"):
    return _bert(ffj, JaxBertConfig, jax_build_bert, kind, impl)[0]


def _port_model(jax_ff, kind="adam", impl="xla", accum=1):
    ff, _ = _bert(fft, BertConfig, build_bert, kind, impl, accum,
                  device="cpu")
    load_reference_params(ff, jax.device_get(jax_ff.params),
                          [(l.name, l.op_type) for l in jax_ff.layers])
    return ff


def _data(rows, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (rows, SEQ)).astype(np.int32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (rows, 1))
    y = rng.integers(0, 2, (rows, 1)).astype(np.int32)
    return ids, pos, y


def _batches(n=STEPS, seed=0):
    ids, pos, y = _data(n * BATCH, seed)
    return [{"input_ids": ids[i::n], "position_ids": pos[i::n],
             "label": y[i::n]} for i in range(n)]


def _train(ff, batches):
    step_fn = ff.executor.make_train_step()
    return [float(np.asarray(ff._run_train_step(step_fn, b)["loss"]))
            for b in batches]


def _assert_params_close(port_ff, jax_params, atol=ATOL):
    jp = jax.device_get(jax_params)
    for ln, ws in port_ff.params.items():
        for wn, t in ws.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[ln][wn]),
                                       atol=atol, rtol=0,
                                       err_msg=f"{ln}/{wn}")


_JAX_RUNS = {}


def _jax_run(kind, impl):
    """(initial params, loss history, final params) of a JAX model over
    the shared batches, computed once per (optimizer, impl)."""
    if (kind, impl) not in _JAX_RUNS:
        ff = _jax_model(kind, impl)
        init = jax.device_get(ff.params)
        losses_ = _train(ff, _batches())
        _JAX_RUNS[(kind, impl)] = (ff, init, losses_,
                                   jax.device_get(ff.params))
    return _JAX_RUNS[(kind, impl)]


@pytest.mark.parametrize("kind,impl,fused", [
    ("sgd", "xla", False),
    ("adam", "xla", False),
    ("adam", "xla", True),
    ("adam", "flash", True),
])
def test_train_steps_match_jax(kind, impl, fused):
    jff, init, want_losses, want_params = _jax_run(kind, impl)
    ff, _ = _bert(fft, BertConfig, build_bert, kind, impl, device="cpu")
    load_reference_params(ff, init, [(l.name, l.op_type)
                                     for l in jff.layers])
    if fused:
        # the fused predicate refuses the CPU: set the plan directly
        ff.executor._kernel_impls["opt_update"] = "fused"
        from flexflow_tpu_torch.kernels.opt_update import fused_adam_update
        before = fused_adam_update.plain_calls
    got = _train(ff, _batches())
    np.testing.assert_allclose(got, want_losses, atol=ATOL, rtol=0)
    _assert_params_close(ff, want_params)
    if fused:
        assert fused_adam_update.plain_calls == before + STEPS


def _mlp(pkg, accum, **model_kw):
    """An MLP classifier (BERT's pooler reshapes to the compile-time
    batch, so it takes no micro-batches in either package)."""
    cfg = pkg.FFConfig()
    cfg.batch_size = BATCH
    cfg.use_bf16_compute = False
    cfg.gradient_accumulation_steps = accum
    ff = pkg.FFModel(cfg, **model_kw)
    x = ff.create_tensor((BATCH, 20), name="x")
    h = ff.dense(x, 32, activation=pkg.ActiMode.AC_MODE_RELU)
    ff.softmax(ff.dense(h, 4))
    ff.compile(_optimizer(pkg, "adam"), "sparse_categorical_crossentropy",
               ["accuracy"])
    return ff


def test_gradient_accumulation_two_matches_one_and_jax():
    rng = np.random.default_rng(5)
    batches = [{"x": rng.standard_normal((BATCH, 20)).astype(np.float32),
                "label": rng.integers(0, 4, (BATCH, 1)).astype(np.int32)}
               for _ in range(3)]
    jff = _mlp(ffj, 2)
    names = [(l.name, l.op_type) for l in jff.layers]
    init = jax.device_get(jff.params)
    one, two = _mlp(fft, 1, device="cpu"), _mlp(fft, 2, device="cpu")
    for m in (one, two):
        load_reference_params(m, init, names)
    s1, s2 = one.executor.make_train_step(), two.executor.make_train_step()
    sj = jff.executor.make_train_step()
    for b in batches:
        m1 = one._run_train_step(s1, b)
        m2 = two._run_train_step(s2, b)
        mj = jff._run_train_step(sj, b)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   atol=ATOL)
        np.testing.assert_allclose(float(m2["loss"]), float(mj["loss"]),
                                   atol=ATOL)
        # a count metric sums over micro-batches, it is not averaged
        assert float(m2["accuracy_correct"]) == \
            float(m1["accuracy_correct"]) == float(mj["accuracy_correct"])
    for ln, ws in one.params.items():
        for wn, t in ws.items():
            np.testing.assert_allclose(two.params[ln][wn].numpy(),
                                       t.numpy(), atol=ATOL, rtol=0)
    _assert_params_close(two, jff.params)
    with pytest.raises(ValueError, match="micro-batches"):
        s2(two.params, two.opt_state, two.state, 0,
           {k: v[:3] for k, v in batches[0].items()})


_FIT = {}


def _fit_pair():
    """JAX and port models fitted for 2 shuffled epochs from the same
    weights, then evaluated; computed once."""
    if not _FIT:
        ids, pos, y = _data(4 * BATCH, seed=9)
        jff = _jax_model("adam", "xla")
        ff = _port_model(jff, "adam", "xla")
        _FIT["jax"] = (jff.fit([ids, pos], y, epochs=2, verbose=False),
                       jff.eval([ids, pos], y))
        _FIT["port"] = (ff.fit([ids, pos], y, epochs=2, verbose=False),
                        ff.eval([ids, pos], y))
        _FIT["models"] = (jff, ff)
    return _FIT


def test_fit_shuffled_history_matches_jax():
    fit = _fit_pair()
    got, want = fit["port"][0], fit["jax"][0]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["accuracy"] == w["accuracy"]
        np.testing.assert_allclose(g["loss"], w["loss"], atol=ATOL)
        assert g["samples_per_sec"] > 0
    jff, ff = fit["models"]
    assert ff._step == jff._step == 8
    _assert_params_close(ff, jff.params)


def test_eval_metrics_match_jax():
    fit = _fit_pair()
    got, want = fit["port"][1], fit["jax"][1]
    assert set(got) == set(want) == {"accuracy", "loss"}
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=ATOL)
    assert fit["models"][1].get_perf_metrics() == got


def test_load_reference_opt_state_continues_jax_training():
    """Two JAX Adam steps, then weights and moments carried into the
    port: the next two steps agree."""
    jff = _jax_model("adam", "xla")
    batches = _batches(4, seed=13)
    _train(jff, batches[:2])
    ff = _port_model(jff, "adam", "xla")
    names = [(l.name, l.op_type) for l in jff.layers]
    new = load_reference_opt_state(ff, jax.device_get(jff.opt_state), names)
    assert set(new) == {"m", "v"} and ff.opt_state is new
    ff._step = jff._step
    got = _train(ff, batches[2:])
    want = _train(jff, batches[2:])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    _assert_params_close(ff, jff.params)
    with pytest.raises(ValueError, match="slots differ"):
        load_reference_opt_state(ff, {"v": {}}, names)
    bad = jax.device_get(jff.opt_state)
    bad["m"] = dict(bad["m"])
    first = next(iter(ff.params))
    bad["m"][names[[n for n, _ in names].index(first)][0]] = {}
    with pytest.raises(ValueError, match="weight names differ"):
        load_reference_opt_state(ff, bad, names)


@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_order_matches_jax_and_resumes_exactly(shuffle):
    ids, pos, y = _data(22, seed=2)
    arrays = {"input_ids": ids, "position_ids": pos, "label": y}
    port = SingleDataLoader(arrays, 4, shuffle=shuffle, seed=3)
    ref = JaxSingleDataLoader(arrays, 4, shuffle=shuffle, seed=3)
    for _ in range(2):   # the same order epoch after epoch
        port.reset()
        ref.reset()
        np.testing.assert_array_equal(port._order, ref._order)
    assert port.num_batches == ref.num_batches == 5
    # exact resume mid-epoch, the next epoch's shuffle included
    port = SingleDataLoader(arrays, 4, shuffle=shuffle, seed=3)
    it = iter(port)
    for _ in range(2):
        next(it)
    sd = port.state_dict()
    rest = [b["input_ids"].numpy() for b in it]
    port.reset()
    nxt = [b["input_ids"].numpy() for b in iter(lambda: port.next_batch(),
                                                 None)]
    resumed = SingleDataLoader(arrays, 4, shuffle=shuffle, seed=3)
    resumed.load_state_dict(sd)
    got = []
    while (b := resumed.next_batch()) is not None:
        got.append(b["input_ids"].numpy())
    resumed.reset()
    got_next = []
    while (b := resumed.next_batch()) is not None:
        got_next.append(b["input_ids"].numpy())
    for a, b in zip(rest + nxt, got + got_next):
        np.testing.assert_array_equal(a, b)
    assert len(got) == len(rest) == 3
    with pytest.raises(ValueError, match="batch_size"):
        SingleDataLoader(arrays, 2).load_state_dict(sd)


def _jnp(x):
    return jnp.asarray(np.asarray(x))


@pytest.mark.parametrize("loss_name,logits", [
    ("LOSS_SPARSE_CATEGORICAL_CROSSENTROPY", True),
    ("LOSS_SPARSE_CATEGORICAL_CROSSENTROPY", False),
    ("LOSS_CATEGORICAL_CROSSENTROPY", True),
    ("LOSS_CATEGORICAL_CROSSENTROPY", False),
    ("LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE", False),
    ("LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE", False),
    ("LOSS_IDENTITY", False),
])
def test_losses_match_jax(loss_name, logits):
    rng = np.random.default_rng(7)
    z = rng.standard_normal((6, 5)).astype(np.float32)
    pred = z if logits else np.asarray(jax.nn.softmax(z, axis=-1))
    if "SPARSE" in loss_name:
        label = rng.integers(0, 5, (6, 1)).astype(np.int32)
    elif "CATEGORICAL" in loss_name:
        label = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    else:
        label = rng.standard_normal((6, 5)).astype(np.float32)
    lt = LossType[loss_name]
    got = losses.compute_loss(lt, torch.tensor(pred), torch.tensor(label),
                              logits=logits)
    want = jax_losses.compute_loss(int(lt), _jnp(pred), _jnp(label),
                                   logits=logits)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                               atol=1e-6)
    assert losses.wants_logits(lt) == jax_losses.wants_logits(int(lt))


def test_ce_on_logits_is_what_the_executor_takes():
    """A graph ending in Softmax under a cross-entropy loss: the executor
    takes the softmax's input as logits (stable log-softmax form), which
    equals CE on the probabilities where those do not underflow."""
    jff = _jax_run("adam", "xla")[0]
    ff = _port_model(jff)
    soft = ff.executor.program.output_tensors[0].owner_layer
    assert ff.executor._logits_tensor is soft.inputs[0]
    assert jff.executor._logits_tensor.name == \
        ff.executor._logits_tensor.name
    b = _batches(1)[0]
    outs, _, aux, cap = ff.executor._forward(ff.params, ff.state, b, False)
    loss, bm = ff.executor._loss_and_metrics(outs, cap, b["label"], aux)
    on_probs = losses.compute_loss(LossType(ff.loss_type), outs[0],
                                   torch.from_numpy(b["label"]))
    np.testing.assert_allclose(loss.item(), on_probs.item(), rtol=1e-5)
    assert set(bm) == {"accuracy_correct", "loss"}


@pytest.mark.parametrize("metric", [
    "METRICS_ACCURACY", "METRICS_CATEGORICAL_CROSSENTROPY",
    "METRICS_SPARSE_CATEGORICAL_CROSSENTROPY", "METRICS_MEAN_SQUARED_ERROR",
    "METRICS_ROOT_MEAN_SQUARED_ERROR", "METRICS_MEAN_ABSOLUTE_ERROR"])
def test_batch_metrics_match_jax(metric):
    rng = np.random.default_rng(8)
    pred = np.asarray(jax.nn.softmax(rng.standard_normal((6, 4)), axis=-1),
                      np.float32)
    sparse = metric in ("METRICS_ACCURACY",
                        "METRICS_SPARSE_CATEGORICAL_CROSSENTROPY")
    label = rng.integers(0, 4, (6, 1)).astype(np.int32) if sparse else \
        np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    lt = LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY if sparse else \
        LossType.LOSS_CATEGORICAL_CROSSENTROPY
    mt = MetricsType[metric]
    got = metrics.compute_batch_metrics([mt], torch.tensor(pred),
                                        torch.tensor(label), lt)
    want = jax_metrics.compute_batch_metrics([int(mt)], _jnp(pred),
                                             _jnp(label), int(lt))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   atol=1e-7)
    assert metrics.COUNT_KEYS == jax_metrics.COUNT_KEYS
    assert metrics.RMS_KEYS == jax_metrics.RMS_KEYS


def test_metrics_buffer_folds_in_order_and_screens_nans():
    pm = metrics.PerfMetrics()
    buf = MetricsBuffer(window=2, pm=pm)
    vals = [0.5, 0.25, float("nan"), 0.75]
    for i, v in enumerate(vals):
        loss = torch.tensor(v)
        buf.push(10 + i, {"loss": loss, "all_finite":
                          torch.isfinite(loss).all(),
                          "accuracy_correct": torch.tensor(float(i))}, 4)
    assert buf.pending == 4          # nothing read back before a flush
    assert buf.flush() == 4 and buf.pending == 0
    assert pm.train_all == 16 and pm.train_correct == 6
    assert buf.first_bad_step == 12
    with pytest.raises(NonFiniteMetrics, match="step 12"):
        buf.raise_if_poisoned()
    sync = MetricsBuffer(window=0, pm=metrics.PerfMetrics())
    sync.push(0, {"loss": torch.tensor(1.0)}, 2)
    assert sync.pending == 0 and sync.pm.report() == {"accuracy": 0.0,
                                                      "loss": 1.0}


def test_dropout_randomness_is_keyed_by_step_and_layer():
    jff = _jax_run("adam", "xla")[0]
    ff, _ = _bert(fft, BertConfig, build_bert, "adam", "flash",
                  device="cpu")
    rngs = ff.executor._rngs_for_step(3)
    drop = [(li, l.name) for li, l in enumerate(ff.layers)
            if l.op_type.name == "OP_DROPOUT"]
    assert drop and all(rngs[n].key == (ff.config.seed + 1, 3, li)
                        for li, n in drop)
    assert set(rngs) == {l.name for l in jff.layers
                         if l.op_type.name == "OP_DROPOUT"}
    # with dropout on, a step's loss is a function of (seed, step)
    a = _port_model(jff, "adam", "flash")
    b = _port_model(jff, "adam", "flash")
    for m in (a, b):
        for layer in m.layers:
            if "dropout" in layer.params:
                layer.params["dropout"] = 0.3
            if "rate" in layer.params:
                layer.params["rate"] = 0.3
    batch = _batches(1)[0]
    la = _train(a, [batch, batch])
    lb = _train(b, [batch, batch])
    assert la == lb and la[0] != la[1]


def test_train_step_refuses_multi_device_options():
    jff = _jax_run("adam", "xla")[0]
    ff = _port_model(jff)
    ff.config.overlap = "on"
    with pytest.raises(NotImplementedError, match="overlap"):
        ff.executor.make_train_step()
    ff.config.overlap = "auto"
    ff.config.shard_optimizer_states = True
    with pytest.raises(NotImplementedError, match="ZeRO"):
        ff.executor.make_train_step()
    ff.zero_gradients()
    ff.backward()
    ff.update()


@pytest.mark.parametrize("batched", [False, True])
def test_mm_f32_backward_follows_the_jax_rounding_rule(batched):
    """Each operand's gradient is the f32 cotangent times the other bf16
    operand, computed in f32 and rounded once to bf16, then widened for
    the f32 master: within one bf16 ulp of JAX's (the f32 sums differ in
    order, which can move a rounding)."""
    rng = np.random.default_rng(6)
    if batched:
        x = rng.standard_normal((3, 5, 8)).astype(np.float32)
        w = rng.standard_normal((3, 8, 4)).astype(np.float32)
        spec = "bmk,bkn->bmn"
    else:
        x = rng.standard_normal((2, 5, 8)).astype(np.float32)
        w = rng.standard_normal((8, 4)).astype(np.float32)
        spec = "...k,kn->...n"
    dy = rng.standard_normal(np.einsum(spec, x, w).shape).astype(np.float32)

    def f(x_, w_):
        y = jnp.einsum(spec, x_.astype(jnp.bfloat16), w_.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        return jnp.sum(y * dy)

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y = mm_f32(xt.to(torch.bfloat16), wt.to(torch.bfloat16))
    assert y.dtype == torch.float32
    y.backward(torch.from_numpy(dy))
    for g, w_ in ((xt.grad, want[0]), (wt.grad, want[1])):
        w_ = np.asarray(w_)
        assert g.dtype == torch.float32
        # the gradient is a bf16 value widened to f32
        assert torch.equal(g, g.to(torch.bfloat16).float())
        np.testing.assert_allclose(g.numpy(), w_, rtol=2 ** -8, atol=1e-6)
