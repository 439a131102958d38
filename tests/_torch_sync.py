"""The JAX package's references for the port's multi-device train-step
tests (``test_torch_zero.py``, ``test_torch_overlap.py``,
``test_torch_quantized_collectives.py``): BERT-tiny and the Transformer
at small widths in f32, trained on a mesh of the conftest's CPU devices
under the same flags the port's ranks run, from which the world payloads
(weights, layers, batches) are taken."""
import jax
import numpy as np

import flexflow_tpu as ffj
from flexflow_tpu.models import BertConfig, TransformerConfig
from flexflow_tpu.models import build_bert, build_transformer
from flexflow_tpu.parallel.machine import MachineSpec

B, S = 8, 16
FWD_TOL, LOSS_TOL = 2e-3, 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
DP = ["--only-data-parallel"]
TCFG = dict(hidden_size=32, num_heads=4, num_layers=2, sequence_length=16)


def _optimizer(opt):
    return ffj.SGDOptimizer(0.05, momentum=0.9) if opt == "sgdm" \
        else ffj.AdamOptimizer(1e-3, epsilon=1e-4)


def jax_run(model, argv=(), opt="adam", devices=2, steps=4, what="all"):
    """A JAX model compiled under ``argv`` (``FFConfig.parse_args``) on a
    mesh of ``devices`` CPU devices, data parallel, with its initial
    weights, layers and batches; then (``what``) "all": the forward on the
    first batch, the first-step gradients and a ``steps``-step loss
    history over the two batches in turn; "losses": the history only;
    "init": nothing more."""
    cfg = ffj.FFConfig.parse_args(list(argv) + DP)
    cfg.use_bf16_compute = False
    rng = np.random.default_rng(0)
    if model == "bert":
        cfg.batch_size = B
        ff = ffj.FFModel(cfg)
        bcfg = BertConfig.tiny()
        bcfg.max_position, bcfg.dropout = S, 0.0
        out = build_bert(ff, B, S, bcfg)
        loss = "sparse_categorical_crossentropy"
        batches = [{"input_ids": rng.integers(0, bcfg.vocab_size, (B, S))
                    .astype(np.int32),
                    "position_ids": np.tile(np.arange(S, dtype=np.int32),
                                            (B, 1)),
                    "label": rng.integers(0, bcfg.num_labels, (B, 1))
                    .astype(np.int32)} for _ in range(2)]
    else:
        cfg.batch_size = 8
        ff = ffj.FFModel(cfg)
        out = build_transformer(ff, 8, TransformerConfig(**TCFG))
        loss = "mean_squared_error"
        batches = [{"input": rng.normal(size=(8, 16, 32)).astype(np.float32),
                    "label": rng.normal(size=(8, 16, 1)).astype(np.float32)}
                   for _ in range(2)]
    spec = MachineSpec.detect()
    spec.num_devices = devices
    ff.compile(_optimizer(opt), loss, [], output_tensor=out,
               machine_spec=spec)
    ex = ff.executor
    b0 = batches[0]
    inputs = {k: v for k, v in b0.items() if k != "label"}

    def loss_fn(p):
        outs, _, aux, capture = ex._forward(p, ff.state, b0, True, 0)
        return ex._loss_and_metrics(outs, capture, b0["label"], aux)[0]

    ref = {"params": jax.device_get(ff.params),
           "layers": [(l.name, int(l.op_type)) for l in ff.layers],
           "batches": batches, "mesh": dict(ff.dmesh.axis_sizes), "ff": ff}
    if what == "init":
        return ref
    if what == "all":
        ref["forward"] = np.asarray(ex.make_forward()(ff.params, ff.state,
                                                      inputs))
        ref["grads"] = jax.device_get(jax.jit(jax.grad(loss_fn))(ff.params))
    step = ex.make_train_step()
    ref["losses"] = [float(np.asarray(ff._run_train_step(
        step, batches[i % 2])["loss"])) for i in range(steps)]
    return ref


def payload_of(ref):
    """What a rank needs of a reference run."""
    return {k: ref[k] for k in ("params", "layers", "batches")}


def close_grads(got, names, ref):
    """The port's first-step gradients (keyed by its layer names, in graph
    order ``names``) against the reference's, leaf by leaf."""
    n = 0
    for port_name, (ref_name, _) in zip(names, ref["layers"]):
        for wn, g in ref["grads"].get(ref_name, {}).items():
            np.testing.assert_allclose(got[port_name][wn], np.asarray(g),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"{ref_name}/{wn}")
            n += 1
    assert n > 0


def assert_matches_jax(run, ref):
    """A port run against the JAX package's run of the same strategy:
    the forward within FWD_TOL, first-step gradients within GRAD_ATOL +
    GRAD_RTOL relative, the loss history within LOSS_TOL."""
    np.testing.assert_allclose(run["forward"], ref["forward"],
                               atol=FWD_TOL, rtol=0)
    close_grads(run["grads"], run["names"], ref)
    np.testing.assert_allclose(run["losses"], ref["losses"],
                               atol=LOSS_TOL, rtol=0)


def same_weights(a, b):
    """Bit-equal weight trees."""
    assert a.keys() == b.keys()
    for ln in a:
        for wn in a[ln]:
            np.testing.assert_array_equal(a[ln][wn], b[ln][wn],
                                          err_msg=f"{ln}/{wn}")
