"""The port's sharded strategies over a world of ranks, held against the
JAX package on the same weights.

Mirrors ``tests/test_parallel.py`` (the Transformer under tp, sp and dp,
an expert-parallel MoE step) and ``tests/test_tp_flag.py`` (BERT-tiny
under ``--tp 2``, ``--tp 2 --sp`` and ``--only-data-parallel``), plus a
searched compile. The JAX references run in this process on one
strategy (every strategy computes the same function); the port runs in a
world of 2 ranks (mesh (2,)) and of 4 ranks (mesh (2, 2): dp x tp, dp x
ep), each launched once (``tests/_torch_world.py``), from the reference's
weights (``interop.load_reference_params``). Everything is f32 with
dropout 0 against JAX: the forward within 2e-3 absolute, the first
step's gradients leaf by leaf within 1e-5 + 1e-4 relative, the SGD loss
histories within 1e-4. At dropout 0.1 through the flash kernel's plain
version, the ranks' gradients equal the port's one-rank run's (the masks
are drawn and hashed at global indices, so no sharding changes them).
"""
import jax
import numpy as np
import pytest

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.models import BertConfig as JaxBertConfig
from flexflow_tpu.models import MoeConfig as JaxMoeConfig
from flexflow_tpu.models import TransformerConfig as JaxTransformerConfig
from flexflow_tpu.models import build_bert as jax_build_bert
from flexflow_tpu.models import build_moe_mnist as jax_build_moe
from flexflow_tpu.models import build_transformer as jax_build_transformer
from flexflow_tpu_torch.interop import load_reference_params
from flexflow_tpu_torch.models import BertConfig, build_bert

from _torch_world import run_world

B, S = 8, 16
FWD_TOL, LOSS_TOL = 2e-3, 1e-4
BERT_RUNS = [("tp", ["--tp", "2"], 0.0, "xla"),
             ("dp", ["--only-data-parallel"], 0.0, "xla"),
             ("tpsp", ["--tp", "2", "--sp"], 0.0, "xla"),
             ("tp_drop", ["--tp", "2"], 0.1, "flash"),
             ("dp_drop", ["--only-data-parallel"], 0.1, "flash")]


def _jax_model(build, loss, batch, lr):
    cfg = ffj.FFConfig()
    cfg.batch_size, cfg.only_data_parallel = batch, True
    cfg.use_bf16_compute = False
    ff = ffj.FFModel(cfg)
    out = build(ff)
    ff.compile(ffj.SGDOptimizer(lr), loss, [], output_tensor=out)
    return ff


def _jax_ref(ff, batches, steps, inputs):
    """Initial params and layers, forward on the first batch, first-step
    gradients and an SGD loss history of a JAX model."""
    ex = ff.executor
    b0 = batches[0]

    def loss_fn(p):
        outs, _, aux, capture = ex._forward(p, ff.state, b0, True, 0)
        return ex._loss_and_metrics(outs, capture, b0["label"], aux)[0]

    ref = {"params": jax.device_get(ff.params),
           "layers": [(l.name, int(l.op_type)) for l in ff.layers],
           "batches": batches,
           "forward": np.asarray(ex.make_forward()(
               ff.params, ff.state, {k: b0[k] for k in inputs})),
           "grads": jax.device_get(jax.grad(loss_fn)(ff.params))}
    step = ex.make_train_step()
    ref["losses"] = [float(np.asarray(ff._run_train_step(
        step, batches[i % len(batches)])["loss"])) for i in range(steps)]
    return ref


def _bert_batches(bcfg, n):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, bcfg.vocab_size, (B, S)).astype(
                 np.int32),
             "position_ids": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
             "label": rng.integers(0, bcfg.num_labels, (B, 1)).astype(
                 np.int32)} for _ in range(n)]


_REFS = {}


def _refs():
    """The JAX references and the port's one-rank dropout runs, once."""
    if _REFS:
        return _REFS
    bcfg = JaxBertConfig.tiny()
    bcfg.max_position, bcfg.dropout = S, 0.0
    jb = _jax_model(lambda f: jax_build_bert(f, B, S, bcfg),
                    "sparse_categorical_crossentropy", B, 0.05)
    _REFS["bert"] = _jax_ref(jb, _bert_batches(bcfg, 2), 3,
                             ("input_ids", "position_ids"))
    tcfg = JaxTransformerConfig(hidden_size=32, num_heads=4, num_layers=2,
                                sequence_length=16)
    jt = _jax_model(lambda f: jax_build_transformer(f, 8, tcfg),
                    "mean_squared_error", 8, 0.01)
    rng = np.random.default_rng(1)
    tb = [{"input": rng.normal(size=(8, 16, 32)).astype(np.float32),
           "label": rng.normal(size=(8, 16, 1)).astype(np.float32)}
          for _ in range(2)]
    _REFS["transformer"] = _jax_ref(jt, tb, 2, ("input",))
    jm = _jax_model(lambda f: jax_build_moe(f, 16, JaxMoeConfig.tiny()),
                    "sparse_categorical_crossentropy", 16, 0.01)
    mb = [{"input": rng.normal(size=(16, 64)).astype(np.float32),
           "label": rng.integers(0, 10, (16, 1)).astype(np.int32)}
          for _ in range(2)]
    _REFS["moe"] = _jax_ref(jm, mb, 2, ("input",))

    def mlp(f):
        x = f.create_tensor((16, 16), name="x")
        h = f.dense(x, 32, activation=ffj.ActiMode.AC_MODE_RELU)
        h = f.dense(h, 32, activation=ffj.ActiMode.AC_MODE_RELU)
        return f.softmax(f.dense(h, 4))
    jl = _jax_model(mlp, "sparse_categorical_crossentropy", 16, 0.05)
    lb = [{"x": rng.normal(size=(16, 16)).astype(np.float32),
           "label": rng.integers(0, 4, (16, 1)).astype(np.int32)}
          for _ in range(3)]
    _REFS["mlp"] = _jax_ref(jl, lb, 3, ("x",))
    _REFS["mlp"]["weights"] = [dict(_REFS["mlp"]["params"][l.name])
                               for l in jl.layers
                               if l.name in _REFS["mlp"]["params"]]
    # the port on one device at dropout 0.1 through flash: the gradients
    # every sharded run must reproduce
    for tag, impl in (("drop", "flash"),):
        cfg = fft.FFConfig()
        cfg.batch_size, cfg.device, cfg.seed = B, "cpu", 0
        cfg.only_data_parallel, cfg.use_bf16_compute = True, False
        cfg.kernel_impls = f"attention:{impl}"
        pf = fft.FFModel(cfg)
        pb = BertConfig.tiny()
        pb.max_position, pb.dropout = S, 0.1
        out = build_bert(pf, B, S, pb)
        pf.compile(fft.SGDOptimizer(lr=0.05),
                   "sparse_categorical_crossentropy", ["accuracy"],
                   output_tensor=out)
        load_reference_params(pf, _REFS["bert"]["params"],
                              _REFS["bert"]["layers"])
        g, _, _ = pf.executor._grads(pf.params, pf.state,
                                     _REFS["bert"]["batches"][0], 0)
        _REFS["port_" + tag] = {ln: {wn: t.detach().numpy()
                                     for wn, t in d.items()}
                                for ln, d in g.items()}
    return _REFS


def _payload(world):
    r = _refs()
    mesh = (2,) if world == 2 else (2, 2)

    def strip(ref):
        return {k: ref[k] for k in ("params", "layers", "batches")}
    return {"bert": {"runs": BERT_RUNS, "batch": B, "seq": S, "opt": "sgd",
                     "steps": 3, **strip(r["bert"])},
            "presets": {"transformer": strip(r["transformer"]),
                        "moe": strip(r["moe"]), "mesh": mesh, "steps": 2},
            "searched": {"batch": 16, "budget": 20,
                         "weights": r["mlp"]["weights"],
                         "batches": r["mlp"]["batches"]}}


_WORLDS = {}


def _world(world):
    if world not in _WORLDS:
        _WORLDS[world] = run_world("suite", world, _payload(world))
    return _WORLDS[world]


def _close_grads(got, names, ref_layers, want, atol=1e-5, rtol=1e-4):
    """Port gradients (keyed by the port's layer names, in graph order
    ``names``) against reference ones (keyed by ``ref_layers``' names)."""
    n = 0
    for port_name, (ref_name, _) in zip(names, ref_layers):
        for wn, g in want.get(ref_name, {}).items():
            np.testing.assert_allclose(got[port_name][wn], np.asarray(g),
                                       atol=atol, rtol=rtol,
                                       err_msg=f"{ref_name}/{wn}")
            n += 1
    assert n > 0


WORLDS = [2, 4]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["tp", "dp", "tpsp"])
def test_bert_tiny_flags_match_jax(world, name):
    """--tp 2, --tp 2 --sp and --only-data-parallel over the world."""
    ref = _refs()["bert"]
    for rank, res in enumerate(_world(world)):
        r = res["bert"][name]
        np.testing.assert_allclose(r["forward"], ref["forward"],
                                   atol=FWD_TOL, rtol=0)
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   atol=LOSS_TOL, rtol=0)
        _close_grads(r["grads"], r["names"], ref["layers"], ref["grads"])
        want_mesh = {"x0": 2} if world == 2 else {"x0": 2, "x1": 2}
        assert r["mesh"] == want_mesh
        # tp: the local wq holds 4 / 2 heads; the weights API the whole
        assert r["wq_local"] == ((64, 2, 16) if name != "dp"
                                 else (64, 4, 16))
        assert r["wq_global"] == (64, 4, 16)
        # the world's checkpoint: the multi-host format, read back whole
        # (the quorum restore) equal to the weights API's wq
        assert r["save"] == (3, world, (64, 4, 16), True)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["tp_drop", "dp_drop"])
def test_dropout_masks_do_not_change_with_the_sharding(world, name):
    """At dropout 0.1 through flash (its plain version on the CPU), every
    rank's first-step gradients equal the port's one-device run's: the
    Dropout ops draw the whole mask and keep their block, the attention
    hashes at the global b*h."""
    refs = _refs()
    for res in _world(world):
        r = res["bert"][name]
        _close_grads(r["grads"], r["names"], refs["bert"]["layers"],
                     {ln: refs["port_drop"][pn]
                      for (ln, _), pn in zip(refs["bert"]["layers"],
                                             r["names"])
                      if pn in refs["port_drop"]},
                     atol=1e-6, rtol=1e-5)
        assert r["flash_calls"] > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["dp", "tp", "sp"])
def test_transformer_strategies_match_jax(world, kind):
    ref = _refs()["transformer"]
    for res in _world(world):
        r = res["presets"][kind]
        np.testing.assert_allclose(r["forward"], ref["forward"],
                                   atol=FWD_TOL, rtol=0)
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   atol=LOSS_TOL, rtol=0)
        _close_grads(r["grads"], r["names"], ref["layers"], ref["grads"])
        whole = res["presets"]["dp"]["wq_local"]
        assert whole[1] == 4
        if kind != "dp":
            # the head axis of wq sharded over tp: 4 / 2 heads a rank
            assert r["wq_local"] == (whole[0], 2, whole[2])
            assert "Shard(dim=1)" in r["wq_placements"]


@pytest.mark.parametrize("world", WORLDS)
def test_expert_parallel_moe_step_matches_jax(world):
    ref = _refs()["moe"]
    for res in _world(world):
        r = res["presets"]["ep"]
        np.testing.assert_allclose(r["forward"], ref["forward"],
                                   atol=FWD_TOL, rtol=0)
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   atol=LOSS_TOL, rtol=0)
        _close_grads(r["grads"], r["names"], ref["layers"], ref["grads"])


@pytest.mark.parametrize("world", WORLDS)
def test_searched_compile_runs_over_the_world(world):
    ref = _refs()["mlp"]
    for res in _world(world):
        r = res["searched"]
        assert r["live"] and int(np.prod(list(r["mesh"].values()))) == world
        np.testing.assert_allclose(r["forward"], ref["forward"],
                                   atol=FWD_TOL, rtol=0)
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   atol=LOSS_TOL, rtol=0)
        for got, (ln, _) in zip(r["grads"], [
                l for l in ref["layers"] if l[0] in ref["params"]]):
            for wn, g in got.items():
                np.testing.assert_allclose(g, np.asarray(
                    ref["grads"][ln][wn]), atol=1e-5, rtol=1e-4)
