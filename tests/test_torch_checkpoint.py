"""Checkpoints cross between the two packages: a 2-layer, hidden-64 BERT
(``BertConfig.tiny()``, batch 4, seq 16) in f32 with dropout 0, the
flash attention impl (on the CPU the JAX package runs its Pallas kernels
in interpret mode and the port its kernels' plain versions) and Adam
(alpha 1e-3, epsilon 1e-4, as in tests/test_torch_train.py), the port's
update through the fused Adam's plain version.

- A step the JAX package writes (``CheckpointManager(writer="numpy")``)
  restores into the port, and one the port writes restores into the JAX
  package; the next 3 steps' losses then agree within 1e-5 relative.
- For the same state, both packages write the same ``manifest.json``:
  the same ``keystr`` leaf keys, shapes, dtypes and CRC32s.
- ``tests/data/bert_base_checkpoint_leaves.json`` lists the manifest
  leaves (key, shape, dtype) of BERT-base at 8 x 128 with Adam as the
  JAX package keys them; ``chip_smoke.py``'s resilience phase holds the
  port's manifest on the card against it. Regenerate it with
  ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_checkpoint.py``
  from the repo root.

The two packages name BERT's layers alike (by index), so leaves pair by
key; ``interop.load_reference_params`` (pairing by position) carries the
JAX model's initial weights into the port.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.models import BertConfig as JaxBertConfig
from flexflow_tpu.models import build_bert as jax_build_bert
from flexflow_tpu.runtime.checkpoint import \
    CheckpointManager as JaxCheckpointManager
from flexflow_tpu.runtime.checkpoint import \
    save_model_checkpoint as jax_save_model_checkpoint
from flexflow_tpu_torch.interop import (load_reference_opt_state,
                                        load_reference_params)
from flexflow_tpu_torch.models import BertConfig, build_bert
from flexflow_tpu_torch.runtime.callbacks import PeriodicCheckpoint
from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager
from flexflow_tpu_torch.runtime.metrics_buffer import NonFiniteMetrics

BATCH, SEQ = 4, 16
RTOL = 1e-5
LEAVES_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "bert_base_checkpoint_leaves.json")


def _bert(pkg, cfg_cls, builder, **model_kw):
    cfg = pkg.FFConfig()
    cfg.batch_size = BATCH
    cfg.only_data_parallel = True
    cfg.use_bf16_compute = False
    cfg.kernel_impls = "attention:flash"
    ff = pkg.FFModel(cfg, **model_kw)
    bcfg = cfg_cls.tiny()
    bcfg.max_position = SEQ
    bcfg.dropout = 0.0
    out = builder(ff, BATCH, SEQ, bcfg)
    ff.compile(pkg.AdamOptimizer(alpha=1e-3, epsilon=1e-4),
               "sparse_categorical_crossentropy", ["accuracy"],
               output_tensor=out)
    return ff


def _jax_model():
    return _bert(ffj, JaxBertConfig, jax_build_bert)


def _port_model(jff=None):
    """The port's model with the fused Adam (set directly: its
    predicate refuses the CPU), from the JAX model's weights when
    given."""
    ff = _bert(fft, BertConfig, build_bert, device="cpu")
    ff.executor._kernel_impls["opt_update"] = "fused"
    if jff is not None:
        load_reference_params(ff, jax.device_get(jff.params),
                              [(l.name, l.op_type) for l in jff.layers])
    return ff


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 1024, (BATCH, SEQ)).astype(
                np.int32),
             "position_ids": np.tile(np.arange(SEQ, dtype=np.int32),
                                     (BATCH, 1)),
             "label": rng.integers(0, 2, (BATCH, 1)).astype(np.int32)}
            for _ in range(n)]


def _train(ff, batches):
    step_fn = ff.executor.make_train_step()
    return [float(np.asarray(ff._run_train_step(step_fn, b)["loss"]))
            for b in batches]


def _port_state_like_jax(jff):
    """A port model holding the JAX model's params, Adam state and step."""
    names = [(l.name, l.op_type) for l in jff.layers]
    ff = _port_model()
    load_reference_params(ff, jax.device_get(jff.params), names)
    load_reference_opt_state(ff, jax.device_get(jff.opt_state), names)
    ff._step = jff._step
    return ff


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jff = _jax_model()
    _train(jff, _batches(2, 0))
    d = str(tmp_path / "jax")
    jax_save_model_checkpoint(
        jff, d, manager=JaxCheckpointManager(d, writer="numpy"))
    assert os.path.exists(os.path.join(d, "2", "state.pkl"))
    ff = _port_model()     # its own initial weights, overwritten
    assert ff.restore_checkpoint(d) == 2
    nxt = _batches(3, 1)
    np.testing.assert_allclose(_train(ff, nxt), _train(jff, nxt),
                               rtol=RTOL)


def test_port_checkpoint_restores_into_jax(tmp_path):
    j0 = _jax_model()
    ff = _port_model(j0)
    _train(ff, _batches(2, 0))
    d = str(tmp_path / "port")
    ff.save_checkpoint(d)
    jff = _jax_model()
    assert jff.restore_checkpoint(d) == 2
    nxt = _batches(3, 1)
    np.testing.assert_allclose(_train(jff, nxt), _train(ff, nxt),
                               rtol=RTOL)


def test_restore_copies_into_the_live_tensors(tmp_path):
    """Restored leaves land in the live tensors (same storage, strides
    and dtype): the fused Adam's pointer table stays valid."""
    ff = _port_model()
    _train(ff, _batches(2, 0))
    d = str(tmp_path / "live")
    ff.save_checkpoint(d)
    want = {k: t.clone() for k, t in ff.params["word_embeddings"].items()}
    ptrs = {(s, ln, wn): t.data_ptr()
            for s, tree in (("p", ff.params), ("m", ff.opt_state["m"]),
                            ("v", ff.opt_state["v"]))
            for ln, ws in tree.items() for wn, t in ws.items()}
    _train(ff, _batches(1, 5))
    assert ff.restore_checkpoint(d) == 2
    for k, t in ff.params["word_embeddings"].items():
        assert torch.equal(t, want[k])
    assert {(s, ln, wn): t.data_ptr()
            for s, tree in (("p", ff.params), ("m", ff.opt_state["m"]),
                            ("v", ff.opt_state["v"]))
            for ln, ws in tree.items() for wn, t in ws.items()} == ptrs


def test_same_state_same_manifest(tmp_path):
    jff = _jax_model()
    _train(jff, _batches(2, 0))
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_save_model_checkpoint(
        jff, dj, manager=JaxCheckpointManager(dj, writer="numpy"))
    _port_state_like_jax(jff).save_checkpoint(dp)
    with open(os.path.join(dj, "2", "manifest.json")) as f:
        mj = json.load(f)
    with open(os.path.join(dp, "2", "manifest.json")) as f:
        mp = json.load(f)
    params = [k for k in mj["leaves"] if k.startswith("['params']")]
    assert len(mj["leaves"]) == 3 * len(params) > 0   # params, m, v
    assert mp == mj
    with open(os.path.join(dp, "2", "meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 2 and meta["strategy"] is None \
        and meta["batch_size"] == BATCH


def _rule_leaves(layers, opt_slots=("m", "v")):
    """Manifest leaves (key -> shape, dtype) of a model with Adam and no
    op state, from its layers' weight specs: params, then each optimizer
    slot, in the layout the JAX package checkpoints."""
    from flexflow_tpu.dtypes import to_jnp
    out = {}
    for top, prefix in [("params", "")] + [("opt_state", f"['{s}']")
                                           for s in opt_slots]:
        for l in layers:
            for w in l.weights:
                out[f"['{top}']{prefix}['{l.name}']['{w.name}']"] = {
                    "shape": list(w.shape),
                    "dtype": str(np.dtype(to_jnp(w.dtype)))}
    return out


def test_leaf_rule_matches_the_jax_tree():
    """The rule that lists BERT-base's leaves gives, at tiny size, exactly
    ``keystr`` over the compiled JAX model's checkpointed tree."""
    from jax.tree_util import keystr, tree_flatten_with_path
    jff = _jax_model()
    tree = {"params": jff.params, "opt_state": jff.opt_state,
            "state": jff.state}
    leaves, _ = tree_flatten_with_path(tree)
    got = {keystr(p): {"shape": list(x.shape), "dtype": str(x.dtype)}
           for p, x in leaves}
    assert got == _rule_leaves(jff.layers)


def jax_bert_base_leaves():
    """The manifest leaves of chip_smoke.py's resilience-phase model:
    BERT-base (``BertConfig.base()``, seq 128, batch 8) with Adam, built
    through the JAX package (no weight materialised)."""
    cfg = ffj.FFConfig()
    cfg.batch_size = 8
    ff = ffj.FFModel(cfg)
    bcfg = JaxBertConfig.base()
    bcfg.max_position = 128
    jax_build_bert(ff, 8, 128, bcfg)
    return {"model": "BertConfig.base(), batch 8, seq 128, Adam",
            "leaves": _rule_leaves(ff.layers)}


def test_bert_base_leaf_file_is_the_jax_packages():
    with open(LEAVES_FILE) as f:
        doc = json.load(f)
    assert doc == jax_bert_base_leaves()
    n = sum(int(np.prod(r["shape"])) for k, r in doc["leaves"].items()
            if k.startswith("['params']"))
    assert n == 109_187_330 and len(doc["leaves"]) == 600


def test_periodic_checkpoint_and_max_to_keep(tmp_path):
    ff = _port_model()
    b = _batches(1, 0)[0]
    x = [np.concatenate([b["input_ids"]] * 2),
         np.concatenate([b["position_ids"]] * 2)]
    y = np.concatenate([b["label"]] * 2)
    cb = PeriodicCheckpoint(str(tmp_path / "ckpt"), every_epochs=1,
                            max_to_keep=2)
    ff.fit(x, y, epochs=3, verbose=False, callbacks=[cb])
    assert cb.saved_steps == [2, 4, 6]
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [4, 6]
    ff2 = _port_model()
    assert ff2.restore_checkpoint(str(tmp_path / "ckpt")) == 6
    for ln, ws in ff.params.items():
        for wn, t in ws.items():
            assert torch.equal(ff2.params[ln][wn], t), (ln, wn)


def test_save_checkpoint_refuses_a_poisoned_buffer(tmp_path):
    """Inside fit a checkpoint save flushes the metrics buffer first and
    raises on a non-finite step: a poisoned state never reaches disk."""
    from flexflow_tpu_torch.resilience import faults
    ff = _port_model()
    b = _batches(1, 0)[0]
    x = [np.concatenate([b["input_ids"]] * 2),
         np.concatenate([b["position_ids"]] * 2)]
    y = np.concatenate([b["label"]] * 2)
    faults.install("nan@1")
    try:
        with pytest.raises(NonFiniteMetrics, match="step 1"):
            ff.fit(x, y, epochs=1, verbose=False,
                   callbacks=[PeriodicCheckpoint(str(tmp_path / "c"))])
    finally:
        faults.clear()
    assert CheckpointManager(str(tmp_path / "c")).all_steps() == []
    assert ff._metrics_buffer is None     # detached on the way out
    assert all(torch.isnan(t).all() for ws in ff.params.values()
               for t in ws.values())


if __name__ == "__main__":
    os.makedirs(os.path.dirname(LEAVES_FILE), exist_ok=True)
    with open(LEAVES_FILE, "w") as f:
        json.dump(jax_bert_base_leaves(), f, indent=0)
        f.write("\n")
    print(LEAVES_FILE)
