"""Block rematerialization (``remat="blocks"``) in the port's executor
against the JAX package's.

``_find_remat_blocks`` finds the same repeated-block run (start, unit,
repeats, and the tensors entering and leaving each block, by producer
layer) on BERT and GPT-2 graphs, and none on LLaMA's in either. Under remat the port's losses
and weights after SGD steps match the JAX package's remat run (f32,
1e-5; SGD weights carry each step's gradients), and they are
bit-identical to the port's own run without remat, with dropout 0.1 too:
each dropout mask is keyed by (seed + 1, step, layer), so a recomputed
block draws the masks it drew the first time. Each rematted block runs
its forward twice per step (the flash plain-call count shows it).
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu import executor as jexec
from flexflow_tpu_torch import executor as texec
from flexflow_tpu_torch.interop import load_reference_params
from flexflow_tpu_torch.kernels.flash_attention import flash_attention

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_graphs as graphs  # noqa: E402


def _where(layers, guids):
    """Each tensor guid as (producer layer name, output index)."""
    at = {t.guid: (l.name, i) for l in layers
          for i, t in enumerate(l.outputs)}
    return [at.get(g) for g in guids]


@pytest.mark.parametrize("graph", ["bert", "gpt2", "llama"])
def test_remat_blocks_found_alike(graph):
    jff, tff = {"bert": graphs.bert, "gpt2": graphs.gpt2,
                "llama": graphs.llama}[graph](layers=3)
    j = jexec._find_remat_blocks(jff.layers)
    t = texec._find_remat_blocks(tff.layers)
    if graph == "llama":
        # every LLaMA block reads a second graph tensor besides the
        # residual stream: no single-crossing run in either package
        assert j is None and t is None
        return
    assert j is not None and t is not None
    assert t[:3] == j[:3] and t[2] == 3
    assert _where(tff.layers, t[3]) == _where(jff.layers, j[3])
    assert _where(tff.layers, t[4]) == _where(jff.layers, j[4])


def _data(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 1024, (4, 16)).astype(np.int32),
             "position_ids": np.tile(np.arange(16, dtype=np.int32), (4, 1)),
             "label": rng.integers(0, 2, (4, 1)).astype(np.int32)}
            for _ in range(n)]


def _compiled(pkg_ff, pkg, remat, impl="xla", dropout=0.0):
    jff, tff = graphs.bert(batch=4, seq=16, layers=3, dropout=dropout,
                           use_bf16_compute=False, only_data_parallel=True,
                           remat=remat, kernel_impls=f"attention:{impl}")
    ff = jff if pkg_ff == "jax" else tff
    ff.compile(pkg.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
               ["accuracy"])
    return ff


def _train(ff, batches):
    step = ff.executor.make_train_step()
    return [float(np.asarray(ff._run_train_step(step, b)["loss"]))
            for b in batches]


def test_remat_losses_and_weights_match_jax_remat():
    import flexflow_tpu as ffj
    import flexflow_tpu_torch as fft
    j = _compiled("jax", ffj, "blocks")
    t = _compiled("port", fft, "blocks")
    assert j.executor._remat is not None and t.executor._remat is not None
    load_reference_params(t, jax.device_get(j.params),
                          [(l.name, l.op_type) for l in j.layers])
    got, want = _train(t, _data()), _train(j, _data())
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    jp = jax.device_get(j.params)
    for ln, ws in t.params.items():
        for wn, w in ws.items():
            np.testing.assert_allclose(w.numpy(), np.asarray(jp[ln][wn]),
                                       atol=1e-5, rtol=0,
                                       err_msg=f"{ln}/{wn}")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_is_bit_identical_to_no_remat_with_dropout(impl):
    import flexflow_tpu_torch as fft
    runs = {}
    for remat in ("none", "blocks"):
        ff = _compiled("port", fft, remat, impl, dropout=0.1)
        if runs:
            with torch.no_grad():
                for ln, ws in runs["none"][1].items():
                    for wn, w in ws.items():
                        ff.params[ln][wn].copy_(w)
        init = {ln: {wn: w.clone() for wn, w in ws.items()}
                for ln, ws in ff.params.items()}
        before = flash_attention.plain_calls
        losses = _train(ff, _data(3))
        runs[remat] = (losses, init, ff.params,
                       flash_attention.plain_calls - before)
    assert runs["none"][0] == runs["blocks"][0]
    for ln, ws in runs["none"][2].items():
        for wn, w in ws.items():
            assert torch.equal(w, runs["blocks"][2][ln][wn]), (ln, wn)
    if impl == "flash":
        # 3 attention layers x 3 steps, each forward recomputed
        assert runs["none"][3] == 9 and runs["blocks"][3] == 18


def test_remat_without_repeated_blocks_warns_and_runs(caplog):
    import flexflow_tpu_torch as fft
    _, t = graphs.mlp(remat="blocks", use_bf16_compute=False)
    t.compile(fft.SGDOptimizer(0.01), "sparse_categorical_crossentropy", [])
    assert t.executor._remat is None
    with pytest.raises(ValueError, match="remat"):
        _, bad = graphs.mlp(remat="everything")
        bad.compile(fft.SGDOptimizer(0.01),
                    "sparse_categorical_crossentropy", [])
