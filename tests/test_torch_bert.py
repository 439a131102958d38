"""The port's serving slice end to end against the JAX package: a tiny
BERT built through ``FFModel`` in both, the reference's weights carried
into the port by ``interop.load_reference_params``, then
``Executor.make_forward`` and ``InferenceSession.infer`` compared.

f32 compute holds to atol = rtol = 1e-5 on the output probabilities:
the graphs agree op for op and differ only in f32 summation order. With
bf16 matmul operands (the default) both packages round the same operands
to bf16 and sum in f32, but a different summation order can flip a later
bf16 rounding by one ulp (2**-8 relative), so that case holds to 5e-3.
"""
import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as ffj
import flexflow_tpu_torch as fft
from flexflow_tpu.models import BertConfig as JaxBertConfig
from flexflow_tpu.models import build_bert as jax_build_bert
from flexflow_tpu.serving import InferenceSession as JaxSession
from flexflow_tpu_torch.interop import load_reference_params
from flexflow_tpu_torch.kernels import flash_attention
from flexflow_tpu_torch.models import BertConfig, build_bert
from flexflow_tpu_torch.serving import InferenceSession

BATCH = 2


def _config(pkg, impl, bf16):
    cfg = pkg.FFConfig()
    cfg.batch_size = BATCH
    cfg.only_data_parallel = True
    cfg.use_bf16_compute = bf16
    cfg.kernel_impls = f"attention:{impl}"
    return cfg


def _bert(pkg, cfg_cls, builder, seq, impl, bf16, **model_kw):
    ff = pkg.FFModel(_config(pkg, impl, bf16), **model_kw)
    bcfg = cfg_cls.tiny()
    bcfg.max_position = seq
    out = builder(ff, BATCH, seq, bcfg)
    ff.compile(pkg.SGDOptimizer(0.01), "sparse_categorical_crossentropy",
               [], output_tensor=out)
    return ff, bcfg


def _pair(seq, impl, bf16=False):
    ffj_, bcfg = _bert(ffj, JaxBertConfig, jax_build_bert, seq, impl, bf16)
    fft_, _ = _bert(fft, BertConfig, build_bert, seq, impl, bf16,
                    device="cpu")
    load_reference_params(fft_, jax.device_get(ffj_.params),
                          [(l.name, l.op_type) for l in ffj_.layers])
    return ffj_, fft_, bcfg


def _batch(bcfg, seq, rows, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, bcfg.vocab_size,
                                      (rows, seq)).astype(np.int32),
            "position_ids": np.tile(np.arange(seq, dtype=np.int32),
                                    (rows, 1))}


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("seq", [16, 64])
def test_make_forward_matches_jax_f32(seq, impl):
    ffj_, fft_, bcfg = _pair(seq, impl)
    batch = _batch(bcfg, seq, BATCH)
    want = np.asarray(ffj_.executor.make_forward()(ffj_.params, ffj_.state,
                                                   batch))
    calls = flash_attention.plain_calls
    got = fft_.executor.make_forward()(fft_.params, fft_.state, batch)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # the flash branch ran once per attention layer, or not at all
    ran = flash_attention.plain_calls - calls
    assert ran == (bcfg.num_layers if impl == "flash" else 0)


def test_make_forward_matches_jax_bf16():
    ffj_, fft_, bcfg = _pair(16, "flash", bf16=True)
    batch = _batch(bcfg, 16, BATCH, seed=1)
    want = np.asarray(ffj_.executor.make_forward()(ffj_.params, ffj_.state,
                                                   batch))
    got = fft_.executor.make_forward()(fft_.params, fft_.state, batch)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)


def test_inference_session_matches_jax():
    """Requests of 1, 2 and 5 rows through bucket 2 (the pooler reshapes
    to the compile-time batch): zero-row padding and chunking agree."""
    ffj_, fft_, bcfg = _pair(16, "flash")
    sj = JaxSession(ffj_, batch_buckets=(BATCH,))
    st = InferenceSession(fft_, batch_buckets=(BATCH,))
    assert st.input_names == sj.input_names
    assert st.input_signature == sj.input_signature
    calls = flash_attention.plain_calls
    for rows in (1, 2, 5):
        batch = _batch(bcfg, 16, rows, seed=rows)
        got = st.infer(batch)
        assert got.shape == (rows, bcfg.num_labels)
        np.testing.assert_allclose(got, sj.infer(batch), atol=1e-5,
                                   rtol=1e-5)
    # 1 + 1 + 3 forwards, one flash call per layer each
    assert flash_attention.plain_calls - calls == 5 * bcfg.num_layers
    with pytest.raises(ValueError, match="missing inputs"):
        st.infer({"input_ids": batch["input_ids"]})


# ---------------------------------------------------------------------------
# interop.load_reference_params
# ---------------------------------------------------------------------------
def test_load_reference_params_round_trips_exactly():
    ffj_, fft_, _ = _pair(16, "xla")
    ref = jax.device_get(ffj_.params)
    assert set(fft_.params) == set(ref)
    for name, ws in ref.items():
        assert set(fft_.params[name]) == set(ws)
        for wname, arr in ws.items():
            t = fft_.params[name][wname]
            assert t.device.type == "cpu" and t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(arr))


def test_load_reference_params_rejects_mismatches():
    ffj_, _, _ = _pair(16, "xla")
    ref = jax.device_get(ffj_.params)
    names = [(l.name, l.op_type) for l in ffj_.layers]
    # a wider FFN in the port: same layers, other weight shapes
    ff = fft.FFModel(_config(fft, "xla", False), device="cpu")
    bcfg = BertConfig.tiny()
    bcfg.max_position = 16
    bcfg.intermediate_size = 256
    build_bert(ff, BATCH, 16, bcfg)
    ff.compile(fft.SGDOptimizer(0.01), "sparse_categorical_crossentropy")
    with pytest.raises(ValueError, match="shape differs"):
        load_reference_params(ff, ref, names)
    _, fft_, _ = _pair(16, "xla")
    bad = list(names)
    bad[3] = (bad[3][0], ffj.OperatorType.OP_LINEAR)
    with pytest.raises(ValueError, match="op type differs"):
        load_reference_params(fft_, ref, bad)
    with pytest.raises(ValueError, match="layer count differs"):
        load_reference_params(fft_, ref, names[:-1])
    missing = {k: dict(v) for k, v in ref.items()}
    missing["word_embeddings"].pop("kernel")
    with pytest.raises(ValueError, match="weight names differ"):
        load_reference_params(fft_, missing, names)
