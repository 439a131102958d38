"""The port's ONNX wire codec (``flexflow_tpu_torch/frontends/onnx_wire``):
the robustness tests of ``tests/test_onnx_wire_hardening.py`` run against
it (truncated or garbage input raises a clear ``ValueError``), and its
encoder and decoder held against the JAX package's codec byte for byte."""
from types import SimpleNamespace

import numpy as np
import pytest

from flexflow_tpu.frontends import onnx_wire as jw
from flexflow_tpu_torch.frontends import onnx_wire as w


def _mlp_model_bytes(codec=w):
    x = codec.make_value_info("x", 1, (4, 8))
    y = codec.make_value_info("y", 1, (4, 2))
    wt = codec.make_tensor("w0", np.zeros((8, 2), np.float32))
    node = codec.make_node("MatMul", ["x", "w0"], ["y"])
    return codec.make_model([node], [x], [y], [wt])


def test_truncated_model_raises_value_error():
    data = _mlp_model_bytes()
    assert w.load_model(data).graph.node[0].op_type == "MatMul"
    for cut in (1, len(data) // 3, len(data) - 1):
        with pytest.raises(ValueError, match="truncated/unsupported"):
            w.load_model(data[:cut])


def test_unterminated_varint_raises():
    with pytest.raises(ValueError, match="truncated/unsupported"):
        list(w._fields(b"\x80\x80\x80"))      # continuation bit forever


def test_oversized_length_delimited_raises():
    # field 1, wire type 2, claims 100 bytes with only 2 present
    with pytest.raises(ValueError, match="length-delimited"):
        list(w._fields(b"\x0a\x64ab"))


def test_truncated_fixed_width_raises():
    with pytest.raises(ValueError, match="fixed64"):
        list(w._fields(b"\x09\x01\x02"))      # wt=1 needs 8 bytes
    with pytest.raises(ValueError, match="fixed32"):
        list(w._fields(b"\x0d\x01"))          # wt=5 needs 4 bytes


def test_bfloat16_initializer_gets_explicit_error():
    t = SimpleNamespace(name="emb", data_type=16, dims=[2, 2],
                        raw_data=b"\x00" * 8, float_data=[],
                        int32_data=[], int64_data=[], double_data=[],
                        uint64_data=[])
    with pytest.raises(ValueError, match="bfloat16"):
        w.to_array(t)
    t.data_type = 17
    with pytest.raises(ValueError, match="float8"):
        w.to_array(t)
    # the message names the tensor so the user can find it
    t.data_type = 16
    with pytest.raises(ValueError, match="emb"):
        w.to_array(t)


def _rich_model(codec):
    """A model exercising every encoder: tensors of several dtypes and
    ranks, attributes of every kind (float, int incl. negative, string,
    float and int lists), named and unnamed nodes."""
    rng = np.random.default_rng(0)
    inits = [codec.make_tensor("f32", rng.normal(size=(3, 4))
                               .astype(np.float32)),
             codec.make_tensor("i64", np.array([-1, 0, 2**40], np.int64)),
             codec.make_tensor("f16", rng.normal(size=(5,))
                               .astype(np.float16)),
             codec.make_tensor("u8", np.arange(6, dtype=np.uint8)
                               .reshape(2, 3)),
             codec.make_tensor("scalar", np.array(2.5, np.float64))]
    nodes = [codec.make_node("Conv", ["x", "f32"], ["c"], name="conv",
                             kernel_shape=[3, 3], pads=[1, 1, 1, 1],
                             group=1),
             codec.make_node("LeakyRelu", ["c"], ["l"], alpha=0.25),
             codec.make_node("Softmax", ["l"], ["s"], axis=-1),
             codec.make_node("Pad", ["s"], ["p"], mode="constant",
                             scales=[1.0, 0.5])]
    return codec.make_model(
        nodes, [codec.make_value_info("x", 1, (2, 3, 8, 8))],
        [codec.make_value_info("p", 1, (2, 3, 8, 8))], inits,
        graph_name="rich")


def test_codec_matches_the_jax_codec_both_ways():
    """The same model encodes to the same bytes in both packages, and
    each package's decoder reads either's bytes to the same graph."""
    data = _rich_model(w)
    assert data == _rich_model(jw)
    assert _mlp_model_bytes(w) == _mlp_model_bytes(jw)
    ours, ref = w.load_model(data), jw.load_model(data)
    assert ours.ir_version == ref.ir_version == 8
    assert ours.graph.name == ref.graph.name == "rich"
    for a, b in zip(ours.graph.node, ref.graph.node, strict=True):
        assert (a.op_type, a.name, a.input, a.output) == \
            (b.op_type, b.name, b.input, b.output)
        for x, y in zip(a.attribute, b.attribute, strict=True):
            assert x.name == y.name
            vx, vy = w.attribute_value(x), jw.attribute_value(y)
            assert vx == vy, x.name
    for a, b in zip(ours.graph.initializer, ref.graph.initializer,
                    strict=True):
        xa, xb = w.to_array(a), jw.to_array(b)
        assert a.name == b.name and xa.dtype == xb.dtype
        np.testing.assert_array_equal(xa, xb)
    vi = ours.graph.input[0].type.tensor_type
    assert vi.elem_type == 1
    assert [d.dim_value for d in vi.shape.dim] == [2, 3, 8, 8]
    # a decoded tensor re-encodes to the bytes it came from
    t = ours.graph.initializer[1]
    assert w.make_tensor(t.name, w.to_array(t)) == \
        jw.make_tensor("i64", np.array([-1, 0, 2**40], np.int64))
