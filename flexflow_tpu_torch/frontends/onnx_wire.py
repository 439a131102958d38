"""Self-contained ONNX protobuf wire codec (no ``onnx`` package).

The port's own copy of ``flexflow_tpu/frontends/onnx_wire.py`` (pure
numpy; the two must decode and encode the same bytes). The upstream
Triton backend parses ONNX natively (``triton/src/onnx_parser.cc``); this
is the same design decision in a few hundred lines of wire-format
decoding: ModelProto/GraphProto/NodeProto/AttributeProto/TensorProto/
ValueInfoProto are all varints + length-delimited submessages (proto3),
so the frontend works, and is tested, whether or not the ``onnx``
package is installed. The decoder exposes lightweight objects with the
SAME attribute surface the frontend uses (``model.graph.node[i].op_type``,
``init.name``, ``to_array(init)``,
``vi.type.tensor_type.shape.dim[j].dim_value`` ...); a matching
mini-encoder builds valid .onnx files for tests and tooling.

Field numbers (onnx.proto3):
  ModelProto:   ir_version=1, graph=7, opset_import=8
  GraphProto:   node=1, name=2, initializer=5, input=11, output=12
  NodeProto:    input=1, output=2, name=3, op_type=4, attribute=5
  AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20
  TensorProto:  dims=1, data_type=2, float_data=4, int32_data=5,
                int64_data=7, name=8, raw_data=9
  ValueInfoProto: name=1, type=2;  TypeProto: tensor_type=1
  TypeProto.Tensor: elem_type=1, shape=2
  TensorShapeProto: dim=1;  Dimension: dim_value=1, dim_param=2
"""
from __future__ import annotations

import struct
from types import SimpleNamespace
from typing import Any, List, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype
_NP_OF = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
          5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
          10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}
_DT_OF = {np.dtype(v): k for k, v in _NP_OF.items()}


# ----------------------------------------------------------------------
# wire primitives
# ----------------------------------------------------------------------
def _rvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise ValueError(
                "truncated/unsupported ONNX: varint runs past end of "
                f"buffer (offset {pos} of {n})")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise ValueError(
                "truncated/unsupported ONNX: varint longer than 64 bits")


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message. Every
    read is bounds-checked against ``len(buf)`` so truncated or
    garbage input raises ``ValueError`` instead of silently decoding
    short slices into wrong tensors."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _rvarint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:                      # varint
            v, pos = _rvarint(buf, pos)
        elif wt == 1:                    # fixed64
            if pos + 8 > n:
                raise ValueError(
                    "truncated/unsupported ONNX: fixed64 field "
                    f"{field} runs past end of buffer")
            v = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:                    # length-delimited
            ln, pos = _rvarint(buf, pos)
            if ln < 0 or pos + ln > n:
                raise ValueError(
                    "truncated/unsupported ONNX: length-delimited "
                    f"field {field} claims {ln} bytes, "
                    f"{n - pos} remain")
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:                    # fixed32
            if pos + 4 > n:
                raise ValueError(
                    "truncated/unsupported ONNX: fixed32 field "
                    f"{field} runs past end of buffer")
            v = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _s64(v: int) -> int:
    """proto int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ----------------------------------------------------------------------
# decoding
# ----------------------------------------------------------------------
def _dims(buf: bytes):
    dim = []
    for f, wt, v in _fields(buf):
        if f == 1 and wt == 2:           # Dimension submessage
            dv, dp = 0, ""
            for f2, _, v2 in _fields(v):
                if f2 == 1:
                    dv = _s64(v2)
                elif f2 == 2:
                    dp = v2.decode()
            dim.append(SimpleNamespace(dim_value=dv, dim_param=dp))
    return SimpleNamespace(dim=dim)


def _value_info(buf: bytes):
    name, elem, shape = "", 0, SimpleNamespace(dim=[])
    for f, _, v in _fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            for f2, _, v2 in _fields(v):
                if f2 == 1:              # tensor_type
                    for f3, wt3, v3 in _fields(v2):
                        if f3 == 1:
                            elem = v3
                        elif f3 == 2:
                            shape = _dims(v3)
    return SimpleNamespace(
        name=name,
        type=SimpleNamespace(tensor_type=SimpleNamespace(
            elem_type=elem, shape=shape)))


def _tensor(buf: bytes):
    t = SimpleNamespace(dims=[], data_type=1, name="", raw_data=b"",
                        float_data=[], int32_data=[], int64_data=[],
                        double_data=[], uint64_data=[])
    for f, wt, v in _fields(buf):
        if f == 1:
            t.dims.append(_s64(v))
        elif f == 2:
            t.data_type = v
        elif f == 4:
            if wt == 2:                  # packed floats
                t.float_data.extend(struct.unpack(
                    f"<{len(v) // 4}f", v))
            else:
                t.float_data.append(struct.unpack("<f", v)[0])
        elif f == 5:
            t.int32_data.append(_s64(v))
        elif f == 7:
            t.int64_data.append(_s64(v))
        elif f == 8:
            t.name = v.decode()
        elif f == 9:
            t.raw_data = v
        elif f == 10:
            if wt == 2:                  # packed doubles
                t.double_data.extend(struct.unpack(
                    f"<{len(v) // 8}d", v))
            else:
                t.double_data.append(struct.unpack("<d", v)[0])
        elif f == 11:
            t.uint64_data.append(v if wt == 0 else 0)
    return t


def _attribute(buf: bytes):
    a = SimpleNamespace(name="", f=0.0, i=0, s=b"", t=None, floats=[],
                        ints=[], type=0)
    for f, wt, v in _fields(buf):
        if f == 1:
            a.name = v.decode()
        elif f == 2:
            a.f = struct.unpack("<f", v)[0]
        elif f == 3:
            a.i = _s64(v)
        elif f == 4:
            a.s = v
        elif f == 5:
            a.t = _tensor(v)
        elif f == 7:
            if wt == 2:
                a.floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                a.floats.append(struct.unpack("<f", v)[0])
        elif f == 8:
            if wt == 2:
                pos = 0
                while pos < len(v):
                    x, pos = _rvarint(v, pos)
                    a.ints.append(_s64(x))
            else:
                a.ints.append(_s64(v))
        elif f == 20:
            a.type = v
    return a


def _node(buf: bytes):
    n = SimpleNamespace(input=[], output=[], name="", op_type="",
                        attribute=[])
    for f, _, v in _fields(buf):
        if f == 1:
            n.input.append(v.decode())
        elif f == 2:
            n.output.append(v.decode())
        elif f == 3:
            n.name = v.decode()
        elif f == 4:
            n.op_type = v.decode()
        elif f == 5:
            n.attribute.append(_attribute(v))
    return n


def _graph(buf: bytes):
    g = SimpleNamespace(node=[], name="", initializer=[], input=[],
                        output=[])
    for f, _, v in _fields(buf):
        if f == 1:
            g.node.append(_node(v))
        elif f == 2:
            g.name = v.decode()
        elif f == 5:
            g.initializer.append(_tensor(v))
        elif f == 11:
            g.input.append(_value_info(v))
        elif f == 12:
            g.output.append(_value_info(v))
    return g


def load_model(data: bytes):
    """Decode a serialized ModelProto into the lightweight object tree
    the frontend consumes."""
    m = SimpleNamespace(ir_version=0, graph=SimpleNamespace(
        node=[], initializer=[], input=[], output=[], name=""))
    for f, _, v in _fields(data):
        if f == 1:
            m.ir_version = v
        elif f == 7:
            m.graph = _graph(v)
    return m


# TensorProto.DataType ids the codec knows about but cannot decode to a
# numpy array (no stable numpy dtype): name them in the error instead of
# a bare KeyError
_UNSUPPORTED_DT = {8: "string", 14: "complex64", 15: "complex128",
                   16: "bfloat16", 17: "float8e4m3fn", 18: "float8e4m3fnuz",
                   19: "float8e5m2", 20: "float8e5m2fnuz", 21: "uint4",
                   22: "int4", 23: "float4e2m1"}


def to_array(t) -> np.ndarray:
    """``onnx.numpy_helper.to_array`` for decoded TensorProtos."""
    dtype_id = int(t.data_type)
    if dtype_id not in _NP_OF:
        name = _UNSUPPORTED_DT.get(dtype_id, f"data_type={dtype_id}")
        raise ValueError(
            f"truncated/unsupported ONNX: tensor {t.name!r} has "
            f"unsupported dtype {name} (data_type={dtype_id}); "
            "bfloat16/float8 initializers are not decodable without the "
            "onnx package — re-export the model with float32/float16 "
            "weights")
    dt = np.dtype(_NP_OF[dtype_id])
    shape = tuple(int(d) for d in t.dims)
    n = 1
    for d in shape:
        n *= d
    if t.raw_data:
        return np.frombuffer(t.raw_data, dtype=dt.newbyteorder("<")) \
            .astype(dt).reshape(shape)
    if dtype_id == 10 and len(t.int32_data):
        # float16 stored as int32 bit patterns (TensorProto docs)
        bits = np.asarray(t.int32_data, np.uint16)
        return bits.view(np.float16).reshape(shape)
    for field in (t.float_data, t.double_data, t.int64_data,
                  t.int32_data, t.uint64_data):
        if len(field):
            return np.asarray(field).astype(dt).reshape(shape)
    if n == 0:
        return np.zeros(shape, dt)
    raise ValueError(
        f"tensor {t.name!r}: no data field decoded for "
        f"data_type={dtype_id} shape={shape} — unsupported storage")


def attribute_value(a) -> Any:
    """``onnx.helper.get_attribute_value`` for decoded attributes
    (type tag when present, else first non-empty field)."""
    kind = int(getattr(a, "type", 0))
    if kind == 1:
        return a.f
    if kind == 2:
        return a.i
    if kind == 3:
        return a.s.decode() if isinstance(a.s, bytes) else a.s
    if kind == 4:
        return to_array(a.t)
    if kind == 6:
        return list(a.floats)
    if kind == 7:
        return list(a.ints)
    if a.ints:
        return list(a.ints)
    if a.floats:
        return list(a.floats)
    if a.s:
        return a.s.decode() if isinstance(a.s, bytes) else a.s
    if a.t is not None:
        return to_array(a.t)
    if a.f:
        return a.f
    return a.i


# ----------------------------------------------------------------------
# encoding (tests/tooling: build valid .onnx bytes without the package)
# ----------------------------------------------------------------------
def _wvarint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wt: int) -> bytes:
    return _wvarint((field << 3) | wt)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _wvarint(len(payload)) + payload


def _str(field: int, s: str) -> bytes:
    return _ld(field, s.encode())


def make_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b"".join(_tag(1, 0) + _wvarint(int(d)) for d in arr.shape)
    out += _tag(2, 0) + _wvarint(_DT_OF[arr.dtype])
    out += _str(8, name)
    out += _ld(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return out


def make_attr(name: str, value) -> bytes:
    out = _str(1, name)
    if isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value)
        out += _tag(20, 0) + _wvarint(1)
    elif isinstance(value, int):
        out += _tag(3, 0) + _wvarint(value)
        out += _tag(20, 0) + _wvarint(2)
    elif isinstance(value, str):
        out += _ld(4, value.encode())
        out += _tag(20, 0) + _wvarint(3)
    elif isinstance(value, (list, tuple)) and value \
            and isinstance(value[0], float):
        out += _ld(7, b"".join(struct.pack("<f", v) for v in value))
        out += _tag(20, 0) + _wvarint(6)
    else:                                # list of ints (or empty)
        out += _ld(8, b"".join(_wvarint(int(v)) for v in value))
        out += _tag(20, 0) + _wvarint(7)
    return out


def make_node(op_type: str, inputs, outputs, name: str = "",
              **attrs) -> bytes:
    out = b"".join(_str(1, s) for s in inputs)
    out += b"".join(_str(2, s) for s in outputs)
    if name:
        out += _str(3, name)
    out += _str(4, op_type)
    out += b"".join(_ld(5, make_attr(k, v)) for k, v in attrs.items())
    return out


def make_value_info(name: str, elem_type: int, shape) -> bytes:
    dims = b"".join(_ld(1, _tag(1, 0) + _wvarint(int(d))) for d in shape)
    tt = _tag(1, 0) + _wvarint(elem_type) + _ld(2, dims)
    return _str(1, name) + _ld(2, _ld(1, tt))


def make_model(nodes: List[bytes], inputs: List[bytes],
               outputs: List[bytes],
               initializers: List[bytes] = (),
               graph_name: str = "g") -> bytes:
    g = b"".join(_ld(1, n) for n in nodes)
    g += _str(2, graph_name)
    g += b"".join(_ld(5, t) for t in initializers)
    g += b"".join(_ld(11, vi) for vi in inputs)
    g += b"".join(_ld(12, vi) for vi in outputs)
    return _tag(1, 0) + _wvarint(8) + _ld(7, g)
