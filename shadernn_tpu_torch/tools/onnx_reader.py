"""Minimal ONNX reader (counterpart of shadernn_tpu/tools/onnx_reader.py):
protobuf wire-format parser for the model subset the converter needs — no
`onnx` package required.

The reference's convertTool consumes ONNX opset 11 graphs
(tools/convertTool, docs/ModelConversion.md); this module parses the
ModelProto/GraphProto/NodeProto/TensorProto/AttributeProto wire format
directly (protobuf encoding is stable and documented) into plain Python
structures consumed by tools/convert.py.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# protobuf wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Iterate (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == _I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _zigzag_ok_int(v: int) -> int:
    # ONNX ints are plain varints (two's complement for negatives, 64-bit)
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def _packed_ints(val, wt) -> List[int]:
    if wt == _VARINT:
        return [_zigzag_ok_int(val)]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(_zigzag_ok_int(v))
    return out


def _packed_floats(val, wt) -> List[float]:
    if wt == _I32:
        return [struct.unpack("<f", val)[0]]
    return list(np.frombuffer(val, "<f4"))


@dataclasses.dataclass
class OnnxTensor:
    name: str
    dims: Tuple[int, ...]
    data: np.ndarray


@dataclasses.dataclass
class OnnxAttr:
    name: str
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    floats: List[float] = dataclasses.field(default_factory=list)
    ints: List[int] = dataclasses.field(default_factory=list)
    t: Optional[OnnxTensor] = None

    @property
    def value(self):
        for v in (self.i, self.f, self.s, self.t):
            if v is not None:
                return v
        return self.ints or self.floats


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, OnnxAttr]

    def attr(self, name, default=None):
        a = self.attrs.get(name)
        return a.value if a is not None else default


@dataclasses.dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, OnnxTensor]
    inputs: List[Tuple[str, Tuple[Optional[int], ...]]]
    outputs: List[str]
    name: str = "onnx_model"


# ONNX TensorProto.DataType
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
            10: np.float16, 11: np.float64}


def _parse_tensor(buf: bytes) -> OnnxTensor:
    dims: List[int] = []
    dtype = np.float32
    raw = b""
    float_data: List[float] = []
    int64_data: List[int] = []
    int32_data: List[int] = []
    name = ""
    for field, wt, val in _fields(buf):
        if field == 1:
            dims.extend(_packed_ints(val, wt))
        elif field == 2:
            dtype = _DTYPES.get(val, np.float32)
        elif field == 4:
            float_data.extend(_packed_floats(val, wt))
        elif field == 5:
            int32_data.extend(_packed_ints(val, wt))
        elif field == 7:
            int64_data.extend(_packed_ints(val, wt))
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
    if raw:
        data = np.frombuffer(raw, dtype=dtype).copy()
    elif float_data:
        data = np.asarray(float_data, np.float32)
    elif int64_data:
        data = np.asarray(int64_data, np.int64)
    elif int32_data:
        data = np.asarray(int32_data, np.int32)
    else:
        data = np.zeros(0, dtype)
    if dims:
        data = data.reshape(dims)
    return OnnxTensor(name, tuple(dims), data)


def _parse_attr(buf: bytes) -> OnnxAttr:
    a = OnnxAttr(name="")
    for field, wt, val in _fields(buf):
        if field == 1:
            a.name = val.decode()
        elif field == 2:
            a.f = struct.unpack("<f", val)[0]
        elif field == 3:
            a.i = _zigzag_ok_int(val)
        elif field == 4:
            a.s = val
        elif field == 5:
            a.t = _parse_tensor(val)
        elif field == 6:
            a.floats.extend(_packed_floats(val, wt))
        elif field == 8:
            a.ints.extend(_packed_ints(val, wt))
    return a


def _parse_node(buf: bytes) -> OnnxNode:
    inputs, outputs, attrs = [], [], {}
    name = op_type = ""
    for field, wt, val in _fields(buf):
        if field == 1:
            inputs.append(val.decode())
        elif field == 2:
            outputs.append(val.decode())
        elif field == 3:
            name = val.decode()
        elif field == 4:
            op_type = val.decode()
        elif field == 5:
            a = _parse_attr(val)
            attrs[a.name] = a
    return OnnxNode(op_type, name or (outputs[0] if outputs else ""), inputs,
                    outputs, attrs)


def _parse_value_info(buf: bytes) -> Tuple[str, Tuple[Optional[int], ...]]:
    name = ""
    shape: List[Optional[int]] = []
    for field, wt, val in _fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:  # TypeProto
            for f2, _, v2 in _fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 2:  # shape
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:  # dim
                                    dim_val: Optional[int] = None
                                    for f5, _, v5 in _fields(v4):
                                        if f5 == 1:
                                            dim_val = v5
                                    shape.append(dim_val)
    return name, tuple(shape)


def _parse_graph(buf: bytes) -> OnnxGraph:
    nodes: List[OnnxNode] = []
    inits: Dict[str, OnnxTensor] = {}
    inputs = []
    outputs = []
    name = "onnx_model"
    for field, wt, val in _fields(buf):
        if field == 1:
            nodes.append(_parse_node(val))
        elif field == 2:
            name = val.decode()
        elif field == 5:
            t = _parse_tensor(val)
            inits[t.name] = t
        elif field == 11:
            inputs.append(_parse_value_info(val))
        elif field == 12:
            n, _ = _parse_value_info(val)
            outputs.append(n)
    return OnnxGraph(nodes, inits, inputs, outputs, name)


def parse_onnx(data: bytes) -> OnnxGraph:
    """Parse ModelProto bytes -> OnnxGraph."""
    for field, wt, val in _fields(data):
        if field == 7:  # ModelProto.graph
            return _parse_graph(val)
    raise ValueError("no GraphProto found; not an ONNX ModelProto?")


def load_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        return parse_onnx(f.read())
