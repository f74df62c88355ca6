"""A small msgpack codec for the files `flax.serialization` writes.

The JAX package saves its variables tree as `flax.serialization.to_bytes`
of nested dicts with array leaves (`.ckpt`, deeplabv3p_tpu/utils/
checkpoint.py). This module reads and writes that subset in pure Python, so
the port needs neither flax nor the `msgpack` package:

* maps, arrays, str, bin, ints, floats, nil and bools;
* ext type 1, an ndarray: the msgpack array `(shape, dtype name, C-order
  bytes)` (`flax.serialization._ndarray_to_bytes`);
* ext type 3, a numpy scalar, encoded as a 0-d ndarray.

Arrays decode to numpy arrays, except `bfloat16`, which numpy lacks: those
decode to `torch.bfloat16` tensors (never widened to f32 here) and encode
back under the same dtype name. Anything outside the subset raises
`MsgpackError`: other ext types, flax's chunked form of arrays over 2^30
bytes, a truncated or over-long input.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
# flax's marker of an array split into chunks (flax.serialization._chunk)
CHUNKED_KEY = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """The bytes are not msgpack of the subset this module reads."""


# -- decoding ---------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError(
                f"truncated: {n} bytes wanted at offset {self.pos} of {len(self.data)}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-size first bytes: (struct format of the length or value, kind)
_SIZED = {
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xCA: (">f", "value"), 0xCB: (">d", "value"),
    0xCC: (">B", "value"), 0xCD: (">H", "value"), 0xCE: (">I", "value"),
    0xCF: (">Q", "value"), 0xD0: (">b", "value"), 0xD1: (">h", "value"),
    0xD2: (">i", "value"), 0xD3: (">q", "value"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _decode(r: _Reader, depth: int = 0) -> Any:
    if depth > 64:
        raise MsgpackError("nested deeper than 64 levels")
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _decode_map(r, b & 0x0F, depth)
    if 0x90 <= b <= 0x9F:
        return [_decode(r, depth + 1) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F))
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _decode_ext(code, bytes(r.take(_FIXEXT[b])))
    if b not in _SIZED:
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x} at offset {r.pos - 1}")
    fmt, kind = _SIZED[b]
    v = r.unpack(fmt)
    if kind == "value":
        return v
    if kind == "bin":
        return bytes(r.take(v))
    if kind == "str":
        return _str(r.take(v))
    if kind == "array":
        return [_decode(r, depth + 1) for _ in range(v)]
    if kind == "map":
        return _decode_map(r, v, depth)
    code = r.unpack(">b")  # ext
    return _decode_ext(code, bytes(r.take(v)))


def _str(raw: memoryview) -> str:
    try:
        return bytes(raw).decode("utf-8")
    except UnicodeDecodeError as e:
        raise MsgpackError(f"a str that is not UTF-8: {e}") from None


def _decode_map(r: _Reader, n: int, depth: int) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r, depth + 1)
        if isinstance(key, (dict, list)):
            raise MsgpackError(f"unhashable map key {type(key).__name__}")
        out[key] = _decode(r, depth + 1)
    if CHUNKED_KEY in out:
        raise MsgpackError(
            "an array split into chunks (flax writes arrays over 2^30 bytes so): "
            "not supported")
    return out


def _decode_ext(code: int, payload: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise MsgpackError(f"unsupported msgpack ext type {code}")
    arr = _decode_ndarray(payload)
    if code == EXT_NPSCALAR:
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    return arr


def _decode_ndarray(payload: bytes):
    fields = unpackb(payload)
    if not (isinstance(fields, list) and len(fields) == 3):
        raise MsgpackError("an ndarray ext that is not (shape, dtype, bytes)")
    shape, name, buf = fields
    if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)):
        raise MsgpackError(f"an ndarray ext with shape {shape!r}")
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if not isinstance(name, str) or not isinstance(buf, bytes):
        raise MsgpackError("an ndarray ext whose dtype or data has the wrong type")
    if name == "bfloat16":
        count = int(np.prod(shape, dtype=np.int64))
        if len(buf) != 2 * count:
            raise MsgpackError(f"bfloat16 {shape}: {len(buf)} bytes")
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise MsgpackError(f"unknown dtype {name!r}") from None
    if dtype.hasobject or dtype.fields is not None:
        raise MsgpackError(f"unsupported dtype {name!r}")
    if len(buf) != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
        raise MsgpackError(f"{name} {shape}: {len(buf)} bytes")
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills `data` exactly."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} bytes left over after the object")
    return out


# -- encoding ---------------------------------------------------------------


def _head(out: bytearray, n: int, fix: int | None, fix_max: int, codes) -> None:
    """The type byte and length of a str/bin/array/map of n entries."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise MsgpackError(f"{n} entries: too many for msgpack")


def _encode_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise MsgpackError(f"int {v} does not fit 64 bits")
    else:
        for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15), (0xD2, ">i", 31),
                                (0xD3, ">q", 63)):
            if v >= -(1 << bits):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise MsgpackError(f"int {v} does not fit 64 bits")


def _encode_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fix is not None:
        out.append(fix)
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _ndarray_payload(x) -> bytes:
    """`(shape, dtype name, C-order bytes)` as flax's `_ndarray_to_bytes`."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name = list(t.shape), "bfloat16"
            data = t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, data = list(a.shape), a.dtype.name, a.tobytes("C")
    else:
        a = np.asarray(x)
        if a.dtype.hasobject or a.dtype.fields is not None:
            raise MsgpackError(f"unsupported dtype {a.dtype}")
        shape, name, data = list(a.shape), a.dtype.name, a.tobytes("C")
    return packb([shape, name, data])


def _encode(out: bytearray, x: Any, depth: int = 0) -> None:
    if depth > 64:
        raise MsgpackError("nested deeper than 64 levels")
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        _encode_int(out, x)
    elif isinstance(x, float):
        out += struct.pack(">Bd", 0xCB, x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _head(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(x, (bytes, bytearray)):
        _head(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _encode(out, k, depth + 1)
            _encode(out, v, depth + 1)
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _encode(out, v, depth + 1)
    elif isinstance(x, np.generic):
        _encode_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _encode_ext(out, EXT_NDARRAY, _ndarray_payload(x))
    else:
        raise MsgpackError(f"cannot encode {type(x).__name__}")


def packb(x: Any) -> bytes:
    """Encode `x` (dicts, lists, str, bytes, ints, floats, None, bools,
    numpy arrays and scalars, torch tensors) as flax's `msgpack_serialize`
    does, array leaves as ext type 1 and numpy scalars as ext type 3."""
    out = bytearray()
    _encode(out, x)
    return bytes(out)
