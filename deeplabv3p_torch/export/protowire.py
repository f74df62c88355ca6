"""A protobuf wire codec for dataclass messages, shared by the port's ONNX
messages (`export/onnx/proto.py`) and TensorFlow GraphDef messages
(`export/tf/graph_pb.py`). No `protobuf` package is needed: a deployment box
need not have one.

A message is a dataclass deriving from `Message` whose `_FIELDS` holds
(number, name, kind, label): kind a scalar kind (`_WIRE`) or a message
class, label 'one' (a proto3 scalar), 'opt' (a singular message or a oneof
member: None when unset), 'rep' or 'map'. A map field's kind is a (key kind,
value kind) pair, and its value a dict. `_ONEOF` lists groups of fields of
one oneof.

`encode()` writes the fields in the order of their numbers, as protobuf's
own serializer does: proto3 scalars at their default are left out, repeated
numbers are packed, singular messages and oneof members are written when set
(`None` is unset), and a map's entries go out in the order of their keys
(protobuf's deterministic order), each with its key and value. `decode(data)`
reads repeated numbers packed and unpacked alike, merges a singular message
that occurs twice, skips the fields it does not know and raises
`DecodeError` on input that is not a message of the schema (a truncated
field, a wire type that does not fit the field).
"""

from __future__ import annotations

import struct

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
# field kind -> wire type of one element
_WIRE = {"int64": _VARINT, "int32": _VARINT, "uint64": _VARINT, "enum": _VARINT,
         "bool": _VARINT, "float": _I32, "double": _I64, "string": _LEN, "bytes": _LEN}
_PACKED = ("int64", "int32", "uint64", "enum", "bool", "float", "double")
_FIXED = {"float": "f", "double": "d"}


class DecodeError(ValueError):
    """The bytes are not a message of the schema the decoding class reads."""


# -- the wire format ----------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:  # int32 and int64 go out as 64-bit two's complement
        n += 1 << 64
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(buf: memoryview, pos: int, end: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= end:
            raise DecodeError(f"truncated varint at offset {pos}")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError(f"varint over 10 bytes at offset {pos}")


def _signed(kind: str, n: int):
    if kind == "uint64":
        return n
    if kind == "bool":
        return n != 0
    n &= (1 << 64) - 1
    if n >= 1 << 63:
        n -= 1 << 64
    if kind in ("int32", "enum"):  # a 64-bit varint whose low 32 bits hold the value
        n = (n + (1 << 31)) % (1 << 32) - (1 << 31)
    return n


def _take(buf: memoryview, pos: int, end: int, n: int) -> tuple[int, int]:
    if pos + n > end:
        raise DecodeError(f"truncated field: {n} bytes wanted at offset {pos}, {end - pos} left")
    return pos, pos + n


def _skip(buf: memoryview, pos: int, end: int, wire: int) -> int:
    if wire == _VARINT:
        return _read_varint(buf, pos, end)[1]
    if wire == _I64:
        return _take(buf, pos, end, 8)[1]
    if wire == _I32:
        return _take(buf, pos, end, 4)[1]
    if wire == _LEN:
        n, pos = _read_varint(buf, pos, end)
        return _take(buf, pos, end, n)[1]
    raise DecodeError(f"wire type {wire} at offset {pos} (groups are not read)")


def _is_default(kind: str, v) -> bool:
    if kind in _FIXED:  # by the bits, as protobuf: -0.0 is written
        return struct.pack("<" + _FIXED[kind], v) == bytes(struct.calcsize(_FIXED[kind]))
    return not v


def _scalar(kind: str, v) -> bytes:
    if kind in _FIXED:
        return struct.pack("<" + _FIXED[kind], v)
    if kind == "string":
        v = v.encode()
    if kind in ("string", "bytes"):
        return _varint(len(v)) + bytes(v)
    return _varint(int(v))


def _field(num: int, kind, value) -> bytes:
    """One field of a scalar or message `value`, tag included."""
    if isinstance(kind, str):
        return _varint(num << 3 | _WIRE[kind]) + _scalar(kind, value)
    body = value.encode()
    return _varint(num << 3 | _LEN) + _varint(len(body)) + body


def _read_value(kind: str, buf: memoryview, pos: int, end: int, owner: str):
    """One scalar of `kind` at `pos`: (value, position after it)."""
    if kind in _FIXED:
        size = struct.calcsize(_FIXED[kind])
        start, pos = _take(buf, pos, end, size)
        return struct.unpack_from("<" + _FIXED[kind], buf, start)[0], pos
    if kind in ("string", "bytes"):
        n, pos = _read_varint(buf, pos, end)
        start, pos = _take(buf, pos, end, n)
        value = bytes(buf[start:pos])
        if kind == "string":
            try:
                value = value.decode()
            except UnicodeDecodeError as e:
                raise DecodeError(f"{owner}: not UTF-8") from e
        return value, pos
    raw, pos = _read_varint(buf, pos, end)
    return _signed(kind, raw), pos


def _default(kind):
    if not isinstance(kind, str):
        return kind()
    return {"string": "", "bytes": b"", "float": 0.0, "double": 0.0, "bool": False}.get(kind, 0)


# -- messages -------------------------------------------------------------------


class Message:
    """Codec shared by the message dataclasses (see the module's text)."""

    _FIELDS: tuple = ()
    _ONEOF: tuple = ()

    def encode(self) -> bytes:
        out = []
        for num, name, kind, label in self._FIELDS:
            v = getattr(self, name)
            msg = not isinstance(kind, str)
            if label == "map":
                key_kind, value_kind = kind
                for key in sorted(v):
                    body = _field(1, key_kind, key) + _field(2, value_kind, v[key])
                    out.append(_varint(num << 3 | _LEN) + _varint(len(body)) + body)
                continue
            if label == "rep":
                if not v:
                    continue
                if kind in _PACKED:
                    if kind in _FIXED:
                        payload = struct.pack(f"<{len(v)}{_FIXED[kind]}", *v)
                    else:
                        payload = b"".join(_varint(int(x)) for x in v)
                    out.append(_varint(num << 3 | _LEN) + _varint(len(payload)) + payload)
                    continue
                tag = _varint(num << 3 | (_LEN if msg else _WIRE[kind]))
                for x in v:
                    body = x.encode() if msg else _scalar(kind, x)
                    out.append(tag + (_varint(len(body)) + body if msg else body))
                continue
            if v is None or (label == "one" and _is_default(kind, v)):
                continue
            out.append(_field(num, kind, v))
        return b"".join(out)

    @classmethod
    def decode(cls, data):
        buf = memoryview(data)
        if buf.ndim != 1 or buf.itemsize != 1:
            buf = buf.cast("B")
        return cls()._merge(buf, 0, len(buf))

    def _set(self, name: str, value) -> None:
        for group in self._ONEOF:
            if name in group:
                for other in group:
                    setattr(self, other, None)
        setattr(self, name, value)

    def _merge(self, buf: memoryview, pos: int, end: int):
        by_num = type(self)._by_num()
        owner = type(self).__name__
        while pos < end:
            key, pos = _read_varint(buf, pos, end)
            num, wire = key >> 3, key & 7
            spec = by_num.get(num)
            if spec is None:
                pos = _skip(buf, pos, end, wire)
                continue
            name, kind, label = spec
            if label == "map":
                if wire != _LEN:
                    raise DecodeError(f"{owner}.{name}: wire type {wire}, expected {_LEN}")
                n, pos = _read_varint(buf, pos, end)
                start, pos = _take(buf, pos, end, n)
                k, v = _read_entry(kind, buf, start, pos, f"{owner}.{name}")
                getattr(self, name)[k] = v
                continue
            msg = not isinstance(kind, str)
            if label == "rep" and kind in _PACKED and wire == _LEN:
                n, pos = _read_varint(buf, pos, end)
                start, pos = _take(buf, pos, end, n)
                getattr(self, name).extend(_unpack(kind, buf, start, pos))
                continue
            want = _LEN if msg else _WIRE[kind]
            if wire != want:
                raise DecodeError(f"{owner}.{name}: wire type {wire}, expected {want}")
            if msg:
                n, pos = _read_varint(buf, pos, end)
                start, pos = _take(buf, pos, end, n)
                held = None if label == "rep" else getattr(self, name)
                value = (held if held is not None else kind())._merge(buf, start, pos)
            else:
                value, pos = _read_value(kind, buf, pos, end, f"{owner}.{name}")
            if label == "rep":
                getattr(self, name).append(value)
            else:
                self._set(name, value)
        return self

    @classmethod
    def _by_num(cls) -> dict:
        cache = cls.__dict__.get("_by_num_cache")
        if cache is None:
            cache = {num: (name, kind, label) for num, name, kind, label in cls._FIELDS}
            cls._by_num_cache = cache
        return cache


def _read_entry(kinds, buf: memoryview, pos: int, end: int, owner: str):
    """A map entry's (key, value); a field it lacks is its default."""
    key_kind, value_kind = kinds
    key = value = None
    while pos < end:
        tag, pos = _read_varint(buf, pos, end)
        num, wire = tag >> 3, tag & 7
        if num not in (1, 2):
            pos = _skip(buf, pos, end, wire)
            continue
        kind = key_kind if num == 1 else value_kind
        msg = not isinstance(kind, str)
        want = _LEN if msg else _WIRE[kind]
        if wire != want:
            raise DecodeError(f"{owner}: entry field {num}: wire type {wire}, expected {want}")
        if msg:
            n, pos = _read_varint(buf, pos, end)
            start, pos = _take(buf, pos, end, n)
            got = (value if value is not None else kind())._merge(buf, start, pos)
        else:
            got, pos = _read_value(kind, buf, pos, end, owner)
        if num == 1:
            key = got
        else:
            value = got
    return (_default(key_kind) if key is None else key,
            _default(value_kind) if value is None else value)


def _unpack(kind: str, buf: memoryview, start: int, end: int) -> list:
    if kind in _FIXED:
        size = struct.calcsize(_FIXED[kind])
        if (end - start) % size:
            raise DecodeError(f"packed {kind}s: {end - start} bytes")
        return list(struct.unpack_from(f"<{(end - start) // size}{_FIXED[kind]}", buf, start))
    out, pos = [], start
    while pos < end:
        raw, pos = _read_varint(buf, pos, end)
        out.append(_signed(kind, raw))
    return out
