"""A minimal FlatBuffers codec (the counterpart of `export/protowire.py` for
the FlatBuffers files TFLite reads and writes). No `flatbuffers` package is
needed: a deployment box need not have one.

`Builder` writes back to front, as FlatBuffers' own builder does, so every
object is written before the objects that point at it and every offset
points forward: strings, vectors of scalars and of offsets, and tables with
their vtables (identical vtables are shared). Each scalar is aligned to its
size, a vector's elements to theirs (or to a larger `align`: the TFLite
schema asks 16 for a `Buffer`'s data, which its CPU kernels read in place),
and `finish` pads the whole to its largest alignment, then writes the root
offset and the 4-byte file identifier after it.

`Table(buf, pos)` reads the same: scalars at their default when absent,
strings, sub-tables, vectors of scalars (as numpy arrays) and of tables.
`root(buf, identifier)` checks the identifier and returns the root table.
Every read is bounds-checked: bytes that are not such a buffer raise
`FlatBufferError`.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

# a scalar kind -> its struct format (little-endian)
SCALARS = {"bool": "?", "int8": "b", "uint8": "B", "int16": "h", "uint16": "H",
           "int32": "i", "uint32": "I", "int64": "q", "uint64": "Q", "float32": "f",
           "float64": "d"}
_NP = {"bool": np.bool_, "int8": np.int8, "uint8": np.uint8, "int16": np.int16,
       "uint16": np.uint16, "int32": np.int32, "uint32": np.uint32, "int64": np.int64,
       "uint64": np.uint64, "float32": np.float32, "float64": np.float64}


class FlatBufferError(ValueError):
    """The bytes are not a FlatBuffer of the schema the reader reads."""


class Builder:
    """A FlatBuffer written back to front; an object's handle is its offset
    from the end of the buffer, which stays fixed while the buffer grows."""

    def __init__(self, size: int = 1 << 16):
        self.buf = bytearray(size)
        self.head = size
        self.minalign = 1
        self.fields: Optional[list] = None  # slot -> handle, while a table is open
        self.table_start = 0
        self.vtables: dict[bytes, int] = {}

    def offset(self) -> int:
        return len(self.buf) - self.head

    def _room(self, n: int) -> None:
        while self.head < n:
            old = len(self.buf)
            grown = bytearray(2 * old)
            grown[old:] = self.buf
            self.buf, self.head = grown, self.head + old

    def prep(self, size: int, additional: int = 0) -> None:
        """Pad so that `size` bytes written after `additional` more are
        aligned to `size`."""
        self.minalign = max(self.minalign, size)
        pad = -(self.offset() + additional) % size
        self._room(pad)
        self.head -= pad  # the buffer is zero where nothing was written

    def _put(self, fmt: str, value) -> None:
        self._room(struct.calcsize(fmt))
        self.head -= struct.calcsize(fmt)
        struct.pack_into("<" + fmt, self.buf, self.head, value)

    def _write(self, data: bytes) -> None:
        self._room(len(data))
        self.head -= len(data)
        self.buf[self.head:self.head + len(data)] = data

    def scalar(self, kind: str, value) -> int:
        fmt = SCALARS[kind]
        self.prep(struct.calcsize(fmt))
        self._put(fmt, value)
        return self.offset()

    def uoffset(self, handle: int) -> int:
        """A forward offset to the object `handle`, written here."""
        self.prep(4)
        self._put("I", self.offset() + 4 - handle)
        return self.offset()

    def string(self, text: str) -> int:
        data = text.encode()
        self.prep(4, len(data) + 1)
        self._write(data + b"\0")
        self._put("I", len(data))
        return self.offset()

    def scalars(self, kind: str, values, align: int = 1) -> int:
        """A vector of scalars, its elements aligned to `align` (or their size)."""
        data = np.ascontiguousarray(values, _NP[kind]).astype(
            np.dtype(_NP[kind]).newbyteorder("<"), copy=False).tobytes()
        n = len(data) // np.dtype(_NP[kind]).itemsize
        self.prep(4, len(data))
        self.prep(max(align, np.dtype(_NP[kind]).itemsize), len(data))
        self._write(data)
        self._put("I", n)
        return self.offset()

    def offsets(self, handles) -> int:
        """A vector of offsets to the objects `handles`, in their order."""
        handles = list(handles)
        self.prep(4, 4 * len(handles))
        for h in reversed(handles):
            self.uoffset(h)
        self._put("I", len(handles))
        return self.offset()

    def start(self, num_fields: int) -> None:
        if self.fields is not None:
            raise RuntimeError("a table is open: write its children before it")
        self.fields = [0] * num_fields
        self.prep(4)  # tables of one layout then have one size, and share a vtable
        self.table_start = self.offset()

    def add(self, slot: int, kind: str, value) -> None:
        """A scalar field (the caller leaves out a default)."""
        self.fields[slot] = self.scalar(kind, value)

    def add_offset(self, slot: int, handle: int) -> None:
        self.fields[slot] = self.uoffset(handle)

    def end(self) -> int:
        """Close the table: its soffset to the vtable, the vtable shared with
        an identical earlier one or written just before the table."""
        self.prep(4)
        self._put("i", 0)
        table = self.offset()
        rel = [table - f if f else 0 for f in self.fields]
        while rel and not rel[-1]:
            rel.pop()
        vtable = struct.pack(f"<{2 + len(rel)}H", 4 + 2 * len(rel), table - self.table_start,
                             *rel)
        at = self.vtables.get(vtable)
        if at is None:
            self._write(vtable)
            at = self.vtables[vtable] = self.offset()
        # table position minus vtable position, both counted from the end
        struct.pack_into("<i", self.buf, len(self.buf) - table, at - table)
        self.fields = None
        return table

    def finish(self, root: int, identifier: bytes) -> bytes:
        if len(identifier) != 4:
            raise ValueError(f"a file identifier is 4 bytes, not {identifier!r}")
        self.prep(max(self.minalign, 4), 8)
        self._write(identifier)
        self.uoffset(root)
        return bytes(self.buf[self.head:])


class Table:
    """A table of a FlatBuffer at `pos`; slots count from 0."""

    __slots__ = ("buf", "pos", "vtable", "vsize")

    def __init__(self, buf, pos: int):
        self.buf = buf if isinstance(buf, memoryview) else memoryview(buf)
        self.pos = pos
        vt = pos - _unpack(self.buf, "i", pos)
        self.vsize = _unpack(self.buf, "H", vt)
        if self.vsize < 4 or self.vsize % 2:
            raise FlatBufferError(f"a vtable of {self.vsize} bytes at offset {vt}")
        _check(self.buf, vt, self.vsize)
        self.vtable = vt

    def _field(self, slot: int) -> int:
        """The field's position, or 0 when absent."""
        at = 4 + 2 * slot
        if at >= self.vsize:
            return 0
        rel = _unpack(self.buf, "H", self.vtable + at)
        return self.pos + rel if rel else 0

    def has(self, slot: int) -> bool:
        return bool(self._field(slot))

    def scalar(self, slot: int, kind: str, default=0):
        p = self._field(slot)
        return _unpack(self.buf, SCALARS[kind], p) if p else default

    def _deref(self, slot: int) -> int:
        p = self._field(slot)
        return p + _unpack(self.buf, "I", p) if p else 0

    def table(self, slot: int) -> Optional["Table"]:
        p = self._deref(slot)
        return Table(self.buf, p) if p else None

    def string(self, slot: int) -> Optional[str]:
        p = self._deref(slot)
        if not p:
            return None
        n = _unpack(self.buf, "I", p)
        _check(self.buf, p + 4, n)
        try:
            return bytes(self.buf[p + 4:p + 4 + n]).decode()
        except UnicodeDecodeError as e:
            raise FlatBufferError(f"a string at offset {p} is not UTF-8") from e

    def scalars(self, slot: int, kind: str) -> Optional[np.ndarray]:
        """A vector of scalars as a numpy array (a copy), None when absent."""
        p = self._deref(slot)
        if not p:
            return None
        n = _unpack(self.buf, "I", p)
        dtype = np.dtype(_NP[kind]).newbyteorder("<")
        _check(self.buf, p + 4, n * dtype.itemsize)
        return np.frombuffer(self.buf, dtype, n, p + 4).astype(_NP[kind])

    def tables(self, slot: int) -> list["Table"]:
        p = self._deref(slot)
        if not p:
            return []
        n = _unpack(self.buf, "I", p)
        _check(self.buf, p + 4, 4 * n)
        return [Table(self.buf, q + _unpack(self.buf, "I", q))
                for q in range(p + 4, p + 4 + 4 * n, 4)]


def _check(buf: memoryview, pos: int, n: int) -> None:
    if pos < 0 or n < 0 or pos + n > len(buf):
        raise FlatBufferError(f"{n} bytes at offset {pos} run past the buffer's {len(buf)}")


def _unpack(buf: memoryview, fmt: str, pos: int):
    _check(buf, pos, struct.calcsize(fmt))
    return struct.unpack_from("<" + fmt, buf, pos)[0]


def root(buf, identifier: Optional[bytes] = None) -> Table:
    """The root table of `buf`; raises unless its file identifier is
    `identifier` (when given)."""
    buf = memoryview(buf)
    if buf.ndim != 1 or buf.itemsize != 1:
        buf = buf.cast("B")
    if identifier is not None:
        _check(buf, 4, 4)
        if bytes(buf[4:8]) != identifier:
            raise FlatBufferError(f"file identifier {bytes(buf[4:8])!r}, not {identifier!r}")
    return Table(buf, _unpack(buf, "I", 0))
