"""A reader and a writer of flax's msgpack checkpoints, in plain Python
and numpy.

``flax.serialization.to_bytes`` writes a variables tree as msgpack: maps of
strings, and each array as extension type 1 holding a packed
(shape, dtype name, C-order bytes) triple. This module decodes that
format without ``msgpack`` or ``flax``: maps, arrays, strings, bin, ints,
floats, nil, bool, ext 8/16/32 and fixext; extension 1 (ndarray), 2
(complex) and 3 (numpy scalar) as flax does, and flax's chunked form of
oversized arrays. Any other extension comes back as (code, bytes).
:func:`packb` and :func:`save_variables` write the same format, as
``msgpack.packb(..., use_bin_type=True)`` under flax's hooks encodes it.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
_MAX_CHUNK_BYTES = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack data ends at byte {len(self.data)}, "
                             f"{n} more bytes wanted at {self.pos}")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def string(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        return _decode_ext(code, self.take(n))

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}  # bin 8/16/32
        if b in sized:
            return self.take(self.unpack(sized[b]))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self.ext(self.unpack({0xC7: "B", 0xC8: "H", 0xC9: "I"}[b]))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.string(self.unpack({0xD9: "B", 0xDA: "H", 0xDB: "I"}[b]))
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.read() for _ in range(self.unpack("H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack object")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape, order="C")


def _decode_ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    return (code, data)


def unpackb(data: bytes):
    """One msgpack object → Python (dicts, lists, str, bytes, int, float,
    None, bool, numpy arrays and scalars, complex). Trailing bytes raise."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out


def _unchunk(tree):
    """flax's chunked form of oversized arrays back into arrays."""
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """``flax.serialization.msgpack_restore``: a serialized state dict →
    nested dicts of numpy arrays."""
    return _unchunk(unpackb(data))


def load_variables(path) -> dict:
    """The variables tree of a flax checkpoint file (``to_bytes``); raises
    ``FileNotFoundError`` naming the path where there is none."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no flax checkpoint at {path}")
    return msgpack_restore(path.read_bytes())


# -- writing -----------------------------------------------------------------


def _sized(out: bytearray, n: int, small: tuple | None, wide: tuple) -> None:
    """A msgpack header: the fix form ``small`` = (first byte, limit) where
    n fits, else the first of ``wide``'s (byte, struct code) that holds n."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
        return
    for byte, code in wide:
        if n < 1 << (8 * struct.calcsize(code)):
            out.append(byte)
            out += struct.pack(">" + code, n)
            return
    raise ValueError(f"msgpack cannot hold a length of {n}")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")) if v >= 0 else (
        (0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q"))
    for byte, code in forms:
        try:
            packed = struct.pack(">" + code, v)
        except struct.error:
            continue
        out.append(byte)
        out += packed
        return
    raise ValueError(f"msgpack cannot hold the integer {v}")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _sized(out, len(data), None, ((0xC7, "B"), (0xC8, "H"), (0xC9, "I")))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no flax encoding")
    return packb((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _sized(out, len(raw), (0xA0, 32), ((0xD9, "B"), (0xDA, "H"), (0xDB, "I")))
        out += raw
    elif type(obj) in (bytes, bytearray, memoryview):
        raw = bytes(obj)
        _sized(out, len(raw), None, ((0xC4, "B"), (0xC5, "H"), (0xC6, "I")))
        out += raw
    elif type(obj) in (list, tuple):
        _sized(out, len(obj), (0x90, 16), ((0xDC, "H"), (0xDD, "I")))
        for v in obj:
            _pack(out, v)
    elif type(obj) is dict:
        _sized(out, len(obj), (0x80, 16), ((0xDE, "H"), (0xDF, "I")))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif type(obj) is complex:
        _pack_ext(out, _EXT_COMPLEX, packb((obj.real, obj.imag)))
    else:
        raise TypeError(f"no msgpack encoding for {type(obj).__name__}")


def packb(obj) -> bytes:
    """Python (dicts, lists, tuples, str, bytes, int, float, None, bool,
    numpy arrays and scalars, complex) → msgpack bytes, with flax's
    extensions for arrays, numpy scalars and complex numbers."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _chunked(tree):
    """flax's chunked form of arrays above 1 GiB (``_chunk_array_leaves``)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, np.ndarray) and v.size * v.dtype.itemsize > _MAX_CHUNK_BYTES:
            flat, n = v.reshape(-1), max(1, _MAX_CHUNK_BYTES // v.dtype.itemsize)
            chunks = [flat[i:i + n] for i in range(0, flat.size, n)]
            v = {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(v.shape)},
                 "chunks": {str(i): c for i, c in enumerate(chunks)}}
        out[str(k)] = _chunked(v)
    return out


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize``: nested dicts of numpy
    arrays → bytes that :func:`msgpack_restore` and flax read back."""
    return packb(_chunked(tree))


def save_variables(path, variables: dict) -> Path:
    """Write a variables tree (nested dicts of numpy arrays, as
    ``convert.midas_small_to_flax`` returns them) as flax's ``to_bytes``
    does, creating the parent directory; returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(variables))
    return path
