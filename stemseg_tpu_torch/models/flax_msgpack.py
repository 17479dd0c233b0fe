"""A reader of flax's msgpack serialisation, the format of the JAX package's
``.ckpt`` checkpoints (``flax.serialization.msgpack_serialize``), that needs
neither flax nor the msgpack package.

``msgpack_restore`` returns what flax's ``msgpack_restore`` returns: dicts,
lists, Python scalars and arrays. It decodes the msgpack types flax writes
(map, array, str, bin, int, float, bool, nil) and flax's three ext types:

* 1, an ndarray, as the msgpack array ``(shape, dtype name, C-order bytes)``:
  a read-only numpy array; ``bfloat16``, which numpy does not have, is read
  through a ``uint16`` view into a ``torch.bfloat16`` tensor;
* 3, a numpy scalar in the same encoding: the 0-d array's item;
* 2, a Python complex, as ``(real, imag)``.

Arrays that flax split into chunks (``__msgpack_chunked_array__``, leaves of
more than 1 GiB) are joined again, where flax joins them: as values of maps.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# fixed-width header bytes: (kind, struct format of the value or length)
_FIXED = {
    0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
    0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
    0xca: ("value", ">f"), 0xcb: ("value", ">d"),
    0xcc: ("value", ">B"), 0xcd: ("value", ">H"), 0xce: ("value", ">I"), 0xcf: ("value", ">Q"),
    0xd0: ("value", ">b"), 0xd1: ("value", ">h"), 0xd2: ("value", ">i"), 0xd3: ("value", ">q"),
    0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
    0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
    0xde: ("map", ">H"), 0xdf: ("map", ">I"),
}
_FIXEXT_SIZES = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_CONSTANTS = {0xc0: None, 0xc2: False, 0xc3: True}


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self.map(b & 0x0f)
        if b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _FIXEXT_SIZES:
            code = self.unpack(">b")
            return _ext(code, self.take(_FIXEXT_SIZES[b]))
        if b not in _FIXED:
            raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no msgpack object")
        kind, fmt = _FIXED[b]
        n = self.unpack(fmt)
        if kind == "value":
            return n
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _ndarray(data: memoryview):
    reader = _Reader(data)
    if reader.take(1)[0] != 0x93:  # a fixarray of 3
        raise ValueError("flax ndarray: not a (shape, dtype, bytes) triple")
    shape = reader.read()
    name = reader.read()
    kind, fmt = _FIXED.get(reader.take(1)[0], (None, None))
    if kind != "bin":
        raise ValueError("flax ndarray: the buffer is not a msgpack bin")
    buf = reader.take(reader.unpack(fmt))
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
    if code == EXT_COMPLEX:
        real, imag = _Reader(data).read()
        return complex(real, imag)
    raise ValueError(f"msgpack ext type {code} is none of flax's (ndarray 1, complex 2, "
                     "numpy scalar 3)")


def _unchunk(d: Dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if torch.is_tensor(chunks[0]):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_in_place(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = _unchunk_in_place(v)
    return tree


def msgpack_restore(data: bytes):
    """The tree that ``flax.serialization.msgpack_restore(data)`` returns."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return _unchunk_in_place(tree)


def read_msgpack_file(path: str):
    with open(path, "rb") as fh:
        return msgpack_restore(fh.read())
