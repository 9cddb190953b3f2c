"""Flax's msgpack format, read and written without msgpack, flax or jax.

The JAX package writes its model files, training checkpoints and session
checkpoints with ``flax.serialization.to_bytes``: msgpack of the object's
state dict (a tuple or a NamedTuple is a map keyed by its indices or field
names), with three extension types:

* ext 1, an array: msgpack of ``(shape, dtype name, C-order bytes)``;
* ext 2, a Python complex: msgpack of ``(real, imag)``;
* ext 3, a numpy scalar: an ext 1 payload of its 0-d array.

:func:`loads` reads the subset of msgpack that this emits (nil, bool,
ints, floats, str, bin, array, map and those extensions) into nested dicts
and lists of numpy arrays; ``bfloat16`` has no numpy dtype, so such a leaf
is read as ``uint16`` and viewed as a ``torch.bfloat16`` tensor. Arrays
over 2**30 bytes, which flax splits into ``__msgpack_chunked_array__``
maps, are refused. :func:`dumps` is the inverse, byte for byte what
``flax.serialization.msgpack_serialize`` writes for the same tree (tuples
and lists as arrays, as flax's inner encoding; a state dict holds none).

Malformed input raises ``ValueError``; nothing is guessed.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["loads", "dumps"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------- #
# reading


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str leaves as bytes (flax's inner array encoding)

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at offset {self.pos} of {len(self.data)}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self) -> Any:
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map_(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self.str_(tag & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if tag in scalars:
            return self.unpack(scalars[tag])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if tag in fixext:
            return self.ext(fixext[tag])
        if tag not in sized:
            raise ValueError(f"unsupported msgpack type byte 0x{tag:02x} at offset {self.pos - 1}")
        n = self.unpack(sized[tag])
        if tag <= 0xC6:
            return bytes(self.take(n))
        if tag <= 0xC9:
            return self.ext(n)
        if tag <= 0xDB:
            return self.str_(n)
        return self.array(n) if tag <= 0xDD else self.map_(n)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _array_from(payload)
        if code == _EXT_NPSCALAR:
            arr = _array_from(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _whole(payload, raw=False)
            return complex(real, imag)
        raise ValueError(f"unsupported msgpack extension type {code}")


def _whole(data: bytes, raw: bool):
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the msgpack value")
    return out


def _array_from(payload: bytes):
    """An ext 1 payload -> a numpy array (a torch.bfloat16 tensor for
    ``bfloat16``)."""
    parts = _whole(payload, raw=True)
    if not (isinstance(parts, list) and len(parts) == 3 and isinstance(parts[1], bytes)
            and isinstance(parts[2], bytes)):
        raise ValueError("malformed array extension: want (shape, dtype name, bytes)")
    shape, name, buffer = tuple(parts[0]), parts[1].decode("ascii"), parts[2]
    dtype = np.dtype(np.uint16 if name == "bfloat16" else name)
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != len(buffer):
        raise ValueError(f"array of {shape} {name} needs {count * dtype.itemsize} bytes; has {len(buffer)}")
    arr = np.frombuffer(bytearray(buffer), dtype=dtype).reshape(shape)  # writable
    return torch.from_numpy(arr).view(torch.bfloat16) if name == "bfloat16" else arr


def _refuse_chunked(tree, path: str = "") -> None:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError(f"{path or 'the tree'}: a chunked array (over 2**30 bytes) is not read")
        for key, value in tree.items():
            _refuse_chunked(value, f"{path}/{key}")


def loads(data: bytes):
    """Flax msgpack bytes -> the state dict they hold: nested dicts (str
    keys) and lists of numpy arrays, numpy scalars, Python scalars and
    ``torch.bfloat16`` tensors. Raises ``ValueError`` on anything else."""
    tree = _whole(bytes(data), raw=False)
    _refuse_chunked(tree)
    return tree


# --------------------------------------------------------------------- #
# writing


def _head(small: Tuple[int, int], widths, n: int, what: str) -> bytes:
    """A msgpack length header: the fix form ``small`` = (base, limit) or
    the first of ``widths`` ((tag, struct format, limit)) that holds n."""
    base, limit = small
    if n < limit:
        return bytes([base | n])
    for tag, fmt, top in widths:
        if n <= top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"{what} of {n} is too long for msgpack")


_U8, _U16, _U32 = 0xFF, 0xFFFF, 0xFFFFFFFF


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -0x20 <= v < 0:
        return struct.pack(">b", v)
    for lo, hi, tag, fmt in ((-0x80, 0, 0xD0, ">b"), (0x80, _U8, 0xCC, ">B"),
                             (-0x8000, 0, 0xD1, ">h"), (0x100, _U16, 0xCD, ">H"),
                             (-0x80000000, 0, 0xD2, ">i"), (0x10000, _U32, 0xCE, ">I"),
                             (-(2**63), 0, 0xD3, ">q"), (2**32, 2**64 - 1, 0xCF, ">Q")):
        if lo <= v <= hi:
            return bytes([tag]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} is out of msgpack's range")


def _ext(code: int, payload: bytes) -> bytes:
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fix:
        head = bytes([fix[n]])
    else:
        head = _head((0, 0), ((0xC7, ">B", _U8), (0xC8, ">H", _U16), (0xC9, ">I", _U32)), n, "extension")
    return head + struct.pack(">b", code) + payload


def _array_payload(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.bfloat16:
            raise TypeError(f"only bfloat16 tensors are written as tensors; got {arr.dtype}")
        shape, name = tuple(arr.shape), "bfloat16"
        data = arr.detach().cpu().contiguous().view(torch.uint16).numpy().tobytes("C")
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise TypeError("object and structured dtypes are not written")
        shape, name, data = arr.shape, arr.dtype.name, arr.tobytes("C")
    return _pack((list(shape), name, data))


def _pack(v) -> bytes:
    if v is None:
        return b"\xc0"
    if v is True or v is False:
        return b"\xc3" if v else b"\xc2"
    if isinstance(v, np.ndarray) or isinstance(v, torch.Tensor):
        return _ext(_EXT_NDARRAY, _array_payload(v))
    if isinstance(v, np.generic):
        return _ext(_EXT_NPSCALAR, _array_payload(np.asarray(v)))
    if type(v) is int:
        return _int(v)
    if type(v) is float:
        return b"\xcb" + struct.pack(">d", v)
    if type(v) is complex:
        return _ext(_EXT_COMPLEX, _pack((v.real, v.imag)))
    if type(v) is str:
        b = v.encode("utf-8")
        return _head((0xA0, 32), ((0xD9, ">B", _U8), (0xDA, ">H", _U16), (0xDB, ">I", _U32)),
                     len(b), "string") + b
    if type(v) is bytes:
        return _head((0, 0), ((0xC4, ">B", _U8), (0xC5, ">H", _U16), (0xC6, ">I", _U32)),
                     len(v), "bytes") + v
    if type(v) in (list, tuple):
        return _head((0x90, 16), ((0xDC, ">H", _U16), (0xDD, ">I", _U32)), len(v), "array") + b"".join(
            _pack(x) for x in v)
    if type(v) is dict:
        return _head((0x80, 16), ((0xDE, ">H", _U16), (0xDF, ">I", _U32)), len(v), "map") + b"".join(
            _pack(k) + _pack(x) for k, x in v.items())
    raise TypeError(f"cannot write {type(v).__name__} in flax's msgpack format")


def dumps(tree) -> bytes:
    """A state dict (nested dicts of arrays, numpy scalars, ``torch.bfloat16``
    tensors and Python scalars) -> the bytes ``msgpack_serialize`` writes
    for it."""
    return _pack(tree)
