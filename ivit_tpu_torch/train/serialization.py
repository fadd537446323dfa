"""flax's msgpack checkpoint encoding, in plain Python (the subset
``flax.serialization.to_bytes`` / ``msgpack_restore`` write and read for a
trainer state; no ``msgpack`` package).

A state dict is a tree of str-keyed dicts whose leaves are numpy arrays,
numpy scalars or Python scalars (no complex numbers).  Maps, arrays,
strings, binaries, ints, floats (float64), bools and nil take msgpack's
smallest form, as
``msgpack.packb(use_bin_type=True)`` chooses it; an ndarray is ext type 1
holding the packed ``(shape, dtype name, C-order bytes)`` tuple, a numpy
scalar ext type 3 (the same tuple of its 0-d array), flax's ids.  A leaf
larger than ``MAX_CHUNK_SIZE`` bytes is written as flax chunks it: a dict
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
of flat pieces, which reading joins again.  Dict keys are written in the
dict's own order: the caller orders them as ``jax.device_get`` and flax's
``to_state_dict`` do (``train/checkpoint.py``).
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3          # flax's ids (2 is a native complex)
MAX_CHUNK_SIZE = 2**30


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: list):
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -0x20 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0x80 <= n <= 0xFF:
        out.append(struct.pack("BB", 0xCC, n))
    elif -0x80 <= n < 0:
        out.append(struct.pack(">Bb", 0xD0, n))
    elif 0xFF < n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, n))
    elif -0x8000 <= n < -0x80:
        out.append(struct.pack(">Bh", 0xD1, n))
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, n))
    elif -0x80000000 <= n < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, n))
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, n))
    elif -0x8000000000000000 <= n < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, n))
    else:
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: list):
    """A header for a str / bin / array / map of ``n`` entries: the fix form
    below ``fix_max`` (``fix`` set to None where there is none), else 8-,
    16- or 32-bit length (``codes``, None where a width is not used)."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack("BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack object of {n} entries is too large")


def _pack_ext(code: int, data: bytes, out: list):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("Bb", fixed[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax ``_ndarray_to_bytes``: the packed ``(shape, dtype name, bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name,
                  arr.tobytes("C")))


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif type(obj) is bytes:
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(obj)
    elif type(obj) in (list, tuple):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for x in obj:
            _pack(x, out)
    elif type(obj) is dict:
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` with flax's ext hook."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax ``_chunk``: flat pieces of at most ``MAX_CHUNK_SIZE`` bytes."""
    chunksize = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + chunksize] for i in range(0, flat.size, chunksize)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree):
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def to_bytes(state_dict) -> bytes:
    """flax ``msgpack_serialize`` of a state dict (the bytes
    ``serialization.to_bytes`` writes for the same tree)."""
    return packb(_chunk_leaves(state_dict))


# ---------------------------------------------------------------------------
# Unpacking
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED_EXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
          0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
          0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_NUMBERS = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _ext(code: int, data):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        shape, dtype_name, buf = unpackb(data, raw=True)
        arr = np.frombuffer(bytearray(buf), dtype=np.dtype(dtype_name.decode())).reshape(
            shape, order="C")
        return arr[()] if code == EXT_NPSCALAR else arr
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unpack(r: _Reader, raw: bool):
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _NUMBERS:
        return r.unpack(_NUMBERS[b])
    if b in _FIXED_EXT:
        code = r.unpack("b")
        return _ext(code, r.take(_FIXED_EXT[b]))
    if b in _SIZED:
        n = r.unpack(_SIZED[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(r.take(n))
        if b in (0xD9, 0xDA, 0xDB):
            return _str(r.take(n), raw)
        if b in (0xDC, 0xDD):
            return [_unpack(r, raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return _map(r, n, raw)
        code = r.unpack("b")
        return _ext(code, r.take(n))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _str(data, raw: bool):
    return bytes(data) if raw else bytes(data).decode("utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, raw)
        out[k] = _unpack(r, raw)
    return out


def unpackb(data, raw: bool = False):
    """``msgpack.unpackb`` with flax's ext hook (arrays from ext types 1 and
    3) of what ``packb`` writes; ``raw`` keeps strings as bytes."""
    r = _Reader(data)
    obj = _unpack(r, raw)
    if r.pos != len(r.data):
        raise ValueError("extra data after the msgpack object")
    return obj


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data):
    """flax ``msgpack_restore``: the state dict, chunked leaves joined."""
    return _unchunk_leaves(unpackb(data))
