"""Flax's msgpack serialization in pure Python (counterpart of the
`flax.serialization.msgpack_serialize` / `msgpack_restore` calls of
`r3dfsseg_tpu/utils/checkpoint.py`), so that the port reads and writes the
JAX package's `.msgpack` checkpoints without the `msgpack` or `flax`
packages.

The msgpack subset covered: nil, bool, ints (up to 64 bits), float32 and
float64, str, bin, array, map and ext.  Flax's ext types:

  * code 1, an ndarray: a nested msgpack array (shape, dtype name,
    C-order bytes);
  * code 3, a numpy scalar: the same encoding of its 0-d array;
  * code 2, a Python complex: refused, as is every other code.

Arrays over `MAX_CHUNK_SIZE` bytes that are the tree or a map's value are
written, as Flax writes them, as ``{'__msgpack_chunked_array__': True,
'shape': {'0': d0, ...}, 'chunks': {'0': flat chunk, ...}}``, and read back
whole.  Restored arrays are writable numpy arrays, except `bfloat16` ones:
numpy has no bf16, so they come back as `torch.bfloat16` tensors (their
uint16 bits); a bf16 tensor is written under the dtype name 'bfloat16'.
The writer picks the same encodings as the `msgpack` package, so a tree
serializes to Flax's bytes.  Any other leaf type raises TypeError naming
it.
"""
from __future__ import annotations

import struct
from collections.abc import Mapping
from typing import Any, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30      # Flax's limit per array leaf (msgpack's is 2**31 - 1)
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------------ write --
def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif n >= 0:
        for lim, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                               (0xFFFFFFFF, 0xCE, ">I"), (2**64 - 1, 0xCF, ">Q")):
            if n <= lim:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: int {n} does not fit in 64 bits")
    elif n >= -0x20:
        out += struct.pack(">b", n)
    else:
        for lim, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                               (-2**31, 0xD2, ">i"), (-2**63, 0xD3, ">q")):
            if n >= lim:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: int {n} does not fit in 64 bits")


def _pack_len(n: int, out: bytearray, fix: Tuple[int, int] | None, codes) -> None:
    """A length header: the fix form (base, limit) where it fits, else the
    8/16/32-bit codes (``codes`` maps a limit to a code and a format)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for lim, code, fmt in codes:
        if n <= lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"msgpack: length {n} past 2**32 - 1")


_STR = ((0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"), (0xFFFFFFFF, 0xDB, ">I"))
_BIN = ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"), (0xFFFFFFFF, 0xC6, ">I"))
_ARRAY = ((0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I"))
_MAP = ((0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I"))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xFF, 0xC7, ">B"), (0xFFFF, 0xC8, ">H"), (0xFFFFFFFF, 0xC9, ">I"))


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    if len(data) in _FIXEXT:
        out.append(_FIXEXT[len(data)])
    else:
        _pack_len(len(data), out, None, _EXT)
    out.append(code)
    out += data


def _array_parts(x) -> Tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), "bfloat16", x.view(torch.uint16).numpy().tobytes()
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct or x.dtype.names:
        raise TypeError(f"msgpack: arrays of dtype {x.dtype} are not serializable")
    return x.shape, x.dtype.name, x.tobytes("C")


def _ndarray_bytes(x) -> bytes:
    shape, name, data = _array_parts(x)
    out = bytearray()
    _pack((tuple(int(s) for s in shape), name, data), out)
    return bytes(out)


def _pack(x: Any, out: bytearray) -> None:
    t = type(x)
    if x is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if x else 0xC2)
    elif t is int:
        _pack_int(x, out)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)), out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(x), out)
    elif t is str:
        b = x.encode("utf-8")
        _pack_len(len(b), out, (0xA0, 32), _STR)
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _pack_len(len(b), out, None, _BIN)
        out += b
    elif isinstance(x, Mapping):
        _pack_len(len(x), out, (0x80, 16), _MAP)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), out, (0x90, 16), _ARRAY)
        for v in x:
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot serialize a {t.__module__}.{t.__qualname__}")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(x) -> dict:
    """Flax's `_chunk`: a flat array cut into MAX_CHUNK_SIZE-byte pieces."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {_CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(i): flat[j:j + size]
                       for i, j in enumerate(range(0, flat.shape[0], size))}}


def _sorted_keys(x: Mapping) -> list:
    try:
        return sorted(x)
    except TypeError:       # keys of mixed types: their own order
        return list(x)


def _chunked(x):
    """The tree as Flax writes it, without touching the caller's tree: maps
    in sorted key order (Flax copies the tree with `jax.tree_util`, which
    sorts dict keys), and every oversized array that is the tree or a
    map's value in its chunked form (`_chunk_array_leaves_in_place`)."""
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return _chunk(x) if _nbytes(x) > MAX_CHUNK_SIZE else x
    if isinstance(x, Mapping):
        return {k: _chunked(x[k]) for k in _sorted_keys(x)}
    return x


def msgpack_serialize(tree) -> bytes:
    """``tree`` (nested dicts and lists of Python scalars, str, bytes, numpy
    arrays and scalars, torch tensors) as Flax's msgpack bytes."""
    out = bytearray()
    _pack(_chunked(tree), out)
    return bytes(out)


# ------------------------------------------------------------------- read --
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# the length field of bin (c4-c6), ext (c7-c9), str (d9-db), array (dc-dd), map (de-df)
_SIZES = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
          0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_FIXEXT_SIZE = {code: n for n, code in _FIXEXT.items()}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _SIZES:
            n = self.unpack(_SIZES[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xC9:
                code = self.unpack(">b")
                return _ext(code, bytes(self.take(n)))
            if b <= 0xDB:
                return str(self.take(n), "utf-8")
            if b <= 0xDD:
                return [self.obj() for _ in range(n)]
            return self.map(n)
        if b in _FIXEXT_SIZE:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(_FIXEXT_SIZE[b])))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, bytes, int)):
                raise TypeError(f"msgpack: a map key of type {type(k).__name__}")
            out[k] = self.obj()
        return out


def _ndarray_from_bytes(data: bytes):
    r = _Reader(data)
    shape, name, buf = r.obj()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise TypeError(f"msgpack: an array of dtype {name!r}, which numpy does not know") \
            from None
    return np.frombuffer(buf, dtype).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_NPSCALAR:
        a = _ndarray_from_bytes(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    if code == EXT_COMPLEX:
        raise TypeError("msgpack: Flax's complex-number ext (code 2) is not read by the port")
    raise TypeError(f"msgpack: unknown ext type {code}")


def _unchunked(x):
    if isinstance(x, dict):
        if _CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            cat = torch.cat if isinstance(chunks[0], torch.Tensor) else np.concatenate
            return cat(chunks).reshape(shape)
        return {k: _unchunked(v) for k, v in x.items()}
    return x


def msgpack_restore(data: bytes):
    """Flax's msgpack bytes -> the tree (dicts, lists, Python scalars, str,
    bytes, numpy arrays and scalars; bf16 arrays as torch tensors)."""
    r = _Reader(bytes(data))
    tree = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes past the end of the tree")
    return _unchunked(tree)
