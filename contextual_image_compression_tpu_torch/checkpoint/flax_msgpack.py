"""flax's msgpack checkpoint format, read and written without flax or msgpack.

A file is what `flax.serialization.to_bytes` writes for a state dict and
what `flax.serialization.msgpack_restore` reads back: one msgpack object,
in practice a map with str keys whose leaves are arrays. flax packs with
`strict_types=True` and `use_bin_type=True`, and adds three ext types:

  * 1, an ndarray: the payload is itself msgpack, the array
    (shape, dtype name, C-order bytes), shape an array of ints, the dtype
    name a str, the bytes a bin;
  * 3, a numpy scalar: the same payload for a 0-d array;
  * 2, a Python complex: the payload is the array (real, imag).

An array leaf above `MAX_CHUNK_SIZE` bytes is stored as the map
{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
flat chunk, ...}}, and reads back as one array. Tuples reach the file as
{"0": ..., "1": ...} maps and optax's EmptyState as {}: this module deals in
dicts, never tuples. numpy has no bfloat16, so a bfloat16 leaf reads as
a torch.bfloat16 tensor (its uint16 bits, viewed); torch tensors of any
device are written as arrays of their dtype.

`write` streams each leaf's buffer to the file and builds no whole-file
bytes (the full-width train state is ~5 GB). `read` makes array leaves
read-only `np.frombuffer` views of the one buffer it reads. Keys keep the
order they have in the tree or the file, so a tree read from a file and
written back gives the same bytes.
"""

from __future__ import annotations

import io
import struct
from typing import Any, BinaryIO

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: msgpack's limit per object is 2**31 - 1.
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class FormatError(ValueError):
    """The bytes are not one well-formed msgpack object of this format."""


# ----------------------------------------------------------------------- read


class _Reader:
    def __init__(self, buf, raw: bool):
        self.buf = memoryview(buf)
        self.pos = 0
        # raw: str as bytes and bin as a view of the buffer (flax reads the
        # ndarray payload with raw=True; the view spares a copy of the data)
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.buf):
            raise FormatError(f"truncated: want {n} bytes at offset {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def text(self, n: int):
        data = self.take(n)
        if self.raw:
            return bytes(data)
        try:
            return str(data, "utf-8")
        except UnicodeDecodeError as exc:
            raise FormatError(f"invalid UTF-8 in a str at offset {self.pos - n}") from exc

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, (str, bytes)):  # msgpack's strict_map_key
                raise FormatError(f"map key {key!r} is not a str")
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.sint(1)
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from(data)
        if code == EXT_NPSCALAR:
            leaf = _ndarray_from(data)
            return leaf[()] if isinstance(leaf, np.ndarray) else leaf.reshape(())
        if code == EXT_COMPLEX:
            parts = loads(data)
            return complex(parts[0], parts[1])
        raise FormatError(f"unknown ext type {code}")

    def obj(self) -> Any:
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            data = self.take(self.uint(1 << (b - 0xC4)))
            return data if self.raw else bytes(data)
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.uint(1 << (b - 0xC7)))
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 << (b - 0xDC)))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 << (b - 0xDE)))
        raise FormatError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no msgpack object")


def _ndarray_from(payload: memoryview):
    r = _Reader(payload, raw=True)
    parts = r.obj()
    if r.pos != len(payload) or not (isinstance(parts, list) and len(parts) == 3):
        raise FormatError("an ndarray payload is not (shape, dtype, bytes)")
    shape, name, data = parts
    if name == b"bfloat16":
        bits = np.frombuffer(data, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name.decode())
    except (TypeError, AttributeError, UnicodeDecodeError) as exc:
        raise FormatError(f"unknown dtype name {name!r}") from exc
    return np.frombuffer(data, dtype=dtype).reshape(shape)


def _unchunk(tree):
    """flax's _unchunk_array_leaves_in_place, on a fresh tree."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [_as_numpy(tree["chunks"][str(i)]) for i in range(len(tree["chunks"]))]
        flat = np.concatenate(chunks)
        if chunks and isinstance(tree["chunks"]["0"], torch.Tensor):
            return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):  # bfloat16: its bits
        return leaf.view(torch.int16).numpy().view(np.uint16)
    return leaf


def loads(buf) -> Any:
    """One msgpack object of flax's format from `buf` (bytes, bytearray,
    memoryview or mmap), chunked arrays joined. Raises FormatError on bytes
    that are empty, truncated, malformed, or hold more than one object."""
    r = _Reader(buf, raw=False)
    tree = r.obj()
    if r.pos != len(r.buf):
        raise FormatError(f"{len(r.buf) - r.pos} bytes of extra data after the object")
    return _unchunk(tree)


def read(path) -> Any:
    """The tree of a file, read with one read."""
    with open(path, "rb") as f:
        return loads(f.read())


# ---------------------------------------------------------------------- write


def _int_bytes(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return bytes([v & 0xFF])
    if v > 0:
        for code, n in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < 1 << (8 * n):
                return bytes([code]) + v.to_bytes(n, "big")
    else:
        for code, n in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * n - 1)):
                return bytes([code]) + v.to_bytes(n, "big", signed=True)
    raise OverflowError(f"integer {v} does not fit 64 bits")


def _header(n: int, fix: int, fixmax: int, codes) -> bytes:
    """The header of a str / bin / array / map of n elements or bytes."""
    if fix is not None and n <= fixmax:
        return bytes([fix | n])
    for code, width in codes:
        if n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise OverflowError(f"length {n} does not fit 32 bits")


def _str_bytes(s: str) -> bytes:
    data = s.encode("utf-8")
    return _header(len(data), 0xA0, 31, ((0xD9, 1), (0xDA, 2), (0xDB, 4))) + data


def _bin_header(n: int) -> bytes:
    return _header(n, None, -1, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))


def _array_header(n: int) -> bytes:
    return _header(n, 0x90, 15, ((0xDC, 2), (0xDD, 4)))


def _map_header(n: int) -> bytes:
    return _header(n, 0x80, 15, ((0xDE, 2), (0xDF, 4)))


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _header(n, None, -1, ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
    return head + struct.pack(">b", code)


def _host_array(leaf):
    """(shape, dtype name, C-contiguous numpy view of the bytes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        data = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        return tuple(t.shape), name, data
    a = leaf if leaf.flags.c_contiguous else leaf.copy(order="C")
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise TypeError("object and structured dtypes are not serializable")
    return a.shape, a.dtype.name, a


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return leaf.size * leaf.dtype.itemsize


def _chunked(leaf) -> dict:
    """flax's _chunk: the flat array in chunks of MAX_CHUNK_SIZE bytes."""
    itemsize = leaf.element_size() if isinstance(leaf, torch.Tensor) else leaf.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = leaf.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(leaf.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f

    def array(self, leaf, code: int) -> None:
        shape, name, data = _host_array(leaf)
        head = (bytes([0x93]) + _array_header(len(shape)) + b"".join(_int_bytes(int(d)) for d in shape)
                + _str_bytes(name) + _bin_header(data.nbytes))
        self.f.write(_ext_header(len(head) + data.nbytes, code) + head)
        self.f.write(memoryview(data.reshape(-1).view(np.uint8)))

    def obj(self, x) -> None:
        t = type(x)
        if isinstance(x, (np.ndarray, torch.Tensor)):
            if _nbytes(x) > MAX_CHUNK_SIZE:
                self.obj(_chunked(x))
            else:
                self.array(x, EXT_NDARRAY)
        elif t is dict:
            self.f.write(_map_header(len(x)))
            for k, v in x.items():
                if type(k) is not str:
                    raise TypeError(f"map key {k!r} is not a str")
                self.f.write(_str_bytes(k))
                self.obj(v)
        elif x is None:
            self.f.write(b"\xc0")
        elif t is bool:
            self.f.write(b"\xc3" if x else b"\xc2")
        elif t is int:
            self.f.write(_int_bytes(x))
        elif t is float:
            self.f.write(b"\xcb" + struct.pack(">d", x))
        elif t is str:
            self.f.write(_str_bytes(x))
        elif t is bytes:
            self.f.write(_bin_header(len(x)) + x)
        elif t is list:
            self.f.write(_array_header(len(x)))
            for v in x:
                self.obj(v)
        elif isinstance(x, np.generic):
            self.array(np.asarray(x), EXT_NPSCALAR)
        elif t is complex:
            payload = b"\x92\xcb" + struct.pack(">d", x.real) + b"\xcb" + struct.pack(">d", x.imag)
            self.f.write(_ext_header(len(payload), EXT_COMPLEX) + payload)
        else:  # flax packs with strict_types: a tuple or a subclass is refused
            raise TypeError(f"cannot serialize {t.__name__}")


def write(f: BinaryIO, tree: Any) -> None:
    """Stream `tree` to the binary file `f` as flax.serialization.to_bytes
    would encode it (the tree taken as an already flat state dict)."""
    _Writer(f).obj(tree)


def dumps(tree: Any) -> bytes:
    """The bytes of `write` (small trees; files are written with `write`)."""
    buf = io.BytesIO()
    write(buf, tree)
    return buf.getvalue()
