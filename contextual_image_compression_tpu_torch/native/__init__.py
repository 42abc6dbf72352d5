"""The port's host libraries, bound with ctypes: the adaptive range coder of
its bitstreams and the multithreaded image loader.

`entropy_coder.cpp` and `image_loader.cpp` are the port's own copies of the
JAX package's sources, so streams are byte-identical between the two
packages for equal symbols, and loaded batches bitwise equal. At first use
each is compiled with `g++` into
`contextual_image_compression_tpu_torch/build/<entropy|loader>-<hash of the
source>/`, like the CUDA kernels (ops/cuda_kernels.py): an edited source
builds anew and an unchanged one is reused. The loader links libjpeg and
libpng. A failed build raises; nothing falls back to another coder (the
image loader's caller, data/images.py, decodes file by file instead, as the
JAX package does).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "entropy_coder.cpp"
LOADER_SRC = Path(__file__).resolve().parent / "image_loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
LIB_NAME = "libcic_entropy.so"
LOADER_LIB_NAME = "libcic_loader.so"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
LOADER_LINK = ["-ljpeg", "-lpng"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I16P = ctypes.POINTER(ctypes.c_int16)


def _build(src: Path, prefix: str, lib_name: str, link=(), what: str = "range coder",
           build_root: Path = BUILD_ROOT) -> Path:
    flags = [*GXX_FLAGS, *link]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = build_root / f"{prefix}-{digest}"
    lib_path = out_dir / lib_name
    if lib_path.exists():
        return lib_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the {what} builds only where a C++ compiler is")
    build_root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=build_root))
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp / lib_name), str(src), *link]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         timeout=300)
    if res.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"{what} build failed: {' '.join(cmd)}\n{res.stdout[-4000:]}")
    try:
        tmp.rename(out_dir)
    except OSError:
        # another process finished the same build first; use its copy
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def build() -> Path:
    """Compile the coder (if not built yet) and return the library's path."""
    return _build(SRC, "entropy", LIB_NAME)


def build_loader(build_root: Path = BUILD_ROOT) -> Path:
    """Compile the image loader against libjpeg and libpng under build_root
    (if not built there yet) and return the library's path; raises where
    g++, the libraries or their headers are missing."""
    return _build(LOADER_SRC, "loader", LOADER_LIB_NAME, LOADER_LINK, "image loader",
                  build_root)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded coder (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    lib.cic_entropy_encode.restype = ctypes.c_size_t
    lib.cic_entropy_encode.argtypes = [_I16P, ctypes.c_size_t, _U8P, ctypes.c_size_t]
    lib.cic_entropy_decode.restype = ctypes.c_size_t
    lib.cic_entropy_decode.argtypes = [_U8P, ctypes.c_size_t, _I16P, ctypes.c_size_t]
    lib.cic_entropy_encode_batch.restype = ctypes.c_size_t
    lib.cic_entropy_encode_batch.argtypes = [_I16P, ctypes.c_size_t, ctypes.c_size_t, _U8P,
                                             ctypes.c_size_t, ctypes.c_int]
    lib.cic_entropy_decode_batch.restype = ctypes.c_size_t
    lib.cic_entropy_decode_batch.argtypes = [_U8P, ctypes.c_size_t, ctypes.c_size_t,
                                             ctypes.c_size_t, _I16P, ctypes.c_int]
    return lib


def available() -> bool:
    """Whether the coder builds and loads here."""
    try:
        library()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def entropy_encode(symbols: np.ndarray) -> bytes:
    """Range-code a 1-D int16 symbol array."""
    s = np.ascontiguousarray(symbols, dtype=np.int16).ravel()
    cap = max(64, s.size * 4 + 64)
    out = np.empty(cap, np.uint8)
    n = library().cic_entropy_encode(s.ctypes.data_as(_I16P), s.size,
                                     out.ctypes.data_as(_U8P), cap)
    if n == 0 and s.size:
        raise RuntimeError("entropy encode overflow")
    return out[:n].tobytes()


def entropy_decode(data: bytes, n_symbols: int) -> np.ndarray:
    """The n_symbols int16 symbols of an entropy_encode stream."""
    inp = np.frombuffer(data, np.uint8)
    out = np.empty(n_symbols, np.int16)
    got = library().cic_entropy_decode(inp.ctypes.data_as(_U8P), inp.size,
                                       out.ctypes.data_as(_I16P), n_symbols)
    if got != n_symbols:
        raise RuntimeError(f"entropy decode: got {got}/{n_symbols} symbols")
    return out


def _threads(num_threads: int) -> int:
    return num_threads if num_threads > 0 else min(16, os.cpu_count() or 1)


def entropy_encode_batch(symbols: np.ndarray, num_threads: int = 0) -> bytes:
    """Range-code (B, N) int16 symbols as B independent streams, framed as
    [uint32 length][bytes] per item, on num_threads host threads (0: up to 16)."""
    s = np.ascontiguousarray(symbols, dtype=np.int16)
    if s.ndim != 2:
        raise ValueError(f"entropy_encode_batch: expected (B, N) symbols, got {s.shape}")
    cap = max(64, s.size * 4 + 64 + 8 * s.shape[0])
    out = np.empty(cap, np.uint8)
    n = library().cic_entropy_encode_batch(s.ctypes.data_as(_I16P), s.shape[0], s.shape[1],
                                           out.ctypes.data_as(_U8P), cap, _threads(num_threads))
    if n == 0 and s.size:
        raise RuntimeError("entropy batch encode overflow")
    return out[:n].tobytes()


def entropy_decode_batch(data: bytes, batch: int, n_per_item: int,
                         num_threads: int = 0) -> np.ndarray:
    """The (batch, n_per_item) int16 symbols of an entropy_encode_batch blob."""
    inp = np.frombuffer(data, np.uint8)
    out = np.empty((batch, n_per_item), np.int16)
    got = library().cic_entropy_decode_batch(inp.ctypes.data_as(_U8P), inp.size, batch,
                                             n_per_item, out.ctypes.data_as(_I16P),
                                             _threads(num_threads))
    if got != batch:
        raise RuntimeError(f"entropy batch decode: {got}/{batch} items decoded")
    return out


@functools.lru_cache(maxsize=1)
def loader_library() -> ctypes.CDLL:
    """The loaded image loader (built on first call)."""
    lib = ctypes.CDLL(str(build_loader()))
    lib.cic_load_images.restype = ctypes.c_size_t
    lib.cic_load_images.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def load_images(paths, target_size, normalization: str = "gan", num_threads: int = 0):
    """Decode, resize and normalize image files on num_threads host threads
    (0: up to 16). target_size: (W, H), as cv2.resize takes it;
    normalization 'gan' -> [-1, 1], 'unit' -> [0, 1]. Returns the float32
    batch (N, H, W, 3) and a bool mask (N,) of the files that decoded (the
    others are zero-filled)."""
    if normalization not in ("gan", "unit"):
        raise ValueError(f"normalization 'gan' or 'unit', got {normalization!r}")
    lib = loader_library()
    tw, th = target_size
    n = len(paths)
    out = np.empty((n, th, tw, 3), np.float32)
    ok = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.cic_load_images(c_paths, n, th, tw, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        1 if normalization == "gan" else 0, _threads(num_threads),
                        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, ok.astype(bool)
