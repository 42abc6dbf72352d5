"""Build and load the port's hand-written CUDA kernels.

The sources under `contextual_image_compression_tpu_torch/csrc/` expose a
plain C interface. At first use they are compiled with `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`, no fast-math: `__expf` would move
which symbols `rint` picks), one `nvcc -c` per source, all started together,
then linked into one shared library that `ctypes` loads. The library lives in
`contextual_image_compression_tpu_torch/build/<hash of the sources>/`, so an
edited source builds anew and an unchanged one is reused.

Nothing here runs when the module is imported: the CPU tests import every
module of the port on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "build"
LIB_NAME = "libcic_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# K1's entry points, the cluster and the tiled route; its bf16 route takes the same
_K1_CLUSTER = [
    _P, _P, _I, _I, _I, _I, _I,  # gray, spec, B, H, W, spec_h, spec_w
    _P, _P, _P, _P,              # up_idx_h, up_w_h, up_idx_w, up_w_w
    _I, _I, _F, _F,              # scale_mask, rmax, spectral_w, fine_w
    _I, _P, _I,                  # radius, bilateral taps (host), n taps
    _P, _I,                      # gaussian kernel (host), ksize
    _I, _I, _I, _I, _I,          # cluster, rows, stride, halo, smem bytes
    _P, _P,                      # out, stream
]
_K1_TILED = [
    _P, _P, _I, _I, _I, _I, _I,  # gray, spec, B, H, W, spec_h, spec_w
    _P, _P, _P, _P,              # up_idx_h, up_w_h, up_idx_w, up_w_w
    _I, _I, _F, _F,              # scale_mask, rmax, spectral_w, fine_w
    _I, _P, _I,                  # radius, bilateral taps, n taps
    _P, _I,                      # gaussian kernel, ksize
    _P, _P, _P, _P, _P,          # scratch1, scratch2, maxes, out, stream
]

# argtypes of every exported function (all return a cudaError_t as int)
_SIGNATURES = {
    "cic_contextual_mask_cluster": _K1_CLUSTER,
    "cic_contextual_mask_cluster_bf16": _K1_CLUSTER,  # K1's bf16 route
    "cic_smooth_mask_cluster": [
        _P, _I, _I, _I,              # saliency, B, H, W
        _I, _P, _I,                  # radius, bilateral taps (host), n taps
        _P, _I,                      # gaussian kernel (host), ksize
        _I, _I, _I, _I, _I,          # cluster, rows, stride, halo, smem bytes
        _P, _P,                      # out, stream
    ],
    "cic_mask_max_clusters": [
        _I, _I, _I, _I, _I, _I,      # contextual, H, W, rmax, radius, ksize
        _I, _I, _I, _I, _I,          # cluster, rows, stride, halo, smem bytes
        _P,                          # int *max_clusters (host)
    ],
    "cic_contextual_mask": _K1_TILED,
    "cic_contextual_mask_bf16": _K1_TILED,  # K1's bf16 route
    "cic_smooth_mask": [
        _P, _I, _I, _I,              # saliency, B, H, W
        _I, _P, _I,                  # radius, bilateral taps, n taps
        _P, _I,                      # gaussian kernel, ksize
        _P, _P, _P, _P,              # scratch, maxes, out, stream
    ],
    "cic_dct_strips": [
        _P, _P, _P,                  # planes, dct matrix (8x8), tables (3x8x8)
        _P, _P,                      # rec, sym
        _I, _I, _I, _I, _P,          # B, C, H, W, stream
    ],
    "cic_attention_block": [
        _I,                          # dtype code (0 f32, 1 bf16)
        _P, _P, _P, _P, _P, _P,      # q, k, v, residual, gamma (f32 on device), out
        _P, _L,                      # float32 scratch (null for bf16), its element count
        _I, _I, _I, _I, _P,          # B, N, DK, DV, stream
    ],
    "cic_attention_core": [
        _I,                          # dtype code
        _P, _P, _P, _P,              # q, k, v, out
        _P, _L,                      # float32 scratch (null for bf16), its element count
        _I, _I, _I, _I, _P,          # B, N, DK, DV, stream
    ],
    "cic_sagan_block": [         # float32
        _P, _L, _L, _L,              # x and its (batch, position, channel) element strides
        _P, _P, _P,                  # packed QKV weight (TF32 hi, lo), its bias(f32), gamma(f32)
        _P, _L,                      # the float32 route's TF32 scratch, its element count
        _P, _L, _L, _L,              # out and its element strides
        _I, _I, _I, _I, _P,          # B, N, C, DK, stream
    ],
    "cic_sagan_block_bf16": [
        _P, _L, _L, _L,              # x and its (batch, position, channel) element strides
        _P, _P, _P,                  # packed QKV weight (K-major), its bias(f32), gamma(f32)
        _P, _P, _P,                  # Q, K, V scratch
        _P, _L, _L, _L,              # out and its element strides
        _I, _I, _I, _I, _P,          # B, N, C, DK, stream
    ],
    "cic_packed_tail": [         # float32
        _P, _P, _P, _P, _P, _P,      # x, taps (TF32 hi, lo), shift(f32), out weight (hi, lo), bias(f32), out
        _I, _I, _I, _I, _I, _I,      # B, Cin, H, W, Cmid, Co
        _F, _P,                      # LeakyReLU slope, stream
    ],
    "cic_packed_tail_bf16": [
        _P, _P, _P, _P, _P, _P,      # x, tap tiles, shift, out weight, bias(f32), out
        _I, _I, _I, _I, _I, _I,      # B, Cin, H, W, Cmid, Co
        _F, _P,                      # LeakyReLU slope, stream
    ],
    "cic_packed_tail_int8": [
        _P, _P, _P, _P, _P, _P, _P,  # x, tap tiles, shift, 127 / amax(f32), out weight, bias, out
        _I, _I, _I, _I, _I, _I,      # B, Cin, H, W, Cmid, Co
        _F, _P,                      # LeakyReLU slope, stream
    ],
    "cic_channel_norm": [
        _I, _P, _P, _P, _I,          # dtype code of x, x, alpha, beta, their dtype code
        _P, _I, _I, _I, _I,          # out, B, C, H, W
        _I, _F, _I, _P,              # pixels a tile, eps, relu, stream
    ],
    "cic_channel_norm_nhwc": [       # x and out channels_last
        _I, _P, _P, _P, _I,          # dtype code of x, x, alpha, beta, their dtype code
        _P, _I, _I, _I, _I, _I,      # out, B, C, S (elements a pixel's row), H, W
        _I, _I, _F, _I, _P,          # pixels a tile, lanes a pixel, eps, relu, stream
    ],
    "cic_adaptive_quantize": [
        _I,                          # dtype code of the latent
        _P, _P, _I, _P, _I,          # latent, score, its dtype code, strength, its dtype code
        _F, _P,                      # coeff, out
        _I, _I, _P,                  # B, D, stream
    ],
    "cic_adaptive_quantize_bwd": [
        _I,                          # dtype code of latent and gradient
        _P, _P,                      # latent, grad
        _P, _I, _P, _I, _F,          # score, its dtype code, strength, its dtype code, coeff
        _P, _P,                      # dscore (score's dtype), dstrength (strength's dtype)
        _I, _I, _P,                  # B, D, stream
    ],
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the shared library (if not built yet) and return
    its path. Writes `build.log` (ptxas register and spill report) beside it."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    t0 = time.time()
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    procs = []
    for src in srcs:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src), "-o", str(obj)]
        procs.append((src, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    failed_logs = []
    for src, cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
            failed_logs.append(log[-1][-6000:])
    if not failed:
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
               *[str(tmp / (s.stem + ".o")) for s in srcs], "-o", str(tmp / LIB_NAME)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"$ {' '.join(cmd)}\n{res.stdout}")
        if res.returncode != 0:
            failed.append("link")
            failed_logs.append(log[-1][-6000:])
    log.append(f"build seconds: {time.time() - t0:.1f}\n")
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"CUDA kernel build failed ({', '.join(failed)}); log in {tmp / 'build.log'}:\n"
            + "\n".join(failed_logs)
        )
    if verbose:
        print("\n".join(log))
    try:
        tmp.rename(out_dir)
    except OSError:
        # another process finished the same build first; use its copy
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError_t {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16 tensors, got {dtype}")


def needs_grad(*tensors) -> bool:
    """Whether autograd must record a call on these tensors; a wrapper that
    gets False launches its kernel without an autograd Function."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Device and contiguity checks shared by the kernel wrappers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def tf32_split(t: torch.Tensor) -> torch.Tensor:
    """(2, *t.shape) float32: the TF32 hi and lo of t as `csrc/hopper.cuh`'s
    tf32_split forms them, hi = cvt.rna.tf32(t) (10 mantissa bits, ties away
    from zero: half a TF32 ulp added to the magnitude bits, the 13 low bits
    cleared) and lo = cvt.rna.tf32(t - hi); hi + lo is t to within 2^-22 of
    |t|. The float32 routes of K7 and K8 take their weights split so."""

    def rna(a):
        return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    t = t.float().contiguous()
    hi = rna(t)
    return torch.stack([hi, rna(t - hi)])
