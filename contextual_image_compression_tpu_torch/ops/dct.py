"""JPEG-style 8x8 DCT baseline codec: kernel K5, its plain twin, and the codec.

Counterpart of `contextual_image_compression_tpu/ops/dct.py`:

  * RGB <-> YCbCr (BT.601 full range, the JPEG convention);
  * per 8x8 tile of the level-shifted planes: forward DCT -> libjpeg
    quality-scaled quantization -> round half to even -> dequantize ->
    inverse DCT, all in kernel K5 (`dct_strips`, csrc/dct.cu) on the card;
  * the analytic bpp from the empirical entropy of the symbols;
  * self-contained streams: a `<BBBHH` header (version 2, coder, quality,
    height, width) and the range-coded int16 symbols (native/), which the
    JAX package's decoder reads and which decode the JAX package's streams.

K5 replaces `_dct_strips_pallas`. On a CPU tensor `dct_strips` runs
`dct_strips_plain`, the JAX package's `_dct_strips_jnp` formula, which is
also what the card's result is held against. The decoder's inverse transform
is plain float32 matrix products, as in the JAX package.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from contextual_image_compression_tpu_torch import native
from contextual_image_compression_tpu_torch.config import DCTCodecConfig, resolve_device
from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck
from contextual_image_compression_tpu_torch.ops.saliency import _full_fp32_matmul

# JPEG Annex K quantization tables.
_LUMA_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    np.float32,
)
_CHROMA_TABLE = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    np.float32,
)


def quality_scaled_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's quality -> table scaling."""
    quality = int(np.clip(quality, 1, 100))
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    return np.clip(np.floor((base * scale + 50.0) / 100.0), 1.0, 255.0).astype(np.float32)


def quality_tables(quality: int) -> np.ndarray:
    """(3, 8, 8) float32 tables of the Y, Cb and Cr planes."""
    luma = quality_scaled_table(_LUMA_TABLE, quality)
    chroma = quality_scaled_table(_CHROMA_TABLE, quality)
    return np.stack([luma, chroma, chroma])


@functools.lru_cache(maxsize=1)
def _dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix, evaluated in float64, rounded to float32."""
    n = 8
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _block_diag_dt(width: int) -> np.ndarray:
    """(W, W) block-diagonal matrix of D^T tiles: the per-tile column
    transform of a (8, W) strip as one product."""
    bd = np.zeros((width, width), np.float32)
    for i in range(0, width, 8):
        bd[i:i + 8, i:i + 8] = _dct_matrix().T
    return bd


def rgb_to_ycbcr(rgb255: torch.Tensor) -> torch.Tensor:
    """JPEG full-range BT.601. rgb255: (..., 3) in [0, 255]."""
    r, g, b = rgb255[..., 0], rgb255[..., 1], rgb255[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return torch.stack([y, cb, cr], dim=-1)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    y, cb, cr = ycc[..., 0], ycc[..., 1] - 128.0, ycc[..., 2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1)


def _check_planes(planes: torch.Tensor, tables: torch.Tensor) -> None:
    if planes.ndim != 4 or tables.shape != (planes.shape[1], 8, 8):
        raise ValueError("dct_strips: expected planes (B, C, H, W) and tables (C, 8, 8)")
    if planes.shape[-2] % 8 or planes.shape[-1] % 8:
        raise ValueError(f"dct_strips: H and W must be multiples of 8, got {tuple(planes.shape)}")


def _inverse_strips(deq: torch.Tensor, d: torch.Tensor, bd: torch.Tensor) -> torch.Tensor:
    """D^T (deq BD^T) per (8, W) strip: the inverse transform."""
    return d.T @ (deq @ bd.T)


def dct_strips_plain(planes: torch.Tensor, tables: torch.Tensor):
    """K5's function in plain PyTorch, float32: for level-shifted planes
    (B, C, H, W) and per-channel tables (C, 8, 8), returns (rec, sym), both
    (B, C, H, W) float32. The formula of `_dct_strips_jnp`: row transform
    D X, column transform against the (W, W) block-diagonal of D^T, rint of
    coef / q, and the two transposed products back."""
    _check_planes(planes, tables)
    b, c, h, w = planes.shape
    dev = planes.device
    d = torch.from_numpy(_dct_matrix()).to(dev)
    bd = torch.from_numpy(_block_diag_dt(w)).to(dev)
    strips = planes.to(torch.float32).reshape(b, c, h // 8, 8, w)
    q = tables.to(device=dev, dtype=torch.float32).repeat(1, 1, w // 8)[None, :, None]
    with _full_fp32_matmul(dev):
        coef = (d @ strips) @ bd
        sym = torch.round(coef / q)
        rec = _inverse_strips(sym * q, d, bd)
    return rec.reshape(b, c, h, w), sym.reshape(b, c, h, w)


@functools.lru_cache(maxsize=4)
def _device_dct_matrix(dev) -> torch.Tensor:
    return torch.from_numpy(_dct_matrix()).to(dev)


def dct_strips(planes: torch.Tensor, tables: torch.Tensor):
    """(rec, sym) of level-shifted planes (B, C, H, W) float32 under tables
    (C, 8, 8). Launches K5 for CUDA tensors; the plain twin runs only for
    CPU tensors."""
    if planes.device.type == "cpu":
        return dct_strips_plain(planes, tables)
    if planes.device.type != "cuda":
        raise ValueError(f"dct_strips: unsupported device {planes.device}")
    if planes.dtype != torch.float32 or tables.dtype != torch.float32:
        raise TypeError("dct_strips: planes and tables must be float32")
    _check_planes(planes, tables)
    # the kernel reads and writes 16 bytes at a time
    planes, tables = planes.contiguous(), tables.contiguous()
    if planes.data_ptr() % 16:
        planes = planes.clone()
    ck.require_cuda("dct_strips", planes, tables)
    b, c, h, w = planes.shape
    dev = planes.device
    d = _device_dct_matrix(dev)
    rec = torch.empty_like(planes)
    sym = torch.empty_like(planes)
    err = ck.library().cic_dct_strips(
        planes.data_ptr(), d.data_ptr(), tables.data_ptr(), rec.data_ptr(), sym.data_ptr(),
        b, c, h, w, ck.stream_ptr(dev),
    )
    ck.check(err, "dct_strips")
    dct_strips.launches += 1
    return rec, sym


dct_strips.launches = 0


def _entropy_bits_per_symbol(sym: torch.Tensor, max_abs: int = 1024) -> torch.Tensor:
    """Empirical entropy (bits per symbol) of each row of sym (B, N) -> (B,),
    over the symbols clipped to [-max_abs, max_abs]."""
    nb = 2 * max_abs + 1
    clipped = (torch.clamp(sym, -max_abs, max_abs) + max_abs).to(torch.int64)
    rows = torch.arange(sym.shape[0], device=sym.device)[:, None] * nb
    hist = torch.bincount((clipped + rows).reshape(-1), minlength=sym.shape[0] * nb)
    p = hist.reshape(sym.shape[0], nb).to(torch.float32) / sym.shape[-1]
    terms = torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-12)), torch.zeros_like(p))
    return -terms.sum(dim=-1)


class DCTCodec:
    """Batched JPEG-style codec on `device` (the card unless the caller asks
    for the CPU): encode and decode in one K5 launch per batch."""

    _STREAM_HEADER = "<BBBHH"  # version, coder (0 zlib, 1 range coder), quality, h, w
    _STREAM_VERSION = 2

    def __init__(self, cfg: DCTCodecConfig = DCTCodecConfig(), device="cuda"):
        if not cfg.use_pallas:
            raise NotImplementedError("DCTCodecConfig.use_pallas=False: the port always runs K5")
        if cfg.block != 8:
            raise ValueError(f"DCTCodec: block must be 8, got {cfg.block}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._tables = torch.from_numpy(quality_tables(cfg.quality)).to(self.device)

    def roundtrip(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: (B, H, W, 3) in [-1, 1] -> (reconstruction (B, H, W, 3) in
        [-1, 1], symbols (B, 3*H*W) float32 in plane order)."""
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        b = images.shape[0]
        ycc = rgb_to_ycbcr((images + 1.0) * 127.5) - 128.0
        planes = ycc.permute(0, 3, 1, 2).contiguous()
        rec_planes, sym = dct_strips(planes, self._tables)
        rec_rgb = ycbcr_to_rgb(rec_planes.permute(0, 2, 3, 1) + 128.0)
        rec = torch.clamp(rec_rgb / 127.5 - 1.0, -1.0, 1.0)
        return rec, sym.reshape(b, -1)

    def evaluate(self, images) -> Dict[str, torch.Tensor]:
        """Reconstruction, symbols and the analytic bpp (entropy of the symbols)."""
        rec, sym = self.roundtrip(images)
        h, w = rec.shape[1:3]
        bpp = _entropy_bits_per_symbol(sym) * sym.shape[-1] / (h * w)
        return {"reconstruction": rec, "symbols": sym, "bpp": bpp}

    def encode_stream(self, image) -> bytes:
        """One (H, W, 3) [-1, 1] image -> header + range-coded symbols."""
        image = torch.as_tensor(image, dtype=torch.float32)
        _, sym = self.roundtrip(image[None])
        h, w = image.shape[0], image.shape[1]
        coder, payload = self._serialize_tagged(sym[0].cpu().numpy())
        return struct.pack(self._STREAM_HEADER, self._STREAM_VERSION, coder, self.cfg.quality,
                           h, w) + payload

    def decode_stream(self, data: bytes) -> torch.Tensor:
        """Inverse of encode_stream: stream -> (H, W, 3) image in [-1, 1] on
        the codec's device. The quality comes from the header, so a codec
        configured at another quality decodes the same image."""
        hdr = struct.calcsize(self._STREAM_HEADER)
        version, coder, quality, h, w = struct.unpack_from(self._STREAM_HEADER, data, 0)
        if version != self._STREAM_VERSION:
            raise ValueError(f"unknown DCT stream version {version}")
        n = 3 * h * w
        payload = data[hdr:]
        if coder == 1:
            sym = native.entropy_decode(payload, n)
        elif coder == 0:
            sym = np.frombuffer(zlib.decompress(payload), np.int16)[:n]
        else:
            raise ValueError(f"unknown entropy coder id {coder}")
        dev = self.device
        sym = torch.from_numpy(sym.astype(np.float32)).to(dev).reshape(3, h // 8, 8, w)
        q = torch.from_numpy(quality_tables(quality)).to(dev).repeat(1, 1, w // 8)[:, None]
        d = torch.from_numpy(_dct_matrix()).to(dev)
        bd = torch.from_numpy(_block_diag_dt(w)).to(dev)
        with _full_fp32_matmul(dev):
            rec_planes = _inverse_strips(sym * q, d, bd).reshape(3, h, w)
        rec = ycbcr_to_rgb(rec_planes.permute(1, 2, 0) + 128.0)
        return torch.clamp(rec / 127.5 - 1.0, -1.0, 1.0)

    @staticmethod
    def _serialize_tagged(symbols: np.ndarray) -> Tuple[int, bytes]:
        """(coder id, payload): always the range coder (id 1); a coder that
        does not build raises."""
        s = np.clip(np.asarray(symbols), -32768, 32767).astype(np.int16)
        return 1, native.entropy_encode(s.ravel())

    @staticmethod
    def serialize(symbols: np.ndarray) -> bytes:
        return DCTCodec._serialize_tagged(symbols)[1]

    @staticmethod
    def measured_bpp(symbols: np.ndarray, hw: Tuple[int, int]) -> float:
        return 8.0 * len(DCTCodec.serialize(symbols)) / float(hw[0] * hw[1])
