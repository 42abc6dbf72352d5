"""Real bitstreams of the learned codec: latent streams and CICZ containers.

Counterpart of `contextual_image_compression_tpu/ops/bitstream.py`, byte for
byte: for equal inputs both packages write the same bytes, and each reads the
other's streams. Host code on numpy arrays; the payloads go through the
port's range coder (`native/`).

Latent stream, per image (little-endian):
  [uint8 version=2][uint8 coder][float32 scale][uint32 n_symbols][uint32 payload_len][payload]
with symbols = round(latent * scale) as int16 and scale = exp(3 q (1 - s)),
the quantizer's grid. The coder byte says which entropy coder wrote the
payload (0 zlib, 1 range coder); decoding follows the header. The port
always encodes with the range coder (a coder that does not build raises,
nothing falls back to zlib) and still decodes zlib payloads.

Container (everything the generator-only decoder needs):
  [magic 'CICZ'][uint8 version=1][uint16 H][uint16 W][float32 target_bpp]
  [uint16 mh][uint16 mw][uint8 mask_coder][uint32 mask_len][mask payload]
  [uint32 hq_len][hq latent stream][uint32 lq_len][lq latent stream]
where the mask is the smooth saliency mask box-averaged by `mask_downsample`
and quantized to uint8.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

from contextual_image_compression_tpu_torch import native

_HEADER = struct.Struct("<BBfII")
_VERSION = 2
CODER_ZLIB = 0
CODER_RANGE = 1


def _encode_payload(symbols: np.ndarray) -> Tuple[int, bytes]:
    """(coder id, payload): always the range coder."""
    return CODER_RANGE, native.entropy_encode(symbols)


def _decode_payload(payload: bytes, n: int, coder: int) -> np.ndarray:
    if coder == CODER_RANGE:
        return native.entropy_decode(payload, n)
    if coder == CODER_ZLIB:
        return np.frombuffer(zlib.decompress(payload), np.int16)[:n].copy()
    raise ValueError(f"unknown entropy coder id {coder}")


def pack_latent(latent: np.ndarray, scale: float) -> bytes:
    """One latent vector at quantizer grid `scale` -> stream; the symbols are
    round(latent * scale) (idempotent on an already quantized latent)."""
    symbols = np.clip(np.round(latent * scale), -32768, 32767).astype(np.int16)
    coder, payload = _encode_payload(symbols)
    return _HEADER.pack(_VERSION, coder, float(scale), symbols.size, len(payload)) + payload


def unpack_latent(stream: bytes) -> Tuple[np.ndarray, float]:
    """(dequantized latent float32, scale)."""
    version, coder, scale, n, plen = _HEADER.unpack_from(stream, 0)
    if version != _VERSION:
        raise ValueError(f"unknown bitstream version {version}")
    symbols = _decode_payload(stream[_HEADER.size:_HEADER.size + plen], n, coder)
    return symbols.astype(np.float32) / scale, scale


def quantizer_scale(saliency_score: float, quant_strength: float,
                    scale_coeff: float = 3.0) -> float:
    """exp(coeff * quant_strength * (1 - saliency_score))."""
    return float(np.exp(scale_coeff * quant_strength * (1.0 - saliency_score)))


def pack_symbols(symbols: np.ndarray, scale: float) -> bytes:
    """Stream of symbols already computed (a float array of integers, e.g.
    the pipeline's float32 device symbols) at grid `scale`."""
    sym = np.clip(np.asarray(symbols), -32768, 32767).astype(np.int16)
    coder, payload = _encode_payload(sym)
    return _HEADER.pack(_VERSION, coder, float(scale), sym.size, len(payload)) + payload


def pack_codec_symbols(hq_symbols: np.ndarray, lq_symbols: np.ndarray,
                       hq_scales: np.ndarray, lq_scales: np.ndarray) -> List[Tuple[bytes, bytes]]:
    """Per-image (hq, lq) streams from (B, 2D) and (B, D) symbols and (B,) scales."""
    return [(pack_symbols(hq_symbols[i], float(hq_scales[i])),
             pack_symbols(lq_symbols[i], float(lq_scales[i])))
            for i in range(hq_symbols.shape[0])]


def pack_codec_latents(hq_latent_q: np.ndarray, lq_latent_q: np.ndarray,
                       hq_scales: np.ndarray, lq_scales: np.ndarray) -> List[Tuple[bytes, bytes]]:
    """Per-image (hq, lq) streams from quantized latents."""
    return [(pack_latent(hq_latent_q[i], float(hq_scales[i])),
             pack_latent(lq_latent_q[i], float(lq_scales[i])))
            for i in range(hq_latent_q.shape[0])]


def measured_bpp(streams: List[Tuple[bytes, bytes]], img_hw: Tuple[int, int]) -> np.ndarray:
    """Bits per pixel of the serialized latents."""
    hw = float(img_hw[0] * img_hw[1])
    return np.array([8.0 * (len(h) + len(l)) / hw for h, l in streams], np.float32)


_CONTAINER_MAGIC = b"CICZ"
_CONTAINER_VERSION = 1
_CONTAINER_HEAD = struct.Struct("<4sBHHf")
_MASK_HEAD = struct.Struct("<HHBI")


def _mask_to_u8(mask: np.ndarray, downsample: int) -> np.ndarray:
    """(H, W) float [0, 1] -> (H / ds, W / ds) uint8 by box average."""
    h, w = mask.shape
    ds = max(1, int(downsample))
    hh, ww = h // ds, w // ds
    m = mask[:hh * ds, :ww * ds].reshape(hh, ds, ww, ds).mean(axis=(1, 3))
    return np.clip(np.round(m * 255.0), 0, 255).astype(np.uint8)


def pack_container(hq_stream: bytes, lq_stream: bytes, mask: np.ndarray, target_bpp: float,
                   img_hw: Tuple[int, int], mask_downsample: int = 8) -> bytes:
    """One image's container: the two latent streams, the (H, W) float mask
    in [0, 1] downsampled to uint8, the target bpp and the image size."""
    mu8 = _mask_to_u8(np.asarray(mask, np.float32), mask_downsample)
    coder, payload = _encode_payload(mu8.astype(np.int16).ravel())
    return b"".join((
        _CONTAINER_HEAD.pack(_CONTAINER_MAGIC, _CONTAINER_VERSION, img_hw[0], img_hw[1],
                             float(target_bpp)),
        _MASK_HEAD.pack(mu8.shape[0], mu8.shape[1], coder, len(payload)),
        payload,
        struct.pack("<I", len(hq_stream)), hq_stream,
        struct.pack("<I", len(lq_stream)), lq_stream,
    ))


def unpack_container(data: bytes) -> dict:
    """Keys: hq_latent, lq_latent (dequantized float32), hq_scale, lq_scale,
    mask_small (float [0, 1], (mh, mw)), target_bpp, img_hw."""
    magic, version, h, w, target_bpp = _CONTAINER_HEAD.unpack_from(data, 0)
    if magic != _CONTAINER_MAGIC:
        raise ValueError("not a CICZ container stream")
    if version != _CONTAINER_VERSION:
        raise ValueError(f"unknown container version {version}")
    off = _CONTAINER_HEAD.size
    mh, mw, mcoder, mlen = _MASK_HEAD.unpack_from(data, off)
    off += _MASK_HEAD.size
    mask_small = (_decode_payload(data[off:off + mlen], mh * mw, mcoder)
                  .astype(np.float32).reshape(mh, mw) / 255.0)
    off += mlen
    (hq_len,) = struct.unpack_from("<I", data, off)
    off += 4
    hq_latent, hq_scale = unpack_latent(data[off:off + hq_len])
    off += hq_len
    (lq_len,) = struct.unpack_from("<I", data, off)
    off += 4
    lq_latent, lq_scale = unpack_latent(data[off:off + lq_len])
    return {
        "hq_latent": hq_latent,
        "lq_latent": lq_latent,
        "hq_scale": hq_scale,
        "lq_scale": lq_scale,
        "mask_small": mask_small,
        "target_bpp": float(target_bpp),
        "img_hw": (int(h), int(w)),
    }
