"""The port's storable codec against the JAX package: latent streams, CICZ
containers, the range coder's batch entry points, the generator-only decode
and the pipeline's bytes -> image round trip.

Streams and containers must be byte-identical for equal numpy inputs and
cross-decode both ways to identical latents, scales and masks. The decode is
held to the serving bar of the first slice: decoded-u8 PSNR >= 40 dB against
JAX on the same weights (bf16 serving); float32 decode_latents to 1e-4.
"""

import dataclasses
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import perturb_variables, to_numpy_tree

from contextual_image_compression_tpu import native as jnative
from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.models.adaptive import AdaptiveCodec as JCodec
from contextual_image_compression_tpu.ops import bitstream as jbs
from contextual_image_compression_tpu.serve import CompressionPipeline as JPipeline
from contextual_image_compression_tpu.serve import _serving_model_config as j_serving
from contextual_image_compression_tpu_torch import native as tnative
from contextual_image_compression_tpu_torch.config import ModelConfig
from contextual_image_compression_tpu_torch.convert import convert_codec_variables
from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
from contextual_image_compression_tpu_torch.ops import bitstream as tbs
from contextual_image_compression_tpu_torch.serve import CompressionPipeline

SERVE_KW = dict(img_size=(64, 64), base_latent_dim=64, generator_base_hw=4)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _latents(seed, b=3, d=96):
    rng = np.random.RandomState(seed)
    hq = (rng.laplace(0, 2, (b, 2 * d))).astype(np.float32)
    lq = (rng.laplace(0, 2, (b, d))).astype(np.float32)
    hs = np.exp(3.0 * rng.rand(b) * 0.9).astype(np.float32)
    ls = np.exp(3.0 * rng.rand(b) * 0.9).astype(np.float32)
    return hq, lq, hs, ls


def _mask(seed, h=64, w=64):
    yy, xx = np.mgrid[0:h, 0:w] / h
    cy, cx = np.random.RandomState(seed).rand(2)
    return np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.05).astype(np.float32)


def test_latent_streams_byte_identical_to_jax():
    assert jnative.available()
    hq, lq, hs, ls = _latents(0)
    assert tbs.pack_latent(hq[0], float(hs[0])) == jbs.pack_latent(hq[0], float(hs[0]))
    sym = np.round(hq * hs[:, None])
    assert tbs.pack_symbols(sym[1], float(hs[1])) == jbs.pack_symbols(sym[1], float(hs[1]))
    lq_sym = np.round(lq * ls[:, None])
    assert (tbs.pack_codec_symbols(sym, lq_sym, hs, ls)
            == jbs.pack_codec_symbols(sym, lq_sym, hs, ls))
    streams = tbs.pack_codec_latents(hq, lq, hs, ls)
    assert streams == jbs.pack_codec_latents(hq, lq, hs, ls)
    np.testing.assert_array_equal(tbs.measured_bpp(streams, (64, 64)),
                                  jbs.measured_bpp(streams, (64, 64)))
    assert tbs.quantizer_scale(0.3, 0.7) == jbs.quantizer_scale(0.3, 0.7)
    assert streams[0][0][1] == tbs.CODER_RANGE


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_latent_streams_cross_decode(direction):
    hq, _, hs, _ = _latents(1)
    writer, reader = (jbs, tbs) if direction == "jax_to_port" else (tbs, jbs)
    own = tbs if writer is tbs else jbs
    stream = writer.pack_latent(hq[2], float(hs[2]))
    got, scale = reader.unpack_latent(stream)
    want, want_scale = own.unpack_latent(stream)
    np.testing.assert_array_equal(got, want)
    assert scale == want_scale == np.float32(hs[2])
    np.testing.assert_array_equal(got, np.round(hq[2] * hs[2]).astype(np.int16) / np.float32(hs[2]))


@pytest.mark.parametrize("downsample", [1, 8])
def test_containers_byte_identical_and_cross_decode(downsample):
    hq, lq, hs, ls = _latents(2, b=1)
    streams = tbs.pack_codec_latents(hq, lq, hs, ls)[0]
    mask = _mask(3)
    np.testing.assert_array_equal(tbs._mask_to_u8(mask, downsample),
                                  jbs._mask_to_u8(mask, downsample))
    ours = tbs.pack_container(*streams, mask, 0.4, (64, 64), downsample)
    theirs = jbs.pack_container(*streams, mask, 0.4, (64, 64), downsample)
    assert ours == theirs
    for blob in (ours, theirs):
        got, want = tbs.unpack_container(blob), jbs.unpack_container(blob)
        assert set(got) == set(want)
        for key in ("hq_latent", "lq_latent", "mask_small"):
            np.testing.assert_array_equal(got[key], want[key])
        for key in ("hq_scale", "lq_scale", "target_bpp", "img_hw"):
            assert got[key] == want[key], key
    assert tbs.unpack_container(ours)["mask_small"].shape == (64 // downsample,) * 2


def test_zlib_payloads_decode_and_bad_headers_raise():
    """Coder 0 (zlib), which the JAX package writes where its range coder
    does not build, decodes; unknown coders, versions and magic raise."""
    sym = np.array([3, -2, 0, 0, 7, -32768, 32767], np.int16)
    zstream = struct.pack("<BBfII", 2, 0, 2.0, sym.size, 0)
    payload = zlib.compress(sym.tobytes(), 6)
    zstream = zstream[:-4] + struct.pack("<I", len(payload)) + payload
    lat, scale = tbs.unpack_latent(zstream)
    np.testing.assert_array_equal(lat, sym.astype(np.float32) / 2.0)
    np.testing.assert_array_equal(lat, jbs.unpack_latent(zstream)[0])
    good = tbs.pack_latent(np.ones(4, np.float32), 1.0)
    with pytest.raises(ValueError, match="version"):
        tbs.unpack_latent(b"\x03" + good[1:])
    with pytest.raises(ValueError, match="coder"):
        tbs.unpack_latent(good[:1] + b"\x05" + good[2:])
    hq, lq, hs, ls = _latents(4, b=1)
    blob = tbs.pack_container(*tbs.pack_codec_latents(hq, lq, hs, ls)[0], _mask(5), 1.0, (64, 64))
    with pytest.raises(ValueError, match="CICZ"):
        tbs.unpack_container(b"XXXX" + blob[4:])
    with pytest.raises(ValueError, match="container version"):
        tbs.unpack_container(blob[:4] + b"\x02" + blob[5:])


def test_encoding_never_falls_back_to_zlib(monkeypatch):
    def broken():
        raise RuntimeError("range coder build failed")

    monkeypatch.setattr(tnative, "library", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        tbs.pack_latent(np.ones(8, np.float32), 1.0)


@pytest.mark.parametrize("shape,threads", [((8, 4096), 4), ((1, 1), 1), ((5, 3000), 0)])
def test_batch_coder_round_trips_and_matches_jax(shape, threads):
    """As tests/test_native_bitstream.py's batch cases: the port's batch
    blob equals the JAX package's and decodes back bit-exactly."""
    rng = np.random.RandomState(shape[1])
    sym = rng.laplace(0, 3, size=shape).astype(np.int16)
    blob = tnative.entropy_encode_batch(sym, num_threads=threads)
    assert blob == jnative.entropy_encode_batch(sym, num_threads=max(threads, 1))
    np.testing.assert_array_equal(tnative.entropy_decode_batch(blob, *shape, num_threads=threads),
                                  sym)
    np.testing.assert_array_equal(jnative.entropy_decode_batch(blob, *shape), sym)
    # each frame is an ordinary single stream
    (n0,) = struct.unpack_from("<I", blob, 0)
    np.testing.assert_array_equal(tnative.entropy_decode(blob[4:4 + n0], shape[1]), sym[0])


def test_batch_decode_rejects_truncated_blobs():
    sym = np.random.RandomState(9).laplace(0, 3, size=(4, 256)).astype(np.int16)
    blob = tnative.entropy_encode_batch(sym)
    with pytest.raises(RuntimeError, match="items decoded"):
        tnative.entropy_decode_batch(blob[: len(blob) // 2], 4, 256)
    with pytest.raises(ValueError):
        tnative.entropy_encode_batch(sym[0])


# ---------------------------------------------------------- decode path

def _images(seed, b=2):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    out = []
    for _ in range(b):
        cy, cx = rng.rand(2)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.02)[..., None] * rng.rand(3)
        edge = (xx > rng.rand())[..., None] * rng.rand(3) * 0.5
        out.append(blob + edge + 0.1 * rng.rand(64, 64, 3))
    return np.clip(np.stack(out) * 200, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module", params=["zero", "mask"])
def pipelines(request):
    """The JAX and the port serving pipelines on the same perturbed weights."""
    jcfg = JModelConfig(**SERVE_KW, skip_mode=request.param)
    v = JCodec(j_serving(jcfg)).init(jax.random.PRNGKey(0), batch_size=1)
    v = perturb_variables(to_numpy_tree(v), np.random.RandomState(21))
    tcfg = ModelConfig(**SERVE_KW, skip_mode=request.param)
    port = CompressionPipeline(state_dict=convert_codec_variables(v, tcfg), model_config=tcfg,
                               device="cpu")
    return JPipeline(variables=v, model_config=jcfg), port


def test_jax_containers_decode_in_the_port(pipelines):
    """Containers written by the JAX pipeline decode through the port's
    generator-only path to the JAX decode of the same bytes: PSNR >= 40 dB;
    and the port's own containers decode in JAX the same way."""
    jpipe, tpipe = pipelines
    u8 = _images(22)
    jstreams = jpipe.encode_to_bitstream(u8, target_bpp=1.0)
    got = tpipe.decode_from_bitstream(jstreams)
    want = jpipe.decode_from_bitstream(jstreams)
    assert got.shape == want.shape == u8.shape and got.dtype == np.uint8
    assert _psnr(got, want) >= 40.0
    tstreams = tpipe.encode_to_bitstream(u8, target_bpp=1.0)
    assert _psnr(jpipe.decode_from_bitstream(tstreams), tpipe.decode_from_bitstream(tstreams)) >= 40.0


@pytest.mark.parametrize("skip_mode", ["zero", "mask"])
def test_decode_latents_matches_jax_float32(skip_mode):
    """AdaptiveCodec.decode_latents in float32 on converted weights."""
    jcfg = JModelConfig(**SERVE_KW, skip_mode=skip_mode)
    jcodec = JCodec(jcfg)
    v = perturb_variables(to_numpy_tree(jcodec.init(jax.random.PRNGKey(1), batch_size=1)),
                          np.random.RandomState(23))
    tcfg = ModelConfig(**SERVE_KW, skip_mode=skip_mode)
    port = AdaptiveCodec(tcfg)
    port.load_state_dict(convert_codec_variables(v, tcfg))
    port.eval()
    rng = np.random.RandomState(24)
    hq = rng.randn(2, 2 * 64).astype(np.float32)
    lq = rng.randn(2, 64).astype(np.float32)
    mask = np.stack([_mask(25), _mask(26)])[..., None]
    bpp = np.array([[0.2], [1.5]], np.float32)
    want = np.asarray(jcodec.decode_latents(v, *(jnp.asarray(a) for a in (hq, lq, mask, bpp))))
    with torch.no_grad():
        got = port.decode_latents(*(torch.from_numpy(a) for a in (hq, lq, mask, bpp))).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.fixture(scope="module")
def zero_skip_pipeline():
    cfg = ModelConfig(**SERVE_KW, skip_mode="zero")
    return CompressionPipeline(model_config=cfg, device="cpu", seed=4)


def test_storable_codec_bitstream_roundtrip(zero_skip_pipeline):
    """The port's counterpart of tests/test_serve.py's: bytes -> image with
    no encoder in the loop matches the direct forward up to the 8x
    downsampled mask: mean |diff| < 4 grey levels."""
    pipe = zero_skip_pipeline
    imgs = np.random.RandomState(27).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    direct, _ = pipe(imgs, target_bpp=1.0)
    streams = pipe.encode_to_bitstream(imgs, target_bpp=1.0, mask_downsample=8)
    assert len(streams) == 2 and all(isinstance(s, bytes) for s in streams)
    decoded = pipe.decode_from_bitstream(streams)
    assert decoded.shape == direct.shape and decoded.dtype == np.uint8
    diff = np.abs(decoded.astype(np.int32) - direct.astype(np.int32))
    assert np.mean(diff) < 4.0, np.mean(diff)
    np.testing.assert_array_equal(pipe.decode_from_bitstream(streams[0])[0], decoded[0])
    with pytest.raises(ValueError, match="image size"):
        pipe.decode_from_bitstream(streams[0][:5] + struct.pack("<H", 32) + streams[0][7:])


def test_storable_codec_mask_fidelity(zero_skip_pipeline):
    """Without mask downsampling only the uint8 mask quantization remains:
    mean |diff| < 1 and max <= 16."""
    pipe = zero_skip_pipeline
    imgs = np.random.RandomState(28).randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    direct, _ = pipe(imgs, target_bpp=0.1)
    decoded = pipe.decode_from_bitstream(
        pipe.encode_to_bitstream(imgs, target_bpp=0.1, mask_downsample=1))
    diff = np.abs(decoded.astype(np.int32) - direct.astype(np.int32))
    assert np.mean(diff) < 1.0 and np.max(diff) <= 16, (np.mean(diff), np.max(diff))


def test_serialize_latents_decode_to_the_quantized_latents(zero_skip_pipeline):
    """As tests/test_serve.py::test_pipeline_latent_bitstreams, and the
    streams are the JAX package's bytes for the same symbols."""
    pipe = zero_skip_pipeline
    imgs = np.random.RandomState(29).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    _, info = pipe(imgs, target_bpp=0.1)
    streams, bpp = pipe.serialize_latents(info)
    assert len(streams) == 2 and bpp.shape == (2,) and np.all(bpp > 0)
    hq, scale = tbs.unpack_latent(streams[0][0])
    want = info["hq_latent_q"].float().numpy()[0]
    np.testing.assert_allclose(hq, np.round(want * scale) / scale,
                               atol=np.abs(want).max() / 256 + 1e-5)
    host = {k: info[k].float().numpy() for k in ("hq_symbols", "lq_symbols", "hq_scale", "lq_scale")}
    assert streams == jbs.pack_codec_symbols(host["hq_symbols"], host["lq_symbols"],
                                             host["hq_scale"], host["lq_scale"])
