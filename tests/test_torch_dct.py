"""The port's DCT baseline codec, its K5 twin, metrics and range coder
against the JAX package.

K5 is a CUDA kernel in the port; on the CPU `dct_strips` runs its plain twin
(the formula of `_dct_strips_jnp`), held here against the JAX Pallas kernel
in interpret mode and against the jnp path. A symbol rint(coef / q) can flip
where coef lies within an ulp of a half step, and the two packages sum the
8-term products in other orders, so the stated floor is "within +-1 and
identical on >= 99.99%"; on these seeded images they come out identical.
Streams must cross-decode, and for equal symbols be byte-identical.
"""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextual_image_compression_tpu import native as jnative
from contextual_image_compression_tpu.config import DCTCodecConfig as JDCTCodecConfig
from contextual_image_compression_tpu.data.images import synthetic_images
from contextual_image_compression_tpu.ops import dct as jdct
from contextual_image_compression_tpu.ops import metrics as jmetrics
from contextual_image_compression_tpu_torch import native as tnative
from contextual_image_compression_tpu_torch.config import DCTCodecConfig
from contextual_image_compression_tpu_torch.ops import dct as tdct
from contextual_image_compression_tpu_torch.ops import metrics as tmetrics


def _assert_symbols(got, want):
    """+-1 everywhere and identical on >= 99.99% (the stated floor); returns
    the share of identical symbols."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1.0
    share = float(np.mean(got == want))
    assert share >= 0.9999, share
    return share


def _assert_rec_on_agreeing_blocks(rec, want, sym, sym_want, atol=1e-4):
    """rec within atol on every 8x8 block (B, C, H, W) whose symbols agree."""
    b, c, h, w = rec.shape
    agree = (sym == sym_want).reshape(b, c, h // 8, 8, w // 8, 8).all(axis=(3, 5))
    err = np.abs(rec - want).reshape(b, c, h // 8, 8, w // 8, 8).max(axis=(3, 5))
    assert agree.mean() >= 0.99
    assert err[agree].max() <= atol, err[agree].max()


def _planes(imgs):
    """Level-shifted YCbCr planes (B, 3, H, W) as both packages make them."""
    ycc = jdct.rgb_to_ycbcr((jnp.asarray(imgs) + 1.0) * 127.5) - 128.0
    return np.ascontiguousarray(np.moveaxis(np.asarray(ycc), -1, 1))


def test_tables_and_transform_exactly_equal():
    np.testing.assert_array_equal(tdct._LUMA_TABLE, jdct._LUMA_TABLE)
    np.testing.assert_array_equal(tdct._CHROMA_TABLE, jdct._CHROMA_TABLE)
    for q in (1, 10, 20, 30, 50, 60, 75, 90, 95, 100):
        for base in (jdct._LUMA_TABLE, jdct._CHROMA_TABLE):
            np.testing.assert_array_equal(tdct.quality_scaled_table(base, q),
                                          jdct.quality_scaled_table(base, q))
        np.testing.assert_array_equal(tdct.quality_tables(q), jdct.DCTCodec._tables_for(q))
    np.testing.assert_array_equal(tdct._dct_matrix(), jdct._dct_matrix())
    np.testing.assert_array_equal(tdct._block_diag_dt(32), jdct._block_diag_dt(32))


def test_colorspace_matches_jax_and_round_trips():
    rgb = np.random.RandomState(1).rand(4, 8, 8, 3).astype(np.float32) * 255
    ycc = tdct.rgb_to_ycbcr(torch.from_numpy(rgb))
    np.testing.assert_allclose(ycc.numpy(), np.asarray(jdct.rgb_to_ycbcr(jnp.asarray(rgb))),
                               atol=1e-4)
    np.testing.assert_allclose(tdct.ycbcr_to_rgb(ycc).numpy(), rgb, atol=1e-2)


def test_k5_twin_matches_pallas_interpret():
    """(2, 32, 32) images at quality 75: the twin against _dct_strips_pallas."""
    imgs = synthetic_images(2, (32, 32), seed=1)
    planes = _planes(imgs)
    codec = jdct.DCTCodec(JDCTCodecConfig(use_pallas=True))
    rec_j, sym_j = jdct._dct_strips_pallas(jnp.asarray(planes.reshape(-1, 8, 32)),
                                           codec._qtable_strips(2, 3, 32, 32))
    before = tdct.dct_strips.launches
    rec, sym = tdct.dct_strips(torch.from_numpy(planes), torch.from_numpy(tdct.quality_tables(75)))
    assert tdct.dct_strips.launches == before  # CPU tensors take the twin
    sym_j = np.asarray(sym_j).reshape(planes.shape)
    assert _assert_symbols(sym.numpy(), sym_j) == 1.0
    _assert_rec_on_agreeing_blocks(rec.numpy(), np.asarray(rec_j).reshape(planes.shape),
                                   sym.numpy(), sym_j)


@pytest.mark.parametrize("quality", [10, 75, 95])
def test_k5_twin_matches_jnp(quality):
    """(2, 64, 64) images: the twin against _dct_strips_jnp."""
    imgs = synthetic_images(2, (64, 64), seed=quality)
    planes = _planes(imgs)
    codec = jdct.DCTCodec(JDCTCodecConfig(quality=quality, use_pallas=False))
    rec_j, sym_j = jdct._dct_strips_jnp(jnp.asarray(planes.reshape(-1, 8, 64)),
                                        codec._qtable_strips(2, 3, 64, 64))
    rec, sym = tdct.dct_strips_plain(torch.from_numpy(planes),
                                     torch.from_numpy(tdct.quality_tables(quality)))
    sym_j = np.asarray(sym_j).reshape(planes.shape)
    assert _assert_symbols(sym.numpy(), sym_j) == 1.0
    _assert_rec_on_agreeing_blocks(rec.numpy(), np.asarray(rec_j).reshape(planes.shape),
                                   sym.numpy(), sym_j)


def test_roundtrip_and_evaluate_match_jax():
    imgs = synthetic_images(2, (64, 64), seed=2)
    want = jdct.DCTCodec(JDCTCodecConfig(use_pallas=False)).evaluate(jnp.asarray(imgs))
    got = tdct.DCTCodec(DCTCodecConfig(), device="cpu").evaluate(imgs)
    assert got["reconstruction"].shape == (2, 64, 64, 3) and got["symbols"].shape == (2, 3 * 64 * 64)
    assert _assert_symbols(got["symbols"].numpy(), want["symbols"]) == 1.0
    np.testing.assert_allclose(got["reconstruction"].numpy(), np.asarray(want["reconstruction"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["bpp"].numpy(), np.asarray(want["bpp"]), rtol=1e-5)
    rec, sym = tdct.DCTCodec(DCTCodecConfig(), device="cpu").roundtrip(torch.from_numpy(imgs))
    np.testing.assert_array_equal(rec.numpy(), got["reconstruction"].numpy())
    np.testing.assert_array_equal(sym.numpy(), got["symbols"].numpy())


def test_quality_ordering_and_gan_metrics_match_jax():
    """PSNR rises with quality through the port's gan_metrics, which is held
    against the JAX package's: PSNR 1e-4 dB, SSIM 1e-5, MSE 1e-6 relative."""
    imgs = synthetic_images(2, (64, 64), seed=0)
    psnrs = {}
    for q in (30, 75, 95):
        rec, _ = tdct.DCTCodec(DCTCodecConfig(quality=q), device="cpu").roundtrip(imgs)
        got = tmetrics.gan_metrics(torch.from_numpy(imgs), rec)
        want = jmetrics.gan_metrics(jnp.asarray(imgs), jnp.asarray(rec.numpy()))
        np.testing.assert_allclose(got["psnr"].numpy(), np.asarray(want["psnr"]), atol=1e-4)
        np.testing.assert_allclose(got["ssim"].numpy(), np.asarray(want["ssim"]), atol=1e-5)
        np.testing.assert_allclose(got["mse"].numpy(), np.asarray(want["mse"]), rtol=1e-6)
        psnrs[q] = float(got["psnr"].mean())
    assert psnrs[30] < psnrs[75] < psnrs[95], psnrs
    assert psnrs[95] > 30


def _stream_image(seed=9, size=64):
    return synthetic_images(1, (size, size), seed=seed)[0]


def test_streams_cross_decode_and_are_byte_identical():
    """A JAX stream decodes in the port within 1e-5 of JAX's own decode, a
    port stream decodes in JAX within 1e-5 of the port's decode, and with
    equal symbols the two streams are the same bytes."""
    img = _stream_image()
    jcodec = jdct.DCTCodec(JDCTCodecConfig(quality=60, use_pallas=False))
    tcodec = tdct.DCTCodec(DCTCodecConfig(quality=60), device="cpu")
    js, ts = jcodec.encode_stream(jnp.asarray(img)), tcodec.encode_stream(img)
    assert js[1] == ts[1] == 1  # the range coder
    _, jsym = jcodec.roundtrip(jnp.asarray(img)[None])
    _, tsym = tcodec.roundtrip(img[None])
    assert _assert_symbols(tsym.numpy(), jsym) == 1.0
    assert ts == js
    np.testing.assert_allclose(tcodec.decode_stream(js).numpy(),
                               np.asarray(jcodec.decode_stream(js)), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jcodec.decode_stream(ts)),
                               tcodec.decode_stream(ts).numpy(), atol=1e-5)
    rec, _ = tcodec.roundtrip(img[None])
    np.testing.assert_allclose(tcodec.decode_stream(ts).numpy(), rec[0].numpy(), atol=1e-5)


def test_zlib_stream_decodes():
    """Coder 0: the JAX package writes zlib payloads where its range coder
    does not build; the port decodes them to the same image."""
    img = _stream_image(seed=4)
    tcodec = tdct.DCTCodec(DCTCodecConfig(quality=75), device="cpu")
    _, sym = tcodec.roundtrip(img[None])
    s16 = np.clip(sym[0].numpy(), -32768, 32767).astype(np.int16)
    zstream = struct.pack("<BBBHH", 2, 0, 75, 64, 64) + zlib.compress(s16.tobytes(), level=6)
    np.testing.assert_array_equal(tcodec.decode_stream(zstream).numpy(),
                                  tcodec.decode_stream(tcodec.encode_stream(img)).numpy())


def test_stream_guards_and_cross_quality_decode():
    img = _stream_image()
    enc = tdct.DCTCodec(DCTCodecConfig(quality=60), device="cpu")
    stream = enc.encode_stream(img)
    with pytest.raises(ValueError, match="version"):
        enc.decode_stream(b"\x09" + stream[1:])
    with pytest.raises(ValueError, match="coder"):
        enc.decode_stream(stream[:1] + b"\x07" + stream[2:])
    other = tdct.DCTCodec(DCTCodecConfig(quality=90), device="cpu")
    np.testing.assert_array_equal(other.decode_stream(stream).numpy(),
                                  enc.decode_stream(stream).numpy())
    assert 0 < enc.measured_bpp(enc.roundtrip(img[None])[1][0].numpy(), (64, 64)) < 24


def test_encoder_raises_when_the_coder_does_not_build(monkeypatch):
    """No zlib fallback: a coder that does not build makes encoding raise."""
    def broken():
        raise RuntimeError("range coder build failed")

    monkeypatch.setattr(tnative, "library", broken)
    codec = tdct.DCTCodec(DCTCodecConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="build failed"):
        codec.encode_stream(_stream_image())
    assert not tnative.available()


@pytest.mark.parametrize("kind", ["laplace", "wide", "zeros", "extremes", "empty"])
def test_range_coder_byte_identical_to_jax(kind):
    rng = np.random.RandomState(len(kind))
    if kind == "laplace":
        s = np.round(rng.laplace(0, 3, 5000))
    elif kind == "wide":
        s = rng.randint(-3000, 3000, 4000)
    elif kind == "zeros":
        s = np.zeros(3000)
    elif kind == "extremes":
        s = np.concatenate([[-32768, 32767, -1, 1, 0], rng.randint(-32768, 32768, 500)])
    else:
        s = np.zeros(0)
    s = s.astype(np.int16)
    assert jnative.available()
    data = tnative.entropy_encode(s)
    assert data == jnative.entropy_encode(s)
    np.testing.assert_array_equal(tnative.entropy_decode(data, s.size), s)
    assert tnative.available()


def test_codec_options_and_device_guards(monkeypatch):
    # use_pallas=False (it raised before the port had the route) runs
    # `dct_strips_plain`, JAX's `_dct_strips_jnp` formula: the round trip equals JAX's with that flag
    # (symbols equal, images within 1e-6; tests/test_torch_options.py holds
    # more)
    imgs = synthetic_images(2, (32, 32), seed=4)
    rec, sym = tdct.DCTCodec(DCTCodecConfig(use_pallas=False), device="cpu").roundtrip(imgs)
    jrec, jsym = jdct.DCTCodec(JDCTCodecConfig(use_pallas=False)).roundtrip(jnp.asarray(imgs))
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=1e-6)
    with pytest.raises(ValueError):
        tdct.dct_strips(torch.zeros(1, 3, 12, 16), torch.zeros(3, 8, 8))
    with pytest.raises(ValueError):  # a meta tensor is neither CPU nor CUDA
        tdct.dct_strips(torch.zeros(1, 3, 8, 8, device="meta"), torch.zeros(3, 8, 8, device="meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdct.DCTCodec(DCTCodecConfig())
