"""HiFiC in the port (models/hific.py, `CompressionPipeline` with a
`HiFiCConfig`) against the plain reference (tests/reference_hific.py, which
is the benchmark's portbench/reference/hific.py), on the CPU at a small
width, on seeded weights; the stride-2 SAME transposed convolutions of
`KConvT`; the five hific spans. No JAX."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import reference_hific as ref
from contextual_image_compression_tpu_torch.config import HiFiCConfig
from contextual_image_compression_tpu_torch.models.hific import HiFiCCodec
from contextual_image_compression_tpu_torch.models.layers import KConvT
from contextual_image_compression_tpu_torch.serve import CompressionPipeline
from contextual_image_compression_tpu_torch.utils import profiling

SMALL = HiFiCConfig(encoder_filters=(8, 16, 16, 32, 32), latent_channels=8, hyper_channels=8,
                    residual_blocks=2, dtype="float32")
HIFIC_SPANS = ("hific.analysis", "hific.hyper", "hific.synthesis", "hific.resblocks",
               "hific.norm")

# Float32 against float32, the same weights: the port and the reference sum
# in different orders (var_mean, addcmul, conv_transpose2d against the
# dilated convolution), ~1e-6 relative. A y or z symbol flips only where
# y - mu lands that close to a half, which the seeds here never do; bits
# then agree to float32 sums over ~3000 terms.
DECODED_LEVELS = 1       # |decoded - reference| in uint8 levels, every value
SYMBOL_FLIPS = 0.0       # share of y and z symbols that differ
BITS_REL = 1e-4          # relative gap in bits per image


def _model(cfg):
    return {k: v for k, v in vars(cfg).items()}


def _images(b, h, w, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (b, 1, 1, 3))
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = ((yy[None, :, :, None] * 3 + xx[None, :, :, None] * 2) % 97).astype(np.int64)
    noise = rng.randint(-20, 21, (b, h, w, 3))
    return np.clip(base // 2 + ramp + noise, 0, 255).astype(np.uint8)


def _gaps(got_decoded, got, want):
    d = np.abs(got_decoded.astype(np.int32) - want["decoded"].numpy().astype(np.int32))
    sym = torch.cat([(got["y_symbols"] != want["y_symbols"]).flatten(),
                     (got["z_symbols"] != want["z_symbols"]).flatten()])
    bits = float(((got["bits"] - want["bits"]).abs() / want["bits"].abs()).max())
    return {"decoded_max": int(d.max()), "symbol_flips": float(sym.float().mean()),
            "bits_rel": bits}


def _within(g):
    return (g["decoded_max"] <= DECODED_LEVELS and g["symbol_flips"] <= SYMBOL_FLIPS
            and g["bits_rel"] <= BITS_REL)


@pytest.fixture(scope="module")
def pipe():
    return CompressionPipeline(model_config=SMALL, device="cpu", seed=7)


@pytest.fixture(scope="module")
def params(pipe):
    return {k: v.detach().clone() for k, v in pipe.codec.state_dict().items()}


@pytest.mark.parametrize("size", [(128, 192), (130, 200)])
def test_port_matches_reference(pipe, params, size):
    """128x192 runs unpadded; 130x200 is padded by reflection to 192x256
    and cropped back."""
    u8 = _images(2, *size)
    decoded, info = pipe(u8)
    assert decoded.shape == (2,) + size + (3,) and decoded.dtype == np.uint8
    ph, pw = -(-size[0] // 64) * 64, -(-size[1] // 64) * 64
    assert tuple(info["y_symbols"].shape) == (2, 8, ph // 16, pw // 16)
    assert tuple(info["z_symbols"].shape) == (2, 8, ph // 64, pw // 64)
    want = ref.serve(params, _model(SMALL), torch.from_numpy(u8))
    gaps = _gaps(decoded, info, want)
    assert _within(gaps), gaps
    # the seeded weights exercise the clamps without living in them
    assert float(want["sigma_at_bound"]) < 0.01
    assert ((decoded == 0) | (decoded == 255)).mean() < 0.01
    assert len(torch.unique(info["y_symbols"])) >= 5


def test_padding_follows_the_encoder_depth():
    """Four encoder filters halve the image three times, so the stride is
    32 and a 70x100 image is padded to 96x128, in the port and in the
    reference alike."""
    cfg = HiFiCConfig(encoder_filters=(8, 16, 16, 32), latent_channels=8, hyper_channels=8,
                      residual_blocks=2, dtype="float32")
    assert cfg.stride == 32
    pipe = CompressionPipeline(model_config=cfg, device="cpu", seed=7)
    u8 = _images(2, 70, 100)
    decoded, info = pipe(u8)
    assert decoded.shape == (2, 70, 100, 3)
    assert tuple(info["z_symbols"].shape) == (2, 8, 3, 4)
    p = {k: v.detach().clone() for k, v in pipe.codec.state_dict().items()}
    gaps = _gaps(decoded, info, ref.serve(p, _model(cfg), torch.from_numpy(u8)))
    assert _within(gaps), gaps


def test_pad_is_reflection_and_crop(pipe, params):
    u8 = _images(1, 130, 200, seed=3)
    padded = np.pad(u8, ((0, 0), (0, 62), (0, 56), (0, 0)), mode="reflect")
    small, info = pipe(u8)
    big, big_info = pipe(padded)
    np.testing.assert_array_equal(small, big[:, :130, :200])
    torch.testing.assert_close(info["y_symbols"], big_info["y_symbols"], rtol=0, atol=0)


def test_fp8_control_fails_the_tolerances(params):
    """The reference with float8 products and stored results (one step
    below the program's bfloat16) put in the program's place."""
    u8 = torch.from_numpy(_images(2, 128, 192))
    want = ref.serve(params, _model(SMALL), u8)
    got = ref.serve(params, _model(SMALL), u8, ref.FP8)
    gaps = _gaps(got["decoded"].numpy(), got, want)
    assert not _within(gaps), gaps


def test_bf16_serving_follows_the_reference_roundings():
    """The port in bfloat16 against the reference rounded where the port
    rounds (`ref.BF16`): the same values but for the order of float32 sums
    inside a product. At this width one flipped y symbol of ~1600 moves
    ChannelNorm's statistics over 8 channels, so the decoded images differ
    around it; the float32 reference, which rounds nowhere, is several
    times further off on every number (measured: flips 1 / 5, values more
    than 3 levels off 1.6% / 8.4%, mean level gap 0.30 / 1.25)."""
    cfg = HiFiCConfig(encoder_filters=SMALL.encoder_filters, latent_channels=8,
                      hyper_channels=8, residual_blocks=2)
    pipe = CompressionPipeline(model_config=cfg, device="cpu", seed=7)
    p = {k: v.detach().float() for k, v in pipe.codec.state_dict().items()}
    u8 = _images(2, 128, 192)
    decoded, info = pipe(u8)
    gaps = {}
    for name, rnd in (("bf16", ref.BF16), ("float32", ref.FLOAT32)):
        want = ref.serve(p, _model(cfg), torch.from_numpy(u8), rnd)
        d = np.abs(decoded.astype(np.int32) - want["decoded"].numpy().astype(np.int32))
        gaps[name] = dict(_gaps(decoded, info, want), far=float((d > 3).mean()),
                          mean=float(d.mean()))
    for k in ("symbol_flips", "bits_rel", "far", "mean"):
        assert gaps["bf16"][k] * 3 <= gaps["float32"][k], gaps


@pytest.mark.parametrize("kernel", [3, 4, 5])
@pytest.mark.parametrize("hw", [(5, 7), (8, 6)])
def test_kconvt_same_routes_match_the_written_out_transpose(kernel, hw):
    gen = torch.Generator().manual_seed(kernel)
    layer = KConvT(6, 4, kernel)
    layer.reset_parameters(gen)
    with torch.no_grad():
        layer.bias.uniform_(-0.5, 0.5, generator=gen)
    x = torch.randn((2, 6) + hw, generator=gen)
    got = layer(x)
    assert got.shape == (2, 4, 2 * hw[0], 2 * hw[1])
    p = {"t.weight": layer.weight.detach(), "t.bias": layer.bias.detach()}
    torch.testing.assert_close(got, ref.conv_t(p, "t", x), rtol=1e-5, atol=1e-5)


def test_kconvt_4x4_route_unchanged():
    """The codec's 4x4 deconv keeps its code: bit for bit the library's
    transposed convolution with padding 1, and the polyphase lowering."""
    gen = torch.Generator().manual_seed(0)
    layer, poly = KConvT(6, 4), KConvT(6, 4, polyphase=True)
    layer.reset_parameters(gen)
    poly.load_state_dict(layer.state_dict())
    x = torch.randn(2, 6, 5, 7, generator=gen)
    want = torch.nn.functional.conv_transpose2d(x, layer.weight, stride=2, padding=1)
    torch.testing.assert_close(layer(x), want + layer.bias[:, None, None], rtol=0, atol=0)
    torch.testing.assert_close(poly(x), layer(x), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        KConvT(6, 4, 3, polyphase=True)
    with pytest.raises(ValueError):
        KConvT(6, 4, 7)


def test_published_widths_and_shape_table():
    with torch.device("meta"):
        codec = HiFiCCodec(HiFiCConfig())
    count = {name: sum(p.numel() for p in getattr(codec, name).parameters())
             for name in ("analysis", "synthesis", "hyper_analysis", "hyper_mean",
                          "hyper_scale", "z_prior")}
    assert 181.4e6 < sum(count.values()) - count["z_prior"] < 181.5e6
    assert HiFiCConfig().stride == 64 and SMALL.stride == 64
    assert {k: tuple(v.shape) for k, v in codec.state_dict().items()} == \
        ref.shapes(_model(HiFiCConfig()))


def test_hific_spans_open_only_under_a_profiler(pipe, monkeypatch, tmp_path):
    u8 = _images(1, 64, 64)
    entered = []

    @contextlib.contextmanager
    def record(name):
        entered.append(name)
        yield

    with monkeypatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", record)
        pipe(u8)
    assert entered == []
    with profiling.trace(str(tmp_path)):
        pipe(u8)
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") in HIFIC_SPANS), key=lambda s: s[1])
    counts = {n: sum(s[0] == n for s in spans) for n in HIFIC_SPANS}
    assert counts == {"hific.analysis": 1, "hific.hyper": 1, "hific.synthesis": 1,
                      "hific.resblocks": 1, "hific.norm": 5 + 2 + 2 * 2 + 4}
    top = {s[0]: s for s in spans if s[0] != "hific.norm"}
    assert top["hific.analysis"][2] <= top["hific.hyper"][1] <= top["hific.synthesis"][1]
    assert top["hific.synthesis"][1] <= top["hific.resblocks"][1]
    assert top["hific.resblocks"][2] <= top["hific.synthesis"][2]
    assert all(top["hific.hyper"][2] <= s[1] or s[2] <= top["hific.hyper"][1]
               for s in spans if s[0] == "hific.norm")
    assert set(HIFIC_SPANS) <= set(profiling.SPANS)


def test_hific_pipeline_refuses_what_it_does_not_serve(pipe):
    with pytest.raises(ValueError):
        CompressionPipeline(model_config=SMALL, device="cpu", model_dir="nowhere")
    with pytest.raises(TypeError):
        pipe.warmup(1)
    with pytest.raises(TypeError):
        pipe.encode_to_bitstream(_images(1, 64, 64))
    with pytest.raises(TypeError):
        pipe.decode_from_bitstream(b"")
