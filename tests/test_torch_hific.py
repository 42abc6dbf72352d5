"""HiFiC in the port (models/hific.py, `CompressionPipeline` with a
`HiFiCConfig`) against the plain reference (tests/reference_hific.py, which
is the benchmark's portbench/reference/hific.py), on the CPU at a small
width, on seeded weights; the stride-2 SAME transposed convolutions of
`KConvT`; the five hific spans; the served channels_last layout. No JAX."""

import contextlib
import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import reference_hific as ref
from contextual_image_compression_tpu_torch.config import HiFiCConfig
from contextual_image_compression_tpu_torch.models.hific import ChannelNorm, HiFiCCodec
from contextual_image_compression_tpu_torch.models.layers import KConv, KConvT
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


def test_pipeline_codec_is_the_seeded_codec_in_its_serving_form():
    """A pipeline's HiFiC codec equals HiFiCCodec seeded by the same seed
    and passed through prepare_serving, bit for bit: in bf16 every layer but
    the prior of z cast, in eval mode, no gradients."""
    cfg = dataclasses.replace(SMALL, dtype="bfloat16")
    got = CompressionPipeline(model_config=cfg, device="cpu", seed=7).codec
    want = HiFiCCodec(cfg)
    want.reset_parameters(7)
    want = want.prepare_serving()
    got_sd, want_sd = got.state_dict(), want.state_dict()
    assert list(got_sd) == list(want_sd)
    for k, v in want_sd.items():
        assert got_sd[k].dtype == v.dtype and torch.equal(got_sd[k], v), k
        assert v.dtype == (torch.float32 if k.startswith("z_prior.") else torch.bfloat16), k
    assert not got.training and not any(p.requires_grad for p in got.parameters())


def test_hific_pipeline_refuses_what_it_does_not_serve(pipe):
    with pytest.raises(ValueError):
        CompressionPipeline(model_config=SMALL, device="cpu", model_dir="nowhere")
    with pytest.raises(TypeError):
        pipe.warmup(1)
    with pytest.raises(TypeError):
        pipe.encode_to_bitstream(_images(1, 64, 64))
    with pytest.raises(TypeError):
        pipe.decode_from_bitstream(b"")


# ---- the served layout: channels_last ---------------------------------------

SERVED_PARTS = ("analysis", "synthesis", "hyper_analysis", "hyper_mean", "hyper_scale")
CL = torch.channels_last
# widths that are no multiple of 8, as the published 60: the serving form
# pads E's rows of 6, 12, 20 and G's of 20, 12, 6 channels to 8, 16, 24
ODD = HiFiCConfig(encoder_filters=(6, 12, 16, 20, 32), latent_channels=8, hyper_channels=8,
                  residual_blocks=2, dtype="float32")


def _nchw_network(codec):
    """A copy of the codec held in NCHW, the layout it was served in before
    channels_last: contiguous weights, and hooks that turn every layer's
    input back to contiguous NCHW."""
    old = copy.deepcopy(codec)
    for mod in old.modules():
        if isinstance(mod, (KConv, KConvT)):
            mod.weight.data = mod.weight.data.contiguous()
        if isinstance(mod, (KConv, KConvT, ChannelNorm)):
            mod.register_forward_pre_hook(lambda m, args: (args[0].contiguous(), *args[1:]))
    return old


def _upload_before(u8, cfg):
    """`_run_hific`'s input as it was before: an NCHW copy in float32, /
    255, padded by reflection, cast to the compute dtype."""
    _, h, w, _ = u8.shape
    x = torch.from_numpy(u8).permute(0, 3, 1, 2).float().contiguous() / 255.0
    k = cfg.stride
    if h % k or w % k:
        x = torch.nn.functional.pad(x, (0, -w % k, 0, -h % k), mode="reflect")
    return x.to(cfg.compute_dtype())


@pytest.mark.parametrize("part", SERVED_PARTS)
def test_serving_form_holds_channels_last_weights(part):
    cfg = dataclasses.replace(SMALL, dtype="bfloat16")
    codec = HiFiCCodec(cfg)
    codec.reset_parameters(7)
    convs = [m for m in getattr(codec, part).modules() if isinstance(m, (KConv, KConvT))]
    assert convs and not any(m.weight.is_contiguous(memory_format=CL) for m in convs)
    codec = codec.prepare_serving()
    for mod in convs:
        assert mod.weight.is_contiguous(memory_format=CL) and not mod.weight.is_contiguous()
        assert mod.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_serving_apply_keeps_every_layer_channels_last(pipe, layout):
    """Every KConv / KConvT and ChannelNorm of a serving call gets a
    channels_last input, whatever x's layout: a layer that fell back to NCHW
    would bring cuDNN's layout transposes back on the card."""
    x = torch.from_numpy(_images(2, 128, 192)).permute(0, 3, 1, 2).float() / 255.0
    x = x.contiguous(memory_format=CL if layout == "channels_last" else torch.contiguous_format)
    seen, handles = [], []
    for name, mod in pipe.codec.named_modules():
        if isinstance(mod, (KConv, KConvT, ChannelNorm)):
            handles.append(mod.register_forward_pre_hook(
                lambda m, args, name=name: seen.append(
                    (name, args[0].is_contiguous(memory_format=CL)))))
    try:
        with torch.no_grad():
            out = pipe.codec.apply(x)
    finally:
        for h in handles:
            h.remove()
    assert len(seen) == len(handles)  # each layer once a call
    assert [name for name, ok in seen if not ok] == []
    assert out.x_hat.is_contiguous(memory_format=CL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_in_either_layout_matches_the_nchw_network(dtype):
    """An NCHW x and a channels_last copy of it give the same bits (apply
    turns NCHW to channels_last once at entry), and both match the network
    held in NCHW, the form served before: the same symbols; x_hat within
    1e-5 in float32 (the CPU's convolutions sum in another order in each
    layout; measured 4.8e-7) and within a bf16 ulp at 1.0 in bfloat16
    (measured 0); bits within 1e-5 relative (measured 1.2e-7)."""
    cfg = dataclasses.replace(SMALL, dtype=dtype)
    codec = HiFiCCodec(cfg)
    codec.reset_parameters(7)
    codec = codec.prepare_serving()
    x = _upload_before(_images(2, 128, 192), cfg)
    with torch.no_grad():
        a = codec.apply(x)
        b = codec.apply(x.contiguous(memory_format=CL))
        before = _nchw_network(codec).apply(x)
    for k in a._fields:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(a.y_symbols, before.y_symbols)
    assert torch.equal(a.z_symbols, before.z_symbols)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert float((a.x_hat.float() - before.x_hat.float()).abs().max()) <= tol
    assert float(((a.bits - before.bits).abs() / before.bits).max()) <= 1e-5


@pytest.mark.parametrize("size", [(128, 192), (130, 200)])
def test_pipeline_output_is_unchanged_and_c_contiguous(pipe, size):
    """The pipeline reads the upload as a channels_last view and hands back
    the permuted channels_last x_hat without a copy: the same uint8 images
    as the NCHW copy in and the transposing copy out gave, as a C-contiguous
    (B, H, W, 3) array."""
    u8 = _images(2, *size, seed=5)
    decoded, _ = pipe(u8)
    with torch.no_grad():
        x_hat = pipe.codec.apply(_upload_before(u8, SMALL)).x_hat
    want = torch.clamp(torch.round(x_hat[:, :, :size[0], :size[1]].float() * 255.0), 0, 255)
    want = want.to(torch.uint8).permute(0, 2, 3, 1).contiguous().numpy()
    assert decoded.shape == (2,) + size + (3,) and decoded.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(decoded, want)


def test_serving_form_pads_rows_to_whole_16_bytes():
    codec = HiFiCCodec(ODD)
    codec.reset_parameters(7)
    before = {k: v.clone() for k, v in codec.state_dict().items()}
    served = codec.prepare_serving().state_dict()
    widths = {"analysis.conv0.weight": (8, 3), "analysis.down.0.weight": (16, 8),
              "analysis.down.1.weight": (16, 16), "analysis.down.2.weight": (24, 16),
              "analysis.down.3.weight": (32, 24), "synthesis.up.0.weight": (32, 24),
              "synthesis.up.1.weight": (24, 16), "synthesis.up.2.weight": (16, 16),
              "synthesis.up.3.weight": (16, 8), "synthesis.out.weight": (3, 8)}
    biases = {"analysis.conv0.bias": 8, "analysis.down.0.bias": 16, "analysis.down.2.bias": 24,
              "synthesis.up.0.bias": 24, "synthesis.up.2.bias": 16, "synthesis.up.3.bias": 8}
    for k, v in before.items():
        got = served[k]
        if k in widths:
            assert tuple(got.shape[:2]) == widths[k], k
        elif k in biases:
            assert tuple(got.shape) == (biases[k],), k
        else:
            assert got.shape == v.shape, k
        inner = tuple(slice(0, n) for n in v.shape)
        assert torch.equal(got[inner], v), k
        rest = got.clone()
        rest[inner] = 0
        assert not rest.any(), k  # the padding is zeros


def test_padded_rows_match_the_reference():
    """A pipeline at widths that pad (ODD) against the plain reference on
    the unpadded weights, at the bars of test_port_matches_reference."""
    pipe = CompressionPipeline(model_config=ODD, device="cpu", seed=7)
    codec = HiFiCCodec(ODD)
    codec.reset_parameters(7)
    params = {k: v.detach().clone() for k, v in codec.state_dict().items()}
    u8 = _images(2, 128, 192)
    decoded, info = pipe(u8)
    gaps = _gaps(decoded, info, ref.serve(params, _model(ODD), torch.from_numpy(u8)))
    assert _within(gaps), gaps
