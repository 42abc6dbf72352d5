"""TCM in the port (models/tcm.py, `CompressionPipeline` with a `TCMConfig`)
against the plain reference (tests/reference_tcm.py, which is the
benchmark's portbench/reference/tcm.py), on the CPU at a small width, on
seeded float32 weights: the whole codec, W and SW attention against the
reference's dense same-window / same-region test, GDN and IGDN, the slice
chain's dependence, the reflection padding, the spans and the counters.
No JAX."""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import reference_tcm as ref
from contextual_image_compression_tpu_torch.config import TCMConfig
from contextual_image_compression_tpu_torch.models import tcm
from contextual_image_compression_tpu_torch.models.tcm import GDN, WMSA, TCMCodec
from contextual_image_compression_tpu_torch.serve import CompressionPipeline
from contextual_image_compression_tpu_torch.utils import profiling

SMALL = TCMConfig(n=32, m=40, head_dims=(8, 16, 16, 16, 16, 8), hyper_head_dim=16,
                  swatten_dim=32, swatten_head_dim=16, cc_widths=(24, 16), z_channels=24,
                  dtype="float32")
TCM_SPANS = ("tcm.analysis", "tcm.hyper", "tcm.slices", "tcm.synthesis", "tcm.swin")

# Float32 against float32, the same weights: the port and the reference sum
# in different orders (cuDNN-style convolutions against F.pad + conv2d, the
# library's attention against the reference's dense chunks, GDN's 1x1
# product against an einsum), ~1e-6 relative. A y or z symbol flips only
# where y - mu lands that close to a half, which the seeds here never do;
# bits then agree to float32 sums over ~2000 terms.
DECODED_LEVELS = 1       # |decoded - reference| in uint8 levels, every value
SYMBOL_FLIPS = 0.0       # share of y and z symbols that differ
BITS_REL = 1e-4          # relative gap in bits per image
# One layer against the reference's: float32 sums in another order.
LAYER_ATOL = 1e-5


def _model(cfg):
    return {k: list(v) if isinstance(v, tuple) else v for k, v in vars(cfg).items()}


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


@pytest.mark.parametrize("size", [(128, 128), (256, 128)])
def test_port_matches_reference(pipe, params, size):
    u8 = _images(2, *size)
    decoded, info = pipe(u8)
    assert decoded.shape == (2,) + size + (3,) and decoded.dtype == np.uint8
    assert tuple(info["y_symbols"].shape) == (2, 40, size[0] // 16, size[1] // 16)
    assert tuple(info["z_symbols"].shape) == (2, 24, size[0] // 64, size[1] // 64)
    want = ref.serve(params, _model(SMALL), torch.from_numpy(u8))
    gaps = _gaps(decoded, info, want)
    assert _within(gaps), gaps
    # the seeded weights exercise the clamps without living in them
    assert float(want["sigma_at_bound"]) < 0.01
    assert ((decoded == 0) | (decoded == 255)).mean() < 0.05
    assert len(torch.unique(info["y_symbols"])) >= 5


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("hw,win,hd", [((16, 24), 8, 8), ((8, 12), 4, 16)])
def test_window_attention_matches_the_dense_mask(pipe, params, shifted, hw, win, hd):
    """WMSA alone against the reference's attention, which tests each pair
    of tokens for the same window and, shifted, the same region of the
    rolled image; and the reference of the other type is far off, so a
    wrong roll, mask or bias index shows."""
    layer = WMSA(32, hd, win, shifted)
    gen = torch.Generator().manual_seed(win + shifted)
    for p in layer.parameters():
        with torch.no_grad():
            p.uniform_(-0.5, 0.5, generator=gen)
    x = torch.randn((2,) + hw + (32,), generator=gen)
    p = {f"a.{k}": v.detach() for k, v in layer.state_dict().items()}
    with torch.no_grad():
        got = layer(x)
    want = ref.wmsa(p, "a", x, hd, win, shifted)
    torch.testing.assert_close(got, want, rtol=0, atol=LAYER_ATOL)
    other = ref.wmsa(p, "a", x, hd, win, not shifted)
    assert float((got - other).abs().max()) > 1e-2
    no_bias = dict(p, **{"a.relative_position_params": torch.zeros_like(
        p["a.relative_position_params"])})
    assert float((got - ref.wmsa(no_bias, "a", x, hd, win, shifted)).abs().max()) > 1e-2


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_reference(inverse):
    layer = GDN(16, inverse)
    gen = torch.Generator().manual_seed(int(inverse))
    with torch.no_grad():
        layer.beta.uniform_(-0.1, 1.5, generator=gen)  # some under the bound
        layer.gamma.uniform_(-0.05, 0.4, generator=gen)
    x = torch.randn(2, 16, 6, 5, generator=gen) * 2
    p = {f"g.{k}": v.detach() for k, v in layer.state_dict().items()}
    with torch.no_grad():
        got = layer(x)
        layer.serve(torch.float32)
        served = layer(x)
    torch.testing.assert_close(got, ref.gdn(p, "g", x, inverse), rtol=1e-5, atol=LAYER_ATOL)
    assert torch.equal(got, served)
    beta, gamma = (t.detach() for t in layer.effective())
    assert float(beta.min()) >= 1e-6 - 1e-12 and float(gamma.min()) >= -1e-12


def test_slice_chain_feeds_each_slice_into_the_next(pipe):
    """Moving slice 0's symbols (its y by one) moves mu of slice 1 (through
    SWAtten's support and the LRP) and leaves slice 0's mu as it was."""
    codec = pipe.codec
    x = torch.from_numpy(_images(1, 128, 128)).permute(0, 3, 1, 2).float() / 255.0
    mus = []
    hooks = [codec.cc_mean_transforms[i].register_forward_hook(
        lambda m, a, out: mus.append(out.detach().clone())) for i in (0, 1)]
    try:
        with torch.no_grad():
            y = codec.g_a(x)
            z_hat = codec.h_a(y).round()
            bars = codec.h_mean_s(z_hat), codec.h_scale_s(z_hat)
            sym, _, _ = codec.slices(y, *bars)
            moved = y.clone()
            moved[:, :8] += 1.0
            moved_sym, _, _ = codec.slices(moved, *bars)
    finally:
        for h in hooks:
            h.remove()
    (mu0, mu1), (mu0b, mu1b) = mus[:2], mus[2:]
    assert torch.equal(moved_sym[:, :8], sym[:, :8] + 1.0)
    assert torch.equal(mu0, mu0b)
    assert float((mu1 - mu1b).abs().max()) > 1e-3


def test_pipeline_pads_by_reflection_and_crops(pipe, params):
    """130x200 is padded by reflection to 256x256 and cropped back: the
    same as the padded image served whole; held to the reference too."""
    u8 = _images(1, 130, 200, seed=3)
    padded = np.pad(u8, ((0, 0), (0, 126), (0, 56), (0, 0)), mode="reflect")
    small, info = pipe(u8)
    big, big_info = pipe(padded)
    assert small.shape == (1, 130, 200, 3)
    np.testing.assert_array_equal(small, big[:, :130, :200])
    torch.testing.assert_close(info["y_symbols"], big_info["y_symbols"], rtol=0, atol=0)
    assert tuple(info["y_symbols"].shape) == (1, 40, 16, 16)
    gaps = _gaps(small, info, ref.serve(params, _model(SMALL), torch.from_numpy(u8)))
    assert _within(gaps), gaps


def test_bf16_serving_misses_the_float32_bars():
    """The bf16 serving form against the float32 reference misses the
    float32 bars above (symbols flip; values move by several levels)."""
    cfg = dataclasses.replace(SMALL, dtype="bfloat16")
    pipe = CompressionPipeline(model_config=cfg, device="cpu", seed=7)
    codec = TCMCodec(cfg)
    codec.reset_parameters(7)
    p = {k: v.detach().float() for k, v in codec.state_dict().items()}
    u8 = _images(2, 128, 128)
    decoded, info = pipe(u8)
    gaps = _gaps(decoded, info, ref.serve(p, _model(cfg), torch.from_numpy(u8)))
    assert not _within(gaps), gaps


def _window_counts(b, h, w, cfg):
    """Windows a call attends of each type: every Block attends its
    stage's grid once, plain or shifted (the pairs of each stage)."""
    sb, win, hw = cfg.stage_blocks, cfg.window, cfg.hyper_window
    grid = [(2, win, sb[0] + sb[5]), (4, win, sb[1] + sb[4]), (8, win, sb[2] + sb[3]),
            (32, hw, sb[0] + 2 * sb[3]), (16, win, 4 * cfg.num_slices)]
    return b * sum((h // f // k) * (w // f // k) * n // 2 for f, k, n in grid)


def test_window_and_slice_counters(pipe):
    tcm.reset_counts()
    assert tcm.counts() == {"windows_plain": 0, "windows_shifted": 0, "slice_steps": 0}
    pipe(_images(2, 256, 128))
    n = _window_counts(2, 256, 128, SMALL)
    assert n == 2 * (2 * 128 + 2 * 32 + 2 * 8 + 3 * 2 + 10 * 2)
    assert tcm.counts() == {"windows_plain": n, "windows_shifted": n, "slice_steps": 5}
    pipe(_images(1, 130, 200))  # padded to 256 x 256, and to the batch of 2 already run
    assert tcm.counts()["windows_shifted"] == n + _window_counts(2, 256, 256, SMALL)
    assert tcm.counts()["slice_steps"] == 10


def test_tcm_spans_open_only_under_a_profiler(pipe, monkeypatch, tmp_path):
    u8 = _images(1, 128, 128)
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
                    and e.get("name") in TCM_SPANS), key=lambda s: s[1])
    counts = {n: sum(s[0] == n for s in spans) for n in TCM_SPANS}
    assert counts == {"tcm.analysis": 1, "tcm.hyper": 1, "tcm.slices": 1, "tcm.synthesis": 1,
                      "tcm.swin": 6 + 6 + 2 + 2 + 2 + 20}
    top = [s for s in spans if s[0] != "tcm.swin"]
    assert [s[0] for s in top] == ["tcm.analysis", "tcm.hyper", "tcm.slices", "tcm.synthesis"]
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    swin = [s for s in spans if s[0] == "tcm.swin"]
    assert all(any(t[1] <= s[1] and s[2] <= t[2] for t in top) for s in swin)
    assert sum(top[2][1] <= s[1] <= top[2][2] for s in swin) == 20  # the SWAttens'
    assert set(TCM_SPANS) <= set(profiling.SPANS)


def test_serving_form_is_made_once():
    """prepare_serving keeps GDN's effective parameters and each Block's
    masks (1 for W, 4 for SW) in the compute dtype, casts every layer but
    the prior of z and turns convolution weights channels_last; the served
    codec computes what the unprepared one does."""
    codec = TCMCodec(dataclasses.replace(SMALL, dtype="bfloat16"))
    codec.reset_parameters(7)
    gdns = [m for m in codec.modules() if isinstance(m, GDN)]
    msas = [m for m in codec.modules() if isinstance(m, WMSA)]
    beta, gamma = gdns[0].effective()
    codec.prepare_serving()
    assert all(g._served is not None for g in gdns)
    assert torch.equal(gdns[0]._served[0], beta)
    assert torch.equal(gdns[0]._served[1][:, :, 0, 0], gamma.to(torch.bfloat16))
    for m in msas:
        assert m._masks.dtype == torch.bfloat16
        assert m._masks.shape == (4 if m.shifted else 1, m.heads) + (m.window ** 2,) * 2
        assert bool(torch.isinf(m._masks[1:]).any()) == m.shifted
    for name, p in codec.named_parameters():
        assert p.dtype == (torch.float32 if name.startswith("entropy_bottleneck.")
                           else torch.bfloat16), name
        if p.ndim == 4:
            assert p.is_contiguous(memory_format=torch.channels_last), name
    assert not codec.training and not any(p.requires_grad for p in codec.parameters())

    float_codec = TCMCodec(SMALL)
    float_codec.reset_parameters(7)
    x = torch.from_numpy(_images(1, 128, 128)).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        before = float_codec.apply(x)
        after = float_codec.prepare_serving().apply(x)
    assert torch.equal(before.y_symbols, after.y_symbols)
    torch.testing.assert_close(after.x_hat, before.x_hat, rtol=0, atol=1e-5)


def test_published_widths_and_shape_table():
    with torch.device("meta"):
        codec = TCMCodec(TCMConfig())
    total = sum(p.numel() for p in codec.parameters())
    assert total == 76_567_764
    assert TCMConfig().stride == 128 and SMALL.stride == 128
    assert {k: tuple(v.shape) for k, v in codec.state_dict().items()} == \
        ref.shapes(_model(TCMConfig()))


def test_tcm_pipeline_refuses_what_it_does_not_serve(pipe):
    with pytest.raises(ValueError):
        CompressionPipeline(model_config=SMALL, device="cpu", model_dir="nowhere")
    with pytest.raises(TypeError):
        pipe.warmup(1)
    with pytest.raises(TypeError):
        pipe.encode_to_bitstream(_images(1, 128, 128))
    with pytest.raises(TypeError):
        pipe.decode_from_bitstream(b"")
