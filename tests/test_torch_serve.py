"""The PyTorch port's serving pipeline against the JAX CompressionPipeline,
plus the port's import and device guards.

Both pipelines get the same float32 weights (random BN stats, SAGAN gamma
0.5) and the same uint8 images, and each applies the serving configuration
itself: bfloat16 compute, w8 latent/fc projections, the folded int8 tail.
"""

import ast
import copy
import pathlib

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import perturb_variables, to_numpy_tree

from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.models.adaptive import AdaptiveCodec as JCodec
from contextual_image_compression_tpu.serve import CompressionPipeline as JPipeline
from contextual_image_compression_tpu.serve import _serving_model_config as j_serving
from contextual_image_compression_tpu_torch.config import ModelConfig
from contextual_image_compression_tpu_torch.convert import convert_codec_variables
from contextual_image_compression_tpu_torch.measure import randomize_stats
from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
from contextual_image_compression_tpu_torch.models.layers import (
    cast_floats,
    prepare_w8,
    quantize_dense_w8,
)
from contextual_image_compression_tpu_torch.serve import CompressionPipeline

REPO = pathlib.Path(__file__).resolve().parent.parent
SERVE_KW = dict(img_size=(64, 64), base_latent_dim=64, generator_base_hw=4)


@pytest.fixture(scope="module")
def pipelines():
    jcfg = JModelConfig(**SERVE_KW)
    v = JCodec(j_serving(jcfg)).init(jax.random.PRNGKey(0), batch_size=1)
    v = perturb_variables(to_numpy_tree(v), np.random.RandomState(11))
    tcfg = ModelConfig(**SERVE_KW)
    port = CompressionPipeline(state_dict=convert_codec_variables(v, tcfg), model_config=tcfg,
                               device="cpu")
    return JPipeline(variables=v, model_config=jcfg), port


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


@pytest.mark.parametrize("bpp", [0.1, 1.0])
def test_pipeline_matches_jax(pipelines, bpp):
    """bf16 serving: mask <= 1e-4, decoded u8 PSNR >= 40 dB port vs JAX,
    symbols within +-1 and >= 95% identical."""
    jpipe, tpipe = pipelines
    u8 = _images(12)
    dj, ij = jpipe(u8, target_bpp=bpp)
    dt, it = tpipe(u8, target_bpp=bpp)
    assert dt.shape == dj.shape == u8.shape and dt.dtype == np.uint8
    assert set(it) == set(ij)
    for key in ij:
        assert tuple(it[key].shape) == tuple(np.shape(ij[key])), key
    np.testing.assert_allclose(it["mask"].numpy(), np.asarray(ij["mask"]), atol=1e-4)
    mse = np.mean((dj.astype(np.float64) - dt.astype(np.float64)) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40.0
    for key in ("hq_symbols", "lq_symbols"):
        got, want = it[key].numpy(), np.asarray(ij[key], np.float32)
        assert got.dtype == np.float32 and np.all(np.isfinite(got))
        assert np.abs(got - want).max() <= 1.0
        assert np.mean(got == want) >= 0.95
    assert it["hq_latent_q"].dtype == torch.bfloat16


def test_pipeline_ragged_batch_pads_to_bucket(pipelines):
    _, tpipe = pipelines
    u8 = _images(13, b=4)
    tpipe.warmup(4)
    assert tpipe._padded_batch(3) == 4
    dec3, info3 = tpipe(u8[:3], target_bpp=1.0)
    assert dec3.shape == (3, 64, 64, 3)
    assert all(v.shape[0] == 3 for v in info3.values())
    dec4, _ = tpipe(u8, target_bpp=1.0)
    np.testing.assert_array_equal(dec3, dec4[:3])
    assert tpipe._padded_batch(5) == 8


def test_pipeline_counts_padding_and_new_batch_sizes(pipelines):
    """After warm-up at 4, a call of 3 counts 3 images, 1 padding image and
    no new batch size; its output equals the same call run unpadded (a
    pipeline that has run a batch of 3), whose counts hold no padding."""
    _, tpipe = pipelines
    u8 = _images(14, b=3)
    tpipe.warmup(4)
    tpipe.reset_counts()
    padded, info = tpipe(u8, target_bpp=1.0)
    assert tpipe.counts() == {"images": 3, "padding": 1, "new_batches": 0}
    unpadded = copy.copy(tpipe)
    unpadded._seen_batches = {3}
    unpadded.reset_counts()
    want, want_info = unpadded(u8, target_bpp=1.0)
    assert unpadded.counts() == {"images": 3, "padding": 0, "new_batches": 0}
    np.testing.assert_array_equal(padded, want)
    for k, v in want_info.items():
        torch.testing.assert_close(info[k], v, rtol=0, atol=0)
    tpipe.reset_counts()
    tpipe(_images(15, b=5), target_bpp=1.0)
    assert tpipe.counts() == {"images": 5, "padding": 3, "new_batches": 1}


def test_pipeline_seeded_init_and_provenance():
    cfg = ModelConfig(**SERVE_KW)
    a = CompressionPipeline(model_config=cfg, device="cpu", seed=3)
    b = CompressionPipeline(model_config=cfg, device="cpu", seed=3)
    assert a.provenance == {"all": "init"}
    u8 = _images(14, b=1)
    np.testing.assert_array_equal(a(u8)[0], b(u8)[0])
    sd = a.codec.state_dict()
    assert sd["hq_encoder.latent_dense.weight_q"].dtype == torch.int8
    assert sd["hq_encoder.latent_dense.w8_scale"].dtype == torch.float32
    assert sd["hq_encoder.conv1.weight"].dtype == torch.bfloat16


# Both generators' fc (2048 and 1024 -> 4 x 4 x 512) reach quantize_dense_w8's
# 2^23 weights and are quantized from float32; the encoders' latent
# projections (4 x 4 x 32 -> 2048 and 1024) are quantized from bf16.
W8_SPLIT_KW = dict(SERVE_KW, base_latent_dim=1024, encoder_channels=(8, 16, 24, 32),
                   generator_channels=(24, 16, 8, 8))


@pytest.mark.parametrize("case", ["pipeline", "dense_int8"])
def test_prepare_serving_equals_the_written_out_setup(case):
    """The serving form made by `prepare_serving` equals, bit for bit, the
    set-up steps written out as the pipeline and chip_smoke.py's W8A8
    pipeline ran them: every parameter and buffer (the int8 rows and the w8
    scales among them) and both generators' folded int8-tail operands."""
    sd = AdaptiveCodec(ModelConfig(**W8_SPLIT_KW))
    sd.reset_parameters(4)
    randomize_stats(sd, 4)
    sd = sd.state_dict()
    if case == "pipeline":
        got = CompressionPipeline(state_dict=sd, model_config=ModelConfig(**W8_SPLIT_KW),
                                  device="cpu").codec
        cfg = got.cfg
    else:
        cfg = ModelConfig(**W8_SPLIT_KW, dtype="bfloat16", generator_packed_tail=True,
                          packed_tail_int8=True, dense_int8=True)
        got = AdaptiveCodec(cfg)
        got.load_state_dict(sd)
        got = got.prepare_serving()
    want = AdaptiveCodec(cfg)
    want.load_state_dict(sd)
    if case == "pipeline":
        assert quantize_dense_w8(want) == 2
    cast_floats(want, torch.bfloat16)
    if case == "pipeline":
        prepare_w8(want)
    want.hq_generator.prepare_tail()
    want.lq_generator.prepare_tail()
    want.eval().requires_grad_(False)

    got_sd, want_sd = got.state_dict(), want.state_dict()
    assert list(got_sd) == list(want_sd)
    assert any(k.endswith("weight_q") for k in got_sd) is (case == "pipeline")
    for k, v in want_sd.items():
        assert got_sd[k].dtype == v.dtype and torch.equal(got_sd[k], v), k
    for name in ("hq_generator", "lq_generator"):
        g, w = getattr(got, name)._int8_tail[1], getattr(want, name)._int8_tail[1]
        for field, v in w._asdict().items():
            assert torch.equal(getattr(g, field), v) if torch.is_tensor(v) else \
                getattr(g, field) == v, (name, field)
    assert not got.training and not any(p.requires_grad for p in got.parameters())


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompressionPipeline(model_config=ModelConfig(**SERVE_KW))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    """The port, chip_smoke.py and every scripts/torch_*.py import no jax,
    flax, optax, msgpack (the card's machine has none of them) or
    JAX-package module."""
    files = sorted((REPO / "contextual_image_compression_tpu_torch").rglob("*.py"))
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    assert len(scripts) >= 6
    files += [REPO / "chip_smoke.py"] + scripts
    assert len(files) > 25
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "msgpack",
                                "contextual_image_compression_tpu"), (
                f"{path.relative_to(REPO)} imports {name}"
            )
