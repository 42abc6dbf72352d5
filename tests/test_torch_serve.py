"""The PyTorch port's serving pipeline against the JAX CompressionPipeline,
plus the port's import and device guards.

Both pipelines get the same float32 weights (random BN stats, SAGAN gamma
0.5) and the same uint8 images, and each applies the serving configuration
itself: bfloat16 compute, w8 latent/fc projections, the folded int8 tail.
"""

import ast
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
