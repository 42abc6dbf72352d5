"""The port's saliency methods, thresholds and masks against the JAX package.

K4 (the smooth mask) is a CUDA kernel in the port; on the CPU its wrapper
runs the plain twin, which is held here against the JAX Pallas kernel in
interpret mode and against the JAX package's CPU path
(`create_saliency_mask(smooth=True)`, a 2nd-order clipped Taylor range
weight where the kernel uses the 1st-order one; the two differ by ~4e-9).
The thresholds are discrete, so they must be equal, not close. Inputs are
made from seeds with numpy and handed to both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextual_image_compression_tpu.config import SaliencyConfig as JSaliencyConfig
from contextual_image_compression_tpu.data import pipeline as jpipeline
from contextual_image_compression_tpu.ops import image_ops as jiops
from contextual_image_compression_tpu.ops import masks as jmasks
from contextual_image_compression_tpu.ops import saliency as jsal
from contextual_image_compression_tpu.ops.fused_mask import smooth_mask_pallas
from contextual_image_compression_tpu_torch import ops as tops
from contextual_image_compression_tpu_torch.config import SaliencyConfig
from contextual_image_compression_tpu_torch.data import images as timages
from contextual_image_compression_tpu_torch.data import pipeline as tpipeline
from contextual_image_compression_tpu_torch.ops import image_ops as tiops
from contextual_image_compression_tpu_torch.ops import masks as tmasks
from contextual_image_compression_tpu_torch.ops import saliency as tsal
from contextual_image_compression_tpu_torch.ops.fused_mask import smooth_mask


def _rich_u8(n, size, seed):
    imgs = timages.rich_synthetic_images(n, (size, size), seed=seed)
    return np.clip(np.round((imgs + 1.0) * 127.5), 0, 255).astype(np.uint8)


def _gray255(u8):
    return np.array(jiops.rgb_to_gray(jnp.asarray(u8).astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 32, 64)], ids=["2x64x64", "1x32x64"])
def test_k4_twin_matches_pallas_and_jnp(shape):
    """The twin (first-order Taylor, as the kernel) within 1e-5 of
    smooth_mask_pallas in interpret mode and of the JAX CPU path, JAX's
    own bar between those two (tests/test_fused_mask.py)."""
    sal = np.random.RandomState(shape[-1] + shape[0]).rand(*shape).astype(np.float32)
    before = smooth_mask.launches
    got = smooth_mask(torch.from_numpy(sal)).numpy()
    assert smooth_mask.launches == before  # CPU tensors take the twin
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(smooth_mask_pallas(jnp.asarray(sal))), atol=1e-5)
    want = np.asarray(jmasks.create_saliency_mask(jnp.asarray(sal), smooth=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    port = tmasks.create_saliency_mask(torch.from_numpy(sal), smooth=True).numpy()
    np.testing.assert_array_equal(port, got)


def test_k4_twin_keeps_a_zero_map():
    """The max-normalization leaves a map whose max is 0 as it is."""
    got = smooth_mask(torch.zeros(1, 40, 40)).numpy()
    np.testing.assert_array_equal(got, np.zeros((1, 40, 40), np.float32))


def _maps(kind):
    rng = np.random.RandomState(len(kind))
    if kind == "uniform":
        return rng.rand(3, 48, 40).astype(np.float32)
    if kind == "quantized":  # multiples of 1/255: the uint8 bins tie exactly
        return (rng.randint(0, 256, (3, 48, 40)) / np.float32(255.0)).astype(np.float32)
    if kind == "sparse":  # few levels, empty classes on both sides
        return (rng.randint(0, 4, (3, 48, 40)) * 0.25).astype(np.float32)
    if kind == "constant":
        return np.full((2, 16, 16), 0.3, np.float32)
    gray = _gray255(_rich_u8(3, 48, seed=4))
    return np.array(jsal.fine_grained_saliency(jnp.asarray(gray)))  # "saliency"


@pytest.mark.parametrize("kind", ["uniform", "quantized", "sparse", "constant", "saliency"])
def test_thresholds_and_binary_masks_equal_jax(kind):
    x = _maps(kind)
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(tmasks._histogram_fixed_bins(tx, 50, 0.0, 1.0).numpy(),
                                  np.asarray(jmasks._histogram_fixed_bins(jnp.asarray(x), 50,
                                                                          0.0, 1.0)))
    for tf, jf in [(tmasks.otsu_threshold, jmasks.otsu_threshold),
                   (tmasks.percentile_threshold, jmasks.percentile_threshold),
                   (tmasks.adaptive_threshold, jmasks.adaptive_threshold)]:
        got, want = tf(tx).numpy(), np.asarray(jf(jnp.asarray(x)))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=tf.__name__)
    got = tmasks.create_saliency_mask(tx, smooth=False).numpy()
    want = np.asarray(jmasks.create_saliency_mask(jnp.asarray(x), smooth=False))
    np.testing.assert_array_equal(got, want)
    fixed = tmasks.create_saliency_mask(tx, threshold=0.5, smooth=False).numpy()
    np.testing.assert_array_equal(fixed, (x > 0.5).astype(np.float32))


def test_prefix_sum_matches_jnp_cumsum():
    """The port's prefix sums round as XLA's CPU cumsum does (the Otsu
    class weights depend on it), at lengths below, at and above 16 and 256."""
    rng = np.random.RandomState(9)
    for n in (5, 16, 50, 256, 300, 2049):
        x = (rng.rand(3, n) * rng.rand(3, n)).astype(np.float32)
        np.testing.assert_array_equal(tiops.prefix_sum(torch.from_numpy(x)).numpy(),
                                      np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)))
    x = rng.rand(2, 70, 9).astype(np.float32)
    np.testing.assert_array_equal(tiops.prefix_sum(torch.from_numpy(x), -2).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x), axis=-2)))


@pytest.mark.parametrize("ksize", [3, 5, 7, 13])
def test_box_filter_matches_jax(ksize):
    x = np.random.RandomState(ksize).rand(2, 40, 36).astype(np.float32)
    np.testing.assert_allclose(tiops.box_filter(torch.from_numpy(x), ksize).numpy(),
                               np.asarray(jiops.box_filter(jnp.asarray(x), ksize)), atol=1e-6)


@pytest.mark.parametrize("unit_range", [False, True])
def test_bilateral_filter_matches_jax(unit_range):
    x = np.random.RandomState(5).rand(2, 32, 40).astype(np.float32)
    got = tiops.bilateral_filter(torch.from_numpy(x), 9, 75.0, 75.0, unit_range=unit_range)
    want = jiops.bilateral_filter(jnp.asarray(x), 9, 75.0, 75.0, unit_range=unit_range)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("size", [64, 96])
def test_saliency_methods_match_jax(size):
    """fine_grained and spectral_residual within 1e-5 (the bar of
    spectral_residual_small in tests/test_torch_ops.py); compute_saliency_map
    for all three methods within 1e-5."""
    gray = _gray255(_rich_u8(2, size, seed=size))
    tg, jg = torch.from_numpy(gray), jnp.asarray(gray)
    np.testing.assert_allclose(tsal.fine_grained_saliency(tg).numpy(),
                               np.asarray(jsal.fine_grained_saliency(jg)), atol=1e-5)
    got = tsal.spectral_residual_saliency(tg).numpy()
    assert got.shape == (2, size, size)
    np.testing.assert_allclose(got, np.asarray(jsal.spectral_residual_saliency(
        jg, 64, 3.0, dft_matmul=True)), atol=1e-5)
    for method in ("spectral_residual", "fine_grained", "combined"):
        np.testing.assert_allclose(
            tsal.compute_saliency_map(tg, method).numpy(),
            np.asarray(jsal.compute_saliency_map(jg, method, JSaliencyConfig())),
            atol=1e-5, err_msg=method)
    with pytest.raises(ValueError):
        tsal.compute_saliency_map(tg, "itti")


@pytest.mark.parametrize("method", ["spectral_residual", "fine_grained"])
@pytest.mark.parametrize("wire", ["uint8", "float"])
def test_compute_contextual_mask_methods_match_jax(method, wire):
    """The K4 path of compute_contextual_mask within 1e-4 of the JAX
    package's (PR 1's mask bar), on uint8 and on [-1, 1] float input."""
    u8 = _rich_u8(2, 64, seed=11)
    images = u8 if wire == "uint8" else (u8.astype(np.float32) / np.float32(127.5) - 1.0)
    before = tops.launch_counts()
    got = tmasks.compute_contextual_mask(torch.from_numpy(images),
                                         SaliencyConfig(method=method)).numpy()
    assert tops.launch_counts() == before
    want = np.asarray(jmasks.compute_contextual_mask(jnp.asarray(images),
                                                     JSaliencyConfig(method=method)))
    assert got.shape == (2, 64, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert 0.99 < got.max() <= 1.0 + 1e-6


def test_binary_contextual_mask_matches_jax():
    """mask_smooth=False: the adaptive thresholds of the two packages'
    saliency maps are equal, and the binary masks differ only where a map
    value lies within the maps' rounding difference of the threshold."""
    u8 = _rich_u8(2, 64, seed=12)
    for method in ("fine_grained", "combined"):
        got = tmasks.compute_contextual_mask(
            torch.from_numpy(u8), SaliencyConfig(method=method, mask_smooth=False)).numpy()
        want = np.asarray(jmasks.compute_contextual_mask(
            jnp.asarray(u8), JSaliencyConfig(method=method, mask_smooth=False)))
        assert set(np.unique(got)) <= {0.0, 1.0}
        assert np.mean(got == want) >= 0.999, method


@pytest.mark.parametrize("method", ["spectral_residual", "fine_grained"])
def test_prepare_masks_methods_match_jax(method):
    """Masks of [-1, 1] images in batches of 3 (one ragged) within 1e-4 of
    the JAX package's jitted pipeline."""
    imgs = timages.rich_synthetic_images(5, (64, 64), seed=3)
    want = jpipeline.prepare_masks(imgs, JSaliencyConfig(method=method), device_batch=3)
    got = tpipeline.prepare_masks(imgs, SaliencyConfig(method=method), device_batch=3,
                                  device="cpu")
    assert got.shape == want.shape == (5, 64, 64, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_enhance_saliency_map_matches_jax():
    x = np.random.RandomState(13).rand(2, 40, 40).astype(np.float32)
    np.testing.assert_allclose(tmasks.enhance_saliency_map(torch.from_numpy(x)).numpy(),
                               np.asarray(jmasks.enhance_saliency_map(jnp.asarray(x))),
                               atol=1e-5)


@pytest.mark.parametrize("change", [
    dict(spectral_dft_matmul=False),
    dict(spectral_dft_matmul=False, method="spectral_residual"),
    dict(mask_engine_dtype="bfloat16"),
    dict(mask_engine_dtype="bfloat16", method="fine_grained"),
    dict(mask_use_pallas=False, method="fine_grained"),
], ids=["fft-core", "fft-core-spectral", "bf16-engine", "bf16-engine-fine", "no-pallas-fine"])
def test_unported_mask_options_raise(change):
    """The bf16 mask engine is not ported, and the port has no plain path on
    the card: these configs raise. The FFT spectral core
    (spectral_dft_matmul=False) is ported: its cases compute the mask, within
    1e-4 of the JAX package's (tests/test_torch_w8a8_fft.py holds the FFT
    core's maps, thresholds and binary masks)."""
    cfg = dataclasses.replace(SaliencyConfig(), **change)
    if not cfg.spectral_dft_matmul:
        u8 = _rich_u8(2, 32, seed=9)
        got = tmasks.compute_contextual_mask(torch.from_numpy(u8), cfg).numpy()
        want = jmasks.compute_contextual_mask(
            jnp.asarray(u8), dataclasses.replace(JSaliencyConfig(), **change))
        assert got.shape == (2, 32, 32) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
        return
    with pytest.raises(NotImplementedError):
        tmasks.compute_contextual_mask(torch.zeros((1, 32, 32, 3), dtype=torch.uint8), cfg)


def test_prepare_masks_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipeline.prepare_masks(np.zeros((1, 32, 32, 3), np.float32),
                                SaliencyConfig(method="fine_grained"))
