"""The port's W8A8 dense layer (`ModelConfig.dense_int8`) and FFT spectral
core (`SaliencyConfig.spectral_dft_matmul=False`) against the JAX package,
on the CPU.

W8A8 quantizes the weight per output and the activation per row to int8
(max|.| / 127, floored at 1e-12, round half to even, in float32),
multiplies in int32, then computes acc * sx * sw + b in float32: the layer
is held to flax's bit for bit, the codec with it to the codec's float32
bars. The FFT core runs `torch.fft` (cuFFT on the card) where JAX runs
`jnp.fft` (XLA's CPU FFT here); they round differently, so the maps are
held within a float32 bar and the discrete results downstream (thresholds,
binary masks) are counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import perturb_variables, to_numpy_tree

from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.config import QuantizerConfig as JQuantizerConfig
from contextual_image_compression_tpu.config import SaliencyConfig as JSaliencyConfig
from contextual_image_compression_tpu.models import layers as jl
from contextual_image_compression_tpu.models.adaptive import AdaptiveCodec as JCodec
from contextual_image_compression_tpu.ops import masks as jmasks
from contextual_image_compression_tpu.ops import saliency as jsal
from contextual_image_compression_tpu_torch.config import ModelConfig, SaliencyConfig
from contextual_image_compression_tpu_torch.convert import convert_codec_variables
from contextual_image_compression_tpu_torch.data import images as timages
from contextual_image_compression_tpu_torch.models import layers as tl
from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
from contextual_image_compression_tpu_torch.ops import image_ops as tiops
from contextual_image_compression_tpu_torch.ops import masks as tmasks
from contextual_image_compression_tpu_torch.ops import saliency as tsal

SMALL_KW = dict(img_size=(64, 64), base_latent_dim=32, generator_base_hw=4)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# ------------------------------------------------------------------ W8A8


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", [(4, 128, 32), (3, 64, 24), (17, 512, 8)])
def test_kdense_int8_matches_flax_bitwise(dtype, m, k, n):
    """KDense(int8=True) against flax's KDense(int8=True), applied eagerly,
    bit for bit; one activation row and one weight column all zero (their
    scale floors at 1e-12, their symbols and outputs are 0 + bias)."""
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    x[1] = 0.0
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    w[:, 2] = 0.0
    b = (rng.randn(n) * 0.1).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    mod = jl.KDense(n, int8=True, dtype=jdt)
    variables = {"params": {"Dense_0": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}}
    want = np.asarray(mod.apply(variables, jnp.asarray(x, jdt)).astype(jnp.float32))

    dense = tl.KDense(k, n, int8=True)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w.T.copy()))
        dense.bias.copy_(torch.from_numpy(b))
    got = dense(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().detach().numpy(), want)
    np.testing.assert_array_equal(got[1].float().detach().numpy(),
                                  torch.from_numpy(b).to(tdt).float().numpy())
    # train=True takes the float path, as the JAX codec builds the layer with
    # int8=dense_int8 and not train
    float_path = tl.KDense(k, n)
    float_path.load_state_dict(dense.state_dict())
    x_t = torch.from_numpy(x).to(tdt)
    assert torch.equal(dense(x_t, train=True), float_path(x_t))


def test_int8_matmul_is_exact_at_the_latent_dense_width():
    """The encoder's latent dense at full width sees 16*16*512 = 131,072
    inputs: |acc| <= 127^2 * 131072 ~ 2.11e9 < 2^31, so the int32 product is
    exact where a float32 accumulation would not be. Saturated +-127
    operands against numpy's int64 product."""
    rng = np.random.RandomState(0)
    a = np.full((3, 131072), 127, np.int8)
    a[1] = -127
    a[2] = rng.randint(-127, 128, 131072)
    b = np.full((131072, 8), 127, np.int8)
    b[:, 1] = -127
    b[:, 2:] = rng.randint(-127, 128, (131072, 6))
    got = tl.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert want[0, 0] == 127 * 127 * 131072
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.fixture(scope="module")
def small_codec_variables():
    v = JCodec(JModelConfig(**SMALL_KW)).init(jax.random.PRNGKey(0), batch_size=1)
    return perturb_variables(to_numpy_tree(v), np.random.RandomState(7))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_codec_dense_int8_matches_jax(small_codec_variables, dtype):
    """AdaptiveCodec.apply (inference) with dense_int8 on the small config,
    the JAX Pallas kernels in interpret mode. The int8 layers are bit for
    bit (test_kdense_int8_matches_flax_bitwise); the codec around them
    rounds its convolutions differently, so: float32 within the codec's
    1e-4 with the latent symbols equal (measured 3.9e-7, symbols equal);
    bfloat16 (weights cast as serving casts them) at the serving bars,
    symbols within +-1 and >= 95% identical, decoded uint8 PSNR >= 40 dB
    (measured: symbols equal, latents within one bfloat16 ulp)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(8)
    img = rng.rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
    mask = rng.rand(2, 64, 64, 1).astype(np.float32)
    bpp = np.array([[0.3], [1.7]], np.float32)
    jcfg = JModelConfig(**SMALL_KW, attention_use_pallas=True,
                        quantizer=JQuantizerConfig(use_pallas=True), dense_int8=True, dtype=dtype)
    tcfg = ModelConfig(**SMALL_KW, dense_int8=True, dtype=dtype)
    jv = jax.tree.map(lambda a: jnp.asarray(a, jdt), small_codec_variables)
    jout, _ = JCodec(jcfg).apply(jv, jnp.asarray(img), jnp.asarray(mask), jnp.asarray(bpp),
                                 train=False)
    codec = AdaptiveCodec(tcfg)
    codec.load_state_dict(convert_codec_variables(small_codec_variables, tcfg))
    tl.cast_floats(codec, tdt)
    with torch.no_grad():
        tout = codec.apply(torch.from_numpy(img), torch.from_numpy(mask), torch.from_numpy(bpp))
    assert tout.blended.dtype == tdt

    def f32(x):
        return x.float().numpy() if torch.is_tensor(x) else np.asarray(x.astype(jnp.float32))

    def symbols(out):
        qs = f32(out.quant_strength)
        return [np.round(f32(lat) * np.exp(3.0 * qs * (1.0 - f32(s))))
                for lat, s in ((out.hq_latent, out.hq_saliency_quant),
                               (out.lq_latent, out.lq_saliency_quant))]

    if dtype == "float32":
        for field in ("blended", "hq_latent", "lq_latent", "hq_latent_q", "lq_latent_q"):
            np.testing.assert_allclose(f32(getattr(tout, field)), f32(getattr(jout, field)),
                                       atol=1e-4, err_msg=field)
        for got, want in zip(symbols(tout), symbols(jout)):
            np.testing.assert_array_equal(got, want)
        return
    for got, want in zip(symbols(tout), symbols(jout)):
        assert np.abs(got - want).max() <= 1 and np.mean(got == want) >= 0.95
    u8 = [np.clip(np.round((f32(o.blended) + 1.0) * 127.5), 0, 255) for o in (tout, jout)]
    mse = float(np.mean((u8[0] - u8[1]) ** 2))
    assert mse == 0.0 or 10 * np.log10(255.0 ** 2 / mse) >= 40.0


# ------------------------------------------------------------ FFT core


def _rich_u8(n, size, seed):
    imgs = timages.rich_synthetic_images(n, (size, size), seed=seed)
    return np.clip(np.round((imgs + 1.0) * 127.5), 0, 255).astype(np.uint8)


def _gray255(u8):
    """The masks' gray255 of uint8 images, in both packages' form."""
    gray = tiops.rgb_to_gray(torch.from_numpy(u8).to(torch.float32))
    return gray, jnp.asarray(gray.numpy())


def test_fft_core_saliency_matches_jax():
    """spectral_residual_small / _saliency and compute_saliency_map
    ('spectral_residual', 'combined') with the FFT core within 1e-5 of
    JAX's (measured 7.2e-7 on the 64^2 map); the FFT and DFT cores of the
    port agree as closely as JAX's two do."""
    cfg, jcfg = (SaliencyConfig(spectral_dft_matmul=False),
                 JSaliencyConfig(spectral_dft_matmul=False))
    gray_t, gray_j = _gray255(_rich_u8(3, 96, seed=2))
    small = tsal.spectral_residual_small(gray_t, 64, 3.0, dft_matmul=False).numpy()
    np.testing.assert_allclose(small, np.asarray(jsal.spectral_residual_small(
        gray_j, 64, 3.0, dft_matmul=False)), atol=1e-5)
    full = tsal.spectral_residual_saliency(gray_t, 64, 3.0, dft_matmul=False).numpy()
    np.testing.assert_allclose(full, np.asarray(jsal.spectral_residual_saliency(
        gray_j, 64, 3.0, dft_matmul=False)), atol=1e-5)
    for method in ("spectral_residual", "combined"):
        np.testing.assert_allclose(
            tsal.compute_saliency_map(gray_t, method, cfg).numpy(),
            np.asarray(jsal.compute_saliency_map(gray_j, method, jcfg)), atol=1e-5,
            err_msg=method)
    dft = tsal.spectral_residual_small(gray_t, 64, 3.0).numpy()
    jdiff = np.abs(np.asarray(jsal.spectral_residual_small(gray_j, 64, 3.0, dft_matmul=True))
                   - np.asarray(jsal.spectral_residual_small(gray_j, 64, 3.0, dft_matmul=False)))
    assert np.abs(dft - small).max() <= max(4 * jdiff.max(), 1e-6)


@pytest.mark.parametrize("method", ["combined", "spectral_residual"])
def test_fft_core_masks_and_thresholds_match_jax(method):
    """compute_contextual_mask with the FFT core on uint8 images: the smooth
    masks ('combined' through K1's twin, 'spectral_residual' through K4's)
    within 1e-4 of JAX's (the serving mask bar; measured 4.8e-7); the binary
    masks' adaptive thresholds equal and the binary masks equal on >= 99.9%
    of pixels (measured: thresholds equal, 0 of 12,288 pixels flip for
    either method)."""
    u8 = _rich_u8(3, 64, seed=5)
    for smooth in (True, False):
        cfg = SaliencyConfig(method=method, spectral_dft_matmul=False, mask_smooth=smooth)
        jcfg = JSaliencyConfig(method=method, spectral_dft_matmul=False, mask_smooth=smooth)
        got = tmasks.compute_contextual_mask(torch.from_numpy(u8), cfg).numpy()
        want = np.asarray(jmasks.compute_contextual_mask(jnp.asarray(u8), jcfg))
        assert got.shape == want.shape == (3, 64, 64)
        if smooth:
            np.testing.assert_allclose(got, want, atol=1e-4)
            continue
        gray_t, gray_j = _gray255(u8)
        sal_t = tsal.compute_saliency_map(gray_t, method, cfg)
        sal_j = jsal.compute_saliency_map(gray_j, method, jcfg)
        np.testing.assert_array_equal(tmasks.adaptive_threshold(sal_t, cfg).numpy(),
                                      np.asarray(jmasks.adaptive_threshold(sal_j, jcfg)))
        assert np.mean(got == want) >= 0.999
