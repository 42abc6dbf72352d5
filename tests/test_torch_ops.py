"""The PyTorch port's ops and kernel twins against the JAX package.

K1 (contextual mask), K2 (attention block) and K3 (adaptive quantizer) are
CUDA kernels in the port; on the CPU each wrapper runs its plain twin, which
is held here against the JAX Pallas kernel in interpret mode (and against
the jnp path) on the same seeded inputs. The kernels themselves are held
against the twins on the card by tests/test_torch_kernels_cuda.py and by
chip_smoke.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextual_image_compression_tpu.config import SaliencyConfig as JSaliencyConfig
from contextual_image_compression_tpu.ops import image_ops as jiops
from contextual_image_compression_tpu.ops import masks as jmasks
from contextual_image_compression_tpu.ops import saliency as jsal
from contextual_image_compression_tpu.ops.attention import (
    attention_block_pallas,
    attention_core_pallas,
)
from contextual_image_compression_tpu.ops.fused_mask import contextual_mask_pallas
from contextual_image_compression_tpu.ops.quantize import _adaptive_quantize_pallas
from contextual_image_compression_tpu_torch import ops as tops
from contextual_image_compression_tpu_torch.ops import cuda_kernels
from contextual_image_compression_tpu_torch.ops import image_ops as tiops
from contextual_image_compression_tpu_torch.ops import masks as tmasks
from contextual_image_compression_tpu_torch.ops import saliency as tsal
from contextual_image_compression_tpu_torch.ops.attention import (
    attention_block,
    attention_core,
    sagan_block,
    sagan_block_spatial,
    attention_block_plain,
    attention_core_plain,
)
from contextual_image_compression_tpu_torch.ops.dct import dct_strips
from contextual_image_compression_tpu_torch.ops.generator_tail import fused_tail
from contextual_image_compression_tpu_torch.ops.fused_mask import (
    contextual_mask,
    smooth_mask,
    upsample_taps,
)
from contextual_image_compression_tpu_torch.ops.quantize import (
    adaptive_quantize,
    adaptive_quantize_bwd,
    adaptive_quantize_plain,
)
from contextual_image_compression_tpu_torch.config import QuantizerConfig
from torch_port_helpers import attention_running_max, late_max_attention_inputs


def _structured_u8(rng, b, size):
    """Images with blobs and edges (flat noise has no saliency structure)."""
    yy, xx = np.mgrid[0:size, 0:size] / size
    imgs = []
    for _ in range(b):
        cy, cx, r = rng.rand(3) * [1, 1, 0.3] + [0, 0, 0.1]
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        edge = (xx + 0.3 * yy > rng.rand()).astype(np.float64)
        base = 0.5 * blob[..., None] * rng.rand(3) + 0.3 * edge[..., None] * rng.rand(3)
        imgs.append(base + 0.05 * rng.rand(size, size, 3))
    return np.clip(np.stack(imgs) * 255, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("src,dst", [(256, 64), (128, 64), (64, 128), (64, 256), (64, 32)])
def test_resize_operator_matches_jax(src, dst):
    want = np.asarray(jsal._resize_op_matrix(src, dst))
    np.testing.assert_allclose(tsal.resize_op_matrix(src, dst), want, atol=1e-7)


def test_filter_and_dft_operators_match_jax():
    np.testing.assert_array_equal(tsal.blur_op_matrix(64, 19, 3.0),
                                  np.asarray(jsal._blur_op_matrix(64, 19, 3.0)))
    np.testing.assert_array_equal(tsal.box_op_matrix(64, 3), np.asarray(jsal._box_op_matrix(64, 3)))
    for got, want in zip(tsal.dft_matrices(64), jsal._dft_matrices(64)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_image_ops_match_jax(rng):
    for k, sigma in [(3, 0.0), (9, 0.0), (19, 3.0), (31, 0.0)]:
        np.testing.assert_array_equal(tiops.gaussian_kernel_1d(k, sigma),
                                      jiops.gaussian_kernel_1d(k, sigma))
    x = rng.rand(2, 40, 48).astype(np.float32)
    np.testing.assert_allclose(tiops.gaussian_blur(torch.from_numpy(x), 31).numpy(),
                               np.asarray(jiops.gaussian_blur(jnp.asarray(x), 31)), atol=1e-6)
    np.testing.assert_allclose(
        tiops.bilateral_filter_taylor(torch.from_numpy(x)).numpy(),
        np.asarray(jiops.bilateral_filter(jnp.asarray(x), 9, 75.0, 75.0, unit_range=True)),
        atol=1e-6)
    for tf, jf in [(tiops.normalize_max, jiops.normalize_max),
                   (tiops.normalize_minmax, jiops.normalize_minmax)]:
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))), atol=1e-7)
    img = rng.rand(2, 8, 8, 3).astype(np.float32) * 255
    np.testing.assert_allclose(tiops.rgb_to_gray(torch.from_numpy(img)).numpy(),
                               np.asarray(jiops.rgb_to_gray(jnp.asarray(img))), atol=1e-4)


@pytest.mark.parametrize("size", [64, 128])
def test_spectral_residual_small_matches_jax(size):
    u8 = _structured_u8(np.random.RandomState(size), 2, size)
    gray = np.array(jiops.rgb_to_gray(jnp.asarray(u8).astype(jnp.float32)))
    want = np.asarray(jsal.spectral_residual_small(jnp.asarray(gray), 64, 3.0, dft_matmul=True))
    got = tsal.spectral_residual_small(torch.from_numpy(gray), 64, 3.0).numpy()
    assert got.shape == (2, 64, 64)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("size", [64, 128])
def test_k1_twin_matches_pallas_interpret(size):
    """contextual_mask on CPU tensors (the twin) == contextual_mask_pallas,
    with the 64^2 spectral map upsampled inside (the mask_spec_small form)."""
    u8 = _structured_u8(np.random.RandomState(size + 1), 2, size)
    gray = jiops.rgb_to_gray(jnp.asarray(u8).astype(jnp.float32))
    spec = jsal.spectral_residual_small(gray, 64, 3.0, dft_matmul=True)
    want = np.asarray(contextual_mask_pallas(gray, spec))
    before = contextual_mask.launches
    got = contextual_mask(torch.from_numpy(np.array(gray)), torch.from_numpy(np.array(spec)))
    assert contextual_mask.launches == before  # CPU tensors take the twin
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("size", [64, 128])
def test_compute_contextual_mask_u8_matches_jax(size):
    u8 = _structured_u8(np.random.RandomState(size + 2), 2, size)
    want = np.asarray(jmasks.compute_contextual_mask(jnp.asarray(u8), JSaliencyConfig()))
    got = tmasks.compute_contextual_mask(torch.from_numpy(u8)).numpy()
    assert got.shape == (2, size, size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert 0.99 < got.max() <= 1.0 + 1e-6


def test_upsample_taps_reproduce_operator():
    for src, dst in [(64, 256), (64, 128), (64, 64)]:
        idx, w = upsample_taps(src, dst)
        mat = np.zeros((dst, src), np.float32)
        for i in range(dst):
            mat[i, idx[i]] += w[i, 0]
            mat[i, min(idx[i] + 1, src - 1)] += w[i, 1]
        np.testing.assert_array_equal(mat, tsal.resize_op_matrix(src, dst))


def _attention_inputs(dtype, seed=3):
    rng = np.random.RandomState(seed)
    shapes = [(2, 128, 16), (2, 128, 16), (2, 128, 64), (2, 128, 64)]
    return [(rng.randn(*s) * 0.7).astype(np.float32) for s in shapes], 0.5


@pytest.mark.parametrize("dtype,zero_residual", [
    ("float32", False), ("bfloat16", False), ("bfloat16", True),
], ids=["float32", "bfloat16", "bfloat16-zero-residual"])
def test_k2_twin_matches_pallas_interpret(dtype, zero_residual):
    """No 1/sqrt(d); e rounded to V's dtype for e.V; f32 epilogue. Bars:
    float32 1e-5 abs; bfloat16 2e-2 of the output's max magnitude. With the
    residual at 0 the output is gamma * softmax(Q K^T) V alone, so the bf16
    bar is relative to the attention term, not to a larger residual."""
    arrays, gamma = _attention_inputs(dtype)
    if zero_residual:
        arrays[3] = np.zeros_like(arrays[3])
    jdt = jnp.dtype(dtype)
    want = np.asarray(
        attention_block_pallas(*[jnp.asarray(a, jdt) for a in arrays], jnp.asarray(gamma, jdt)),
        np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    before = attention_block.launches
    got = attention_block(*[torch.from_numpy(a).to(tdt) for a in arrays],
                          torch.tensor(gamma, dtype=tdt)).float().numpy()
    assert attention_block.launches == before
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["block", "core"])
def test_k2_k6_twins_match_pallas_at_the_serving_shape(kind):
    """The twins the card's K2 / K6 are held against, at the width the kernel
    runs in serving (the HQ encoder's attention: B = 1 of 16, N = 32 * 32,
    Dk = 32, Dv = 256, bf16) against the JAX Pallas kernels in interpret mode
    (block_q 512, so two query blocks, each with all 1024 keys as one block).
    Bar: two bf16 ulps of max |out|, as tests/test_torch_kernels_rest.py:
    float32 summation order can move a value across a bf16 rounding
    boundary."""
    rng = np.random.RandomState(1024)
    q, k = ((rng.randn(1, 1024, 32) * 0.4).astype(np.float32) for _ in range(2))
    v, res = (rng.randn(1, 1024, 256).astype(np.float32) for _ in range(2))
    bf = jnp.bfloat16
    if kind == "block":
        want = attention_block_pallas(*(jnp.asarray(a, bf) for a in (q, k, v, res)),
                                      jnp.float32(0.5))
        got = attention_block_plain(*(torch.from_numpy(a).to(torch.bfloat16)
                                      for a in (q, k, v, res)), torch.tensor(0.5))
    else:
        want = attention_core_pallas(*(jnp.asarray(a, bf) for a in (q, k, v)))
        got = attention_core_plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (1, 1024, 256)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 * 2.0 ** -8 * np.abs(want).max(), err


@pytest.mark.parametrize("kind", ["block", "core"])
def test_late_max_inputs_tell_global_from_running_max(kind):
    """The card test `test_bf16_attention_rounds_at_the_global_max` shows that
    K2 / K6 round e = exp(s - m) at the row's global max only if a kernel
    that rounds at a running max would miss its bar of 99% of outputs
    bit-identical to the twin. On its inputs an online softmax over 64-key
    tiles (`attention_running_max`) is a correct attention, within the 2e-2
    bar of the twin, and matches it bit for bit on far fewer than 99% of the
    outputs (about half)."""
    q, k, v = late_max_attention_inputs()
    scores = torch.einsum("bnd,bmd->bnm", q.float(), k.float())
    assert bool((scores.argmax(-1) == 1000).all())
    if kind == "block":
        r = torch.zeros_like(v)
        want = attention_block_plain(q, k, v, r, torch.tensor(0.5))
        run = attention_running_max(q, k, v, r, 0.5)
    else:
        want = attention_core_plain(q, k, v)
        run = attention_running_max(q, k, v)
    assert (run.float() - want.float()).abs().max() <= 2e-2 * want.float().abs().max()
    share = (run == want).float().mean().item()
    assert share < 0.9, share


def test_k2_backward_matches_jax():
    """The backward is autograd over the plain formula, as the JAX VJP is
    jax.vjp of its jnp formula."""
    arrays, gamma = _attention_inputs("float32", seed=4)
    cot = np.random.RandomState(5).randn(2, 128, 64).astype(np.float32)

    def jloss(q, k, v, r, g):
        return jnp.sum(attention_block_pallas(q, k, v, r, g) * cot)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(gamma, jnp.float32))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    g = torch.tensor(gamma, requires_grad=True)
    (attention_block_plain(*ts, g) * torch.from_numpy(cot)).sum().backward()
    for got, want in zip([t.grad for t in ts] + [g.grad], jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_twin_matches_pallas_interpret(dtype):
    """Within one quantizer step everywhere, and the symbols rint(z * s)
    bitwise equal on >= 99.9% of the entries. XLA's float32 exp and torch's
    differ in the last ulp for some arguments (XLA's is not correctly
    rounded about 9% of the time), which moves a whole row's dequantized
    float32 values by an ulp; the symbols are recovered from each output
    with one shared float64 scale, which that ulp cannot change."""
    rng = np.random.RandomState(6)
    z = (rng.randn(16, 1024) * 2).astype(np.float32)
    score = rng.rand(16, 1).astype(np.float32)
    strength = (rng.rand(16, 1) * 0.9).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = np.asarray(_adaptive_quantize_pallas(
        jnp.asarray(z, jdt), jnp.asarray(score, jdt), jnp.asarray(strength, jdt), 3.0,
        "reference"), np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    before = adaptive_quantize.launches
    got = adaptive_quantize(torch.from_numpy(z).to(tdt), torch.from_numpy(score).to(tdt),
                            torch.from_numpy(strength).to(tdt),
                            QuantizerConfig(grad_mode="reference")).float().numpy()
    assert adaptive_quantize.launches == before
    q64 = np.asarray(jnp.asarray(strength, jdt), np.float64)
    s64 = np.asarray(jnp.asarray(score, jdt), np.float64)
    scale = np.exp(3.0 * q64 * (1.0 - s64))  # (16, 1)
    assert np.all(np.abs(got - want) <= 1.01 / scale + np.abs(want) * 2 ** -7)
    assert np.mean(np.rint(got * scale) == np.rint(want * scale)) >= 0.999
    if dtype == "bfloat16":  # the ulp of the scale vanishes in the bf16 cast
        assert np.mean(got == want) >= 0.999


def test_k3_plain_rounds_half_to_even():
    z = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5]])
    one = torch.zeros(1, 1)
    out = adaptive_quantize_plain(z, one, one)  # scale exp(0) = 1
    assert out.tolist() == [[0.0, 2.0, 2.0, -0.0, -2.0]]


def test_kernel_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises: the plain twin is
    never a fallback for a tensor on another device."""
    meta = torch.empty((1, 32, 32), device="meta")
    with pytest.raises(ValueError):
        contextual_mask(meta, torch.empty((1, 16, 16), device="meta"))
    q = torch.empty((1, 8, 4), device="meta")
    v = torch.empty((1, 8, 64), device="meta")
    with pytest.raises(ValueError):
        attention_block(q, q, v, v, torch.tensor(0.5, device="meta"))
    with pytest.raises(ValueError):
        adaptive_quantize(torch.empty((2, 8), device="meta"), torch.empty((2, 1), device="meta"),
                          torch.empty((2, 1), device="meta"), QuantizerConfig(grad_mode="ste"))
    with pytest.raises(ValueError):
        adaptive_quantize_bwd(torch.empty((2, 8), device="meta"), torch.empty((2, 1), device="meta"),
                              torch.empty((2, 1), device="meta"), torch.empty((2, 8), device="meta"))
    with pytest.raises(ValueError):
        smooth_mask(meta)
    with pytest.raises(ValueError):
        dct_strips(torch.empty((1, 3, 8, 8), device="meta"), torch.empty((3, 8, 8), device="meta"))
    with pytest.raises(ValueError):
        attention_core(q, q, v)
    x = torch.empty((1, 8, 64), device="meta")
    w, bias = torch.empty((64, 8), device="meta"), torch.empty((8,), device="meta")
    wv, bv = torch.empty((64, 64), device="meta"), torch.empty((64,), device="meta")
    with pytest.raises(ValueError):
        sagan_block(x, w, bias, w, bias, wv, bv, 0.5)
    with pytest.raises(ValueError):
        sagan_block_spatial(x.reshape(1, 2, 4, 64), w, bias, w, bias, wv, bv, 0.5)
    with pytest.raises(ValueError):
        fused_tail(torch.empty((1, 16, 4, 4), device="meta"), torch.empty((16, 8, 4, 4), device="meta"),
                   torch.empty((8,), device="meta"), torch.empty((3, 8, 4, 4), device="meta"),
                   torch.empty((3,), device="meta"))
    with pytest.raises(ValueError):
        tops.KERNEL_WRAPPERS["K9"](meta.reshape(1, 1, 32, 32), torch.empty((1,), device="meta"),
                                   torch.empty((1,), device="meta"), 1e-3)
    assert set(tops.launch_counts()) == {"K1", "K2", "K3", "K3b", "K4", "K5", "K6", "K7a", "K7b",
                                         "K8", "K9"}


def test_c_signatures_match_sources():
    """Every ctypes signature names an extern "C" function of csrc/ with the
    same number of parameters (a mismatch would pass garbage to a kernel)."""
    text = "\n".join(p.read_text() for p in cuda_kernels.CSRC_DIR.glob("*.cu"))
    found = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        found[name] = len([p for p in params.split(",") if p.strip()])
    assert set(found) == set(cuda_kernels._SIGNATURES)
    for name, argtypes in cuda_kernels._SIGNATURES.items():
        assert found[name] == len(argtypes), name
