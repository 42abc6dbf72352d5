"""The PyTorch port's layers, generator and codec against the JAX package.

Same inputs (seeded numpy) and the same weights (carried by
contextual_image_compression_tpu_torch.convert) go through both; the port
runs on the CPU, where every kernel wrapper takes its plain twin, and the JAX
Pallas kernels run in interpret mode. Everything here computes in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import nchw, nhwc, perturb_variables, to_numpy_tree

from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.config import QuantizerConfig as JQuantizerConfig
from contextual_image_compression_tpu.models.adaptive import AdaptiveCodec as JCodec
from contextual_image_compression_tpu.models.attention import SelfAttention as JSelfAttention
from contextual_image_compression_tpu.models.generator import Generator as JGenerator
from contextual_image_compression_tpu.models import layers as jl
from contextual_image_compression_tpu_torch.config import (
    ModelConfig,
    QuantizerConfig,
    SaliencyConfig,
)
from contextual_image_compression_tpu_torch.convert import (
    component_state,
    convert_codec_variables,
)
from contextual_image_compression_tpu_torch.models import layers as tl
from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
from contextual_image_compression_tpu_torch.models.attention import SelfAttention
from contextual_image_compression_tpu_torch.models.generator import Generator
from contextual_image_compression_tpu_torch.ops.masks import compute_contextual_mask
from contextual_image_compression_tpu_torch.ops.quantize import adaptive_quantize

SMALL_KW = dict(img_size=(64, 64), base_latent_dim=32, generator_base_hw=4)


def _load(module, tree, name="layer", cfg=None):
    module.load_state_dict(component_state(name, tree, cfg or ModelConfig()))
    return module


@pytest.mark.parametrize("kernel,stride,size", [(4, 1, 16), (4, 2, 16), (3, 2, 16), (4, 2, 15)])
def test_kconv_matches_flax_same_padding(kernel, stride, size):
    """flax SAME pads even kernels asymmetrically: k4/s1 (1, 2), k3/s2 (0, 1)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, size, size, 5).astype(np.float32)
    mod = jl.KConv(7, kernel, stride)
    v = perturb_variables(to_numpy_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    want = np.asarray(mod.apply(v, jnp.asarray(x)))
    port = _load(tl.KConv(5, 7, kernel, stride), v)
    got = nhwc(port(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_kconvt_matches_flax():
    """flax's SAME ConvTranspose == conv_transpose2d(stride 2, padding 1) on
    the kernel flipped on both spatial axes."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    mod = jl.KConvT(6, 4, 2)
    v = perturb_variables(to_numpy_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    want = np.asarray(mod.apply(v, jnp.asarray(x)))
    got = nhwc(_load(tl.KConvT(16, 6), v)(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("prequantized", [False, True])
def test_kdense_w8_matches_flax(prequantized):
    """Weight-only int8 dense: the pre-quantized giant-kernel form and the
    trace-time form of smaller kernels give the same numbers."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 96).astype(np.float32)
    mod = jl.KDense(40, w8=True)
    v = perturb_variables(to_numpy_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    port = _load(tl.KDense(96, 40, w8=True), v)
    if prequantized:
        v = jl.quantize_dense_w8(v, min_elems=1)
        assert v["params"]["Dense_0"]["kernel"].dtype == jnp.int8
        assert tl.quantize_dense_w8(port, min_elems=1) == 1
    else:
        tl.prepare_w8(port)
    want = np.asarray(mod.apply(v, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # and both differ from the float layer by the int8 weight rounding only
    plain = _load(tl.KDense(96, 40), to_numpy_tree({"params": {"Dense_0": {
        "kernel": np.asarray(port.weight_q.float() * port.w8_scale).T,
        "bias": port.bias.detach().numpy()}}}))
    np.testing.assert_allclose(plain(torch.from_numpy(x)).detach().numpy(), got, atol=1e-5)


def test_kbatchnorm_inference_matches_flax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 6, 12).astype(np.float32)
    mod = jl.KBatchNorm()
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=True)
    v = perturb_variables(to_numpy_tree(v), rng)
    want = np.asarray(mod.apply(v, jnp.asarray(x), use_running_average=True))
    got = nhwc(_load(tl.KBatchNorm(12), v)(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_self_attention_matches_jax_pallas():
    """SAGAN layer with gamma 0.5 (the init value 0 would hide attention);
    the JAX layer reaches the Pallas block kernel in interpret mode."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 64).astype(np.float32) * 0.5
    mod = JSelfAttention(64, use_pallas=True)
    v = perturb_variables(to_numpy_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    want = np.asarray(mod.apply(v, jnp.asarray(x)))
    got = nhwc(_load(SelfAttention(64), v)(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)


GEN_KW = dict(channels=(24, 16, 8, 8), base_hw=2, base_ch=32)


def _generator_case(tail):
    rng = np.random.RandomState(6)
    lat = rng.randn(2, 64).astype(np.float32)
    skips = (
        rng.randn(2, 16, 16, 8).astype(np.float32),
        rng.randn(2, 8, 8, 16).astype(np.float32),
        rng.randn(2, 4, 4, 24).astype(np.float32),
    )
    packed, int8 = tail != "native", tail == "packed_int8"
    jgen = JGenerator(**GEN_KW, packed_tail=packed, packed_tail_int8=int8)
    jskips = tuple(jnp.asarray(s) for s in skips)
    v = JGenerator(**GEN_KW).init(jax.random.PRNGKey(0), jnp.asarray(lat), jskips, train=False)
    v = perturb_variables(to_numpy_tree(v), rng)
    want = np.asarray(jgen.apply(v, jnp.asarray(lat), jskips, train=False))
    cfg = ModelConfig(generator_base_hw=2, generator_base_ch=32)
    port = Generator(64, channels=GEN_KW["channels"], skip_channels=(8, 16, 24), base_hw=2,
                     base_ch=32, packed_tail=packed, packed_tail_int8=int8)
    port.load_state_dict(component_state("g_generator", v, cfg))
    with torch.no_grad():
        got = nhwc(port(torch.from_numpy(lat), tuple(nchw(s) for s in skips)))
    return got, want, v


@pytest.mark.parametrize("tail", ["native", "packed"])
def test_generator_matches_jax(tail):
    got, want, _ = _generator_case(tail)
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_generator_packed_int8_tail_matches_jax():
    """The serving tail (BN folded, int8 intermediate) in pixel layout. Where
    the two frameworks round an intermediate on the same int8 code the
    outputs agree to 1e-4; a code can flip where the float32 pre-rounding
    value sits within ~1e-6 of a half step, and then the output moves by at
    most one quantizer step through out_conv: sum |W| * amax / 127."""
    got, want, v = _generator_case("packed_int8")
    err = np.abs(got - want)
    close = err <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), err.max())
    p, s = v["params"], v["batch_stats"]
    bn_scale = p["bn4"]["BatchNorm_0"]["scale"].astype(np.float64)
    bn_bias = p["bn4"]["BatchNorm_0"]["bias"].astype(np.float64)
    inv = 1.0 / np.sqrt(s["bn4"]["BatchNorm_0"]["var"].astype(np.float64) + 1e-3)
    shift = bn_bias + (p["deconv4"]["ConvTranspose_0"]["bias"]
                       - s["bn4"]["BatchNorm_0"]["mean"]) * bn_scale * inv
    amax = np.maximum(np.maximum(np.abs(bn_bias), np.abs(shift)) + 8 * np.abs(bn_scale), 1e-6)
    w = np.abs(p["out_conv"]["Conv_0"]["kernel"].astype(np.float64))  # (4, 4, C, O)
    step_bound = (w * (amax / 127.0)[None, None, :, None]).sum(axis=(0, 1, 2)).max()
    assert err.max() <= step_bound + 1e-4, (err.max(), step_bound)


@pytest.fixture(scope="module")
def small_codec_variables():
    cfg = JModelConfig(**SMALL_KW)
    v = JCodec(cfg).init(jax.random.PRNGKey(0), batch_size=1)
    return perturb_variables(to_numpy_tree(v), np.random.RandomState(7))


def _codec_inputs(seed=8):
    rng = np.random.RandomState(seed)
    img = rng.rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
    mask = rng.rand(2, 64, 64, 1).astype(np.float32)
    bpp = np.array([[0.3], [1.7]], np.float32)
    return img, mask, bpp


def _run_both(variables, **overrides):
    jcfg = JModelConfig(**SMALL_KW, attention_use_pallas=True,
                        quantizer=JQuantizerConfig(use_pallas=True), **overrides)
    tcfg = ModelConfig(**SMALL_KW, **overrides)
    img, mask, bpp = _codec_inputs()
    jout, _ = JCodec(jcfg).apply(variables, jnp.asarray(img), jnp.asarray(mask),
                                 jnp.asarray(bpp), train=False)
    codec = AdaptiveCodec(tcfg)
    codec.load_state_dict(convert_codec_variables(variables, tcfg))
    with torch.no_grad():  # apply is differentiable; inference runs without the graph
        tout = codec.apply(torch.from_numpy(img), torch.from_numpy(mask), torch.from_numpy(bpp))
    return jout, tout


def _symbols(out, coeff=3.0):
    qs = np.asarray(out.quant_strength, np.float32)
    syms = []
    for lat, s in ((out.hq_latent, out.hq_saliency_quant), (out.lq_latent, out.lq_saliency_quant)):
        scale = np.exp(coeff * qs * (1.0 - np.asarray(s, np.float32)))
        syms.append(np.round(np.asarray(lat, np.float32) * scale))
    return syms


def test_codec_apply_matches_jax(small_codec_variables):
    """AdaptiveCodec.apply at float32 on the SMALL config with the attention
    and quantizer kernels on, gamma 0.5 and random BN stats."""
    jout, tout = _run_both(small_codec_variables)
    for field in jout._fields:
        want = np.asarray(getattr(jout, field), np.float32)
        got = getattr(tout, field).float().numpy()
        assert got.shape == want.shape, field
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=field)
    for got, want in zip(_symbols(tout), _symbols(jout)):
        np.testing.assert_array_equal(got, want)
    assert np.abs(np.asarray(jout.hq_output) - np.asarray(jout.lq_output)).max() > 1e-2


@pytest.mark.parametrize("overrides", [
    dict(skip_mode="zero", rate_mode="fixed"),
    dict(skip_mode="mask", threshold_mode="hard"),
])
def test_codec_skip_and_rate_modes_match_jax(small_codec_variables, overrides):
    jout, tout = _run_both(small_codec_variables, **overrides)
    for field in ("blended", "dynamic_threshold", "quant_strength", "hq_latent_q", "lq_latent_q"):
        np.testing.assert_allclose(getattr(tout, field).float().numpy(),
                                   np.asarray(getattr(jout, field), np.float32),
                                   atol=1e-4, err_msg=field)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate_mode,threshold_mode", [("reference", "sigmoid"), ("fixed", "hard")])
def test_rd_schedule_and_dynamic_threshold_match_jax(dtype, rate_mode, threshold_mode):
    """The deterministic schedule and blend map in the compute dtype, with
    JAX's scalar rounding (Python constants take the array's dtype first)."""
    kw = dict(SMALL_KW, dtype=dtype, rate_mode=rate_mode, threshold_mode=threshold_mode)
    jc, tc = JCodec(JModelConfig(**kw)), AdaptiveCodec(ModelConfig(**kw))
    rng = np.random.RandomState(9)
    bpp = np.linspace(0.0, 6.0, 8, dtype=np.float32)[:, None]
    mask = rng.rand(8, 5, 5, 1).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), tc.cfg.compute_dtype()
    jres = jc.rd_schedule(jnp.asarray(bpp, jdt))
    tres = tc.rd_schedule(torch.from_numpy(bpp).to(tdt))
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))
    jthr = jc.dynamic_threshold(jnp.asarray(mask, jdt), jres[1])
    tthr = tc.dynamic_threshold(torch.from_numpy(mask).to(tdt).permute(0, 3, 1, 2), tres[1])
    np.testing.assert_allclose(nhwc(tthr), np.asarray(jthr, np.float32),
                               atol=1e-6 if dtype == "float32" else 2 ** -8)


def test_convert_keeps_every_parameter(small_codec_variables):
    """Every JAX leaf lands in the port's state dict and nothing is left over."""
    sd = convert_codec_variables(small_codec_variables, ModelConfig(**SMALL_KW))
    codec = AdaptiveCodec(ModelConfig(**SMALL_KW))
    assert set(sd) == set(codec.state_dict())
    n_jax = sum(np.size(x) for x in jax.tree.leaves(small_codec_variables))
    assert n_jax == sum(t.numel() for t in sd.values())


def test_codec_rejects_training_mode():
    """Train mode with dense_w8 trains the float projections, as the JAX codec
    builds them (`w8=dense_w8 and not train`; it raised here before, the
    name is kept): the train-mode forward equals the dense_w8=False codec's
    on the same weights, gradients included
    (tests/test_torch_w8_polyphase.py holds the inference-mode quantization
    and a step against JAX). The bf16 compute dtype trains: mixed precision
    runs the train-mode forward in bf16 on the float32 parameters, and the
    backward lands float32 gradients on them
    (tests/test_torch_mixed_precision.py holds the step against JAX)."""
    img, mask, bpp = _codec_inputs()
    outs, grads = [], []
    for w8 in (True, False):
        codec = AdaptiveCodec(ModelConfig(**SMALL_KW, dense_w8=w8))
        codec.reset_parameters(0)
        out = codec.apply(torch.from_numpy(img), torch.from_numpy(mask), torch.from_numpy(bpp),
                          train=True)
        out.blended.square().mean().backward()
        outs.append(out.blended.detach())
        grads.append(codec.hq_generator.fc.weight.grad)
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])
    codec = AdaptiveCodec(ModelConfig(**SMALL_KW, dtype="bfloat16", param_dtype="float32"))
    codec.reset_parameters(0)
    out = codec.apply(torch.from_numpy(img), torch.from_numpy(mask), torch.from_numpy(bpp),
                      train=True, detach_for_training=True)
    assert out.blended.dtype == out.hq_latent.dtype == torch.bfloat16
    out.blended.float().square().mean().backward()
    grads = [p.grad for p in codec.hq_encoder.parameters()]
    assert all(g is not None and g.dtype == torch.float32 for g in grads)
    assert all(p.dtype == torch.float32 for p in codec.parameters())
    cfg = ModelConfig(**SMALL_KW)
    assert dataclasses.replace(cfg, skip_mode="zero").resolved_quantizer().grad_mode == "ste"


@pytest.mark.parametrize("case", ["codec-attention", "codec-quantizer", "quantizer", "mask"])
def test_use_pallas_false_raises(case, small_codec_variables):
    """A use_pallas flag set to False runs the JAX package's jnp formula, as
    JAX does (the port raised here before it had these routes; the name is
    kept): the codec with either flag off against JAX's with the same flag
    (float32, gamma 0.5, random BN statistics: every output within this
    file's codec bar 1e-4, the symbols equal), the 'ste' quantizer alone
    (within 1e-6) and the contextual mask (within 1e-6)."""
    rng = np.random.RandomState(8)
    if case.startswith("codec"):
        attn, quant = case != "codec-attention", case != "codec-quantizer"
        jcfg = JModelConfig(**SMALL_KW, attention_use_pallas=attn,
                            quantizer=JQuantizerConfig(use_pallas=quant))
        tcfg = ModelConfig(**SMALL_KW, attention_use_pallas=attn,
                           quantizer=QuantizerConfig(use_pallas=quant))
        img, mask, bpp = _codec_inputs()
        jout, _ = JCodec(jcfg).apply(small_codec_variables, jnp.asarray(img), jnp.asarray(mask),
                                     jnp.asarray(bpp), train=False)
        codec = AdaptiveCodec(tcfg)
        codec.load_state_dict(convert_codec_variables(small_codec_variables, tcfg))
        with torch.no_grad():
            tout = codec.apply(torch.from_numpy(img), torch.from_numpy(mask), torch.from_numpy(bpp))
        for field in ("blended", "hq_latent", "lq_latent", "hq_latent_q", "lq_latent_q"):
            np.testing.assert_allclose(getattr(tout, field).numpy(),
                                       np.asarray(getattr(jout, field)), atol=1e-4, err_msg=field)
        for got, want in zip(_symbols(tout), _symbols(jout)):
            np.testing.assert_array_equal(got, want)
    elif case == "quantizer":
        lat = rng.randn(2, 8).astype(np.float32) * 3
        score, strength = rng.rand(2, 1).astype(np.float32), rng.rand(2, 1).astype(np.float32)
        got = adaptive_quantize(*map(torch.from_numpy, (lat, score, strength)),
                                QuantizerConfig(grad_mode="ste", use_pallas=False))
        from contextual_image_compression_tpu.ops.quantize import adaptive_quantize as jq
        want = jq(*map(jnp.asarray, (lat, score, strength)),
                  JQuantizerConfig(grad_mode="ste", use_pallas=False))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    else:
        from contextual_image_compression_tpu.config import SaliencyConfig as JSaliencyConfig
        from contextual_image_compression_tpu.ops.masks import compute_contextual_mask as jmask
        u8 = rng.randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
        got = compute_contextual_mask(torch.from_numpy(u8), SaliencyConfig(mask_use_pallas=False))
        want = jmask(jnp.asarray(u8), JSaliencyConfig(mask_use_pallas=False))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
