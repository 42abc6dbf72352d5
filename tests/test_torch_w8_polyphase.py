"""dense_w8 in training and the polyphase deconvolution of the PyTorch port
against the JAX package.

`ModelConfig(dense_w8=True)`: the JAX codec builds its latent and fc
projections with `w8=dense_w8 and not train`, so a forward on BatchNorm's
running statistics (bn_mode 'frozen', every inference forward) quantizes
the float kernel at trace time, s = max|w| / 127 per output, q =
rint(w / max(s, 1e-12)) as int8, and the gradient reaches the kernel only
through s; a batch-statistics forward takes the float layer. The port's
KDense does the same. After Adam steps a w8 kernel can then change only at
the arg-max entries of its rows, which each step's start picks: Adam with
zero moments moves a zero-gradient entry by exactly 0.

`ModelConfig(generator_polyphase=True)` lowers the generators' 4x4/s2
deconvolutions as one stride-1 2x2 convolution with 4 Cout outputs and a
phase interleave (`layers.KConvT(polyphase=True)`), with the parameters
of the plain layer.
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
from contextual_image_compression_tpu.config import TrainConfig as JTrainConfig
from contextual_image_compression_tpu.models import layers as jl
from contextual_image_compression_tpu.models.adaptive import AdaptiveCodec as JCodec
from contextual_image_compression_tpu.train import gan_trainer as jgt
from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.config import (
    ModelConfig,
    QuantizerConfig,
    TrainConfig,
)
from contextual_image_compression_tpu_torch.models import layers as tl
from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
from contextual_image_compression_tpu_torch.train.gan_trainer import Batch, GANStepBuilder

TINY_KW = dict(
    img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
    generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32,
)
# jnp routes on both sides (the quantizer's 'ste' mode, so the encoders'
# latent projections get gradients too)
JW8 = JModelConfig(**TINY_KW, dense_w8=True, attention_use_pallas=False,
                   quantizer=JQuantizerConfig(use_pallas=False, grad_mode="ste"))
TW8 = ModelConfig(**TINY_KW, dense_w8=True, attention_use_pallas=False,
                  quantizer=QuantizerConfig(use_pallas=False, grad_mode="ste"))
W8_LAYERS = ("hq_encoder.latent_dense.weight", "lq_encoder.latent_dense.weight",
             "hq_generator.fc.weight", "lq_generator.fc.weight")
LR = 1e-4


def _arrays(seed=7):
    rng = np.random.RandomState(seed)
    img = rng.rand(4, 32, 32, 3).astype(np.float32) * 2 - 1
    mask = rng.rand(4, 32, 32, 1).astype(np.float32)
    bpp = np.array([[0.1], [1.0], [2.0], [1.0]], np.float32)
    return img, mask, bpp


def test_kdense_w8_trace_time_gradient_matches_jax():
    """KDense(w8=True) holding its float weight, at inference (train=False):
    the output and the gradients of x, the kernel and the bias against the
    flax layer's, float32. The kernel's gradient is nonzero only at each
    output's arg-max |w| (a tie splits it evenly, in both frameworks; a zero
    row gives none), within 1e-6 of its largest magnitude (measured 1.6e-7);
    the output within 2e-6 (measured 9.5e-7), the gradients of x and the
    bias within 1e-6 (measured 4.8e-7). train=True takes the float layer."""
    rng = np.random.RandomState(3)
    x = rng.randn(5, 24).astype(np.float32)
    w = rng.randn(24, 6).astype(np.float32)
    w[3, 1] = -w[:, 1].__abs__().max()  # a tie in column 1
    w[:, 4] = 0.0                       # an all-zero column
    b = rng.randn(6).astype(np.float32)
    g = rng.randn(5, 6).astype(np.float32)
    mod = jl.KDense(6, w8=True)
    v = {"params": {"Dense_0": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}}
    want, vjp = jax.vjp(lambda vv, xx: mod.apply(vv, xx), v, jnp.asarray(x))
    jv, jx = vjp(jnp.asarray(g))
    jk = np.asarray(jv["params"]["Dense_0"]["kernel"]).T  # (out, in)
    port = tl.KDense(24, 6, w8=True)
    port.load_state_dict(convert.component_state("layer", to_numpy_tree(v), ModelConfig()))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt, train=False)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(jv["params"]["Dense_0"]["bias"]),
                               atol=1e-6)
    gw = port.weight.grad.numpy()
    assert np.abs(gw - jk).max() <= 1e-6 * np.abs(jk).max()
    argmax = np.abs(w.T) == np.abs(w.T).max(axis=1, keepdims=True)
    assert np.all(gw[~argmax] == 0) and np.all(jk[~argmax] == 0)
    tie = np.abs(gw[1][argmax[1]])
    assert np.count_nonzero(gw[1]) == 2 and tie[0] == tie[1]
    assert not np.any(gw[4])
    assert torch.equal(port(torch.from_numpy(x), train=True),
                       torch.nn.functional.linear(torch.from_numpy(x), port.weight, port.bias))


@pytest.fixture(scope="module")
def w8_step():
    """The JAX step builder with dense_w8 (bn 'frozen'), perturbed weights,
    one step with D; the port from the same weights takes the same step."""
    builder = jgt.GANStepBuilder(JTrainConfig(model=JW8, batch_size=4, use_perceptual=False),
                                 bn_mode="frozen")
    st = builder.init_state(jax.random.PRNGKey(0), batch_size=4)
    rng = np.random.RandomState(11)
    st = st.replace(codec_vars=perturb_variables(to_numpy_tree(st.codec_vars), rng),
                    disc_vars=perturb_variables(to_numpy_tree(st.disc_vars), rng))
    img, mask, bpp = _arrays()
    jb = jgt.Batch(jnp.asarray(img), jnp.asarray(mask), jnp.asarray(bpp))
    step_d, _ = builder.jitted_steps(donate=False)
    j1, jm = step_d(st, jb)
    tb = GANStepBuilder(TrainConfig(model=TW8, batch_size=4, use_perceptual=False),
                        bn_mode="frozen", device="cpu")
    ts = tb.init_state(0)
    ts.codec.load_state_dict(convert.convert_codec_variables(st.codec_vars, TW8))
    ts.disc.load_state_dict(convert.convert_discriminator_variables(st.disc_vars, TW8))
    start = {k: v.clone() for k, v in ts.codec.state_dict().items()}
    batch = Batch(nchw(img), nchw(mask), torch.from_numpy(bpp))
    _, tm = tb.train_step(ts, batch, True)
    return dict(st=st, j1=j1, jm=jm, tb=tb, ts=ts, tm=tm, start=start, batch=batch)


def test_dense_w8_train_step_matches_jax(w8_step):
    """One step with D: metrics within 1e-5 relative or 1e-8 absolute
    (measured 5.3e-6 at most), parameters within 1e-6 on >= 99.9% and 2 lr
    everywhere (measured all within 6e-8), D's within 1e-6: the float32
    training bars of tests/test_torch_train.py."""
    jm, tm, ts, j1 = w8_step["jm"], w8_step["tm"], w8_step["ts"], w8_step["j1"]
    assert set(tm) == set(jm)
    for k, v in jm.items():
        err = abs(float(tm[k]) - float(v))
        assert err <= 1e-5 * abs(float(v)) or err <= 1e-8, (k, float(tm[k]), float(v))
    want = convert.convert_codec_variables(to_numpy_tree(j1.codec_vars), TW8)
    sd = ts.codec.state_dict()
    err = torch.cat([(sd[k] - want[k]).abs().reshape(-1) for k in want])
    assert float((err <= 1e-6).double().mean()) >= 0.999 and float(err.max()) <= 2 * LR
    dwant = convert.convert_discriminator_variables(to_numpy_tree(j1.disc_vars), TW8)
    assert max(float((ts.disc.state_dict()[k] - v).abs().max()) for k, v in dwant.items()) <= 1e-6


def test_dense_w8_kernels_move_at_their_arg_max_only(w8_step):
    """After the JAX-held step and two more, each w8 kernel changed only at
    entries that were a row's arg-max |w| at the start of some step, and
    each row moved (its arg-max did); the same layers of a float codec move
    almost everywhere."""
    tb, ts, batch = w8_step["tb"], w8_step["ts"], w8_step["batch"]
    start = w8_step["start"]
    allowed = {k: start[k].abs() == start[k].abs().amax(dim=1, keepdim=True) for k in W8_LAYERS}
    for do_d in (False, True):
        sd = ts.codec.state_dict()
        for k in W8_LAYERS:
            allowed[k] |= sd[k].abs() == sd[k].abs().amax(dim=1, keepdim=True)
        tb.train_step(ts, batch, do_d)
    sd = ts.codec.state_dict()
    for k in W8_LAYERS:
        moved = sd[k] != start[k]
        assert not torch.any(moved & ~allowed[k]), k
        assert torch.all(moved.any(dim=1)), k
    fb = GANStepBuilder(TrainConfig(model=dataclasses.replace(TW8, dense_w8=False), batch_size=4,
                                    use_perceptual=False), bn_mode="frozen", device="cpu")
    fs = fb.init_state(0)
    fs.codec.load_state_dict(start)
    fb.train_step(fs, batch, True)
    fsd = fs.codec.state_dict()
    for k in W8_LAYERS:
        assert float((fsd[k] != start[k]).double().mean()) > 0.5, k


def test_dense_w8_on_batch_statistics_trains_the_float_layers():
    """bn_mode 'train': the JAX codec builds the projections without w8 in
    a batch-statistics forward, so dense_w8 changes nothing there: a step
    equals the dense_w8=False codec's bit for bit."""
    img, mask, bpp = _arrays(3)
    batch = Batch(nchw(img), nchw(mask), torch.from_numpy(bpp))
    sds = []
    for w8 in (True, False):
        b = GANStepBuilder(TrainConfig(model=dataclasses.replace(TW8, dense_w8=w8), batch_size=4,
                                       use_perceptual=False), device="cpu")
        s = b.init_state(0)
        b.train_step(s, batch, True)
        sds.append(s.codec.state_dict())
    assert all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])


# ------------------------------------------------------------- polyphase


@pytest.mark.parametrize("shape", [(2, 16, 5, 5), (1, 8, 4, 7)], ids=["5x5", "4x7"])
def test_polyphase_deconv_matches_flax_and_the_plain_layer(shape):
    """PolyphaseConvT4x4s2 against flax's `_PolyphaseConvT4x4s2` and
    nn.ConvTranspose on the same kernel (converted once, as KConvT's), and
    against the port's plain KConvT: all within 1e-5 (measured 9.5e-7;
    JAX's own test calls the lowerings fp32 noise apart)."""
    b, cin, h, w = shape
    rng = np.random.RandomState(2)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    poly = jl._PolyphaseConvT4x4s2(6)
    v = perturb_variables(to_numpy_tree(poly.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    want_poly = np.asarray(poly.apply(v, jnp.asarray(x)))
    want = np.asarray(jl.KConvT(6, 4, 2).apply({"params": {"ConvTranspose_0": v["params"]}},
                                                 jnp.asarray(x)))
    sd = convert.component_state("layer", {"params": {"ConvTranspose_0": v["params"]}},
                                 ModelConfig())
    port = tl.PolyphaseConvT4x4s2(cin, 6)
    port.load_state_dict(sd)
    plain = tl.KConvT(cin, 6)
    plain.load_state_dict(sd)
    got = nhwc(port(nchw(x)))
    assert got.shape == (b, 2 * h, 2 * w, 6)
    for ref in (want_poly, want, nhwc(plain(nchw(x)))):
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_polyphase_codec_matches_jax():
    """A tiny codec with generator_polyphase=True against JAX's with the same
    flag (kernels on: K2 / K3 twins against the Pallas kernels in interpret
    mode), float32, from the same perturbed weights: blended image within
    1e-5 (measured 1.8e-7), and within 1e-5 of the port's plain-deconv
    codec on the same weights (measured 1.8e-7)."""
    jcfg = JModelConfig(**TINY_KW, generator_polyphase=True)
    cfg = ModelConfig(**TINY_KW, generator_polyphase=True)
    jc = JCodec(jcfg)
    v = perturb_variables(to_numpy_tree(jc.init(jax.random.PRNGKey(1), batch_size=1)),
                          np.random.RandomState(5))
    img, mask, bpp = _arrays(2)
    want = np.asarray(jax.jit(lambda vv: jc.apply(vv, jnp.asarray(img), jnp.asarray(mask),
                                                  jnp.asarray(bpp))[0].blended)(v))
    outs = []
    for c in (cfg, dataclasses.replace(cfg, generator_polyphase=False)):
        codec = AdaptiveCodec(c)
        codec.load_state_dict(convert.convert_codec_variables(v, c))
        with torch.no_grad():
            outs.append(codec.apply(*(torch.from_numpy(a) for a in (img, mask, bpp))).blended)
    assert codec.hq_generator.deconv1.polyphase is False
    np.testing.assert_allclose(outs[0].numpy(), want, atol=1e-5)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-5)
