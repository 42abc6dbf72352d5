"""The PyTorch port's training building blocks against the JAX package:
losses, keras-style Adam, BatchNorm in train mode, the discriminator, the
VGG19 tower and the data pipeline.

Same seeded numpy inputs and the same weights (carried by
contextual_image_compression_tpu_torch.convert) go through both packages on
the CPU; the port runs each kernel's plain twin (K1 in prepare_masks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import nchw, nhwc, perturb_variables, to_numpy_tree

from contextual_image_compression_tpu.config import LossConfig as JLossConfig
from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.config import SaliencyConfig as JSaliencyConfig
from contextual_image_compression_tpu.config import TrainConfig as JTrainConfig
from contextual_image_compression_tpu.data import images as jimages
from contextual_image_compression_tpu.data import pipeline as jpipeline
from contextual_image_compression_tpu.models import layers as jl
from contextual_image_compression_tpu.models import vgg as jvgg
from contextual_image_compression_tpu.models.discriminator import Discriminator as JDisc
from contextual_image_compression_tpu.train import gan_trainer as jgt
from contextual_image_compression_tpu.train import losses as JL
from contextual_image_compression_tpu.train.optimizers import keras_adam as j_keras_adam
from contextual_image_compression_tpu_torch import ops as tops
from contextual_image_compression_tpu_torch.config import LossConfig, ModelConfig, TrainConfig
from contextual_image_compression_tpu_torch.convert import (
    component_state,
    convert_discriminator_variables,
    convert_vgg_variables,
)
from contextual_image_compression_tpu_torch.data import images as timages
from contextual_image_compression_tpu_torch.data import pipeline as tpipeline
from contextual_image_compression_tpu_torch.models import layers as tl
from contextual_image_compression_tpu_torch.models import vgg as tvgg
from contextual_image_compression_tpu_torch.models.discriminator import Discriminator
from contextual_image_compression_tpu_torch.train import losses as TL
from contextual_image_compression_tpu_torch.train.gan_trainer import GANStepBuilder
from contextual_image_compression_tpu_torch.train.optimizers import KerasAdam

CFG32 = ModelConfig(img_size=(32, 32))


def _rel(got, want):
    got = got.detach() if torch.is_tensor(got) else got
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# ---------------------------------------------------------------- losses


def _loss_inputs():
    rng = np.random.RandomState(21)
    return dict(
        probs=rng.rand(4, 1).astype(np.float32),
        extreme=np.array([[0.0], [1.0], [0.5], [1e-9]], np.float32),
        a=rng.randn(4, 8, 8, 3).astype(np.float32),
        b=rng.randn(4, 8, 8, 3).astype(np.float32),
        scores=rng.rand(4, 1).astype(np.float32),
        masks=rng.rand(4, 8, 8, 1).astype(np.float32),
        rd=rng.rand(4, 3).astype(np.float32),
        bpp=np.array([[0.1], [1.0], [2.0], [1.7]], np.float32),
        alloc=rng.rand(4, 8, 8, 1).astype(np.float32),
        feats=[rng.randn(2, 4, 4, c).astype(np.float32) * (c / 8) for c in (8, 16, 4, 4, 2)],
        feats2=[rng.randn(2, 4, 4, c).astype(np.float32) for c in (8, 16, 4, 4, 2)],
    )


LOSS_CASES = {
    "bce": lambda m, L, cfg, x: m.bce(x["scores"] > 0.5, x["probs"]),
    "bce_clipped": lambda m, L, cfg, x: m.bce(np.ones_like(x["extreme"]), x["extreme"]),
    "mse": lambda m, L, cfg, x: m.mse(x["a"], x["b"]),
    "mae": lambda m, L, cfg, x: m.mae(x["a"], x["b"]),
    "discriminator": lambda m, L, cfg, x: m.discriminator_loss(x["probs"], x["scores"], cfg),
    "adversarial": lambda m, L, cfg, x: m.adversarial_loss(x["probs"]),
    "perceptual": lambda m, L, cfg, x: m.perceptual_loss(x["feats"], x["feats2"],
                                                         cfg.perceptual_layer_weights, 0.5),
    "latent_saliency": lambda m, L, cfg, x: m.latent_saliency_loss(
        x["scores"], 1 - x["scores"] * 0.5, x["masks"], cfg),
    "latent_saliency_quirk": lambda m, L, cfg, x: m.latent_saliency_loss(
        x["scores"], 1 - x["scores"] * 0.5, x["masks"],
        dataclasses.replace(cfg, reference_broadcast_quirk=True)),
    "rd": lambda m, L, cfg, x: m.rd_loss(x["rd"], x["bpp"], cfg),
    "analytic_bpp": lambda m, L, cfg, x: m.analytic_bpp_from_allocation(x["alloc"], 16, (32, 32)),
    "bitrate": lambda m, L, cfg, x: m.bitrate_losses(x["alloc"], x["bpp"], 16, (32, 32), cfg),
    "bitrate_quirk": lambda m, L, cfg, x: m.bitrate_losses(
        x["alloc"], x["bpp"], 16, (32, 32), dataclasses.replace(cfg, reference_broadcast_quirk=True)),
    "combine_above_floor": lambda m, L, cfg, x: m.combine_generator_loss(
        *[L(v) for v in (0.9, 0.7, 0.4, 0.8, 0.3)], cfg),
    "combine_floor_hack": lambda m, L, cfg, x: m.combine_generator_loss(
        *[L(v) for v in (0.1, 0.2, 0.05, 0.3, 0.1)], cfg),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    """Each loss on the same inputs within 1e-6 relative (the quirk and
    floor-hack branches included)."""
    x = _loss_inputs()

    def jconv(v):
        return [jnp.asarray(a) for a in v] if isinstance(v, list) else jnp.asarray(v)

    def tconv(v):
        return [torch.from_numpy(a) for a in v] if isinstance(v, list) else torch.as_tensor(v)

    want = LOSS_CASES[name](JL, jnp.float32, JLossConfig(), {k: jconv(v) for k, v in x.items()})
    got = LOSS_CASES[name](TL, lambda v: torch.tensor(v, dtype=torch.float32), LossConfig(),
                           {k: tconv(v) for k, v in x.items()})
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        w = np.asarray(w, np.float32)
        g = g.detach().numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    if name == "combine_floor_hack":  # 0.5 floor: g = 0.1375, offset (0.5 - g) / 2
        assert abs(float(got[0]) - (0.1375 + (0.5 - 0.1375) * 0.5)) < 1e-6


# ---------------------------------------------------------------- optimizer


def test_keras_adam_matches_optax_chain():
    """Per-tensor clipnorm (one tensor above the norm, one below, one
    without a gradient in step 2) then Adam, three updates, within 1e-6."""
    rng = np.random.RandomState(5)
    p0 = {"a": rng.randn(6, 5).astype(np.float32), "b": rng.randn(7).astype(np.float32),
          "c": rng.randn(3).astype(np.float32)}
    grads = [{"a": rng.randn(6, 5).astype(np.float32) * 3.0,
              "b": rng.randn(7).astype(np.float32) * 0.01,
              "c": rng.randn(3).astype(np.float32) * (0.0 if i == 1 else 1.0)} for i in range(3)]
    tx = j_keras_adam(1e-3, clipnorm=1.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = KerasAdam(tp.values(), 1e-3, clipnorm=1.0)
    for i, gr in enumerate(grads):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for k, p in tp.items():
            if not (k == "c" and i == 1):  # no gradient: stepped with zeros, as optax does
                p.grad = torch.from_numpy(gr[k].copy())
        opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6)


# ---------------------------------------------------------------- layers


def test_kbatchnorm_train_matches_flax():
    """Train mode: output on the batch statistics, and the running update
    0.99 * running + 0.01 * batch with the biased variance, held until the
    commit."""
    rng = np.random.RandomState(4)
    x = (rng.randn(4, 6, 6, 12) * 1.5 + 0.3).astype(np.float32)
    mod = jl.KBatchNorm()
    v = perturb_variables(to_numpy_tree(
        mod.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=True)), rng)
    want, upd = mod.apply(v, jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    bn = tl.KBatchNorm(12)
    bn.load_state_dict(component_state("layer", v, ModelConfig()))
    got = nhwc(bn(nchw(x), train=True))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    stats = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_array_equal(bn.running_mean.numpy(), v["batch_stats"]["BatchNorm_0"]["mean"])
    bn.commit_batch_stats()
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)
    assert bn.pending is None


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_jax(train):
    """32^2 input: three stages, BN after the activation from stage 1 on,
    the NHWC flatten carried by the converted dense rows."""
    rng = np.random.RandomState(8)
    x = (rng.rand(3, 32, 32, 3) * 2 - 1).astype(np.float32)
    jd = JDisc()
    v = perturb_variables(to_numpy_tree(jd.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)),
                          rng)
    if train:
        want, _ = jd.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jd.apply(v, jnp.asarray(x), train=False)
    td = Discriminator((32, 32))
    td.load_state_dict(convert_discriminator_variables(v, CFG32))
    got = td(nchw(x), train).detach().numpy()
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("size", [32, 64])
def test_vgg_taps_match_jax(size):
    """caffe preprocessing (BGR flip on the channel axis) and the five taps
    with the JAX tower's random weights carried across."""
    rng = np.random.RandomState(size)
    x = (rng.rand(2, size, size, 3) * 2 - 1).astype(np.float32)
    jmod, jv = jvgg.load_vgg19_features("random:3")
    want = jmod.apply(jv, jvgg.preprocess_caffe(jnp.asarray(x)))
    tmod = tvgg.VGG19Features()
    tmod.load_state_dict(convert_vgg_variables(to_numpy_tree(jv)))
    got = tmod(tvgg.preprocess_caffe(nchw(x)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(nhwc(g), w, atol=1e-4 * max(1.0, np.abs(w).max()))


def test_vgg_npz_loader_and_fingerprint(tmp_path):
    """The .npz loader (HWIO kernels) and the fingerprint check: the JAX
    package's fingerprint of a tower passes the port's check, a wrong
    fingerprint is refused, a missing key gives None."""
    jmod, jv = jvgg.load_vgg19_features("random:4")
    fp = jvgg.compute_tap_fingerprint(jmod, jv)
    arrays = {}
    for name, leaf in jv["params"].items():
        arrays[f"{name}_kernel"] = np.asarray(leaf["kernel"])
        arrays[f"{name}_bias"] = np.asarray(leaf["bias"])
    path = tmp_path / "vgg.npz"
    np.savez(path, fingerprint=fp, **arrays)
    mod = tvgg.load_vgg19_features(str(path), device="cpu")
    np.testing.assert_allclose(tvgg.compute_tap_fingerprint(mod), fp, rtol=1e-4)
    np.savez(path, fingerprint=fp * 1.5, **arrays)
    with pytest.raises(ValueError, match="fingerprint"):
        tvgg.load_vgg19_features(str(path), device="cpu")
    del arrays["block5_conv4_bias"]
    np.savez(path, **arrays)
    assert tvgg.load_vgg19_features(str(path), device="cpu") is None
    assert tvgg.load_vgg19_features("", device="cpu") is None


def test_random_vgg_is_seeded_and_lecun_normal():
    a = tvgg.load_vgg19_features("random:7", device="cpu")
    b = tvgg.load_vgg19_features("random:7", device="cpu")
    w = a.block3_conv2.weight
    assert torch.equal(w, b.block3_conv2.weight) and not w.requires_grad
    std = (1.0 / (256 * 9)) ** 0.5
    assert abs(w.std().item() / std - 1.0) < 0.02 and w.abs().max().item() <= 2 * std / 0.8796
    assert not a.block3_conv2.bias.any()


def test_perceptual_term_matches_jax():
    """The step's perceptual term (caffe preprocessing, the VGG19 taps of a
    random tower carried across, z-scored MSE) and its gradient with respect
    to the reconstruction. The bar is set by the reference, not the port:
    XLA's float32 mean and std on the CPU over the 131,072 elements of the
    first tap miss float64 by ~3e-4 relative, where torch's stay within 1e-6
    (asserted here), so the first tap's loss and gradient move by ~1e-4."""
    rng = np.random.RandomState(12)
    a = (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    b = (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    jm, jv = jvgg.load_vgg19_features("random:0")
    builder = jgt.GANStepBuilder(JTrainConfig(model=JModelConfig(img_size=(32, 32)), batch_size=2), vgg=jm, vgg_vars=jv)
    want, jgrad = jax.value_and_grad(lambda x: builder._perceptual(jnp.asarray(a), x))(
        jnp.asarray(b))
    tm = tvgg.VGG19Features().requires_grad_(False)
    tm.load_state_dict(convert_vgg_variables(to_numpy_tree(jv)))
    tb = GANStepBuilder(TrainConfig(model=CFG32, batch_size=2), vgg=tm, device="cpu")
    x = nchw(b).requires_grad_(True)
    got = tb.perceptual(nchw(a), x)
    got.backward()
    assert _rel(got, want) <= 2e-4, (float(got), float(want))
    g, w = nhwc(x.grad), np.asarray(jgrad)
    assert np.linalg.norm(g - w) <= 2e-3 * np.linalg.norm(w)
    with torch.no_grad():
        tap = tm(tvgg.preprocess_caffe(nchw(a)))[0]
    t64 = tap.double()
    assert abs(tap.std(correction=0).item() / t64.std(correction=0).item() - 1) <= 1e-6
    assert abs(tap.mean().item() / t64.mean().item() - 1) <= 1e-6


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("fn", ["synthetic_images", "rich_synthetic_images"])
def test_synthetic_images_bitwise_equal(fn):
    want = getattr(jimages, fn)(3, (48, 40), seed=5)
    got = getattr(timages, fn)(3, (48, 40), seed=5)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_prepare_masks_matches_jax():
    """Masks of [-1, 1] float images in batches of 3 (two batches, one
    ragged) within 1e-4 of the JAX package's."""
    imgs = timages.synthetic_images(5, (64, 64), seed=2)
    want = jpipeline.prepare_masks(imgs, JSaliencyConfig(), device_batch=3)
    before = tops.launch_counts()
    got = tpipeline.prepare_masks(imgs, device_batch=3, device="cpu")
    assert tops.launch_counts() == before
    assert got.shape == want.shape == (5, 64, 64, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("device_resident", [False, True])
def test_dataset_order_and_bpp_match_jax(device_resident):
    """Equal seeds give equal shuffles, bpp draws and first samples; batches
    are NCHW on the port's side."""
    rng = np.random.RandomState(0)
    imgs = rng.rand(10, 8, 8, 3).astype(np.float32)
    masks = rng.rand(10, 8, 8, 1).astype(np.float32)
    jds = jpipeline.CompressionDataset(imgs, masks, batch_size=4, seed=9)
    tds = tpipeline.CompressionDataset(imgs, masks, batch_size=4, seed=9, device="cpu",
                                       device_resident=device_resident)
    assert tds.steps_per_epoch == jds.steps_per_epoch == 2
    for _ in range(2):
        jb, tb = list(jds.epoch()), list(tds.epoch())
        assert len(jb) == len(tb) == 2
        for j, t in zip(jb, tb):
            np.testing.assert_array_equal(nhwc(t.image), np.asarray(j.image))
            np.testing.assert_array_equal(nhwc(t.mask), np.asarray(j.mask))
            np.testing.assert_array_equal(t.bpp.numpy(), np.asarray(j.bpp))
    fixed_j, fixed_t = jds.with_target_bpp(0.5), tds.with_target_bpp(0.5)
    np.testing.assert_array_equal(next(fixed_t.epoch()).bpp.numpy(),
                                  np.asarray(next(fixed_j.epoch()).bpp))
    js, ts = jds.first_samples(3), tds.first_samples(3)
    np.testing.assert_array_equal(ts.bpp.numpy(), np.asarray(js.bpp))
    np.testing.assert_array_equal(nhwc(ts.image), np.asarray(js.image))
