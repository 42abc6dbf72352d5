"""The PyTorch port's GAN training step, loop and quantizer backward against
the JAX package (the building blocks are in test_torch_train_parts.py).

Same seeded numpy inputs and the same weights (carried by
contextual_image_compression_tpu_torch.convert) go through both packages on
the CPU: the port runs each kernel's plain twin, the JAX Pallas kernels run
in interpret mode. The configuration is the tiny one of
tests/test_train_step.py (32^2, D = 16, narrow channels) with the
quantizer's 'reference' gradient mode, so the K3b backward is on the path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import nchw, perturb_variables, to_numpy_tree

from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.config import QuantizerConfig as JQuantizerConfig
from contextual_image_compression_tpu.config import TrainConfig as JTrainConfig
from contextual_image_compression_tpu.models.adaptive import AdaptiveCodec as JCodec
from contextual_image_compression_tpu.ops.quantize import _adaptive_quantize_pallas
from contextual_image_compression_tpu.train import losses as JL
from contextual_image_compression_tpu.train import gan_trainer as jgt
from contextual_image_compression_tpu_torch import ops as tops
from contextual_image_compression_tpu_torch.config import (
    ModelConfig,
    QuantizerConfig,
    TrainConfig,
)
from contextual_image_compression_tpu_torch.convert import (
    component_state,
    convert_codec_variables,
    convert_discriminator_variables,
)
from contextual_image_compression_tpu_torch.data import images as timages
from contextual_image_compression_tpu_torch.data import pipeline as tpipeline
from contextual_image_compression_tpu_torch.models.adaptive import ALL_CODEC_COMPONENTS
from contextual_image_compression_tpu_torch.ops.quantize import (
    adaptive_quantize,
    adaptive_quantize_bwd,
)
from contextual_image_compression_tpu_torch.train.gan_trainer import Batch, GANStepBuilder
from contextual_image_compression_tpu_torch.train.loop import GANTrainer

TINY_KW = dict(
    img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
    generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32,
)
JTINY = JModelConfig(**TINY_KW, attention_use_pallas=True,
                     quantizer=JQuantizerConfig(use_pallas=True, grad_mode="reference"))
TTINY = ModelConfig(**TINY_KW, quantizer=QuantizerConfig(grad_mode="reference"))
LR = 1e-4


def _rel(got, want):
    got = got.detach() if torch.is_tensor(got) else got
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# ---------------------------------------------------------------- K3b


@pytest.mark.parametrize("shape", [(4, 16), (3, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_mode", ["reference", "ste"])
def test_quantizer_backward_matches_jax_vjp(shape, dtype, grad_mode):
    """The port's autograd (K3b's twin in 'reference' mode) against jax.vjp
    of the Pallas quantizer in interpret mode. dsigma and dq are row sums
    whose terms cancel, so the float32 bar is 1e-6 of the sum of the terms'
    magnitudes (summation order differs); bf16 outputs add one bf16 rounding
    (2^-8) of the result."""
    rng = np.random.RandomState(shape[1])
    b, d = shape
    z = (rng.randn(b, d) * 2).astype(np.float32)
    score = rng.rand(b, 1).astype(np.float32)
    strength = (rng.rand(b, 1) * 0.9 + 0.05).astype(np.float32)
    g = rng.randn(b, d).astype(np.float32)
    jdt = jnp.dtype(dtype)
    args = [jnp.asarray(a, jdt) for a in (z, score, strength)]
    _, vjp = jax.vjp(lambda *a: _adaptive_quantize_pallas(*a, 3.0, grad_mode), *args)
    want = [np.asarray(w, np.float32) for w in vjp(jnp.asarray(g, jdt))]

    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ts = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (z, score, strength)]
    before = tops.launch_counts()
    out = adaptive_quantize(*ts, QuantizerConfig(grad_mode=grad_mode))
    out.backward(torch.from_numpy(g).to(tdt))
    assert tops.launch_counts() == before  # CPU tensors: the twins, no launch
    got = [t.grad.float().numpy() for t in ts]
    assert all(x.dtype == tdt for x in (t.grad for t in ts))
    rtol = 1e-6 if dtype == "float32" else 2 ** -8
    if grad_mode == "ste":
        np.testing.assert_array_equal(got[0], want[0])
        assert not got[1].any() and not got[2].any() and not want[1].any()
    else:
        assert not got[0].any() and not want[0].any()
        q64 = np.asarray(args[2], np.float64)
        s64 = np.asarray(args[1], np.float64)
        z64, g64 = np.asarray(args[0], np.float64), np.asarray(jnp.asarray(g, jdt), np.float64)
        scale = np.exp(3.0 * q64 * (1.0 - s64))
        mag = (np.abs(g64 * np.rint(z64 * scale)) / scale ** 2).sum(1, keepdims=True) * 3 * scale
        for x, y, chain in zip(got[1:], want[1:], (q64, 1.0 - s64)):
            bar = 1e-6 * mag * np.abs(chain) + rtol * np.abs(y) * (dtype == "bfloat16")
            assert np.all(np.abs(x - y) <= bar), (np.abs(x - y) / (mag * np.abs(chain))).max()
            assert np.abs(y).max() > 0


def test_k3b_wrapper_twin_and_routing():
    """adaptive_quantize_bwd on CPU tensors is the twin; on another device it
    launches the kernel or raises (never the twin)."""
    rng = np.random.RandomState(3)
    z, g = (torch.from_numpy(rng.randn(2, 8).astype(np.float32)) for _ in range(2))
    s, q = torch.full((2, 1), 0.3), torch.full((2, 1), 0.6)
    ds, dq = adaptive_quantize_bwd(z, s, q, g)
    scale = np.exp(3.0 * 0.6 * 0.7)
    gs = (g.numpy().astype(np.float64) * -np.rint(z.numpy() * scale) / scale ** 2).sum(1)
    np.testing.assert_allclose(ds[:, 0].numpy(), gs * 3 * scale * -0.6, rtol=1e-5)
    np.testing.assert_allclose(dq[:, 0].numpy(), gs * 3 * scale * 0.7, rtol=1e-5)
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError):
        adaptive_quantize_bwd(meta, torch.empty((2, 1), device="meta"),
                              torch.empty((2, 1), device="meta"), meta)


# ---------------------------------------------------------------- train step


def _batch(seed=7):
    rng = np.random.RandomState(seed)
    img = rng.rand(4, 32, 32, 3).astype(np.float32) * 2 - 1
    mask = rng.rand(4, 32, 32, 1).astype(np.float32)
    bpp = np.array([[0.1], [1.0], [2.0], [1.0]], np.float32)
    return img, mask, bpp


def _jax_total_grads(builder, codec_vars, disc_vars, jbatch):
    """jax.grad of the JAX step's g + ls + rd objective (train/gan_trainer.py
    loss_fn) with respect to the codec parameters."""
    lcfg, mcfg = builder.cfg.loss, builder.cfg.model
    rest = {n: {k: v for k, v in codec_vars[n].items() if k != "params"} for n in codec_vars}

    def loss_fn(dp):
        cv = {n: dict(rest[n], params=dp[n]) for n in dp}
        out, _ = builder._codec_apply(cv, jbatch, detach=True)
        fake_preds, _ = builder._disc_apply(jax.lax.stop_gradient(disc_vars), out.blended)
        recon = JL.mse(jbatch.image, out.blended)
        bitrate, underutil = JL.bitrate_losses(out.dynamic_threshold, jbatch.bpp,
                                               mcfg.base_latent_dim, mcfg.img_size, lcfg)
        g = JL.combine_generator_loss(recon, JL.mae(jbatch.image, out.blended),
                                      builder._perceptual(jbatch.image, out.blended),
                                      JL.adversarial_loss(fake_preds), bitrate, lcfg)
        ls = lcfg.ls_loss_weight * JL.latent_saliency_loss(
            out.hq_saliency_loss, out.lq_saliency_loss, jbatch.mask, lcfg)
        rd = (lcfg.rd_loss_weight * JL.rd_loss(out.rd_params, jbatch.bpp, lcfg)
              + lcfg.rd_bitrate_weight * bitrate + underutil)
        return g + ls + rd

    return jax.jit(jax.grad(loss_fn))({n: codec_vars[n]["params"] for n in codec_vars})


def _port_grads(codec):
    return {n: {k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                for k, p in getattr(codec, n).named_parameters()}
            for n in ALL_CODEC_COMPONENTS}


@pytest.fixture(scope="module", params=[("train", "frozen"), ("frozen", "frozen"),
                                        ("train", "train")], ids=lambda p: f"bn_{p[0]}-d_bn_{p[1]}")
def two_steps(request):
    """Both packages take a step with D and a step without from the same
    perturbed weights on the same batch, for the codec's and the
    discriminator's BatchNorm modes. The perceptual term is off here and held
    against JAX on its own (test_perceptual_term_matches_jax)."""
    bn_mode, disc_bn_mode = request.param
    jcfg = JTrainConfig(model=JTINY, batch_size=4, use_perceptual=False)
    tcfg = TrainConfig(model=TTINY, batch_size=4, use_perceptual=False)
    builder = jgt.GANStepBuilder(jcfg, bn_mode=bn_mode, disc_bn_mode=disc_bn_mode)
    st = builder.init_state(jax.random.PRNGKey(0), batch_size=4)
    rng = np.random.RandomState(11)
    st = st.replace(codec_vars=perturb_variables(to_numpy_tree(st.codec_vars), rng),
                    disc_vars=perturb_variables(to_numpy_tree(st.disc_vars), rng))
    img, mask, bpp = _batch()
    jbatch = jgt.Batch(jnp.asarray(img), jnp.asarray(mask), jnp.asarray(bpp))
    step_d, step_nd = builder.jitted_steps(donate=False)
    j1, jm1 = step_d(st, jbatch)
    j2, jm2 = step_nd(j1, jbatch)
    jg1 = _jax_total_grads(builder, st.codec_vars, j1.disc_vars, jbatch)
    jg2 = _jax_total_grads(builder, j1.codec_vars, j1.disc_vars, jbatch)

    tb = GANStepBuilder(tcfg, bn_mode=bn_mode, disc_bn_mode=disc_bn_mode, device="cpu")
    ts = tb.init_state(0)
    ts.codec.load_state_dict(convert_codec_variables(st.codec_vars, TTINY))
    ts.disc.load_state_dict(convert_discriminator_variables(st.disc_vars, TTINY))
    tbatch = Batch(nchw(img), nchw(mask), torch.from_numpy(bpp))
    tm, tg = [], []
    for do_d in (True, False):
        out = tb.codec_forward(ts, tbatch)
        m = {"d_loss": tb.d_phase(ts, tbatch, out)} if do_d else {}
        m.update(tb.g_backward(ts, tbatch, out))
        tg.append(_port_grads(ts.codec))
        tb.g_update(ts)
        tm.append(m)
    return dict(jm=(jm1, jm2), tm=tm, jg=(jg1, jg2), tg=tg, j2=j2, ts=ts)


def test_train_step_metrics_match_jax(two_steps):
    jms, tms = two_steps["jm"], two_steps["tm"]
    assert set(tms[0]) == set(jms[0]) and set(tms[1]) == set(jms[1])
    assert "d_loss" in tms[0] and "d_loss" not in tms[1]
    for jm, tm in zip(jms, tms):
        for k, v in jm.items():
            assert _rel(tm[k], v) <= 1e-5 or abs(float(tm[k]) - float(v)) <= 1e-8, (k, tm[k], v)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_gradients_match_jax(two_steps, step):
    """Each component's gradient of the one backward within a relative L2
    error of 1e-4 (step 1 after the D update, step 2 after two codec steps)."""
    jg, tg = two_steps["jg"][step], two_steps["tg"][step]
    for n in ALL_CODEC_COMPONENTS:
        want = component_state(n, {"params": to_numpy_tree(jg[n])}, TTINY)
        got = tg[n]
        assert set(got) == set(want), n
        diff = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want) ** 0.5
        norm = sum(float((want[k] ** 2).sum()) for k in want) ** 0.5
        assert norm > 0, n
        assert diff <= 1e-4 * norm, (n, diff / norm)


def _param_agreement(got, want):
    err = torch.cat([(got[k].detach().float() - want[k]).abs().reshape(-1) for k in want])
    return float((err <= 1e-6).float().mean()), float(err.max())


def test_train_step_params_match_jax(two_steps):
    """Parameters after the two steps: within 1e-6 on >= 99.9% of elements
    and within 2 lr everywhere (Adam's first steps amplify tiny gradients
    toward +-lr). BN running statistics within 1e-6."""
    ts, j2 = two_steps["ts"], two_steps["j2"]
    want = convert_codec_variables(to_numpy_tree(j2.codec_vars), TTINY)
    sd = ts.codec.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    params = [k for k in want if k not in stats]
    share, worst = _param_agreement(sd, {k: want[k] for k in params})
    assert share >= 0.999 and worst <= 2 * LR, (share, worst)
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
    dwant = convert_discriminator_variables(to_numpy_tree(j2.disc_vars), TTINY)
    share, worst = _param_agreement(ts.disc.state_dict(), dwant)
    assert share >= 0.999 and worst <= 2 * LR, (share, worst)
    assert ts.step == 2


def test_train_step_equals_its_phases():
    """train_step is codec_forward -> d_phase -> g_backward -> g_update."""
    cfg = TrainConfig(model=TTINY, batch_size=4, use_perceptual=False)
    img, mask, bpp = _batch(3)
    batch = Batch(nchw(img), nchw(mask), torch.from_numpy(bpp))
    b = GANStepBuilder(cfg, device="cpu")
    s1, s2 = b.init_state(5), b.init_state(5)
    _, m1 = b.train_step(s1, batch, True)
    out = b.codec_forward(s2, batch)
    m2 = {"d_loss": b.d_phase(s2, batch, out), **b.g_backward(s2, batch, out)}
    b.g_update(s2)
    assert m1.keys() == m2.keys()
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    for (k, a), (_, c) in zip(s1.codec.state_dict().items(), s2.codec.state_dict().items()):
        assert torch.equal(a, c), k


def test_bn_stats_move_in_train_mode_only():
    cfg = TrainConfig(model=TTINY, batch_size=4, use_perceptual=False)
    img, mask, bpp = _batch(4)
    batch = Batch(nchw(img), nchw(mask), torch.from_numpy(bpp))
    for mode in ("train", "frozen"):
        b = GANStepBuilder(cfg, bn_mode=mode, device="cpu")
        s = b.init_state(1)
        before = s.codec.hq_encoder.bn2.running_mean.clone()
        b.train_step(s, batch, True)
        moved = not torch.equal(before, s.codec.hq_encoder.bn2.running_mean)
        assert moved == (mode == "train"), mode


# ---------------------------------------------------------------- loop


def test_rate_control_probe_matches_jax(tmp_path):
    """d mean(HQ ratio) / d bpp at 0.1, 1.0, 2.0 on the first sample, codec
    in eval mode, values and gradients."""
    v = perturb_variables(to_numpy_tree(JCodec(JTINY).init(jax.random.PRNGKey(2))),
                          np.random.RandomState(2))
    img, mask, _ = _batch(9)
    codec = JCodec(JTINY)

    def hq_ratio(b):
        out, _ = codec.apply(v, jnp.asarray(img[:1]), jnp.asarray(mask[:1]),
                             jnp.full((1, 1), b), train=False)
        return jnp.mean(out.dynamic_threshold)

    cfg = TrainConfig(model=TTINY, batch_size=4, use_perceptual=False, model_dir=str(tmp_path))
    trainer = GANTrainer(cfg, device="cpu", log_fn=lambda s: None)
    trainer.init_state(resume=False)
    trainer.state.codec.load_state_dict(convert_codec_variables(v, TTINY))
    sample = Batch(nchw(img), nchw(mask), torch.ones(4, 1))
    got = trainer.rate_control_probe(sample)
    for (bpp, ratio, grad) in got:
        r, g = jax.value_and_grad(hq_ratio)(jnp.float32(bpp))
        assert abs(ratio - float(r)) <= 1e-6 and abs(grad - float(g)) <= 1e-5 * max(1, abs(float(g)))


def test_fit_runs_and_refuses_what_waits(tmp_path):
    """fit alternates the D / no-D steps, fills the history and writes the
    final checkpoint; artifacts raise instead of being skipped quietly.
    init_state() with nothing in model_dir starts fresh."""
    cfg = TrainConfig(model=TTINY, batch_size=4, use_perceptual=False, epochs=1,
                      model_dir=str(tmp_path))
    imgs = timages.synthetic_images(8, (32, 32), seed=1)
    masks = np.random.RandomState(1).rand(8, 32, 32, 1).astype(np.float32)
    ds = tpipeline.CompressionDataset(imgs, masks, batch_size=4, device="cpu")
    logs = []
    trainer = GANTrainer(cfg, device="cpu", log_fn=logs.append)
    assert trainer.init_state().step == 0 and trainer.start_epoch == 0
    with pytest.raises(NotImplementedError):
        trainer.fit(ds)
    hist = trainer.fit(ds, steps_per_epoch=3, artifacts=False)
    assert trainer.state.step == 3
    assert all(len(hist[k]) == 1 and np.isfinite(hist[k][0]) for k in hist)
    assert logs[-1].startswith("Epoch 1:")
    assert (tmp_path / "optimizers_final.msgpack").exists()
    with pytest.raises(NotImplementedError):
        trainer.rate_control_probe(ds.first_samples(), save_path="probe.png")
