"""Mixed-precision GAN training in the PyTorch port against the JAX package.

`ModelConfig(dtype="bfloat16", param_dtype="float32")` (the training
scripts' `--precision mixed`) is JAX's recipe: activations in bfloat16;
parameters, Adam moments and BatchNorm statistics in float32; every loss in
float32; VGG19 in float32. Here, on the CPU:

  * the port's counterparts of tests/test_mixed_precision.py;
  * one step with D and one without, from the same perturbed weights, in
    both packages at that file's TINY_BF16 configuration, the JAX side with
    its Pallas kernels in interpret mode (the port has no use_pallas=False);
  * KBatchNorm in bfloat16 with float32 statistics against
    flax.linen.BatchNorm, preprocess_caffe on bfloat16 against JAX's, and
    K2's bfloat16 gradient against a float64 truth;
  * resume across the packages: a JAX mixed state saved through the JAX
    CheckpointStore resumes in the port's GANTrainer, and the reverse.

bfloat16 keeps 8 significant bits, and the packages round it differently:
XLA may hold a fused chain of bfloat16 operations in float32, torch rounds
after every operation, and the convolutions accumulate in another order.
At this size such a difference flips a few quantizer symbols, so the two
mixed steps agree to bfloat16 noise, not to float32's bars; each test states
its bar and what was measured.
"""

import dataclasses
import os

import flax.linen as fnn
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import nchw, perturb_variables, to_numpy_tree

from contextual_image_compression_tpu.checkpoint import CheckpointStore as JStore
from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.config import QuantizerConfig as JQuantizerConfig
from contextual_image_compression_tpu.config import TrainConfig as JTrainConfig
from contextual_image_compression_tpu.models import vgg as jvgg
from contextual_image_compression_tpu.ops.attention import attention_block_pallas
from contextual_image_compression_tpu.train import gan_trainer as jgt
from contextual_image_compression_tpu.train.loop import GANTrainer as JTrainer
from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.checkpoint import flax_msgpack as fm
from contextual_image_compression_tpu_torch.config import (
    ModelConfig,
    QuantizerConfig,
    TrainConfig,
)
from contextual_image_compression_tpu_torch.data import images as timages
from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
from contextual_image_compression_tpu_torch.models import layers as tl
from contextual_image_compression_tpu_torch.models import vgg as tvgg
from contextual_image_compression_tpu_torch.models.adaptive import ALL_CODEC_COMPONENTS
from contextual_image_compression_tpu_torch.ops.attention import attention_block
from contextual_image_compression_tpu_torch.train import losses as TL
from contextual_image_compression_tpu_torch.train.gan_trainer import Batch, GANStepBuilder
from contextual_image_compression_tpu_torch.train.loop import GANTrainer

TINY_KW = dict(
    img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
    generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32,
)
MIXED = dict(dtype="bfloat16", param_dtype="float32")
# tests/test_mixed_precision.py's TINY_BF16 with the Pallas kernels on
JMIX = JModelConfig(**TINY_KW, attention_use_pallas=True,
                    quantizer=JQuantizerConfig(use_pallas=True, grad_mode="ste"), **MIXED)
TMIX = ModelConfig(**TINY_KW, quantizer=QuantizerConfig(grad_mode="ste"), **MIXED)
FILES = ALL_CODEC_COMPONENTS + ("discriminator", "optimizers")
LR = 1e-4


def _arrays(seed=7):
    rng = np.random.RandomState(seed)
    img = rng.rand(4, 32, 32, 3).astype(np.float32) * 2 - 1
    mask = rng.rand(4, 32, 32, 1).astype(np.float32)
    bpp = np.array([[0.1], [1.0], [2.0], [1.0]], np.float32)
    return img, mask, bpp


def _batches(seed=7):
    img, mask, bpp = _arrays(seed)
    return (jgt.Batch(jnp.asarray(img), jnp.asarray(mask), jnp.asarray(bpp)),
            Batch(nchw(img), nchw(mask), torch.from_numpy(bpp)))


def _floats(tensors):
    return [t for t in tensors if t is not None and t.is_floating_point()]


def _adam_tensors(state):
    return [v for o in (state.g_opt, state.ls_opt, state.rd_opt, state.d_opt)
            for st in o.adam.state.values() for v in st.values() if torch.is_tensor(v)]


# ------------------------------------------- tests/test_mixed_precision.py


def test_bce_saturated_bf16_is_finite():
    """BCE on bfloat16 probabilities saturated at exactly 0 and 1 stays
    finite: the clip at 1 - 1e-7 applies after the cast to float32."""
    probs = torch.tensor([0.0, 1.0, 0.5, 1.0], dtype=torch.bfloat16)
    labels = torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=torch.bfloat16)
    val = TL.bce(labels, probs)
    assert val.dtype == torch.float32 and torch.isfinite(val)
    p = probs.float().requires_grad_(True)
    TL.bce(labels.float(), p).backward()
    assert torch.isfinite(p.grad).all()


def test_losses_return_f32_on_bf16_inputs():
    a = torch.ones((4, 3, 8, 8), dtype=torch.bfloat16)
    b = torch.zeros((4, 3, 8, 8), dtype=torch.bfloat16)
    for val in (TL.mse(a, b), TL.mae(a, b), TL.adversarial_loss(a[:, :1, 0, 0] * 0.5)):
        assert val.dtype == torch.float32 and torch.isfinite(val)


def test_mixed_precision_training_stays_finite(tmp_path):
    """GANTrainer.fit for 6 steps (D every other step) with bfloat16
    activations and the perceptual term on (random VGG19, float32): finite
    metrics every step (nan_guard), the forward in bfloat16, and parameters,
    BatchNorm statistics and Adam moments float32 before and after, all of
    them moved; the rate-control probe runs in bfloat16 and stays finite."""
    cfg = TrainConfig(model=TMIX, batch_size=4, vgg_weights_path="random:0",
                      model_dir=str(tmp_path))
    trainer = GANTrainer(cfg, device="cpu", log_fn=lambda s: None, nan_guard=True)
    state = trainer.init_state(resume=False)
    assert {p.dtype for m in (state.codec, state.disc) for p in m.parameters()} == {torch.float32}
    assert {b.dtype for b in _floats(state.codec.buffers())} == {torch.float32}
    _, tbatch = _batches()
    with torch.no_grad():
        out = state.codec.apply(tbatch.image.permute(0, 2, 3, 1), tbatch.mask.permute(0, 2, 3, 1),
                                tbatch.bpp, train=False)
    assert out.blended.dtype == torch.bfloat16 and out.hq_latent.dtype == torch.bfloat16
    before = [p.detach().clone() for p in state.codec.parameters()]
    stats = state.codec.hq_encoder.bn2.running_var.clone()

    imgs = timages.synthetic_images(8, (32, 32), seed=1)
    masks = np.random.RandomState(1).rand(8, 32, 32, 1).astype(np.float32)
    ds = CompressionDataset(imgs, masks, batch_size=4, device="cpu")
    hist = trainer.fit(ds, epochs=1, steps_per_epoch=6, artifacts=False)
    assert trainer.state.step == 6
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in hist.values()), hist
    for tensors in ([p for m in (state.codec, state.disc) for p in m.parameters()],
                    _floats(state.codec.buffers()), _floats(state.disc.buffers()),
                    _adam_tensors(state)):
        assert tensors and {t.dtype for t in tensors} == {torch.float32}
    moved = [not torch.equal(a, p) for a, p in zip(before, state.codec.parameters())]
    assert sum(moved) > 0.9 * len(moved)
    assert not torch.equal(stats, state.codec.hq_encoder.bn2.running_var)
    probe = trainer.rate_control_probe(ds.first_samples())
    assert all(np.isfinite(r) and np.isfinite(g) for _, r, g in probe)


def test_mixed_matches_fp32_loosely():
    """One mixed step's metrics track the float32 step's within bfloat16
    noise, max(0.05, 0.08 |ref|) (tests/test_mixed_precision.py's bar): same
    seed, same data, BatchNorm frozen, no D step."""
    _, tbatch = _batches()
    out = {}
    for name, mcfg in (("mixed", TMIX), ("fp32", dataclasses.replace(TMIX, dtype="float32"))):
        builder = GANStepBuilder(TrainConfig(model=mcfg, batch_size=4, use_perceptual=False),
                                 bn_mode="frozen", device="cpu")
        _, metrics = builder.train_step(builder.init_state(0), tbatch, False)
        out[name] = {k: float(v) for k, v in metrics.items()}
    assert out["mixed"].keys() == out["fp32"].keys()
    for k, ref in out["fp32"].items():
        assert abs(out["mixed"][k] - ref) <= max(0.05, 0.08 * abs(ref)), (k, out["mixed"][k], ref)


# -------------------------------------------------------- building blocks


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_kbatchnorm_bf16_with_f32_statistics_matches_flax(train):
    """bfloat16 x with float32 scale, bias and statistics: flax computes the
    statistics in float32, promotes every step to float32 and rounds once;
    so does KBatchNorm. Output bit for bit; the running statistics after the
    update within 2e-7 (XLA and torch sum the batch in another order)."""
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 6, 5, 5) * 2 + 0.5).astype(np.float32)
    scale, bias = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6).astype(np.float32) * 0.1
    mean, var = rng.randn(6).astype(np.float32) * 0.1, rng.rand(6).astype(np.float32) + 0.5
    bn = fnn.BatchNorm(momentum=0.99, epsilon=1e-3, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    want, mut = bn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1), jnp.bfloat16),
                         use_running_average=not train, mutable=["batch_stats"])

    tb = tl.KBatchNorm(6)
    with torch.no_grad():
        for t, a in ((tb.weight, scale), (tb.bias, bias), (tb.running_mean, mean),
                     (tb.running_var, var)):
            t.copy_(torch.from_numpy(a))
    got = tb(torch.from_numpy(x).to(torch.bfloat16), train)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().detach().numpy(),
                                  np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2))
    if train:
        tb.commit_batch_stats()
        for t, key in ((tb.running_mean, "mean"), (tb.running_var, "var")):
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), np.asarray(mut["batch_stats"][key]), atol=2e-7)


def test_preprocess_caffe_bf16_matches_jax_bitwise():
    """(x + 1) * 127.5 rounds to bfloat16 twice, then the float32 means
    promote the result to float32, as in JAX; float32 input is unchanged."""
    rng = np.random.RandomState(5)
    img = (rng.rand(2, 16, 16, 3) * 2 - 1).astype(np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = np.asarray(jvgg.preprocess_caffe(jnp.asarray(img, jdt)))
        got = tvgg.preprocess_caffe(torch.from_numpy(img).to(tdt).permute(0, 3, 1, 2))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_k2_bf16_gradient_against_float64_truth():
    """K2's bfloat16 backward (autograd over its twin: float32 scores, e
    rounded to bf16 for the e.V product, float32 epilogue) against the
    float64 gradient of gamma * softmax(q k^T) v + r at the same bfloat16
    inputs: B 2, N 128, Dk 16, Dv 64, standard-normal inputs from seed 0,
    gamma 0.5. Measured, as a share of the truth's max |.|: the port misses
    by 0.40% on dq, 0.26% on dk, 0.23% on dv and 0.07% on dgamma; JAX's
    backward (jax.vjp of attention_block_jnp, all in bfloat16) by 1.75%,
    1.68%, 0.65% and 9.24% (99.0 against 109.08 on dgamma). Bar: 1% on each,
    dr exact, and the port closer to the truth than JAX on each."""
    rng = np.random.RandomState(0)
    b, n, dk, dv = 2, 128, 16, 64
    arrays = [rng.randn(*s).astype(np.float32) for s in
              ((b, n, dk), (b, n, dk), (b, n, dv), (b, n, dv), (b, n, dv))]
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    q, k, v, r, g = (t.double().requires_grad_(True) for t in bf)
    gamma = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    (gamma * torch.softmax(q @ k.transpose(1, 2), -1) @ v + r).backward(g.detach())
    truth = [t.grad.numpy() for t in (q, k, v, r, gamma)]

    ins = [t.clone().requires_grad_(True) for t in bf[:4]]
    tgamma = torch.tensor(0.5, dtype=torch.bfloat16, requires_grad=True)
    out = attention_block(*ins, tgamma)
    assert out.dtype == torch.bfloat16
    out.backward(bf[4])
    port = [t.grad.double().numpy() for t in ins + [tgamma]]
    assert all(t.grad.dtype == torch.bfloat16 for t in ins + [tgamma])

    jargs = [jnp.asarray(np.asarray(t.float()), jnp.bfloat16) for t in bf[:4]]
    _, vjp = jax.vjp(attention_block_pallas, *jargs, jnp.asarray(0.5, jnp.bfloat16))
    jgrads = [np.asarray(x, np.float64) for x in vjp(jnp.asarray(np.asarray(bf[4].float()),
                                                                 jnp.bfloat16))]
    for name, want, got, jx in zip(("dq", "dk", "dv", "dr", "dgamma"), truth, port, jgrads):
        top = np.abs(want).max()
        miss, jmiss = np.abs(got - want).max() / top, np.abs(jx - want).max() / top
        if name == "dr":
            np.testing.assert_array_equal(got, want)
            continue
        assert miss <= 1e-2 and miss < jmiss, (name, miss, jmiss)


# ------------------------------------------------ one mixed step vs JAX


def _copy(tree):
    return jax.tree.map(jnp.array, tree)


def _port_from_jax(jstate, bn_mode="train"):
    tb = GANStepBuilder(TrainConfig(model=TMIX, batch_size=4, use_perceptual=False),
                        bn_mode=bn_mode, device="cpu")
    ts = tb.init_state(0)
    ts.codec.load_state_dict(convert.convert_codec_variables(to_numpy_tree(jstate.codec_vars),
                                                             TMIX))
    ts.disc.load_state_dict(convert.convert_discriminator_variables(
        to_numpy_tree(jstate.disc_vars), TMIX))
    return tb, ts


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """The JAX GANTrainer at the mixed tiny configuration (its jitted steps
    are shared by every test below)."""
    d = tmp_path_factory.mktemp("jax_mixed")
    cfg = JTrainConfig(model=JMIX, batch_size=4, use_perceptual=False, model_dir=str(d),
                       results_dir=str(d / "results"))
    return JTrainer(cfg, log_fn=lambda s: None)


@pytest.fixture(scope="module")
def two_steps(jax_trainer):
    """A step with D, then one without, from the same perturbed weights on
    the same batch, bn_mode 'train', D's BatchNorm frozen."""
    jt = jax_trainer
    st = jt.init_state(resume=False)
    rng = np.random.RandomState(11)
    st = st.replace(codec_vars=perturb_variables(to_numpy_tree(st.codec_vars), rng),
                    disc_vars=perturb_variables(to_numpy_tree(st.disc_vars), rng))
    st = _copy(st)
    jbatch, tbatch = _batches()
    jout, jbn = jax.jit(lambda v: jt.codec.apply(v, jbatch.image, jbatch.mask, jbatch.bpp,
                                                 train=True))(st.codec_vars)
    j1, jm1 = jt.step_with_d(_copy(st), jbatch)
    j2, jm2 = jt.step_without_d(_copy(j1), jbatch)

    tb, ts = _port_from_jax(st)
    tm, pending, outs = [], [], []
    for do_d in (True, False):
        out = tb.codec_forward(ts, tbatch)
        outs.append(out)
        m = {"d_loss": tb.d_phase(ts, tbatch, out)} if do_d else {}
        m.update(tb.g_backward(ts, tbatch, out))
        pending.append({name: mod.pending for name, mod in ts.codec.named_modules()
                        if isinstance(mod, tl.KBatchNorm)})
        tb.g_update(ts)
        tm.append(m)
    return dict(st=st, jout=jout, jbn=jbn, j1=j1, j2=j2, jm=(jm1, jm2), tm=tm, tout=outs[0],
                pending=pending, ts=ts)


def test_mixed_step_outputs_match_jax(two_steps):
    """The step's codec forward (bn 'train') in bfloat16 on both sides.
    Latents before the quantizer within 2% of their largest magnitude
    (measured 0.74%, two bfloat16 ulps); the blended image within 2e-2 on
    average (measured 6.8e-3: a few quantizer symbols flip between the
    packages and move their pixels, by 0.16 at most)."""
    jout, tout = two_steps["jout"], two_steps["tout"]
    for name in ("hq_latent", "lq_latent", "blended", "hq_latent_q", "dynamic_threshold"):
        assert getattr(tout, name).dtype == torch.bfloat16, name
    for name in ("hq_latent", "lq_latent"):
        want = np.asarray(getattr(jout, name).astype(jnp.float32))
        got = getattr(tout, name).detach().float().numpy()
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), name
    want = np.asarray(jout.blended.astype(jnp.float32))
    got = tout.blended.detach().float().numpy()
    assert np.abs(got - want).mean() <= 2e-2, np.abs(got - want).mean()


def test_mixed_step_losses_match_jax(two_steps):
    """Every metric of both steps float32 and within 5% of JAX's, or 2e-4
    absolute. Measured: 0.18% at most, except the RD and latent-saliency
    losses, means of squared differences between bfloat16 outputs and their
    targets, where an ulp of the output moves the loss by 2.1% and 2.4%
    (1.2e-4 absolute)."""
    for jm, tm in zip(two_steps["jm"], two_steps["tm"]):
        assert set(tm) == set(jm)
        for k, v in jm.items():
            assert tm[k].dtype == torch.float32, k
            err = abs(float(tm[k]) - float(v))
            assert err <= 5e-2 * abs(float(v)) or err <= 2e-4, (k, float(tm[k]), float(v))


def test_mixed_step_bn_statistics_match_jax(two_steps):
    """The batch statistics of each step's forward, float32 on both sides
    (JAX's recovered from its running update), per channel. Encoders
    (before the quantizer): means within 2% of the channel's RMS, variances
    within 5% (measured 0.6% and 1.9% at most). Generators, which decode the
    quantized latents, where a few symbols flip between the packages:
    within 10% and 25% (measured 4.1% and 12.5%, in bn0 after the fc; 0.5%
    and 1.5% by the last layer)."""
    st, j1, j2 = two_steps["st"], two_steps["j1"], two_steps["j2"]
    for old, new, pending in ((st, j1, two_steps["pending"][0]),
                              (j1, j2, two_steps["pending"][1])):
        for comp in ALL_CODEC_COMPONENTS:
            jstats = to_numpy_tree(new.codec_vars[comp].get("batch_stats", {}))
            ostats = to_numpy_tree(old.codec_vars[comp].get("batch_stats", {}))
            for layer, d in jstats.items():
                mean, var = pending[f"{comp}.{layer}"]
                assert mean.dtype == var.dtype == torch.float32
                bm = (d["BatchNorm_0"]["mean"] - 0.99 * ostats[layer]["BatchNorm_0"]["mean"]) / 0.01
                bv = (d["BatchNorm_0"]["var"] - 0.99 * ostats[layer]["BatchNorm_0"]["var"]) / 0.01
                rms = np.sqrt(bv + bm ** 2) + 1e-6
                bars = (2e-2, 5e-2) if comp.endswith("encoder") else (1e-1, 2.5e-1)
                assert np.all(np.abs(mean.numpy() - bm) <= bars[0] * rms), (comp, layer)
                assert np.all(np.abs(var.numpy() - bv) <= bars[1] * bv + 1e-6), (comp, layer)


def _updates(before, after, cfg):
    a = convert.convert_codec_variables(to_numpy_tree(after), cfg)
    b = convert.convert_codec_variables(to_numpy_tree(before), cfg)
    return {k: a[k] - b[k] for k in a if not k.endswith(("running_mean", "running_var"))}


def test_mixed_step_params_match_jax(two_steps):
    """Parameters and Adam moments float32; the codec's parameter updates of
    the two steps. Adam moves each parameter by about lr whatever the size
    of its gradient, so an update's sign is the gradient's: the signs agree
    on >= 95% of the parameters (measured 97.7%), the updates within 0.1 lr
    on >= 85% (measured 89.2%: gradients near zero, such as those of a bias
    feeding a batch-statistics BatchNorm, differ in sign), and everywhere
    within 4.01 lr, the most two Adam steps from one start can part (each
    moves a parameter by at most 1.0014 lr; measured 3.9992 lr). The
    discriminator's, after its one step, within 1e-6 on >= 95% (measured
    97.5%)."""
    st, j2, ts = two_steps["st"], two_steps["j2"], two_steps["ts"]
    assert {p.dtype for m in (ts.codec, ts.disc) for p in m.parameters()} == {torch.float32}
    assert {t.dtype for t in _adam_tensors(ts)} == {torch.float32}
    want = _updates(st.codec_vars, j2.codec_vars, TMIX)
    start = convert.convert_codec_variables(to_numpy_tree(st.codec_vars), TMIX)
    sd = ts.codec.state_dict()
    got = {k: sd[k] - start[k] for k in want}
    g = torch.cat([got[k].reshape(-1) for k in want])
    w = torch.cat([want[k].reshape(-1) for k in want])
    err = (g - w).abs()
    assert float((torch.sign(g) == torch.sign(w)).double().mean()) >= 0.95
    assert float((err <= 0.1 * LR).double().mean()) >= 0.85
    assert float(err.max()) <= 4.01 * LR
    dwant = convert.convert_discriminator_variables(to_numpy_tree(j2.disc_vars), TMIX)
    derr = torch.cat([(ts.disc.state_dict()[k] - dwant[k]).abs().reshape(-1) for k in dwant])
    assert float((derr <= 1e-6).double().mean()) >= 0.95


# ------------------------------------------------- resume across packages


def _jax_state_bytes(state):
    host = jax.tree.map(np.asarray, {
        **state.codec_vars, "discriminator": state.disc_vars,
        "optimizers": {"g_opt": state.g_opt, "ls_opt": state.ls_opt, "rd_opt": state.rd_opt,
                       "d_opt": state.d_opt, "step": state.step}})
    return {name: flax.serialization.to_bytes(host[name]) for name in FILES}


def _port_state_bytes(state):
    trees = convert.codec_variables(state.codec)
    trees["discriminator"] = convert.discriminator_variables(state.disc, state.codec.cfg)
    trees["optimizers"] = convert.optimizer_variables(state)
    return {name: fm.dumps(trees[name]) for name in FILES}


def _step_agreement(jtrainer, jstate, tbuilder, tstate):
    """One step with D from each package's state on a new batch: the
    metrics at test_mixed_step_losses_match_jax's bar, parameters float32
    and within 2 lr of JAX's (one Adam step each)."""
    jbatch, tbatch = _batches(21)
    j2, jm = jtrainer.step_with_d(_copy(jstate), jbatch)
    tstate, tm = tbuilder.train_step(tstate, tbatch, True)
    for k, v in jm.items():
        err = abs(float(tm[k]) - float(v))
        assert err <= 5e-2 * abs(float(v)) or err <= 2e-4, (k, float(tm[k]), float(v))
    want = convert.convert_codec_variables(to_numpy_tree(j2.codec_vars), TMIX)
    sd = tstate.codec.state_dict()
    assert {t.dtype for t in sd.values()} == {torch.float32}
    err = torch.cat([(sd[k] - want[k]).abs().reshape(-1) for k in want
                     if not k.endswith(("running_mean", "running_var"))])
    assert float(err.max()) <= 2 * LR


def test_port_resumes_a_jax_mixed_state(jax_trainer, two_steps, tmp_path):
    """The JAX mixed state after the two steps, saved through the JAX
    CheckpointStore, restores in the port's GANTrainer exactly (the same
    bytes when written back), all float32; then one step from each."""
    jt, j2 = jax_trainer, two_steps["j2"]
    components = dict(j2.codec_vars)
    components["discriminator"] = j2.disc_vars
    store = JStore(str(tmp_path))
    store.save_components(jax.tree.map(np.asarray, components), "final")
    store.save_component("optimizers", jax.tree.map(np.asarray, {
        "g_opt": j2.g_opt, "ls_opt": j2.ls_opt, "rd_opt": j2.rd_opt, "d_opt": j2.d_opt,
        "step": j2.step}), "final")
    trainer = GANTrainer(TrainConfig(model=TMIX, batch_size=4, use_perceptual=False,
                                     model_dir=str(tmp_path)), device="cpu", log_fn=lambda s: None)
    state = trainer.init_state(resume=True)
    assert state.step == 2
    assert _port_state_bytes(state) == _jax_state_bytes(j2)
    assert {t.dtype for t in _adam_tensors(state) if t.ndim} == {torch.float32}
    _step_agreement(jt, j2, trainer.builder, state)


def test_jax_resumes_a_port_mixed_state(jax_trainer, tmp_path):
    """The port trains 2 mixed steps and fit saves 'final'; the JAX
    trainer's init_state(resume=True) restores it exactly (float32 leaves);
    then one step from each."""
    trainer = GANTrainer(TrainConfig(model=TMIX, batch_size=4, use_perceptual=False,
                                     model_dir=str(tmp_path)), device="cpu", log_fn=lambda s: None)
    imgs = timages.synthetic_images(8, (32, 32), seed=3)
    masks = np.random.RandomState(3).rand(8, 32, 32, 1).astype(np.float32)
    trainer.fit(CompressionDataset(imgs, masks, batch_size=4, device="cpu"), epochs=1,
                steps_per_epoch=2, artifacts=False)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"{n}_final.msgpack" for n in FILES] + ["metadata_final.json"])
    jt = jax_trainer
    jt.store = JStore(str(tmp_path))
    jstate = jt.init_state(resume=True)
    assert _jax_state_bytes(jstate) == _port_state_bytes(trainer.state)
    leaves = jax.tree.leaves((jstate.codec_vars, jstate.disc_vars, jstate.g_opt, jstate.d_opt))
    assert {x.dtype for x in leaves if jnp.issubdtype(x.dtype, jnp.floating)} == {
        np.dtype(np.float32)}
    assert int(jstate.step) == 2 and jt.history == trainer.history
    _step_agreement(jt, jstate, trainer.builder, trainer.state)
