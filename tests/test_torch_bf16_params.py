"""bfloat16 parameters (`ModelConfig(param_dtype="bfloat16")`) in the PyTorch
port against the JAX package.

JAX builds every parameter of the codec and of D in bfloat16, keeps the
BatchNorm statistics in float32 (flax), and optax keeps Adam's moments in
the parameter's dtype and applies the update in it. The port does the same:
`AdaptiveCodec` casts its parameters after building them (the statistics
are buffers and stay float32), `GANStepBuilder` casts D's, and `KerasAdam`
steps a bf16 parameter in optax's order (train/optimizers.py), bit for bit
optax's on equal gradients.

The configuration is tests/test_torch_mixed_precision.py's tiny one with
bf16 parameters, the JAX side with its Pallas kernels in interpret mode and
the port on the kernels' twins. XLA holds fused bf16 chains in float32 and
torch rounds each operation, so one step agrees to bf16 noise; each test
states its bar and what was measured.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import nchw, perturb_variables, to_numpy_tree

from contextual_image_compression_tpu.checkpoint import CheckpointStore as JStore
from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.config import QuantizerConfig as JQuantizerConfig
from contextual_image_compression_tpu.config import TrainConfig as JTrainConfig
from contextual_image_compression_tpu.train import gan_trainer as jgt
from contextual_image_compression_tpu.train.loop import GANTrainer as JTrainer
from contextual_image_compression_tpu.train.optimizers import keras_adam
from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.checkpoint import flax_msgpack as fm
from contextual_image_compression_tpu_torch.config import (
    ModelConfig,
    QuantizerConfig,
    TrainConfig,
)
from contextual_image_compression_tpu_torch.data import images as timages
from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
from contextual_image_compression_tpu_torch.models.adaptive import (
    ALL_CODEC_COMPONENTS,
    AdaptiveCodec,
)
from contextual_image_compression_tpu_torch.train.gan_trainer import Batch, GANStepBuilder
from contextual_image_compression_tpu_torch.train.loop import GANTrainer
from contextual_image_compression_tpu_torch.train.optimizers import KerasAdam

TINY_KW = dict(
    img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
    generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32,
)
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
JBF = JModelConfig(**TINY_KW, attention_use_pallas=True,
                   quantizer=JQuantizerConfig(use_pallas=True, grad_mode="ste"), **BF16)
TBF = ModelConfig(**TINY_KW, quantizer=QuantizerConfig(grad_mode="ste"), **BF16)
FILES = ALL_CODEC_COMPONENTS + ("discriminator", "optimizers")
LR = 1e-4


def _arrays(seed=7):
    rng = np.random.RandomState(seed)
    img = rng.rand(4, 32, 32, 3).astype(np.float32) * 2 - 1
    mask = rng.rand(4, 32, 32, 1).astype(np.float32)
    bpp = np.array([[0.1], [1.0], [2.0], [1.0]], np.float32)
    return img, mask, bpp


def _like(tree, ref):
    """tree's values in ref's dtypes (perturbed float32 numpy back to bf16)."""
    return jax.tree.map(lambda a, r: jnp.asarray(a, r.dtype), tree, ref)


def _copy(tree):
    return jax.tree.map(jnp.array, tree)


def _adam_tensors(state):
    return [v for o in (state.g_opt, state.ls_opt, state.rd_opt, state.d_opt)
            for st in o.adam.state.values() for k, v in st.items() if k != "step"]


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """The JAX GANTrainer at the bf16 tiny configuration (bn 'train', D's
    BatchNorm frozen); its jitted steps serve every test below."""
    d = tmp_path_factory.mktemp("jax_bf16")
    return JTrainer(JTrainConfig(model=JBF, batch_size=4, use_perceptual=False, model_dir=str(d),
                                 results_dir=str(d / "results")), log_fn=lambda s: None)


@pytest.fixture(scope="module")
def one_step(jax_trainer):
    """A step with D in both packages from the same perturbed bf16 weights."""
    jt = jax_trainer
    st = jt.init_state(resume=False)
    rng = np.random.RandomState(11)
    st = st.replace(codec_vars=_like(perturb_variables(to_numpy_tree(st.codec_vars), rng),
                                     st.codec_vars),
                    disc_vars=_like(perturb_variables(to_numpy_tree(st.disc_vars), rng),
                                    st.disc_vars))
    img, mask, bpp = _arrays()
    jb = jgt.Batch(jnp.asarray(img), jnp.asarray(mask), jnp.asarray(bpp))
    jout = jax.jit(lambda v: jt.codec.apply(v, jb.image, jb.mask, jb.bpp)[0])(st.codec_vars)
    j1, jm = jt.step_with_d(_copy(st), jb)
    tb = GANStepBuilder(TrainConfig(model=TBF, batch_size=4, use_perceptual=False), device="cpu")
    ts = tb.init_state(0)
    ts.codec.load_state_dict(convert.convert_codec_variables(to_numpy_tree(st.codec_vars), TBF))
    ts.disc.load_state_dict(convert.convert_discriminator_variables(
        to_numpy_tree(st.disc_vars), TBF))
    with torch.no_grad():
        tout = ts.codec.apply(*(torch.from_numpy(a) for a in (img, mask, bpp)))
    _, tm = tb.train_step(ts, Batch(nchw(img), nchw(mask), torch.from_numpy(bpp)), True)
    return dict(st=st, j1=j1, jm=jm, jout=jout, ts=ts, tm=tm, tout=tout)


def test_bf16_codec_builds_and_inits_in_bf16():
    """Parameters bf16 (codec and D), BatchNorm statistics float32, as flax
    builds them; reset_parameters draws in float32 and rounds, so a bf16
    codec's init is the float32 codec's init rounded to bf16 (JAX draws in
    bf16 directly: same distribution, other numbers)."""
    codec = AdaptiveCodec(TBF)
    codec.reset_parameters(3)
    assert {p.dtype for p in codec.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in codec.buffers()} == {torch.float32}
    ref = AdaptiveCodec(ModelConfig(**TINY_KW))
    ref.reset_parameters(3)
    for (k, a), b in zip(codec.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b.to(a.dtype)), k
    state = GANStepBuilder(TrainConfig(model=TBF, use_perceptual=False), device="cpu").init_state(0)
    assert {p.dtype for p in state.disc.parameters()} == {torch.bfloat16}


def _symbols(out, host):
    """rint(zq * scale) of both latents, each side with its own score and
    strength: the integers the range coder would store."""
    syms = []
    for zq, score in (("hq_latent_q", "hq_saliency_quant"), ("lq_latent_q", "lq_saliency_quant")):
        s, q = host(getattr(out, score)), host(out.quant_strength)
        scale = np.exp(np.float32(3.0) * (q * (np.float32(1.0) - s)))
        syms.append(np.round(host(getattr(out, zq)).astype(np.float64) * scale).ravel())
    return np.concatenate(syms)


def test_bf16_codec_forward_matches_jax(one_step):
    """The inference forward in bf16 on bf16 parameters. Latents within 2% of
    their largest magnitude (measured 0.51%); the quantizer's symbols within
    +-1 and >= 98% identical (measured 99.5%: bf16 noise flips a few); the
    blended image within 1e-2 on average (measured 3.4e-4)."""
    jout, tout = one_step["jout"], one_step["tout"]
    assert tout.blended.dtype == tout.hq_latent.dtype == torch.bfloat16
    for name in ("hq_latent", "lq_latent"):
        want = np.asarray(getattr(jout, name).astype(jnp.float32))
        got = getattr(tout, name).float().numpy()
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), name
    jsym = _symbols(jout, lambda a: np.asarray(a.astype(jnp.float32)))
    tsym = _symbols(tout, lambda t: t.float().numpy())
    assert np.abs(jsym - tsym).max() <= 1 and np.mean(jsym == tsym) >= 0.98
    want = np.asarray(jout.blended.astype(jnp.float32))
    assert np.abs(tout.blended.float().numpy() - want).mean() <= 1e-2


def test_bf16_step_losses_match_jax(one_step):
    """Every metric float32 and within 2% of JAX's or 2e-4 absolute (measured
    0.11% at most, the adversarial loss)."""
    jm, tm = one_step["jm"], one_step["tm"]
    assert set(tm) == set(jm)
    for k, v in jm.items():
        assert tm[k].dtype == torch.float32, k
        err = abs(float(tm[k]) - float(v))
        assert err <= 2e-2 * abs(float(v)) or err <= 2e-4, (k, float(tm[k]), float(v))


def test_bf16_step_params_and_moments_match_jax(one_step):
    """After the step: parameters and Adam moments bf16, BatchNorm
    statistics float32, in both packages. Parameters identical on >= 98%
    (measured 98.8%: an update of lr = 1e-4 is below a bf16 ulp of most
    weights, so it rounds the same way or away) and everywhere within one
    bf16 ulp plus 2.01 lr, two Adam updates apart (measured: 12 entries of
    parameters at 0 moved by -lr and +lr, gradients near 0 whose bf16 noise
    flips their sign). BatchNorm statistics within 1e-3 (measured 1.5e-4).
    The first moments, (1 - b1) g of gradients that carry bf16 noise, agree
    in sign on >= 90% of entries (measured 93.2%); D's parameters identical
    on >= 98% (measured 99.1%)."""
    st, j1, ts = one_step["st"], one_step["j1"], one_step["ts"]
    assert {p.dtype for m in (ts.codec, ts.disc) for p in m.parameters()} == {torch.bfloat16}
    assert {t.dtype for t in _adam_tensors(ts)} == {torch.bfloat16}
    assert {b.dtype for b in ts.codec.buffers()} == {torch.float32}
    jleaves = jax.tree.leaves((j1.codec_vars, j1.g_opt[1][0].mu, j1.g_opt[1][0].nu))
    assert {x.dtype for x in jleaves} == {np.dtype(jnp.bfloat16), np.dtype(np.float32)}
    want = convert.convert_codec_variables(to_numpy_tree(j1.codec_vars), TBF)
    sd = ts.codec.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    keys = [k for k in want if k not in stats]
    got = torch.cat([sd[k].float().reshape(-1) for k in keys])
    ref = torch.cat([want[k].reshape(-1) for k in keys])
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    assert float((got == ref).double().mean()) >= 0.98
    assert bool(((got - ref).abs() <= ulp + 2.01 * LR).all())
    assert max(float((sd[k] - want[k]).abs().max()) for k in stats) <= 1e-3
    tmu = convert.optimizer_variables(ts)["g_opt"]["1"]["0"]["mu"]
    flat = [np.asarray(x.float() if torch.is_tensor(x) else x, np.float32).ravel()
            for x in jax.tree.leaves(tmu)]
    jflat = [np.asarray(x.astype(jnp.float32)).ravel() for x in jax.tree.leaves(j1.g_opt[1][0].mu)]
    a, b = np.concatenate(flat), np.concatenate(jflat)
    nz = (a != 0) | (b != 0)
    assert np.mean(np.sign(a[nz]) == np.sign(b[nz])) >= 0.90
    dwant = convert.convert_discriminator_variables(to_numpy_tree(j1.disc_vars), TBF)
    dgot = torch.cat([ts.disc.state_dict()[k].float().reshape(-1) for k in dwant])
    dref = torch.cat([v.reshape(-1) for v in dwant.values()])
    assert float((dgot == dref).double().mean()) >= 0.98


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_bf16_adam_is_optax_bit_for_bit(jit):
    """KerasAdam on bf16 parameters against optax's keras_adam chain on the
    same bf16 gradients, three steps (clipping on in the large ones):
    parameters and both moments bit for bit, eager and jitted. torch.optim.Adam
    on the same tensors is not (it folds the bias corrections into the step
    size and the root: measured 0.86% of the parameters apart after 3 steps)."""
    rng = np.random.RandomState(0)
    shapes = [(64, 32), (128,), (16, 3, 3, 3), (1000,)]
    params = [rng.randn(*s).astype(np.float32) * 0.1 for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * (0.01 if i % 2 else 3.0) for s in shapes]
             for i in range(3)]
    tx = keras_adam(LR)
    jp = [jnp.asarray(p, jnp.bfloat16) for p in params]
    jst = tx.init(jp)
    update = jax.jit(tx.update) if jit else tx.update
    tp = [torch.nn.Parameter(torch.from_numpy(p).to(torch.bfloat16)) for p in params]
    opt = KerasAdam(tp, LR)
    plain = [torch.nn.Parameter(t.detach().clone()) for t in tp]
    torch_adam = torch.optim.Adam(plain, lr=LR, eps=1e-7)
    for g in grads:
        u, jst = update([jnp.asarray(x, jnp.bfloat16) for x in g], jst, jp)
        jp = optax.apply_updates(jp, u)
        for p, q, x in zip(tp, plain, g):
            p.grad = torch.from_numpy(x).to(torch.bfloat16)
            q.grad = p.grad.clone()
        opt.step()
        for q in plain:  # keras' per-tensor clip by hand (torch's clip_grad_norm_ is global)
            q.grad.mul_(torch.clamp(1.0 / torch.clamp(torch.linalg.vector_norm(q.grad), min=1e-12),
                                    max=1.0))
        torch_adam.step()
    adam = jst[1][0]
    for a, p, mu, nu in zip(jp, tp, adam.mu, adam.nu):
        st = opt.adam.state[p]
        for want, got in ((a, p.detach()), (mu, st["exp_avg"]), (nu, st["exp_avg_sq"])):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    apart = np.mean(np.concatenate([
        (q.detach().float().numpy() != np.asarray(a.astype(jnp.float32))).ravel()
        for a, q in zip(jp, plain)]))
    assert apart > 0, apart


# ------------------------------------------------- checkpoints both ways


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


def test_port_resumes_a_jax_bf16_state(jax_trainer, one_step, tmp_path):
    """The JAX bf16 state after the step, saved by the JAX CheckpointStore,
    restores in the port's GANTrainer: the same bytes when written back,
    parameters and moments bf16."""
    j1 = one_step["j1"]
    store = JStore(str(tmp_path))
    store.save_components(jax.tree.map(np.asarray, {**j1.codec_vars,
                                                    "discriminator": j1.disc_vars}), "final")
    store.save_component("optimizers", jax.tree.map(np.asarray, {
        "g_opt": j1.g_opt, "ls_opt": j1.ls_opt, "rd_opt": j1.rd_opt, "d_opt": j1.d_opt,
        "step": j1.step}), "final")
    trainer = GANTrainer(TrainConfig(model=TBF, batch_size=4, use_perceptual=False,
                                     model_dir=str(tmp_path)), device="cpu", log_fn=lambda s: None)
    state = trainer.init_state(resume=True)
    assert state.step == 1
    assert _port_state_bytes(state) == _jax_state_bytes(j1)
    assert {t.dtype for t in _adam_tensors(state)} == {torch.bfloat16}


def test_jax_resumes_a_port_bf16_state(jax_trainer, tmp_path):
    """The port trains 2 bf16 steps (finite metrics) and fit saves 'final'; the
    JAX trainer's init_state(resume=True) restores it with the same bytes,
    parameters and moments bf16, statistics float32."""
    trainer = GANTrainer(TrainConfig(model=TBF, batch_size=4, use_perceptual=False,
                                     model_dir=str(tmp_path)), device="cpu", log_fn=lambda s: None,
                         nan_guard=True)
    imgs = timages.synthetic_images(8, (32, 32), seed=3)
    masks = np.random.RandomState(3).rand(8, 32, 32, 1).astype(np.float32)
    hist = trainer.fit(CompressionDataset(imgs, masks, batch_size=4, device="cpu"), epochs=1,
                       steps_per_epoch=2, artifacts=False)
    assert all(np.isfinite(v[0]) for v in hist.values())
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"{n}_final.msgpack" for n in FILES] + ["metadata_final.json"])
    jt = jax_trainer
    jt.store = JStore(str(tmp_path))
    jstate = jt.init_state(resume=True)
    assert _jax_state_bytes(jstate) == _port_state_bytes(trainer.state)
    assert int(jstate.step) == 2
    mu = jax.tree.leaves(jstate.g_opt[1][0].mu)
    assert {x.dtype for x in mu} == {np.dtype(jnp.bfloat16)}
    stats = jax.tree.leaves(jstate.codec_vars["hq_encoder"]["batch_stats"])
    assert {x.dtype for x in stats} == {np.dtype(np.float32)}
