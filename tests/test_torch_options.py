"""The `use_pallas=False` routes of the PyTorch port against the JAX package.

With a `use_pallas` flag set to False the JAX package computes its jnp
formulas, and so does the port, with library calls and no kernel:
`adaptive_quantize_reference_jnp` / `_ste_jnp` (QuantizerConfig),
`attention_block_jnp` (ModelConfig.attention_use_pallas, SelfAttention)
and compute_saliency_map -> bilateral -> Gaussian -> normalize_max
(SaliencyConfig.mask_use_pallas). These are not the kernels' twins, which
repeat the TPU kernels' roundings (float32 accumulation, K3's upcast,
normalization after e.V), so each test also shows that no twin runs. K5's
twin has no such rounding of its own: it is `_dct_strips_jnp`'s formula,
and DCTCodecConfig(use_pallas=False) runs it on either device. Then a tiny codec's forward and one GAN
training step (with D) with both codec flags False, at the training bars
of tests/test_torch_train.py.

Everything runs on the CPU from the same seeded numpy inputs; float32 bars
are stated with what was measured, bf16 bars from measurement (XLA holds
fused bf16 chains in float32, torch rounds each operation).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import nchw, nhwc, perturb_variables, to_numpy_tree

from contextual_image_compression_tpu.config import DCTCodecConfig as JDCTCodecConfig
from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.config import QuantizerConfig as JQuantizerConfig
from contextual_image_compression_tpu.config import SaliencyConfig as JSaliencyConfig
from contextual_image_compression_tpu.config import TrainConfig as JTrainConfig
from contextual_image_compression_tpu.data.images import rich_synthetic_images
from contextual_image_compression_tpu.models.attention import SelfAttention as JSelfAttention
from contextual_image_compression_tpu.ops import attention as jattn
from contextual_image_compression_tpu.ops import dct as jdct
from contextual_image_compression_tpu.ops import masks as jmasks
from contextual_image_compression_tpu.ops import quantize as jq
from contextual_image_compression_tpu.train import gan_trainer as jgt
from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.config import (
    DCTCodecConfig,
    ModelConfig,
    QuantizerConfig,
    SaliencyConfig,
    TrainConfig,
)
from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
from contextual_image_compression_tpu_torch.models.attention import SelfAttention
from contextual_image_compression_tpu_torch.ops import attention as tattn
from contextual_image_compression_tpu_torch.ops import dct as tdct
from contextual_image_compression_tpu_torch.ops import fused_mask as tfm
from contextual_image_compression_tpu_torch.ops import masks as tmasks
from contextual_image_compression_tpu_torch.ops import quantize as tq
from contextual_image_compression_tpu_torch.train.gan_trainer import Batch, GANStepBuilder

TINY_KW = dict(
    img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
    generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32,
)
JPLAIN = JModelConfig(**TINY_KW, attention_use_pallas=False,
                      quantizer=JQuantizerConfig(use_pallas=False, grad_mode="reference"))
TPLAIN = ModelConfig(**TINY_KW, attention_use_pallas=False,
                     quantizer=QuantizerConfig(use_pallas=False, grad_mode="reference"))
LR = 1e-4


@pytest.fixture
def no_twins(monkeypatch):
    """Make every kernel twin of the routes under test raise if called."""
    def boom(*args, **kwargs):
        raise AssertionError("a kernel twin ran on a use_pallas=False route")

    for mod, names in ((tq, ("adaptive_quantize_plain", "adaptive_quantize_bwd_plain")),
                       (tattn, ("attention_block_plain",)),
                       (tfm, ("contextual_mask_plain", "smooth_mask_plain"))):
        for name in names:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, boom)
    monkeypatch.setattr(tmasks, "smooth_mask", boom)
    monkeypatch.setattr(tmasks, "contextual_mask", boom)


def _bf(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["reference", "ste"])
def test_quantizer_jnp_route_matches_jax(mode, dtype, no_twins):
    """adaptive_quantize(use_pallas=False) against JAX's jnp formula, forward
    and the gradients of sum(out * g), computed in the inputs' dtype.
    float32: forward within 3e-7 relative (XLA's exp and torch's differ by
    an ulp of the scale; measured 1.4e-7), gradients within 1e-6 of their
    largest magnitude (measured 1.2e-7). bf16: every symbol within
    +-1 and >= 99% identical (measured 100%), the score and strength
    gradients ('reference') within 2% of their largest magnitude (measured
    0.8%), the latent's ('ste') bit for bit. In 'ste' the score and strength
    get no gradient (None here, zeros in JAX)."""
    rng = np.random.RandomState(3)
    lat = rng.randn(6, 48).astype(np.float32) * 3
    score = rng.rand(6, 1).astype(np.float32)
    strength = (rng.rand(6, 1) * 1.5).astype(np.float32)
    g = rng.randn(6, 48).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jfn = jq.adaptive_quantize_ste_jnp if mode == "ste" else jq.adaptive_quantize_reference_jnp
    jargs = [jnp.asarray(a, jdt) for a in (lat, score, strength)]
    jout, vjp = jax.vjp(lambda *a: jfn(*a, 3.0), *jargs)
    jgrads = vjp(jnp.asarray(g, jdt))
    targs = [_bf(a, tdt).requires_grad_(True) for a in (lat, score, strength)]
    out = tq.adaptive_quantize(*targs, QuantizerConfig(grad_mode=mode, use_pallas=False))
    assert out.dtype == tdt
    out.backward(_bf(g, tdt))
    want = np.asarray(jout.astype(jnp.float32))
    got = out.detach().float().numpy()
    scale = np.exp(3.0 * strength * (1 - score))
    if dtype == "float32":  # exp rounds differently in XLA and torch: an ulp of the scale
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
    else:
        sym_t, sym_j = np.round(got * scale), np.round(want * scale)
        assert np.abs(sym_t - sym_j).max() <= 1 and np.mean(sym_t == sym_j) >= 0.99
    for t, jg in zip(targs, jgrads):
        jg = np.asarray(jg.astype(jnp.float32))
        tg = (t.grad if t.grad is not None else torch.zeros_like(t)).float().numpy()  # ste: None
        top = max(np.abs(jg).max(), 1e-30)
        bar = 1e-6 if dtype == "float32" else 2e-2
        if mode == "ste" and t is targs[0]:
            bar = 0.0
        assert np.abs(tg - jg).max() <= bar * top, (np.abs(tg - jg).max() / top)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_jnp_route_matches_jax(dtype, no_twins):
    """attention_block(use_pallas=False) against JAX's attention_block_jnp:
    forward and the gradients of all five inputs, each relative to its
    largest magnitude. float32: 1e-6 (measured 6.8e-7 at most), dgamma, a
    sum of 3072 products, 1e-5 (measured 3.8e-6); the residual's gradient
    exact. bf16: forward 1%, dq / dk / dv 3% (measured 0.41%, 2.4%, 0.89%,
    0.34%); dgamma, a bf16 reduction that XLA and torch accumulate
    differently, within 15% of JAX's (measured 11.8%), within 3% of the
    float64 truth at the same bf16 inputs (measured 2.4%; JAX's 10.8%) and
    nearer it than JAX's."""
    rng = np.random.RandomState(4)
    arrays = [rng.randn(*s).astype(np.float32) for s in
              ((2, 64, 8), (2, 64, 8), (2, 64, 24), (2, 64, 24), (2, 64, 24))]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jargs = [jnp.asarray(a, jdt) for a in arrays[:4]] + [jnp.asarray(0.7, jdt)]
    jout, vjp = jax.vjp(jattn.attention_block_jnp, *jargs)
    jgrads = vjp(jnp.asarray(arrays[4], jdt))
    targs = [_bf(a, tdt).requires_grad_(True) for a in arrays[:4]]
    targs.append(torch.tensor(0.7, dtype=tdt, requires_grad=True))
    out = tattn.attention_block(*targs, use_pallas=False)
    out.backward(_bf(arrays[4], tdt))
    f32 = dtype == "float32"
    bars = dict(out=1e-6, q=1e-6, k=1e-6, v=1e-6, r=0.0, g=1e-5) if f32 else \
        dict(out=1e-2, q=3e-2, k=3e-2, v=3e-2, r=0.0, g=0.15)
    pairs = [("out", out, jout)] + [(n, t.grad, jg) for n, t, jg in zip("qkvrg", targs, jgrads)]
    for name, got, want in pairs:
        want = np.asarray(want.astype(jnp.float32))
        got = got.detach().float().numpy()
        assert got.shape == want.shape
        top = np.abs(want).max()
        assert np.abs(got - want).max() <= bars[name] * top, (name, np.abs(got - want).max() / top)
    if not f32:
        q, k, v, r, g = (_bf(a, tdt).double().requires_grad_(True) for a in arrays)
        gamma = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
        (gamma * torch.softmax(q @ k.transpose(1, 2), -1) @ v + r).backward(g.detach())
        truth = float(gamma.grad)
        miss = abs(float(targs[4].grad) - truth)
        assert miss <= 3e-2 * abs(truth) and miss < abs(float(jgrads[4]) - truth)


def test_self_attention_without_pallas_matches_jax(no_twins):
    """SelfAttention(use_pallas=False) against the flax module with the same
    flag and weights (gamma 0.5), float32: output within 2e-6 (measured
    1.2e-6 on one element of 4096, an ulp), the input's gradient within
    1e-6 of its largest magnitude (measured 6.8e-7)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    mod = JSelfAttention(32, use_pallas=False)
    v = perturb_variables(to_numpy_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    want, vjp = jax.vjp(lambda a: mod.apply(v, a), jnp.asarray(x))
    g = rng.randn(*x.shape).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(g))
    port = SelfAttention(32, use_pallas=False)
    port.load_state_dict(convert.component_state("attention", v, ModelConfig()))
    xt = nchw(x).requires_grad_(True)
    out = port(xt)
    out.backward(nchw(g))
    np.testing.assert_allclose(nhwc(out), np.asarray(want), atol=2e-6)
    dx = xt.grad.permute(0, 2, 3, 1).numpy()
    assert np.abs(dx - np.asarray(jdx)).max() <= 1e-6 * np.abs(np.asarray(jdx)).max()


_MATMULS = ("mm", "bmm", "addmm", "baddbmm", "matmul", "dot")


@pytest.mark.parametrize("route", ["block", "core", "sagan", "sagan_spatial", "block_float_gamma"])
def test_attention_jnp_routes_run_every_product_without_tf32(route, monkeypatch):
    """Every matrix product of a use_pallas=False attention route, the
    backward's included, runs inside `_full_fp32_matmul` (TF32 off on the
    card, whatever the caller set): the context is replaced by one that
    counts its depth, and a dispatch mode records the depth at each aten
    product. Autograd alone would run the backward after the forward's
    context had closed. The gradients equal those of the bare formula."""
    from torch.utils._python_dispatch import TorchDispatchMode
    import contextlib

    depth = [0]

    @contextlib.contextmanager
    def counted(device):
        depth[0] += 1
        try:
            yield
        finally:
            depth[0] -= 1

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.depths = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in _MATMULS:
                self.depths.append(depth[0])
            return func(*args, **(kwargs or {}))

    rng = np.random.RandomState(6)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    x = t(2, 4, 4, 16)
    gamma = torch.tensor(0.6)
    args = {
        "block": (tattn.attention_block, (t(2, 16, 4), t(2, 16, 4), t(2, 16, 8), t(2, 16, 8),
                                          gamma)),
        "block_float_gamma": (tattn.attention_block, (t(2, 16, 4), t(2, 16, 4), t(2, 16, 8),
                                                      t(2, 16, 8), 0.6)),
        "core": (tattn.attention_core, (t(2, 16, 4), t(2, 16, 4), t(2, 16, 8))),
        "sagan": (tattn.sagan_block, (x.reshape(2, 16, 16), t(16, 2), t(2), t(16, 2), t(2),
                                      t(16, 16), t(16), gamma)),
        "sagan_spatial": (tattn.sagan_block_spatial, (x, t(16, 2), t(2), t(16, 2), t(2),
                                                      t(16, 16), t(16), gamma)),
    }[route]
    fn, inputs = args
    leaves = [a.clone().requires_grad_(True) if torch.is_tensor(a) else a for a in inputs]
    bare = [a.clone().requires_grad_(True) if torch.is_tensor(a) else a for a in inputs]
    grad_out = None
    ref = {"block": tattn.attention_block_jnp, "block_float_gamma": tattn.attention_block_jnp,
           "core": tattn.attention_core_jnp, "sagan": tattn.sagan_block_jnp,
           "sagan_spatial": tattn.sagan_block_spatial_jnp}[route]
    want_out = ref(*bare)
    grad_out = torch.from_numpy(rng.randn(*want_out.shape).astype(np.float32))
    want_out.backward(grad_out)
    monkeypatch.setattr(tattn, "_full_fp32_matmul", counted)
    with Products() as rec:
        out = fn(*leaves, use_pallas=False)
        n_forward = len(rec.depths)
        out.backward(grad_out)
    assert n_forward > 0 and len(rec.depths) > n_forward
    assert all(d > 0 for d in rec.depths), rec.depths
    assert torch.equal(out, want_out)
    for got, want in zip(leaves, bare):
        if torch.is_tensor(got):
            assert torch.equal(got.grad, want.grad)


def test_dct_jnp_route_matches_jax(no_twins):
    """DCTCodec(use_pallas=False).roundtrip against JAX's with the same flag
    on 4 images at 64^2, quality 50: symbols equal, reconstructions within
    1e-6 (measured 3.6e-7), and the strips function itself against `_dct_strips_jnp`
    (symbols equal, rec within 5e-5 on planes of +-128: measured 3.1e-5,
    four ulps, on 1632 of 2304 values, since the twin multiplies by the
    block-diagonal matrices in another order than JAX's einsums)."""
    imgs = rich_synthetic_images(4, (64, 64), seed=8)
    jrec, jsym = jdct.DCTCodec(JDCTCodecConfig(quality=50, use_pallas=False)).roundtrip(
        jnp.asarray(imgs))
    codec = tdct.DCTCodec(DCTCodecConfig(quality=50, use_pallas=False), device="cpu")
    rec, sym = codec.roundtrip(imgs)
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=1e-6)
    planes = torch.from_numpy(np.random.RandomState(2).rand(2, 3, 16, 24).astype(np.float32)
                              * 255 - 128)
    tables = torch.from_numpy(tdct.quality_tables(75))
    trec, tsym = tdct.dct_strips(planes, tables, use_pallas=False)
    qstrips = jdct.DCTCodec(JDCTCodecConfig(quality=75))._qtable_strips(2, 3, 16, 24)
    jr, js = jdct._dct_strips_jnp(jnp.asarray(planes.numpy().reshape(-1, 8, 24)), qstrips)
    np.testing.assert_array_equal(tsym.numpy().reshape(-1, 8, 24), np.asarray(js))
    np.testing.assert_allclose(trec.numpy().reshape(-1, 8, 24), np.asarray(jr), atol=5e-5)


@pytest.mark.parametrize("method", ["combined", "spectral_residual", "fine_grained"])
def test_masks_without_pallas_match_jax(method, no_twins):
    """compute_contextual_mask with mask_use_pallas=False against JAX's off
    the TPU (the same formula: compute_saliency_map, bilateral with the
    Taylor range weight, Gaussian 31, normalize_max), 2 uint8 images at
    48^2: within 1e-6 (measured 1.8e-7 at most; the kernel routes' bar is
    1e-4)."""
    u8 = np.clip(np.round((rich_synthetic_images(2, (48, 48), seed=12) + 1.0) * 127.5),
                 0, 255).astype(np.uint8)
    cfg = SaliencyConfig(method=method, mask_use_pallas=False)
    jcfg = JSaliencyConfig(method=method, mask_use_pallas=False)
    got = tmasks.compute_contextual_mask(torch.from_numpy(u8), cfg).numpy()
    want = np.asarray(jmasks.compute_contextual_mask(jnp.asarray(u8), jcfg))
    assert got.shape == (2, 48, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)


# ------------------------------------------- the codec with both flags False


def _arrays(seed=7):
    rng = np.random.RandomState(seed)
    img = rng.rand(4, 32, 32, 3).astype(np.float32) * 2 - 1
    mask = rng.rand(4, 32, 32, 1).astype(np.float32)
    bpp = np.array([[0.1], [1.0], [2.0], [1.0]], np.float32)
    return img, mask, bpp


@pytest.fixture(scope="module")
def plain_step():
    """The JAX step builder at the tiny configuration with both codec flags
    False (bn 'train', D's BatchNorm frozen), perturbed weights, its forward
    and one step with D; the port from the same weights, forward and step."""
    builder = jgt.GANStepBuilder(JTrainConfig(model=JPLAIN, batch_size=4, use_perceptual=False))
    st = builder.init_state(jax.random.PRNGKey(0), batch_size=4)
    rng = np.random.RandomState(11)
    st = st.replace(codec_vars=perturb_variables(to_numpy_tree(st.codec_vars), rng),
                    disc_vars=perturb_variables(to_numpy_tree(st.disc_vars), rng))
    img, mask, bpp = _arrays()
    jb = jgt.Batch(jnp.asarray(img), jnp.asarray(mask), jnp.asarray(bpp))
    jfwd = jax.jit(lambda v: builder.codec.apply(v, jb.image, jb.mask, jb.bpp)[0])(st.codec_vars)
    step_d, _ = builder.jitted_steps(donate=False)
    j1, jm = step_d(st, jb)

    tb = GANStepBuilder(TrainConfig(model=TPLAIN, batch_size=4, use_perceptual=False),
                        device="cpu")
    ts = tb.init_state(0)
    ts.codec.load_state_dict(convert.convert_codec_variables(st.codec_vars, TPLAIN))
    ts.disc.load_state_dict(convert.convert_discriminator_variables(st.disc_vars, TPLAIN))
    with torch.no_grad():
        tfwd = ts.codec.apply(*(torch.from_numpy(a) for a in (img, mask, bpp)))
    _, tm = tb.train_step(ts, Batch(nchw(img), nchw(mask), torch.from_numpy(bpp)), True)
    return dict(jfwd=jfwd, tfwd=tfwd, j1=j1, jm=jm, ts=ts, tm=tm)


def test_codec_without_pallas_forward_matches_jax(plain_step, no_twins):
    """The codec's inference forward with both flags False: blended image and
    latents within 1e-6 (measured 2.1e-7), quantized latents equal to 1e-7
    (measured 3.0e-8), launching no kernel twin (a fresh codec's forward,
    since the fixture's ran before the twins were made to raise)."""
    jf, tf = plain_step["jfwd"], plain_step["tfwd"]
    for name in ("blended", "hq_latent", "lq_latent", "dynamic_threshold"):
        np.testing.assert_allclose(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                   atol=1e-6, err_msg=name)
    for name in ("hq_latent_q", "lq_latent_q"):
        np.testing.assert_allclose(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                   atol=1e-7, err_msg=name)
    codec = AdaptiveCodec(TPLAIN)
    codec.load_state_dict(plain_step["ts"].codec.state_dict())
    img, mask, bpp = _arrays(1)
    codec.apply(*(torch.from_numpy(a) for a in (img, mask, bpp)), train=True,
                detach_for_training=True).blended.sum().backward()


def test_train_step_without_pallas_matches_jax(plain_step):
    """One step with D: every metric within 1e-5 relative or 1e-8 absolute
    (measured 3.9e-6 at most, the latent-saliency loss); parameters within
    1e-6 on >= 99.9% of elements and 2 lr everywhere (measured 99.99%,
    0.24 lr); BatchNorm statistics within 1e-6; D's within 1e-6 (the
    float32 training bars of tests/test_torch_train.py)."""
    jm, tm, ts, j1 = plain_step["jm"], plain_step["tm"], plain_step["ts"], plain_step["j1"]
    assert set(tm) == set(jm)
    for k, v in jm.items():
        err = abs(float(tm[k]) - float(v))
        assert err <= 1e-5 * abs(float(v)) or err <= 1e-8, (k, float(tm[k]), float(v))
    want = convert.convert_codec_variables(to_numpy_tree(j1.codec_vars), TPLAIN)
    sd = ts.codec.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    err = torch.cat([(sd[k] - want[k]).abs().reshape(-1) for k in want if k not in stats])
    assert float((err <= 1e-6).double().mean()) >= 0.999 and float(err.max()) <= 2 * LR
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
    dwant = convert.convert_discriminator_variables(to_numpy_tree(j1.disc_vars), TPLAIN)
    derr = max(float((ts.disc.state_dict()[k] - v).abs().max()) for k, v in dwant.items())
    assert derr <= 1e-6, derr


def test_default_flags_still_take_the_twins():
    """With the flags left True the CPU runs the kernels' twins, as before:
    the quantizer's twin (float32 inside) and the jnp formula differ on a
    bf16 latent, and the default call equals the twin."""
    rng = np.random.RandomState(9)
    lat = torch.from_numpy(rng.randn(4, 64).astype(np.float32) * 3).to(torch.bfloat16)
    score = torch.from_numpy(rng.rand(4, 1).astype(np.float32)).to(torch.bfloat16)
    strength = torch.full((4, 1), 1.3, dtype=torch.bfloat16)
    cfg = QuantizerConfig(grad_mode="reference")
    default = tq.adaptive_quantize(lat, score, strength, cfg)
    assert torch.equal(default, tq.adaptive_quantize_plain(lat, score, strength))
    jnp_route = tq.adaptive_quantize(lat, score, strength, dataclasses.replace(cfg, use_pallas=False))
    assert not torch.equal(default, jnp_route)
