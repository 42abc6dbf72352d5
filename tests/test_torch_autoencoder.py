"""The PyTorch port's baseline autoencoder against the JAX package's.

On the CPU, the same seeded numpy images through both packages: the forward
of the trained checkpoint runs/ae_ref (35.8 dB held out, PARITY.md) within
1e-5; three Adam steps of `fit` from the same init, with the same
validation split and shuffles (see the bars there); `ae_metrics`; and checkpoints
that each package reads from the other. The autoencoder runs no kernel of
the port (cuDNN convolutions on the card).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextual_image_compression_tpu.checkpoint import CheckpointStore as JStore
from contextual_image_compression_tpu.config import AutoencoderConfig as JAEConfig
from contextual_image_compression_tpu.data.images import synthetic_images
from contextual_image_compression_tpu.ops import metrics as jmetrics
from contextual_image_compression_tpu.train.ae_trainer import AETrainer as JAETrainer
from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.config import AutoencoderConfig
from contextual_image_compression_tpu_torch.ops import metrics as tmetrics
from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer

REPO = pathlib.Path(__file__).resolve().parent.parent
AE_DIR = REPO / "runs" / "ae_ref" / "model"


def _images(n, size, seed):
    """Seeded synthetic images in [0, 1], NHWC float32."""
    return ((synthetic_images(n, (size, size), seed=seed) + 1.0) / 2.0).astype(np.float32)


def _port(**kw):
    return AETrainer(AutoencoderConfig(**kw), device="cpu", log_fn=lambda s: None)


def _jax(**kw):
    return JAETrainer(JAEConfig(**kw), log_fn=lambda s: None)


def test_forward_of_the_trained_checkpoint_matches_jax():
    imgs = _images(8, 128, seed=4)
    jt = _jax()
    jt.load(str(AE_DIR))
    want = jt.reconstruct(imgs)
    tt = _port()
    tt.load(str(AE_DIR))
    got = tt.reconstruct(imgs)
    assert got.shape == want.shape == (8, 128, 128, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    psnr = 10 * np.log10(1.0 / np.mean((got - imgs) ** 2))
    assert psnr > 20.0  # a trained model, not an identity or a blank


def test_odd_sizes_pool_and_upsample_like_flax():
    """SAME max-pools over an odd edge, and the decoder's concat shapes: the
    forward at 36^2 (pooled to 18, 9) against JAX from the same weights."""
    imgs = _images(2, 36, seed=5)
    jt = _jax(img_size=(36, 36))
    jt.load(str(AE_DIR))
    encoded = np.asarray(jt.model.apply(jt.params, jnp.asarray(imgs), method="encode"))
    tt = _port(img_size=(36, 36))
    tt.load(str(AE_DIR))
    with torch.no_grad():
        enc = tt.model.encode(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    np.testing.assert_allclose(enc.permute(0, 2, 3, 1).numpy(), encoded, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.reconstruct(imgs), jt.reconstruct(imgs), atol=1e-5, rtol=0)


def test_fit_matches_jax_for_three_steps(tmp_path):
    """56 images: 6 held out (round(5.6)), 50 trained in 3 batches of 16 by
    RandomState(42)'s split and shuffle in both. The first step's gradients
    within 1e-5 relative L2 per tensor; losses within 1e-5 relative; after
    the three Adam steps (eps 1e-8, no clipping) the parameters within 1e-5
    on >= 99% of elements and within 2 lr everywhere (99.41% measured, the
    rest within 1.3e-4): Adam divides each gradient by its own running
    magnitude, so a gradient at float32 rounding level (an input channel
    that ReLU almost always zeroes) moves its weight by a sizeable share of
    lr whatever its rounding, as the GAN step's bars state
    (test_torch_train.py). test_adam_matches_optax holds the update itself
    to JAX's on equal gradients."""
    imgs = _images(56, 64, seed=6)
    jt = _jax(img_size=(64, 64))
    jt.init()
    JStore(str(tmp_path)).save_component("autoencoder", jt.params, "init")
    tt = _port(img_size=(64, 64))
    tt.load(str(tmp_path), tag="init")
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}

    batch = imgs[:16]
    jgrad = jax.grad(lambda p: jnp.mean((jt.model.apply(p, jnp.asarray(batch)) - batch) ** 2))(
        jt.params)
    jgrad = convert.convert_autoencoder_variables(jax.tree.map(np.asarray, jgrad))
    tt._loss(torch.from_numpy(batch).permute(0, 3, 1, 2)).backward()
    for k, p in tt.model.named_parameters():
        assert float((p.grad - jgrad[k]).norm() / jgrad[k].norm()) <= 1e-5, k

    jh = jt.fit(imgs, epochs=1, batch_size=16)
    th = tt.fit(imgs, epochs=1, batch_size=16)
    assert len(tt.opt.state) == 14 and all(float(s["step"]) == 3 for s in tt.opt.state.values())
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(th[key], jh[key], rtol=1e-5, err_msg=key)
    want = convert.convert_autoencoder_variables(jax.tree.map(np.asarray, jt.params))
    got = tt.model.state_dict()
    assert set(got) == set(want)
    err = torch.cat([(got[k] - want[k]).abs().reshape(-1) for k in want])
    lr = AutoencoderConfig().learning_rate
    assert float((err <= 1e-5).float().mean()) >= 0.99 and float(err.max()) <= 2 * lr
    moved = max(float((got[k] - before[k]).abs().max()) for k in got)
    assert moved > 1e-3  # three steps at lr 1e-3 moved the weights


def test_adam_matches_optax():
    """Three steps of the port's AE optimizer and of optax.adam(1e-3), the
    JAX trainer's, on the same parameters and gradients (magnitudes 1e-10
    to 1e-2): within 1e-4 of lr (a few float32 ulps of the weights)."""
    import optax

    rng = np.random.RandomState(9)
    tt = _port(img_size=(32, 32))
    tt.init(seed=1)
    params = {k: p.detach().numpy().copy() for k, p in tt.model.named_parameters()}
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-10, -2, v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = optax.adam(AutoencoderConfig().learning_rate)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tt.model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        tt.opt.step()
    for k, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-7, rtol=0,
                                   err_msg=k)


def test_ae_metrics_match_jax():
    rng = np.random.RandomState(8)
    a = (rng.rand(3, 40, 40, 3) * 255).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.randint(-20, 21, a.shape), 0, 255).astype(np.uint8)
    want = jmetrics.ae_metrics(jnp.asarray(a), jnp.asarray(b))
    got = tmetrics.ae_metrics(torch.from_numpy(a), torch.from_numpy(b))
    assert set(got) == set(want) == {"mse", "psnr", "ssim"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)
    assert tmetrics.estimate_compression_ratio(196608, 65536) == \
        jmetrics.estimate_compression_ratio(196608, 65536)


def test_save_load_round_trip(tmp_path):
    """The port's save, read back by the port and by JAX, equal to the
    weights saved; a port trainer with its own seeded init saves a file JAX
    loads."""
    tt = _port()
    tt.init(seed=3)
    tt.save(str(tmp_path))
    again = _port()
    again.init(seed=4)
    again.load(str(tmp_path))
    for (k, a), (_, b) in zip(tt.model.state_dict().items(), again.model.state_dict().items()):
        assert torch.equal(a, b), k
    jt = _jax()
    jt.load(str(tmp_path))
    want = convert.autoencoder_variables(tt.model)
    got = jax.tree.map(np.asarray, jt.params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(FileNotFoundError):
        again.load(str(tmp_path), tag="epoch_3")
