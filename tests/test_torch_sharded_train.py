"""Sharded training of the port on a (data, model) mesh against JAX's SPMD
step and against the port on one process.

The mesh runs as 4 gloo ranks on the CPU (tests/torch_mesh_worker.py: one
spawn for the step, one for the loop, one for the autoencoder), the model
axis engaged by splitting leaves from 1 << 12 elements; JAX runs in-process
at tests/test_sharding.py's TINY config, its step jitted once for the file.
The port computes the global-batch step with explicit collectives: the
BatchNorm statistics, the losses' means and the gradients summed over the
data group, the latent / fc projections row- and column-parallel.

Bars: metrics within 2e-4 of JAX's replicated step (tests/test_sharding.py's
bar; measured ~1e-7); BatchNorm running statistics within 1e-6 of JAX's;
parameters after the step against the port's one-process step within 1e-6
on >= 99.9% of elements and within 2 lr everywhere (Adam's first step
amplifies sums reordered by the row-parallel product toward +-lr, as in
tests/test_torch_train.py; measured: >= 99.995% within 1e-6, largest
1.5e-5); the autoencoder's losses within 1e-6 and weights within 1e-6 of
one process (measured 8e-8). The parameter rule is what catches a wrong
gradient: with the gradient reduction left out, 58% of the codec's
elements are within 1e-6; with the perceptual z-scores' moments summed
without their backward, 99.0% (the perceptual case alone); with no
collective in any moment's backward, 93%. Step 0's metrics stay within
2e-4 in the last two, since they are taken before the update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_worker as W
from torch_port_helpers import to_numpy_tree

from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.config import QuantizerConfig as JQuantizerConfig
from contextual_image_compression_tpu.config import TrainConfig as JTrainConfig
from contextual_image_compression_tpu.train import gan_trainer as jgt
from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.checkpoint import CheckpointStore
from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer
from contextual_image_compression_tpu_torch.train.loop import GANTrainer

JTINY = JModelConfig(img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
                     generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32,
                     attention_use_pallas=False, quantizer=JQuantizerConfig(use_pallas=False))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's replicated step with D (bn_mode 'train', D's BatchNorm frozen)
    from PRNGKey(0); the same weights and batch through the port on one
    process and on 4 ranks, for each of the worker's STEP_CASES (default
    losses, the broadcast quirk, the perceptual term)."""
    d = tmp_path_factory.mktemp("step")
    rng = np.random.RandomState(3)
    batch = dict(image=rng.rand(8, 32, 32, 3).astype(np.float32) * 2 - 1,
                 mask=rng.rand(8, 32, 32, 1).astype(np.float32),
                 bpp=rng.choice([0.1, 1.0, 2.0], (8, 1)).astype(np.float32))
    np.savez(d / "batch.npz", **batch)
    builder = jgt.GANStepBuilder(JTrainConfig(model=JTINY, batch_size=8, use_perceptual=False),
                                 bn_mode="train")
    st = builder.init_state(jax.random.PRNGKey(0), batch_size=8)
    step_d, _ = builder.jitted_steps(donate=False)
    j1, jm = step_d(st, jgt.Batch(*(jnp.asarray(batch[k]) for k in ("image", "mask", "bpp"))))
    torch.save({"codec": convert.convert_codec_variables(to_numpy_tree(st.codec_vars), W.TINY),
                "disc": convert.convert_discriminator_variables(to_numpy_tree(st.disc_vars),
                                                                W.TINY)}, d / "weights.pt")
    one = {}
    for case in W.STEP_CASES:
        tb, ts = W.train_state(W.step_cfg(case), d)
        _, m = tb.train_step(ts, W._batch(d), True)
        one[case] = {"metrics": {k: float(v) for k, v in m.items()},
                     "codec": ts.codec.state_dict(), "disc": ts.disc.state_dict()}
    return dict(jm={k: float(v) for k, v in jm.items()},
                jstats=convert.convert_codec_variables(to_numpy_tree(j1.codec_vars), W.TINY),
                one=one, ranks=W.spawn("step", 4, d))


def test_sharded_step_metrics_match_jax(steps):
    jm = steps["jm"]
    for out in steps["ranks"]:
        assert out["mesh"][0] == {"data": 2, "model": 2}
        got = out["plain"]["metrics"]
        assert set(got) == set(jm)
        for k, v in jm.items():
            assert abs(got[k] - v) <= 2e-4, (k, got[k], v)


def test_sharded_step_bn_statistics_match_jax(steps):
    """The codec's running statistics after the step are the global batch's
    (synchronized BatchNorm), within 1e-6 of JAX's."""
    got = steps["ranks"][0]["plain"]["codec"]
    stats = [k for k in steps["jstats"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 10
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), steps["jstats"][k].numpy(), atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("key", W.STEP_CASES)
def test_sharded_step_matches_one_process(steps, key):
    """Metrics (the broadcast quirk's (B, B) terms and the perceptual term's
    global z-scores included) within 2e-4 and the gathered parameters (see
    the module docstring) of the port's one-process step; every rank holds
    the same state; the model axis split the leaves, the projections among
    them."""
    want = steps["one"][key]
    ranks = [out[key] for out in steps["ranks"]]
    for k, v in want["metrics"].items():
        assert abs(ranks[0]["metrics"][k] - v) <= 2e-4, (k, ranks[0]["metrics"][k], v)
    for part in ("codec", "disc"):
        got, ref = ranks[0][part], want[part]
        err = torch.cat([(got[k].float() - ref[k].float()).abs().reshape(-1) for k in ref])
        assert float((err <= 1e-6).float().mean()) >= 0.999 and float(err.max()) <= 2 * W.LR
        for other in ranks[1:]:
            assert all(torch.equal(other[part][k], got[k]) for k in got)
    split = ranks[0]["sharded"]
    assert split["hq_encoder.latent_dense.weight"][1] == (32, 64)
    assert split["hq_generator.fc.weight"][1] == (64, 32)
    assert len(split) >= 10


# ------------------------------------------------------------------- loop


@pytest.fixture(scope="module")
def fit_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("fit")
    rng = np.random.RandomState(11)
    np.savez(d / "fit.npz", images=rng.rand(16, 32, 32, 3).astype(np.float32) * 2 - 1,
             masks=rng.rand(16, 32, 32, 1).astype(np.float32))
    return d, W.spawn("fit", 4, d)


def test_fit_on_mesh_then_resume_on_another_shape(fit_ranks):
    """GANTrainer.fit for 2 epochs on (2, 2) with leaves split, a resume on
    (4, 1) that restores every tensor of the (2, 2) run, and 1 more epoch:
    a history of 3 epochs and metadata epoch 3, as tests/test_sharding.py's
    loop test."""
    _, res = fit_ranks
    for out in res:
        assert len(out["history"]["g_loss"]) == 2
        assert all(np.isfinite(v) for v in out["history"]["g_loss"])
        assert out["sharded"] and not out["resumed"]["sharded"]
        assert out["resumed"]["equal"] and out["resumed"]["step"] == 4
        assert out["resumed"]["history"] == out["history"]
        assert len(out["history2"]["g_loss"]) == 3
        assert out["meta"]["epoch"] == 3 and out["step"] == 6
        assert out["history2"] == res[0]["history2"]


def test_mesh_checkpoint_is_a_single_device_checkpoint(fit_ranks):
    """The (2, 2) mesh's 'epoch_1' files (rank 0 writes, split leaves
    gathered) loaded into one process and written again are the same bytes."""
    d, _ = fit_ranks
    cfg = W.fit_cfg(d)
    trainer = GANTrainer(cfg, device="cpu", log_fn=lambda s: None)
    state = trainer.init_state(resume=False)
    store = CheckpointStore(cfg.model_dir)
    templates = convert.codec_variables(state.codec, leaf=convert.placeholder)
    for comp, template in templates.items():
        tree = store.load_component(comp, template, "epoch_1")
        getattr(state.codec, comp).load_state_dict(convert.component_state(comp, tree, cfg.model))
    tree = store.load_component("discriminator", convert.discriminator_variables(
        state.disc, cfg.model, leaf=convert.placeholder), "epoch_1")
    state.disc.load_state_dict(convert.convert_discriminator_variables(tree, cfg.model))
    tree = store.load_component("optimizers", convert.optimizer_variables(
        state, leaf=convert.placeholder), "epoch_1")
    convert.load_optimizer_variables(state, tree)
    trainer.save("again", blocking=True)
    names = [*templates, "discriminator", "optimizers"]
    for name in names:
        first = (d / "models" / f"{name}_epoch_1.msgpack").read_bytes()
        assert (d / "models" / f"{name}_again.msgpack").read_bytes() == first, name


# ------------------------------------------------------------ autoencoder


def test_ae_trainer_on_mesh_matches_one_process(tmp_path):
    """AETrainer(mesh=) on (2, 2) for one epoch: the losses and weights of
    one process, the save readable by one process."""
    rng = np.random.RandomState(4)
    images = rng.rand(20, 16, 16, 3).astype(np.float32)
    np.savez(tmp_path / "ae.npz", images=images)
    res = W.spawn("ae", 4, tmp_path)
    one = AETrainer(W.ae_cfg(), log_fn=lambda s: None, device="cpu")
    one.init(seed=1)
    hist = one.fit(images, epochs=1, batch_size=8, seed=4)
    want = one.model.state_dict()
    for out in res:
        for k in ("loss", "val_loss"):
            np.testing.assert_allclose(out["history"][k], hist[k], atol=1e-6)
        for k, v in want.items():
            np.testing.assert_allclose(out["state"][k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
        assert "enc_conv2.weight" in out["sharded"]
    loaded = AETrainer(W.ae_cfg(), log_fn=lambda s: None, device="cpu")
    loaded.load(str(tmp_path / "ae_model"))
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, res[0]["state"][k]), k
