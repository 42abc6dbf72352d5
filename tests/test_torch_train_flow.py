"""The port's reference training flow against the JAX package's, on the CPU:
`GANTrainer.fit` with its artifacts (sample figures, the probe's figure, the
loss plots), `rate_control_probe(save_path)`, the profiler trace of
`profile_dir`, `train_full_reference_flow`, and fit's refusal to start
without matplotlib.

The configuration is tests/test_loop_and_eval.py's tiny one (32^2, batch 4,
narrow channels) with the quantizer's 'reference' gradient mode as in
tests/test_torch_train.py. Both packages start from the same weights (JAX's
init, which the port resumes from JAX's files) and read the same seeded
numpy images and masks in the same order, so their histories and probes
are held to
tests/test_torch_train.py's bars: each metric within 1e-5 relative (or
1e-8 absolute), the probe's ratio within 1e-6 and its gradient within 1e-5.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.config import QuantizerConfig as JQuantizerConfig
from contextual_image_compression_tpu.config import TrainConfig as JTrainConfig
from contextual_image_compression_tpu.data.images import synthetic_images as j_synthetic
from contextual_image_compression_tpu.data.pipeline import CompressionDataset as JDataset
from contextual_image_compression_tpu.train.loop import GANTrainer as JTrainer
from contextual_image_compression_tpu_torch.config import (
    ModelConfig,
    QuantizerConfig,
    TrainConfig,
)
from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
from contextual_image_compression_tpu_torch.train.loop import (
    GANTrainer,
    train_full_reference_flow,
)

TINY_KW = dict(
    img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
    generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32,
)
JTINY = JModelConfig(**TINY_KW, attention_use_pallas=True,
                     quantizer=JQuantizerConfig(use_pallas=True, grad_mode="reference"))
TTINY = ModelConfig(**TINY_KW, quantizer=QuantizerConfig(grad_mode="reference"))
FLOW = dict(batch_size=4, epochs=1, use_perceptual=False, sample_visualizations=2,
            bpp_range=(0.1, 2.0), fine_tune_epochs=1)


def _data():
    imgs = j_synthetic(8, (32, 32), seed=5)
    masks = np.random.RandomState(5).rand(8, 32, 32, 1).astype(np.float32)
    return imgs, masks


def _dirs(root):
    return dict(results_dir=str(root / "results"), model_dir=str(root / "ckpt"))


def _files(root):
    out = []
    for dirpath, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, n), root) for n in names]
    return sorted(out)


def _close(got, want):
    return abs(got - want) <= 1e-5 * abs(want) or abs(got - want) <= 1e-8


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """train_full_reference_flow in each package (1 epoch with artifacts,
    then 1 fine-tune epoch at each of two bpps) from the same weights: JAX's
    init (cfg.seed) saved as 'final' with an empty history into the port's
    model_dir, which the port's flow resumes; then each one's probe with a
    figure."""
    from contextual_image_compression_tpu.train.loop import train_full_reference_flow as jflow

    root = tmp_path_factory.mktemp("flow")
    imgs, masks = _data()
    jcfg = JTrainConfig(model=JTINY, **FLOW, **_dirs(root / "jax"))
    tcfg = TrainConfig(model=TTINY, **FLOW, **_dirs(root / "port"))
    seed_trainer = JTrainer(dataclasses.replace(jcfg, model_dir=tcfg.model_dir),
                            log_fn=lambda s: None)
    seed_trainer.init_state(resume=False)
    seed_trainer.save("final", blocking=True)
    jtrainer = jflow(jcfg, JDataset(imgs, masks, batch_size=4, bpp_range=FLOW["bpp_range"]),
                     log=lambda s: None)
    logs = []
    trainer = train_full_reference_flow(
        tcfg, CompressionDataset(imgs, masks, batch_size=4, bpp_range=FLOW["bpp_range"],
                                 device="cpu"), log=logs.append, device="cpu")
    sample = CompressionDataset(imgs, masks, batch_size=4, device="cpu").first_samples(1)
    jsample = JDataset(imgs, masks, batch_size=4).first_samples(1)
    return dict(root=root, jtrainer=jtrainer, trainer=trainer, logs=logs, tcfg=tcfg,
                probe=trainer.rate_control_probe(sample, str(root / "probe.png")),
                jprobe=jtrainer.rate_control_probe(jsample, str(root / "jprobe.png")))


def test_fit_writes_the_jax_artifacts_and_checkpoints(flows):
    """Sample figures, the probe's figure and the loss plots of each epoch,
    the final loss plot and the 'final' checkpoint: the same file names as
    JAX's, the probe's save_path figure too."""
    root = flows["root"]
    want = _files(root / "jax")
    assert _files(root / "port") == want
    for f in ["final_loss_history.png", "rate_control_test.png", "loss_history_epoch_1.png",
              "loss_history_epoch_3.png"]:
        assert f"results/{f}" in want
    assert sum(f.startswith("results/training_samples/sample_") for f in want) == 2 * 3
    assert (root / "probe.png").stat().st_size > 0 and (root / "jprobe.png").exists()


def test_reference_flow_history_and_probe_match_jax(flows):
    """History length 3 (the fit's epoch and two fine-tune epochs) in both
    packages, each epoch's means within the bars; then the probe."""
    jh, th = flows["jtrainer"].history, flows["trainer"].history
    assert set(jh) == set(th)
    for k in jh:
        assert len(th[k]) == len(jh[k]) == 3
        for got, want in zip(th[k], jh[k]):
            assert _close(got, want), (k, th[k], jh[k])
    assert sum(s.startswith("Fine-tuning for target bitrate") for s in flows["logs"]) == 2
    for (bpp, r, g), (jbpp, jr, jg) in zip(flows["probe"], flows["jprobe"]):
        assert bpp == jbpp and abs(r - jr) <= 1e-6 and abs(g - jg) <= 1e-5 * max(1, abs(jg))


def test_jax_resumes_the_port_flow(flows):
    """JAX's GANTrainer resumes the port's 'final' at epoch 3 with its
    history; the port's flow refuses a mesh that is not a parallel.Mesh."""
    tcfg = flows["tcfg"]
    resumed = JTrainer(JTrainConfig(model=JTINY, **FLOW, model_dir=tcfg.model_dir),
                       log_fn=lambda s: None)
    resumed.init_state(resume=True)
    assert resumed.start_epoch == 3
    assert resumed.history == flows["trainer"].history
    with pytest.raises(TypeError, match="parallel.Mesh"):
        train_full_reference_flow(tcfg, None, mesh=object(), device="cpu")


def test_fit_without_matplotlib_raises_before_any_step(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    imgs, masks = _data()
    cfg = TrainConfig(model=TTINY, **FLOW, **_dirs(tmp_path))
    trainer = GANTrainer(cfg, device="cpu", log_fn=lambda s: None)
    trainer.init_state(resume=False)
    with pytest.raises(RuntimeError, match="matplotlib"):
        trainer.fit(CompressionDataset(imgs, masks, batch_size=4, device="cpu"))
    assert trainer.state.step == 0 and trainer.history["g_loss"] == []
    assert os.listdir(cfg.model_dir) == [] and not os.path.exists(cfg.results_dir)


@pytest.mark.parametrize("steps,profile_steps", [(3, 1), (2, 3)], ids=["stop-step", "short-epoch"])
def test_profile_dir_writes_a_trace(tmp_path, steps, profile_steps):
    """A Chrome trace of steps 1 .. profile_steps of the first epoch, also
    when the epoch ends before the stop step (JAX's short-epoch stop)."""
    imgs, masks = _data()
    logs = []
    trainer = GANTrainer(TrainConfig(model=TTINY, **FLOW, **_dirs(tmp_path)), device="cpu",
                         log_fn=logs.append)
    trainer.init_state(resume=False)
    trainer.fit(CompressionDataset(imgs, masks, batch_size=4, device="cpu"), epochs=1,
                steps_per_epoch=steps, artifacts=False, profile_dir=str(tmp_path / "trace"),
                profile_steps=profile_steps)
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert (tmp_path / "trace" / traces[0]).stat().st_size > 0
    assert logs.count(f"profiler trace written to {tmp_path / 'trace'}") == 1
    assert trainer.state.step == steps
