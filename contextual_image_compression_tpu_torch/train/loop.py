"""The GAN training loop.

Counterpart of `GANTrainer` in `contextual_image_compression_tpu/train/
loop.py`: the discriminator trains every `d_every_n_steps`-th step and the
codec every step, the epoch's metric sums stay on the device until the
epoch's one host read, and each epoch appends its means to `history` and logs
a line. `rate_control_probe` is d(mean HQ ratio) / d(target bpp).

Checkpoints are the JAX package's files (checkpoint/store.py, in JAX's
layouts through convert.py), so either package resumes what the other
saved: the seven codec components, `discriminator`, `optimizers` (the four
Adam states and the step) and `metadata_{tag}.json` (epoch, history).
`init_state(resume=True)` loads them by the store's ladder; `fit` saves
`epoch_N` every `checkpoint_every` epochs but the last, then `final`.

Not in this slice of the port, and refused rather than skipped: per-epoch
artifacts and plots (`fit(artifacts=True)`, a probe `save_path`), the
fine-tune flow, and meshes.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.checkpoint import CheckpointStore
from contextual_image_compression_tpu_torch.config import TrainConfig, resolve_device
from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
from contextual_image_compression_tpu_torch.models.adaptive import ALL_CODEC_COMPONENTS
from contextual_image_compression_tpu_torch.models.vgg import load_vgg19_features
from contextual_image_compression_tpu_torch.train.gan_trainer import (
    Batch,
    GANStepBuilder,
    GANTrainState,
)
from contextual_image_compression_tpu_torch.utils.tree import find_nonfinite

HISTORY_KEYS = (
    "d_loss",
    "g_loss",
    "reconstruction_loss",
    "gan_loss",
    "perceptual_loss",
    "l1_loss",
    "latent_saliency_loss",
    "rd_loss",
)

_LATER = "training artifacts come with a later slice of the port"


class GANTrainer:
    """Owns the step builder, the train state, the loss history and the
    checkpoints.

    save_mode 'background' (the default): `save` clones the state on the
    device, then a writer thread converts it to JAX's layout, copies it to
    the host and writes it while training goes on. 'host': `save` blocks,
    copies each tensor to the host and converts it there, with no second
    copy of the state on the device. nan_guard: check the step's metrics
    after every step (one host read a step) and raise FloatingPointError
    with the step, the metrics and the codec's non-finite tensors."""

    def __init__(self, cfg: TrainConfig, bn_mode: str = "train",
                 disc_bn_mode: Optional[str] = None,
                 log_fn: Callable[[str], None] = print, device="cuda",
                 nan_guard: bool = False, save_mode: str = "background"):
        if save_mode not in ("background", "host"):
            raise ValueError(f"unknown save_mode {save_mode!r}")
        self.save_mode = save_mode
        self.nan_guard = nan_guard
        self.cfg = cfg
        self.log = log_fn
        self.device = resolve_device(device)
        vgg = load_vgg19_features(cfg.vgg_weights_path, self.device) if cfg.use_perceptual else None
        if vgg is not None:
            self.log("Perceptual loss: VGG19 weights loaded")
        elif cfg.use_perceptual:
            self.log("WARNING: no VGG19 weights available -- perceptual loss disabled")
        self.builder = GANStepBuilder(cfg, vgg=vgg, bn_mode=bn_mode,
                                      disc_bn_mode=disc_bn_mode, device=self.device)
        self.store = CheckpointStore(cfg.model_dir)
        self.history: Dict[str, List[float]] = {k: [] for k in HISTORY_KEYS}
        self.state: Optional[GANTrainState] = None
        self.start_epoch = 0
        self._saver: Optional[threading.Thread] = None
        self._saver_error: Optional[Exception] = None

    # ------------------------------------------------------------------ state
    def init_state(self, resume: bool = True) -> GANTrainState:
        """A fresh seeded state (cfg.seed); with resume, every component the
        store's ladder finds in cfg.model_dir replaces its fresh values.
        The optimizers and the step are restored only when their own file
        was found; the epoch count and history come from the latest
        metadata."""
        state = self.builder.init_state(self.cfg.seed)
        self.start_epoch = 0
        if resume:
            mcfg = self.cfg.model
            templates = convert.codec_variables(state.codec, leaf=convert.placeholder)
            templates["discriminator"] = convert.discriminator_variables(
                state.disc, mcfg, leaf=convert.placeholder)
            templates["optimizers"] = convert.optimizer_variables(state, leaf=convert.placeholder)
            loaded, provenance = self.store.load_components(templates)
            if any(p != "init" for p in provenance.values()):
                self.log(f"Restored components: {provenance}")
                for comp in ALL_CODEC_COMPONENTS:
                    if provenance[comp] != "init":
                        getattr(state.codec, comp).load_state_dict(
                            convert.component_state(comp, loaded[comp], mcfg))
                if provenance["discriminator"] != "init":
                    state.disc.load_state_dict(
                        convert.convert_discriminator_variables(loaded["discriminator"], mcfg))
                if provenance["optimizers"] != "init":
                    convert.load_optimizer_variables(state, loaded["optimizers"])
                meta = self.store.latest_metadata()
                if meta:
                    self.start_epoch = int(meta.get("epoch", 0))
                    self.history = {k: list(meta.get("history", {}).get(k, []))
                                    for k in HISTORY_KEYS}
        self.state = state
        return state

    # ------------------------------------------------------------------ train
    def fit(self, dataset: CompressionDataset, epochs: Optional[int] = None,
            steps_per_epoch: Optional[int] = None, artifacts: bool = True) -> Dict[str, List[float]]:
        """Train `epochs` epochs of `steps_per_epoch` steps (the dataset's
        epoch length by default), restarting the dataset's epoch iterator
        when it runs out; checkpoint as the module docstring says, and
        return once the final checkpoint is written. Without a state it
        calls init_state() (resume=True). artifacts=True raises: see the
        module docstring."""
        if artifacts:
            raise NotImplementedError(f"artifacts=True: {_LATER}; pass artifacts=False")
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        steps_per_epoch = steps_per_epoch or dataset.steps_per_epoch
        if self.state is None:
            self.init_state()
        for epoch in range(epochs):
            t0 = time.time()
            sums: Dict[str, torch.Tensor] = {}
            counts = {k: 0 for k in HISTORY_KEYS}
            step_iter = dataset.epoch()
            n_images = 0
            for step in range(steps_per_epoch):
                try:
                    batch = next(step_iter)
                except StopIteration:
                    step_iter = dataset.epoch()
                    batch = next(step_iter)
                do_d = step % cfg.d_every_n_steps == 0
                self.state, metrics = self.builder.train_step(self.state, batch, do_d)
                if self.nan_guard:
                    self._check_finite(metrics)
                n_images += int(batch.image.shape[0])
                for k, v in metrics.items():
                    if k in counts:
                        sums[k] = v if k not in sums else sums[k] + v
                        counts[k] += 1
            means = {k: (sums[k].item() / counts[k] if counts[k] else float("nan"))
                     for k in HISTORY_KEYS}
            for k in HISTORY_KEYS:
                self.history[k].append(means[k])
            # the history includes restored epochs, so its length is the
            # global epoch number
            epoch_label = len(self.history["g_loss"])
            dt = time.time() - t0
            ips = n_images / dt if dt > 0 else float("nan")
            self.log(
                f"Epoch {epoch_label}: "
                f"D {means['d_loss']:.4f}, G {means['g_loss']:.4f}, "
                f"Recon {means['reconstruction_loss']:.4f}, RD {means['rd_loss']:.4f}, "
                f"LS {means['latent_saliency_loss']:.4f} "
                f"({dt:.2f}s, {ips:.1f} img/s)"
            )
            # the last epoch is covered by the 'final' save below
            if (epoch + 1) % cfg.checkpoint_every == 0 and epoch + 1 != epochs:
                self.save(f"epoch_{epoch_label}")
        self.save("final")
        self._join_saver()  # the final checkpoint is on disk before fit returns
        return self.history

    def _check_finite(self, metrics: Dict[str, torch.Tensor]) -> None:
        values = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()):
            raise FloatingPointError(
                f"non-finite training metrics at step {self.state.step}: {values}; "
                f"non-finite params: {find_nonfinite(self.state.codec)}")

    # ------------------------------------------------------------ checkpoints
    def save(self, tag: str, blocking: bool = False) -> None:
        """Checkpoint the train state under `tag`: the codec's components,
        the discriminator, the optimizers (four Adam states and the step)
        and the metadata (epoch = history length, history).

        The snapshot holds the parameters, the running BatchNorm statistics
        and the optimizer states as they stand. Batch statistics still
        pending (a train-mode forward whose step did not commit them) are
        not state and are not saved; they stay pending.

        'background' mode joins the previous writer, clones the state on the
        device, and hands the clone to a writer thread (blocking=True
        writes before returning); 'host' mode writes before returning, from
        host copies, with no second copy on the device. A writer's error is
        raised by the next save or join."""
        state = self.state
        mcfg = self.cfg.model
        if self.save_mode == "host":
            blocking = True
        else:
            self._join_saver()
        snap = _map_tensors(
            {"codec": state.codec.state_dict(), "disc": state.disc.state_dict(),
             "moments": convert.optimizer_moments(state)},
            (lambda t: t.detach().cpu()) if self.save_mode == "host" else
            (lambda t: t.detach().clone()))
        meta = {"epoch": len(self.history["g_loss"]),
                "history": {k: list(v) for k, v in self.history.items()}}

        def write():
            components = convert.codec_variables(state.codec, tensors=snap["codec"])
            components["discriminator"] = convert.discriminator_variables(
                state.disc, mcfg, tensors=snap["disc"])
            self.store.save_components(components, tag)
            self.store.save_component(
                "optimizers", convert.optimizer_variables(state, moments=snap["moments"]), tag)
            self.store.save_metadata(meta, tag)

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except Exception as exc:  # handed to the next join, which raises it
                self._saver_error = exc

        self._saver = threading.Thread(target=run, name=f"ckpt-{tag}", daemon=False)
        self._saver.start()

    def _join_saver(self) -> None:
        saver, self._saver = self._saver, None
        if saver is not None:
            saver.join()
        err, self._saver_error = self._saver_error, None
        if err is not None:
            raise RuntimeError("the checkpoint writer failed") from err

    def rate_control_probe(self, sample_batch: Batch, save_path: Optional[str] = None):
        """[(bpp, mean HQ ratio, d ratio / d bpp)] for bpp in (0.1, 1.0, 2.0)
        on the first sample, codec in eval mode. The ratio depends on the
        bpp through the blend threshold only, so the backward reaches
        neither the quantizer (K3b) nor the generators, in either package."""
        if save_path:
            raise NotImplementedError(f"save_path (the bit-allocation plot): {_LATER}")
        codec = self.state.codec
        img = sample_batch.image[:1].permute(0, 2, 3, 1)
        mask = sample_batch.mask[:1].permute(0, 2, 3, 1)
        results = []
        for bpp in (0.1, 1.0, 2.0):
            b = torch.tensor(bpp, dtype=torch.float32, device=img.device, requires_grad=True)
            out = codec.apply(img, mask, b.reshape(1, 1).expand(img.shape[0], 1), train=False)
            ratio = torch.mean(out.dynamic_threshold)
            (grad,) = torch.autograd.grad(ratio, b)
            results.append((bpp, ratio.item(), grad.item()))
        self.log("Rate Control Gradient Test:")
        for bpp, ratio, grad in results:
            self.log(f"  BPP: {bpp}, HQ Ratio: {ratio:.4f}, Gradient: {grad:.6f}")
        return results


def _map_tensors(tree, fn):
    """`tree` (nested dicts) with fn applied to every tensor."""
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree
