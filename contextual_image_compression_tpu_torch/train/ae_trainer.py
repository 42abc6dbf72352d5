"""Autoencoder training.

Counterpart of `contextual_image_compression_tpu/train/ae_trainer.py`: Adam
(optax.adam's: eps 1e-8, no clipping) on the MSE of the reconstruction,
the same 90/10 train / validation split and shuffles (numpy RandomState
of the seed), per-epoch train and validation MSE, and checkpoints in the
JAX package's files (component `autoencoder`, through convert.py), so
either package loads what the other saved, `runs/ae_ref` included.
Images cross the API as NHWC numpy arrays in [0, 1], as in JAX.

`mesh=` (parallel/mesh.py) trains on a (data, model) mesh as the JAX
trainer does under SPMD: the parameters and Adam moments placed by the
state rules (parallel/sharding.py), each batch split over 'data', the loss
the global batch's mean and the gradients summed over the data group; the
validation loss is every rank's over the whole held-out set. `save` gathers
the split leaves on every rank and mesh position 0 writes; `load` reads the
whole tensors and places them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.checkpoint import CheckpointStore
from contextual_image_compression_tpu_torch.config import (
    AutoencoderConfig,
    resolve_device,
    torch_dtype,
)
from contextual_image_compression_tpu_torch.models.autoencoder import Autoencoder
from contextual_image_compression_tpu_torch.parallel import sharding
from contextual_image_compression_tpu_torch.train.losses import mean


class AETrainer:
    def __init__(self, cfg: AutoencoderConfig = AutoencoderConfig(),
                 log_fn: Callable[[str], None] = print, device="cuda", mesh=None):
        self.cfg = cfg
        self.log = log_fn
        self.mesh = mesh
        self.group = mesh.data_parallel_group() if mesh is not None else None
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.compute_dtype = torch_dtype(cfg.dtype)
        with torch.device(self.device):
            self.model = Autoencoder(out_channels=cfg.channels, enc_channels=cfg.enc_channels,
                                     in_channels=cfg.channels)
        self.opt: Optional[torch.optim.Adam] = None

    def init(self, seed: int = 42) -> Autoencoder:
        """Seeded glorot-uniform kernels, zero biases, a fresh Adam. The
        values differ from the JAX package's PRNGKey(42) init."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.model.reset_parameters(gen)
        self._fresh_optimizer()
        return self.model

    def _fresh_optimizer(self) -> None:
        if self.mesh is not None:
            sharding.shard_state(self.model, self.mesh)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=self.cfg.learning_rate,
                                    betas=(0.9, 0.999), eps=1e-8)

    def _nchw(self, images: np.ndarray) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        return x.permute(0, 3, 1, 2).to(self.compute_dtype)

    def _loss(self, x: torch.Tensor, group=None) -> torch.Tensor:
        d = self.model(x) - x.float()
        return mean(d * d, group)

    def fit(self, images: np.ndarray, epochs: Optional[int] = None,
            batch_size: Optional[int] = None, seed: int = 42) -> Dict[str, List[float]]:
        """Train on (N, H, W, C) images in [0, 1]: round(N * validation_split)
        images held out by RandomState(seed)'s permutation, the rest
        shuffled by the same generator each epoch, full batches only."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        batch_size = batch_size or cfg.batch_size
        if self.opt is None:
            self.init()
        n = len(images)
        n_val = int(round(n * cfg.validation_split))
        rng = np.random.RandomState(seed)
        perm = rng.permutation(n)
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        history: Dict[str, List[float]] = {"loss": [], "val_loss": []}
        for epoch in range(epochs):
            t0 = time.time()
            rng.shuffle(train_idx)
            losses = []
            for start in range(0, len(train_idx) - batch_size + 1, batch_size):
                batch = self._nchw(images[train_idx[start:start + batch_size]])
                self.opt.zero_grad(set_to_none=True)
                if self.mesh is not None:
                    batch = sharding.shard_batch(batch, self.mesh)
                loss = self._loss(batch, self.group)
                loss.backward()
                if self.mesh is not None:
                    sharding.reduce_gradients(self.model, self.mesh)
                self.opt.step()
                losses.append(loss.detach())
            train_loss = (float(np.mean(torch.stack(losses).double().cpu().numpy()))
                          if losses else float("nan"))
            if len(val_idx):
                with torch.no_grad():
                    val_loss = float(self._loss(self._nchw(images[val_idx])))
            else:
                val_loss = float("nan")
            history["loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            self.log(f"AE epoch {epoch + 1}/{epochs}: loss {train_loss:.5f}, "
                     f"val_loss {val_loss:.5f} ({time.time() - t0:.2f}s)")
        return history

    @torch.no_grad()
    def reconstruct(self, images: np.ndarray, batch_size: int = 64) -> np.ndarray:
        """(N, H, W, C) in [0, 1] -> the reconstructions, float32 numpy."""
        outs = [self.model(self._nchw(images[s:s + batch_size])).float().permute(0, 2, 3, 1).cpu()
                for s in range(0, len(images), batch_size)]
        return torch.cat(outs).numpy() if outs else np.zeros_like(images, np.float32)

    # ---------------------------------------------------------------- persist
    def save(self, directory: str, tag: str = "final") -> str:
        store = CheckpointStore(directory)
        if self.mesh is None:
            return store.save_component("autoencoder", convert.layer_variables(self.model), tag)
        tensors = sharding.full_state_dict(self.model)
        if not self.mesh.is_writer:
            return store._path("autoencoder", tag)
        return store.save_component(
            "autoencoder", convert.layer_variables(self.model, tensors=tensors), tag)

    def load(self, directory: str, tag: str = "final") -> Autoencoder:
        """Load the `autoencoder` component at `tag` (no ladder, as in JAX)
        and start a fresh Adam."""
        template = convert.layer_variables(self.model, leaf=convert.placeholder)
        tree = CheckpointStore(directory).load_component("autoencoder", template, tag)
        sd = convert.convert_layer_variables(tree)
        if self.mesh is not None:
            sd = sharding.local_tensors(self.model, sd)
        self.model.load_state_dict(sd)
        self._fresh_optimizer()
        return self.model
