"""Input pipeline: the mask precompute, and the epoch batcher.

Counterpart of `contextual_image_compression_tpu/data/pipeline.py`:

  * `prepare_masks` runs the contextual-mask engine (ops/masks.py) over the
    corpus in device batches, for any SaliencyConfig the port computes:
    method 'combined' with the smooth mask launches kernel K1 once per
    batch; 'spectral_residual' and 'fine_grained' with the smooth mask
    launch K4 once per batch after their saliency maps (plain PyTorch);
    mask_smooth=False gives binary masks and launches no kernel;
  * `CompressionDataset` yields NCHW `Batch`es on the device with
    per-sample shuffling and a per-sample random target bpp, drawn from
    `np.random.RandomState(seed)` in the JAX dataset's order, so equal seeds
    give equal orders and bpps in both packages. `device_resident=True`
    keeps the corpus on the card and gathers each batch there.
    `process_index` / `process_count` shard the corpus over nodes as the
    JAX dataset shards it over processes (see the class).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from contextual_image_compression_tpu_torch.config import SaliencyConfig, resolve_device
from contextual_image_compression_tpu_torch.ops import masks as mask_ops
from contextual_image_compression_tpu_torch.train.gan_trainer import Batch
from contextual_image_compression_tpu_torch.utils.profiling import annotate


def make_mask_fn(config: SaliencyConfig | None = None):
    """(B, H, W, 3) images in [-1, 1] (or uint8) -> (B, H, W, 1) float32 masks
    of `config` (kernel K1 or K4 on the card, see the module docstring)."""
    cfg = config or SaliencyConfig()

    @torch.no_grad()
    def fn(images: torch.Tensor) -> torch.Tensor:
        return mask_ops.compute_contextual_mask(images, cfg)[..., None]

    return fn


def prepare_masks(images: np.ndarray, config: SaliencyConfig | None = None,
                  device_batch: int = 64, device="cuda") -> np.ndarray:
    """Masks of all images, (N, H, W, 1) float32 numpy, computed on `device`
    in batches of `device_batch` (one K1 or K4 launch each on the card for
    the smooth masks)."""
    dev = resolve_device(device)
    fn = make_mask_fn(config)
    outs = []
    for i in range(0, len(images), device_batch):
        chunk = torch.from_numpy(np.ascontiguousarray(images[i:i + device_batch])).to(dev)
        outs.append(fn(chunk).cpu().numpy())
    if not outs:
        return np.zeros(images.shape[:3] + (1,), np.float32)
    return np.concatenate(outs, axis=0)


def _to_nchw(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device).permute(0, 3, 1, 2).contiguous()


@dataclasses.dataclass
class CompressionDataset:
    """Epoch iterator over (image, mask, bpp) batches on `device`.

    target_bpp=None draws a random bpp per sample from `bpp_range`; a float
    fixes it (the fine-tune phase).

    Multi-node data sharding: construct with the global batch_size and this
    node's (process_index, process_count); the dataset keeps the strided
    shard images[process_index::process_count] and yields local batches of
    batch_size // process_count samples from RandomState(seed +
    process_index), as the JAX dataset does; parallel/sharding.py's
    shard_batch splits that node-local batch over the node's ranks. After
    construction the fields are the local view (process 0 of 1), so a view
    (with_target_bpp) does not slice again."""

    images: np.ndarray  # (N, H, W, 3) in [-1, 1]
    masks: np.ndarray   # (N, H, W, 1) in [0, 1]
    batch_size: int = 16
    bpp_range: Sequence[float] = (0.1, 1.0, 2.0)
    target_bpp: Optional[float] = None
    seed: int = 42
    drop_remainder: bool = True
    device_resident: bool = False
    device: str = "cuda"
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        if len(self.images) != len(self.masks):
            raise ValueError("images and masks differ in length")
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"process_index {self.process_index} out of range for "
                             f"process_count {self.process_count}")
        if self.batch_size % self.process_count:
            raise ValueError(f"global batch_size {self.batch_size} not divisible by "
                             f"process_count {self.process_count}")
        if self.process_count > 1:
            self.images = self.images[self.process_index::self.process_count]
            self.masks = self.masks[self.process_index::self.process_count]
            self.batch_size //= self.process_count
            self.seed += self.process_index  # disjoint shuffle / bpp streams
            self.process_index, self.process_count = 0, 1
        self._device = resolve_device(self.device)
        self._rng = np.random.RandomState(self.seed)
        if self.device_resident:
            self._dev_images = _to_nchw(self.images, self._device)
            self._dev_masks = _to_nchw(self.masks, self._device)

    def __len__(self) -> int:
        return len(self.images)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, len(self.images) // self.batch_size)

    def _bpp(self, n: int) -> np.ndarray:
        if self.target_bpp is None:
            return self._rng.choice(self.bpp_range, size=(n, 1)).astype(np.float32)
        return np.full((n, 1), self.target_bpp, np.float32)

    def epoch(self, shuffle: bool = True) -> Iterator[Batch]:
        n = len(self.images)
        idx = np.arange(n)
        if shuffle:
            self._rng.shuffle(idx)
        limit = (n // self.batch_size) * self.batch_size if self.drop_remainder else n
        limit = max(limit, min(n, self.batch_size))
        for start in range(0, limit, self.batch_size):
            with annotate("data.batch"):
                sel = idx[start:start + self.batch_size]
                bpp = torch.from_numpy(self._bpp(len(sel))).to(self._device)
                if self.device_resident:
                    sel_dev = torch.from_numpy(sel).to(self._device)
                    batch = Batch(image=self._dev_images.index_select(0, sel_dev),
                                  mask=self._dev_masks.index_select(0, sel_dev), bpp=bpp)
                else:
                    batch = Batch(image=_to_nchw(self.images[sel], self._device),
                                  mask=_to_nchw(self.masks[sel], self._device), bpp=bpp)
            yield batch

    def with_target_bpp(self, target_bpp: Optional[float]) -> "CompressionDataset":
        """A view with a fixed target bpp (the fine-tune phase), sharing the
        device-resident corpus instead of uploading it again."""
        ds = dataclasses.replace(self, target_bpp=target_bpp, device_resident=False)
        ds.device_resident = self.device_resident
        if self.device_resident:
            ds._dev_images = self._dev_images
            ds._dev_masks = self._dev_masks
        return ds

    def first_samples(self, k: int = 4) -> Batch:
        """A deterministic sample batch (the first k images, bpps from a
        fresh RandomState(seed))."""
        k = min(k, len(self.images))
        rng = np.random.RandomState(self.seed)
        bpp = rng.choice(self.bpp_range, size=(k, 1)).astype(np.float32)
        if self.target_bpp is not None:
            bpp[:] = self.target_bpp
        return Batch(image=_to_nchw(self.images[:k], self._device),
                     mask=_to_nchw(self.masks[:k], self._device),
                     bpp=torch.from_numpy(bpp).to(self._device))
