"""Autoencoder evaluation.

Counterpart of `contextual_image_compression_tpu/eval/ae_eval.py`: one
batched reconstruct over the test images (`AETrainer.reconstruct`), uint8
metrics on the trainer's device (MSE, PSNR at 255, SSIM of the luma:
ops/metrics.py::ae_metrics), then a JPEG of each reconstruction for the
size-reduction metric: the JPEG of the reconstruction against the original
file's size, as the reference computes it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from contextual_image_compression_tpu_torch.data import images as image_io
from contextual_image_compression_tpu_torch.ops import metrics as metric_ops
from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer


def evaluate_autoencoder(
    trainer: AETrainer,
    images01: np.ndarray,
    file_paths: Sequence[str],
    output_dir: str = "compressed_outputs",
) -> Dict[str, float]:
    """Average MSE / PSNR / SSIM / size reduction (%) and their per-image
    values. images01: (N, H, W, 3) in [0, 1]; file_paths: the originals,
    whose base names the reconstructions take in output_dir."""
    os.makedirs(output_dir, exist_ok=True)
    recon = trainer.reconstruct(images01)

    orig_u8 = np.clip(np.round(images01 * 255.0), 0, 255).astype(np.uint8)
    comp_u8 = np.clip(np.round(recon * 255.0), 0, 255).astype(np.uint8)
    with torch.no_grad():
        m = metric_ops.ae_metrics(torch.from_numpy(orig_u8).to(trainer.device),
                                  torch.from_numpy(comp_u8).to(trainer.device))
    m = {k: v.cpu().numpy() for k, v in m.items()}

    size_reductions: List[float] = []
    for i, path in enumerate(file_paths):
        out_path = os.path.join(output_dir, os.path.basename(path))
        image_io.save_image_unit(recon[i], out_path)
        original_size = os.path.getsize(path)
        compressed_size = os.path.getsize(out_path)
        if original_size > 0:
            size_reductions.append((1 - compressed_size / original_size) * 100.0)

    return {
        "mse": float(np.mean(m["mse"])),
        "psnr": float(np.mean(m["psnr"])),
        "ssim": float(np.mean(m["ssim"])),
        "size_reduction": float(np.mean(size_reductions)) if size_reductions else float("nan"),
        "per_image": {
            "mse": [float(x) for x in m["mse"]],
            "psnr": [float(x) for x in m["psnr"]],
            "ssim": [float(x) for x in m["ssim"]],
            "size_reduction": size_reductions,
        },
    }
