"""Evaluation and training artifacts: the six plots of the JAX package's
`eval/plots.py` and the rate-distortion CSV.

  * per-epoch 4-panel and final 8-panel loss plots;
  * original / saliency / compressed / bit-allocation sample figures;
  * bit-allocation-by-bpp strips;
  * rate-distortion curves (PNG) and `rate_distortion_data.csv`;
  * rate-control accuracy and HQ-ratio scatter plots.

Everything runs on the host on numpy arrays. matplotlib is imported inside
each plot function (Agg backend), so the module imports, and the CSV is
written, where matplotlib is missing; a plot function raises there,
naming matplotlib.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np


def pyplot():
    """matplotlib.pyplot on the Agg backend; RuntimeError naming matplotlib
    where it does not import (callers whose work ends in a figure ask first)."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("this plot needs matplotlib, which does not import here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_epoch_losses(history: Dict[str, List[float]], path: str) -> None:
    """4-panel loss plot of a training run's history."""
    plt = pyplot()
    fig = plt.figure(figsize=(15, 12))

    plt.subplot(2, 2, 1)
    plt.plot(history["d_loss"], label="Discriminator Loss")
    plt.plot(history["g_loss"], label="Generator Loss")
    plt.legend(); plt.title("GAN Losses"); plt.xlabel("Epoch"); plt.ylabel("Loss")

    plt.subplot(2, 2, 2)
    plt.plot(history["reconstruction_loss"], label="Reconstruction Loss")
    plt.plot(history["gan_loss"], label="GAN Component Loss")
    if any(np.isfinite(history.get("perceptual_loss", [np.nan]))):
        plt.plot(history["perceptual_loss"], label="Perceptual Loss")
    plt.plot(history["l1_loss"], label="L1 Loss")
    plt.legend(); plt.title("Generator Loss Components"); plt.xlabel("Epoch"); plt.ylabel("Loss")

    plt.subplot(2, 2, 3)
    plt.plot(history["latent_saliency_loss"], label="Latent Saliency Loss")
    plt.plot(history["rd_loss"], label="Rate-Distortion Loss")
    plt.legend(); plt.title("Adaptive Compression Losses"); plt.xlabel("Epoch"); plt.ylabel("Loss")

    plt.subplot(2, 2, 4)
    plt.plot(history["g_loss"], label="Total Generator Loss")
    plt.title("Total Generator Loss"); plt.xlabel("Epoch"); plt.ylabel("Loss")

    plt.tight_layout()
    fig.savefig(path)
    plt.close(fig)


_FINAL_METRICS = (
    ("d_loss", "Discriminator Loss"),
    ("g_loss", "Generator Loss"),
    ("reconstruction_loss", "Reconstruction Loss"),
    ("gan_loss", "GAN Component Loss"),
    ("l1_loss", "L1 Loss"),
    ("perceptual_loss", "Perceptual Loss"),
    ("latent_saliency_loss", "Latent Saliency Loss"),
    ("rd_loss", "Rate-Distortion Loss"),
)


def plot_final_losses(history: Dict[str, List[float]], path: str) -> None:
    """Final 8-panel loss plot."""
    plt = pyplot()
    fig = plt.figure(figsize=(20, 15))
    for i, (key, title) in enumerate(_FINAL_METRICS):
        plt.subplot(4, 2, i + 1)
        if key in history and len(history[key]) > 0:
            plt.plot(history[key], "b-")
            plt.title(title); plt.xlabel("Epoch"); plt.ylabel("Loss")
            plt.grid(True, alpha=0.3)
    plt.tight_layout()
    fig.savefig(path, dpi=300)
    plt.close(fig)


def visualize_results(
    original: np.ndarray,
    saliency_map: np.ndarray,
    compressed: np.ndarray,
    save_path: Optional[str] = None,
    bit_allocation: Optional[np.ndarray] = None,
) -> None:
    """3-4 panel sample figure. Images in [-1, 1]; saliency and bit
    allocation in [0, 1]."""
    plt = pyplot()
    orig = np.clip((original + 1) / 2, 0, 1)
    comp = np.clip((compressed + 1) / 2, 0, 1)
    num = 4 if bit_allocation is not None else 3
    fig, axes = plt.subplots(1, num, figsize=(5 * num, 5))
    axes[0].imshow(orig); axes[0].set_title("Original"); axes[0].axis("off")
    axes[1].imshow(np.squeeze(saliency_map), cmap="hot")
    axes[1].set_title("Saliency Map"); axes[1].axis("off")
    axes[2].imshow(comp); axes[2].set_title("Compressed"); axes[2].axis("off")
    if bit_allocation is not None:
        axes[3].imshow(np.squeeze(bit_allocation), cmap="viridis")
        axes[3].set_title("Bit Allocation (HQ/LQ)"); axes[3].axis("off")
    plt.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)


def visualize_bit_allocation_by_bpp(
    image: np.ndarray,
    allocations: Dict[float, np.ndarray],
    save_path: Optional[str] = None,
) -> None:
    """The original and one bit-allocation panel per bpp (the codec runs in
    the caller, batched)."""
    plt = pyplot()
    bpps = sorted(allocations)
    fig, axes = plt.subplots(1, len(bpps) + 1, figsize=(5 * (len(bpps) + 1), 5))
    axes[0].imshow(np.clip((image + 1) / 2, 0, 1))
    axes[0].set_title("Original Image"); axes[0].axis("off")
    for i, bpp in enumerate(bpps):
        axes[i + 1].imshow(np.squeeze(allocations[bpp]), cmap="viridis")
        axes[i + 1].set_title(f"Bit Allocation at {bpp} BPP"); axes[i + 1].axis("off")
    plt.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)


def write_rate_distortion_csv(avg_metrics: Dict[float, Dict[str, float]],
                              results_dir: str) -> str:
    """`rate_distortion_data.csv` of a bpp sweep's averaged metrics, one row
    per target bpp in ascending order; returns its path."""
    path = os.path.join(results_dir, "rate_distortion_data.csv")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(
            ["Target BPP", "Actual BPP", "Measured BPP", "PSNR", "SSIM", "HQ Ratio (%)"]
        )
        for b in sorted(avg_metrics):
            m = avg_metrics[b]
            writer.writerow([b, m["actual_bpp"], m.get("measured_bpp", float("nan")),
                             m["psnr"], m["ssim"], m["hq_ratio"] * 100])
    return path


def plot_rate_distortion_curve(
    avg_metrics: Dict[float, Dict[str, float]], results_dir: str
) -> None:
    """`rate_distortion_data.csv`, then the 4-panel RD curves
    `rate_distortion_curves.png`."""
    write_rate_distortion_csv(avg_metrics, results_dir)
    plt = pyplot()
    bitrates = sorted(avg_metrics.keys())
    psnrs = [avg_metrics[b]["psnr"] for b in bitrates]
    ssims = [avg_metrics[b]["ssim"] for b in bitrates]
    actual = [avg_metrics[b]["actual_bpp"] for b in bitrates]
    hq = [avg_metrics[b]["hq_ratio"] * 100 for b in bitrates]

    fig = plt.figure(figsize=(15, 10))
    plt.subplot(2, 2, 1)
    plt.plot(actual, psnrs, "bo-", linewidth=2, markersize=8)
    plt.xlabel("Bits per Pixel (BPP)"); plt.ylabel("PSNR (dB)")
    plt.title("Rate-Distortion Curve (PSNR)"); plt.grid(True, alpha=0.3)

    plt.subplot(2, 2, 2)
    plt.plot(actual, ssims, "ro-", linewidth=2, markersize=8)
    plt.xlabel("Bits per Pixel (BPP)"); plt.ylabel("SSIM")
    plt.title("Rate-Distortion Curve (SSIM)"); plt.grid(True, alpha=0.3)

    plt.subplot(2, 2, 3)
    plt.plot(bitrates, actual, "go-", linewidth=2, markersize=8)
    plt.plot(bitrates, bitrates, "k--", alpha=0.5)
    plt.xlabel("Target BPP"); plt.ylabel("Actual BPP")
    plt.title("Bitrate Control Accuracy"); plt.grid(True, alpha=0.3)

    plt.subplot(2, 2, 4)
    plt.plot(actual, hq, "mo-", linewidth=2, markersize=8)
    plt.xlabel("Bits per Pixel (BPP)"); plt.ylabel("HQ Region Ratio (%)")
    plt.title("HQ/LQ Region Allocation"); plt.grid(True, alpha=0.3)

    plt.tight_layout()
    fig.savefig(os.path.join(results_dir, "rate_distortion_curves.png"), dpi=300)
    plt.close(fig)


_COLORS = ["b", "r", "g", "c", "m", "y", "k"]


def plot_rate_control_scatter(results: Dict[str, list], out_dir: str) -> None:
    """rate_control_accuracy.png and hq_ratio_by_bpp.png. results keys:
    target_bpp, actual_bpp, hq_ratio, image (a file name per point)."""
    plt = pyplot()
    unique_images = sorted(set(results["image"]))

    for metric, fname, ylabel, title, identity in (
        ("actual_bpp", "rate_control_accuracy.png", "Actual BPP", "Rate Control Accuracy", True),
        ("hq_ratio", "hq_ratio_by_bpp.png", "HQ Region Ratio", "Bit Allocation vs. Target BPP", False),
    ):
        fig = plt.figure(figsize=(12, 6))
        for i, img_name in enumerate(unique_images):
            idx = [j for j, x in enumerate(results["image"]) if x == img_name]
            plt.scatter(
                [results["target_bpp"][j] for j in idx],
                [results[metric][j] for j in idx],
                color=_COLORS[i % len(_COLORS)],
                alpha=0.7,
                label=img_name,
            )
        if identity:
            plt.plot([0, 2], [0, 2], "k--")
        plt.xlabel("Target BPP"); plt.ylabel(ylabel); plt.title(title)
        plt.grid(True, alpha=0.3); plt.legend()
        fig.savefig(os.path.join(out_dir, fname))
        plt.close(fig)
