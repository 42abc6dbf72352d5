"""Synthetic training corpora, in pure numpy.

The port's own copy of `synthetic_images` and `rich_synthetic_images` from
`contextual_image_compression_tpu/data/images.py`: the same code on the same
seeds, so both packages train on bitwise-equal images. Image file IO comes
with the slice that ports the data loaders.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_images(
    n: int, size: Tuple[int, int] = (256, 256), seed: int = 0
) -> np.ndarray:
    """Synthetic [-1,1] images with salient blobs on textured backgrounds -- used by
    tests, smoke training, and benchmarks (no dataset ships with the reference)."""
    rng = np.random.RandomState(seed)
    h, w = size
    imgs = np.empty((n, h, w, 3), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        base = rng.uniform(-0.8, -0.2, size=3).astype(np.float32)
        img = np.tile(base, (h, w, 1))
        img += 0.05 * rng.randn(h, w, 3).astype(np.float32)
        # low-frequency texture
        fx, fy = rng.uniform(1, 4, size=2)
        img += 0.1 * np.sin(2 * np.pi * (fx * xx / w + fy * yy / h))[..., None]
        # 1-3 bright salient blobs
        for _ in range(rng.randint(1, 4)):
            cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4, 3 * w // 4)
            ry, rx = rng.randint(h // 10, h // 4), rng.randint(w // 10, w // 4)
            blob = np.exp(-(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2))
            color = rng.uniform(0.3, 1.0, size=3).astype(np.float32)
            img += blob[..., None] * color
        imgs[i] = np.clip(img, -1.0, 1.0)
    return imgs


def rich_synthetic_images(
    n: int, size: Tuple[int, int] = (256, 256), seed: int = 0
) -> np.ndarray:
    """A more diverse synthetic corpus than `synthetic_images` for training runs that
    need quality numbers to mean something: per-image mixes of smooth gradients,
    multi-frequency textures, sharp-edged polygons/rectangles/disks, and salient
    high-contrast objects, with low sensor-style noise. [-1,1] RGB float32."""
    rng = np.random.RandomState(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        # background: oriented smooth gradient between two colors
        c0 = rng.uniform(-0.9, 0.5, size=3).astype(np.float32)
        c1 = rng.uniform(-0.9, 0.5, size=3).astype(np.float32)
        ang = rng.uniform(0, 2 * np.pi)
        t = ((np.cos(ang) * xx / w + np.sin(ang) * yy / h) + 1.0) / 2.0
        img = c0 + (c1 - c0) * t[..., None]
        # 1-3 texture components at mixed frequencies
        for _ in range(rng.randint(1, 4)):
            fx, fy = rng.uniform(0.5, 12, size=2)
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.03, 0.15)
            tex = np.sin(2 * np.pi * (fx * xx / w + fy * yy / h) + ph)
            img += amp * tex[..., None] * rng.uniform(0.3, 1.0, size=3)
        # 2-5 sharp geometric objects (rect / disk / triangle half-plane cuts)
        for _ in range(rng.randint(2, 6)):
            kind = rng.randint(3)
            color = rng.uniform(-1.0, 1.0, size=3).astype(np.float32)
            alpha = rng.uniform(0.6, 1.0)
            if kind == 0:  # rectangle
                y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
                y1 = min(h, y0 + rng.randint(h // 16, h // 3))
                x1 = min(w, x0 + rng.randint(w // 16, w // 3))
                m = np.zeros((h, w), np.float32)
                m[y0:y1, x0:x1] = 1.0
            elif kind == 1:  # disk
                cy, cx = rng.randint(0, h), rng.randint(0, w)
                r = rng.randint(min(h, w) // 16, min(h, w) // 4)
                m = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.float32)
            else:  # half-plane strip (hard diagonal edge)
                a2 = rng.uniform(0, 2 * np.pi)
                d = np.cos(a2) * (xx - w / 2) + np.sin(a2) * (yy - h / 2)
                width = rng.uniform(4, min(h, w) / 6)
                off = rng.uniform(-min(h, w) / 3, min(h, w) / 3)
                m = (np.abs(d - off) < width).astype(np.float32)
            img = img * (1 - alpha * m[..., None]) + color * (alpha * m[..., None])
        # one dominant bright salient object (what the saliency engine keys on)
        cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4, 3 * w // 4)
        ry, rx = rng.randint(h // 12, h // 5), rng.randint(w // 12, w // 5)
        blob = np.exp(-(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2))
        img += blob[..., None] * rng.uniform(0.4, 1.0, size=3)
        # light sensor noise
        img += 0.02 * rng.randn(h, w, 3)
        imgs[i] = np.clip(img, -1.0, 1.0)
    return imgs
