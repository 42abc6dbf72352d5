"""Image file IO and the synthetic corpora, in numpy.

Counterpart of `contextual_image_compression_tpu/data/images.py`:

  * file IO: decode with cv2 (BGR -> RGB, INTER_LINEAR resize) where cv2
    imports, else with PIL (bilinear resize), as the JAX package picks;
    [-1, 1] images for the GAN codec, [0, 1] for the autoencoder; writes
    through the same library (cv2's JPEG quality 95 for `save_image_unit`).
    Where neither library imports, or the library cannot write a format,
    the call raises RuntimeError naming what is missing: no other format is
    written in its place;
  * `load_folder_gan(use_native=True)` decodes through the native loader
    (native/image_loader.cpp: libjpeg / libpng, bilinear resize, normalize,
    a thread pool) where it builds, else file by file as above, in the JAX
    package's order; `load_folder_gan.last_route` says which route the last
    call took ('native', 'cv2' or 'pil');
  * `synthetic_images` and `rich_synthetic_images`: the same code on the
    same seeds, so both packages see bitwise-equal images.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None
try:
    from PIL import Image
except ImportError:
    Image = None

IMAGE_EXTENSIONS = ("*.jpg", "*.png", "*.jpeg")


def image_library() -> str:
    """The library file IO goes through: 'cv2', else 'pil'; raises if neither imports."""
    if cv2 is not None:
        return "cv2"
    if Image is not None:
        return "pil"
    raise RuntimeError("image file IO needs cv2 (opencv-python) or PIL (Pillow); neither imports")


def create_directories(directories: Sequence[str]) -> None:
    for d in directories:
        os.makedirs(d, exist_ok=True)


def list_images(folder: str, extensions: Sequence[str] = IMAGE_EXTENSIONS) -> List[str]:
    paths: List[str] = []
    for ext in extensions:
        paths.extend(glob.glob(os.path.join(folder, ext)))
    return sorted(paths)


def _read_rgb(path: str) -> Optional[np.ndarray]:
    """The file's RGB uint8 pixels, or None where it does not decode."""
    if image_library() == "cv2":
        img = cv2.imread(path)
        if img is None:
            return None
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        return np.asarray(Image.open(path).convert("RGB"))
    except Exception:
        return None


def _resize(img: np.ndarray, target_size: Tuple[int, int]) -> np.ndarray:
    """Resize to target_size = (W, H), as cv2.resize takes it."""
    if image_library() == "cv2":
        return cv2.resize(img, target_size)
    return np.asarray(Image.fromarray(img).resize(target_size, Image.BILINEAR))


def load_and_preprocess_image(
    path: str, target_size: Tuple[int, int] = (256, 256)
) -> np.ndarray:
    """Load -> RGB -> resize -> [-1, 1] float32."""
    img = _read_rgb(path)
    if img is None:
        raise ValueError(f"Could not load image: {path}")
    img = _resize(img, target_size)
    return (img.astype(np.float32) - 127.5) / 127.5


def _write(u8: np.ndarray, path: str, params: Sequence[int] = (), pil_kwargs=None) -> None:
    if image_library() == "cv2":
        bgr = cv2.cvtColor(u8, cv2.COLOR_RGB2BGR) if u8.ndim == 3 and u8.shape[2] == 3 else u8
        try:
            ok = cv2.imwrite(path, bgr, list(params))
        except cv2.error as e:
            raise RuntimeError(f"cv2 cannot write {path}: {e}") from e
        if not ok:
            raise RuntimeError(f"cv2 cannot write {path} (no encoder for its extension)")
        return
    try:
        Image.fromarray(u8).save(path, **(pil_kwargs or {}))
    except (KeyError, ValueError, OSError) as e:
        raise RuntimeError(f"PIL cannot write {path}: {e}") from e


def save_image(img: np.ndarray, path: str) -> None:
    """Save a [-1, 1]-normalized RGB image."""
    u8 = np.clip(np.round((img + 1.0) * 127.5), 0, 255).astype(np.uint8)
    _write(u8, path)


def save_image_unit(img01: np.ndarray, path: str, jpeg_quality: int = 95) -> None:
    """Save a [0, 1]-normalized RGB image; a JPEG at `jpeg_quality` (cv2's
    default 95)."""
    u8 = np.clip(np.round(img01 * 255.0), 0, 255).astype(np.uint8)
    jpeg = path.lower().endswith((".jpg", ".jpeg"))
    params = [int(cv2.IMWRITE_JPEG_QUALITY), jpeg_quality] if jpeg and cv2 is not None else []
    _write(u8, path, params, dict(quality=jpeg_quality))


def load_folder_gan(
    folder: str,
    target_size: Tuple[int, int] = (256, 256),
    max_images: Optional[int] = None,
    use_native: bool = True,
) -> Tuple[np.ndarray, List[str], List[int]]:
    """A folder for the GAN codec: [-1, 1] images, file names and byte sizes.

    use_native takes the native loader where it builds (a file it cannot
    decode is reported and left out), else the file-by-file path of
    `load_and_preprocess_image`; `load_folder_gan.last_route` records which."""
    paths = list_images(folder)
    if max_images:
        paths = paths[:max_images]
    if not paths:
        return np.zeros((0, target_size[1], target_size[0], 3), np.float32), [], []

    if use_native:
        from contextual_image_compression_tpu_torch import native

        try:
            batch, ok = native.load_images(paths, target_size, "gan")
        except (RuntimeError, OSError) as e:
            print(f"native loader unavailable ({e}); decoding file by file")
        else:
            load_folder_gan.last_route = "native"
            for p, o in zip(paths, ok):
                if not o:
                    print(f"Error loading {p}: native decode failed")
            names = [os.path.basename(p) for p, o in zip(paths, ok) if o]
            sizes = [os.path.getsize(p) for p, o in zip(paths, ok) if o]
            return batch[ok], names, sizes

    load_folder_gan.last_route = image_library()
    images, names, sizes = [], [], []
    for p in paths:
        try:
            images.append(load_and_preprocess_image(p, target_size))
            names.append(os.path.basename(p))
            sizes.append(os.path.getsize(p))
        except ValueError as e:  # a file that does not decode is reported and skipped
            print(f"Error loading {p}: {e}")
    if not images:
        return np.zeros((0, target_size[1], target_size[0], 3), np.float32), [], []
    return np.stack(images), names, sizes


load_folder_gan.last_route = None


def load_folder_unit(
    folder: str, target_size: Tuple[int, int] = (128, 128)
) -> Tuple[np.ndarray, List[str]]:
    """A folder for the autoencoder: [0, 1] images and their paths."""
    paths = list_images(folder)
    images, kept = [], []
    for p in paths:
        img = _read_rgb(p)
        if img is None:
            continue
        images.append(_resize(img, target_size).astype(np.float32) / 255.0)
        kept.append(p)
    if not images:
        return np.zeros((0, target_size[1], target_size[0], 3), np.float32), []
    return np.stack(images), kept


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
