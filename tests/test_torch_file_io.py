"""The port's image file IO (data/images.py) and native image loader
(native/image_loader.cpp) against the JAX package's, on a temporary folder
of PNGs and JPEGs of several sizes (and one file that does not decode),
made from numpy seeds.

Both packages decode with the same libraries here (cv2, or PIL where the
port is made to take it), and the native loader is the same C++ code, so
the loaded arrays must be bitwise equal and the written files byte-identical.
"""

import os

import numpy as np
import pytest
from PIL import Image as PILImage

from contextual_image_compression_tpu.data import images as jimages
from contextual_image_compression_tpu_torch import native
from contextual_image_compression_tpu_torch.data import images as timages

SIZES = [(40, 30), (64, 64), (100, 70), (17, 23)]  # (w, h) of the files


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for i, (w, h) in enumerate(SIZES):
        u8 = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        u8[: h // 2] //= 3  # some structure beside the noise
        PILImage.fromarray(u8).save(d / f"img_{i}.png")
        PILImage.fromarray(u8).save(d / f"pic_{i}.jpg", quality=90)
    (d / "broken.jpg").write_bytes(b"not an image")
    (d / "notes.txt").write_text("not listed")
    return str(d)


def test_list_images_matches_jax(folder):
    assert timages.list_images(folder) == jimages.list_images(folder)
    assert len(timages.list_images(folder)) == 2 * len(SIZES) + 1


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "cv2"])
@pytest.mark.parametrize("size", [(32, 32), (48, 40)], ids=["32x32", "48x40"])
def test_load_folder_gan_matches_jax(folder, use_native, size):
    """Images, names and byte sizes equal to JAX's, the file that does not
    decode left out by both, and the route recorded."""
    got, names, sizes = timages.load_folder_gan(folder, size, use_native=use_native)
    assert timages.load_folder_gan.last_route == ("native" if use_native else "cv2")
    want, jnames, jsizes = jimages.load_folder_gan(folder, size, use_native=use_native)
    assert names == jnames and sizes == jsizes and "broken.jpg" not in names
    assert got.dtype == np.float32 and got.shape == (2 * len(SIZES), size[1], size[0], 3)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -1.0 and got.max() <= 1.0


def test_load_folder_gan_max_images_and_empty(folder, tmp_path):
    got, names, _ = timages.load_folder_gan(folder, (32, 32), max_images=4)
    # the first 4 sorted paths hold broken.jpg, which is left out
    assert names == jimages.load_folder_gan(folder, (32, 32), max_images=4)[1]
    assert len(names) == 3 and got.shape[0] == 3
    empty, names, sizes = timages.load_folder_gan(str(tmp_path), (40, 24))
    assert empty.shape == (0, 24, 40, 3) and names == [] and sizes == []


def test_native_unit_normalization_matches_jax(folder):
    """The loader's [0, 1] mode against the JAX package's copy of it."""
    from contextual_image_compression_tpu import native as jnative

    paths = timages.list_images(folder)
    got, ok = native.load_images(paths, (24, 36), "unit", num_threads=3)
    want, jok = jnative.load_images(paths, (24, 36), "unit", num_threads=3)
    np.testing.assert_array_equal(ok, jok)
    assert ok.sum() == 2 * len(SIZES)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        native.load_images(paths, (24, 36), "other")


def test_load_folder_unit_matches_jax(folder):
    got, paths = timages.load_folder_unit(folder, (32, 24))
    want, jpaths = jimages.load_folder_unit(folder, (32, 24))
    assert paths == jpaths
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_load_and_preprocess_image_matches_jax(folder):
    path = os.path.join(folder, "pic_2.jpg")
    np.testing.assert_array_equal(timages.load_and_preprocess_image(path, (50, 20)),
                                  jimages.load_and_preprocess_image(path, (50, 20)))
    with pytest.raises(ValueError):
        timages.load_and_preprocess_image(os.path.join(folder, "broken.jpg"))


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_saved_files_are_byte_identical_to_jax(tmp_path, ext):
    """save_image ([-1, 1]) and save_image_unit ([0, 1], JPEG quality 95)
    write the bytes the JAX package writes for equal arrays."""
    rng = np.random.RandomState(5)
    img = rng.rand(20, 28, 3).astype(np.float32) * 2 - 1
    for fn, arr in (("save_image", img), ("save_image_unit", (img + 1) / 2)):
        a, b = tmp_path / f"port_{fn}{ext}", tmp_path / f"jax_{fn}{ext}"
        getattr(timages, fn)(arr, str(a))
        getattr(jimages, fn)(arr, str(b))
        assert a.read_bytes() == b.read_bytes(), fn


def test_pil_route_matches_jax(folder, tmp_path, monkeypatch):
    """Where cv2 does not import, both packages decode, resize and write
    with PIL."""
    monkeypatch.setattr(timages, "cv2", None)
    monkeypatch.setattr(jimages, "_HAVE_CV2", False)
    monkeypatch.setattr(jimages, "Image", PILImage, raising=False)
    assert timages.image_library() == "pil"
    got, names, _ = timages.load_folder_gan(folder, (32, 32), use_native=False)
    assert timages.load_folder_gan.last_route == "pil"
    want, jnames, _ = jimages.load_folder_gan(folder, (32, 32), use_native=False)
    assert names == jnames
    np.testing.assert_array_equal(got, want)
    img = np.random.RandomState(6).rand(12, 10, 3).astype(np.float32)
    timages.save_image_unit(img, str(tmp_path / "a.jpg"))
    jimages.save_image_unit(img, str(tmp_path / "b.jpg"))
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()


def test_missing_library_or_format_raises(folder, tmp_path, monkeypatch):
    """No other format is written in place of one the library cannot write,
    and without cv2 and PIL the IO raises, naming them."""
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="cv2"):
        timages.save_image(img, str(tmp_path / "x.unknownext"))
    assert not os.listdir(tmp_path)
    monkeypatch.setattr(timages, "cv2", None)
    with pytest.raises(RuntimeError, match="PIL"):
        timages.save_image(img, str(tmp_path / "x.unknownext"))
    monkeypatch.setattr(timages, "Image", None)
    with pytest.raises(RuntimeError, match="cv2.*PIL"):
        timages.load_folder_gan(folder, (32, 32), use_native=False)
    with pytest.raises(RuntimeError, match="cv2.*PIL"):
        timages.save_image_unit(img, str(tmp_path / "y.jpg"))
    assert not os.listdir(tmp_path)


def test_native_route_reports_a_failed_build(folder, monkeypatch, capsys):
    """Where the loader does not build, load_folder_gan(use_native=True)
    says so and decodes file by file, as the JAX package does."""
    def refuse(*args, **kwargs):
        raise RuntimeError("image loader build failed: jpeglib.h missing")

    monkeypatch.setattr(native, "load_images", refuse)
    got, names, _ = timages.load_folder_gan(folder, (32, 32), use_native=True)
    assert timages.load_folder_gan.last_route == "cv2"
    assert "native loader unavailable" in capsys.readouterr().out
    want, jnames, _ = jimages.load_folder_gan(folder, (32, 32), use_native=False)
    assert names == jnames
    np.testing.assert_array_equal(got, want)
