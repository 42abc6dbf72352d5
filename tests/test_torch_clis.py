"""The port's user CLIs against the JAX package's scripts, each pair run on
the CPU in subprocesses with the same argv: scripts/torch_train_gan.py,
torch_train_autoencoder.py, torch_compress.py, torch_eval_bitstream.py and
torch_codec_shootout.py against train_gan.py, train_autoencoder.py,
compress.py, eval_bitstream.py and codec_shootout.py. The port's scripts
run as `main(argv, device="cpu")` (tests/test_torch_eval.py::_run_cli), the
JAX scripts as programs with JAX on the CPU.

Where a script builds `ModelConfig()` at full width, both subprocesses first
replace the config class's defaults by tests/test_loop_and_eval.py's tiny
widths (and eval_bitstream's fixed 256^2 corpus by 32^2), the same patch in
both packages; the checkpoints are the committed JAX-trained tiny GAN
(tests/fixtures/jax_tiny_gan) and autoencoder (runs/ae_ref/model). The two
training CLIs start from the same initial weights, saved where each script
reads them.

Bars: training histories as tests/test_torch_train.py (1e-5 relative or
1e-8 absolute), the autoencoder's losses within 1e-5; DCT streams and
decoded images bitwise; evaluation rows within tests/test_torch_eval.py's
BARS (PSNR 1e-4 dB, SSIM 1e-5, bpp 1e-6, measured and container bpp
exact), the shootout's AE row within 1e-4 dB / 1e-5 (its input resize is
the linear operator as matrices here and jax.image.resize there).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_tiny_gan"
AE_DIR = REPO / "runs" / "ae_ref" / "model"
JPEGS = REPO / "runs" / "ae_ref" / "compressed_outputs"
TINY_KW = dict(base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
               generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32)


def _tiny_prelude(pkg, size_32=False):
    """Code that gives pkg's ModelConfig the tiny widths as defaults (the
    script's own keywords still win) and, with size_32, makes the synthetic
    corpora 32^2 whatever size is asked."""
    code = (f"import functools\nfrom {pkg} import config as _c\n"
            f"_c.ModelConfig = functools.partial(_c.ModelConfig, img_size=(32, 32), **{TINY_KW!r})\n")
    if size_32:
        code += (f"from {pkg}.data import images as _i\n"
                 "for _n in ('synthetic_images', 'rich_synthetic_images'):\n"
                 "    setattr(_i, _n, functools.partial(lambda f, n, size=None, seed=0: "
                 "f(n, (32, 32), seed), getattr(_i, _n)))\n")
    return code


def _run(code, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, timeout=900,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert res.returncode == 0, res.stdout[-4000:]
    return res.stdout


def _run_port(script, argv, tmp_path, prelude=""):
    code = (f"import runpy, sys\nsys.path.insert(0, {str(REPO)!r})\n{prelude}"
            f"sys.exit(runpy.run_path({str(REPO / 'scripts' / script)!r})['main']"
            f"({argv!r}, device='cpu'))\n")
    return _run(code, tmp_path)


def _run_jax(script, argv, tmp_path, prelude=""):
    path = str(REPO / "scripts" / script)
    code = (f"import runpy, sys\nsys.path.insert(0, {str(REPO)!r})\n{prelude}"
            f"sys.argv = [{path!r}] + {argv!r}\nrunpy.run_path({path!r}, run_name='__main__')\n")
    return _run(code, tmp_path)


def _files(root):
    out = []
    for dirpath, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, n), root) for n in names]
    return sorted(out)


def _close(got, want, rel=1e-5, abs_=1e-8):
    return abs(got - want) <= rel * abs(want) or abs(got - want) <= abs_


def _initial_gan_state(model_dir):
    """A seeded initial train state at the CLI's tiny configuration, saved in
    JAX's files as 'final' with an empty history: what both training CLIs
    resume (the port's init; JAX reads the port's files,
    tests/test_torch_checkpoint.py)."""
    from contextual_image_compression_tpu_torch.config import ModelConfig, TrainConfig
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    mcfg = ModelConfig(img_size=(32, 32), **TINY_KW)
    trainer = GANTrainer(TrainConfig(model=mcfg, model_dir=str(model_dir), use_perceptual=False),
                         log_fn=lambda s: None, device="cpu")
    trainer.init_state(resume=False)
    trainer.save("final", blocking=True)


def test_train_gan_cli_matches_jax(tmp_path):
    """One epoch of 1 step and 3 fine-tune epochs at bpp 1.0 from the same
    initial weights: the same files and printed epochs, histories within
    the train bars."""
    argv = ["--synthetic", "4", "--epochs", "1", "--batch-size", "4", "--img-size", "32",
            "--no-perceptual", "--fine-tune-bpps", "1.0"]
    out = {}
    for pkg, run, script in (("contextual_image_compression_tpu", _run_jax, "train_gan.py"),
                             ("contextual_image_compression_tpu_torch", _run_port,
                              "torch_train_gan.py")):
        root = tmp_path / pkg
        _initial_gan_state(root / "ckpt")
        out[pkg] = (run(script, argv + ["--results-dir", str(root / "results"), "--model-dir",
                                        str(root / "ckpt")], tmp_path, _tiny_prelude(pkg)),
                    root)
    (jout, jroot), (tout, troot) = out.values()
    assert _files(troot) == _files(jroot)
    assert "results/final_loss_history.png" in _files(troot)
    for text in ("Fine-tuning for target bitrate: 1.0 bpp...", "Training completed!",
                 "Computing saliency masks on device..."):
        assert text in tout and text in jout
    jh = json.loads((jroot / "ckpt" / "metadata_final.json").read_text())
    th = json.loads((troot / "ckpt" / "metadata_final.json").read_text())
    assert th["epoch"] == jh["epoch"] == 4
    for k, want in jh["history"].items():
        assert len(th["history"][k]) == 4
        assert all(_close(g, w) for g, w in zip(th["history"][k], want)), (k, th, jh)


def test_train_autoencoder_cli_matches_jax(tmp_path):
    """Two epochs on 8 synthetic images from JAX's PRNGKey(42) init (the
    port's script reads it in place of its own seeded init): the saved
    models' losses within 1e-5."""
    import torch

    from contextual_image_compression_tpu.config import AutoencoderConfig as JAECfg
    from contextual_image_compression_tpu.train.ae_trainer import AETrainer as JAE
    from contextual_image_compression_tpu_torch.config import AutoencoderConfig
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer

    init_dir = tmp_path / "init"
    jae = JAE(JAECfg(img_size=(32, 32)), log_fn=lambda s: None)
    jae.init()
    jae.save(str(init_dir), tag="init")
    prelude = ("from contextual_image_compression_tpu_torch.train import ae_trainer as _t\n"
               f"_t.AETrainer.init = lambda self, seed=42: self.load({str(init_dir)!r}, 'init')\n")
    argv = ["--synthetic", "8", "--epochs", "2", "--batch-size", "4", "--img-size", "32"]
    jout = _run_jax("train_autoencoder.py", argv + ["--model-dir", str(tmp_path / "j")], tmp_path)
    tout = _run_port("torch_train_autoencoder.py", argv + ["--model-dir", str(tmp_path / "t")],
                     tmp_path, prelude)
    assert "Model saved to:" in jout and "Model saved to:" in tout
    assert _files(tmp_path / "t") == _files(tmp_path / "j") == ["autoencoder_final.msgpack"]
    images = (synthetic_images(8, (32, 32), 42) + 1) / 2
    losses = []
    for d in ("j", "t"):
        trainer = AETrainer(AutoencoderConfig(img_size=(32, 32)), device="cpu")
        trainer.load(str(tmp_path / d))
        with torch.no_grad():
            losses.append(float(trainer._loss(trainer._nchw(images))))
    assert abs(losses[0] - losses[1]) <= 1e-5, losses


def test_compress_cli_streams_are_jax_bytes(tmp_path):
    """Four JPEGs at quality 75: the .cic files byte-identical, and each
    package's decode of them the same PNG pixels."""
    import cv2

    files = [str(JPEGS / f"t{i}.jpg") for i in range(4)]
    _run_jax("compress.py", ["encode", *files, "--out-dir", str(tmp_path / "jc")], tmp_path)
    out = _run_port("torch_compress.py", ["encode", *files, "--out-dir", str(tmp_path / "tc")],
                    tmp_path)
    assert "reduction)" in out
    names = sorted(os.listdir(tmp_path / "jc"))
    assert names == sorted(os.listdir(tmp_path / "tc")) and len(names) == 4
    for n in names:
        assert (tmp_path / "tc" / n).read_bytes() == (tmp_path / "jc" / n).read_bytes(), n
    cics = [str(tmp_path / "jc" / n) for n in names]
    _run_jax("compress.py", ["decode", *cics, "--out-dir", str(tmp_path / "jd")], tmp_path)
    _run_port("torch_compress.py", ["decode", *cics, "--out-dir", str(tmp_path / "td")], tmp_path)
    for n in names:
        png = n.replace(".cic", ".png")
        want = cv2.imread(str(tmp_path / "jd" / png))
        assert want is not None and want.shape[2] == 3
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "td" / png)), want)


def _rows_close(got, want, bars):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, bool) or k in ("target_bpp", "quality"):
                assert g[k] == v, k
            else:
                assert abs(g[k] - v) <= bars[k], (k, g[k], v)


EVAL_BARS = {"bitstream_decode_psnr": 1e-4, "bitstream_decode_ssim": 1e-5,
             "forward_path_psnr": 1e-4, "container_bpp": 0.0}


def test_eval_bitstream_cli_matches_jax(tmp_path):
    argv = ["--model-dir", str(FIXTURE), "--synthetic", "2", "--bpps", "0.1", "2.0"]
    outs = {}
    for pkg, run, script in (("contextual_image_compression_tpu", _run_jax, "eval_bitstream.py"),
                             ("contextual_image_compression_tpu_torch", _run_port,
                              "torch_eval_bitstream.py")):
        path = tmp_path / f"{pkg}.json"
        run(script, argv + ["--out", str(path)], tmp_path, _tiny_prelude(pkg, size_32=True))
        outs[pkg] = json.loads(path.read_text())
    want, got = outs.values()
    assert {k: v for k, v in got.items() if k != "rows"} == {
        k: v for k, v in want.items() if k != "rows"}
    assert all(np.isfinite(v) for r in got["rows"] for v in r.values())
    _rows_close(got["rows"], want["rows"], EVAL_BARS)


SHOOTOUT_BARS = {"psnr": 1e-4, "ssim": 1e-5, "bpp_entropy": 1e-6, "bpp_measured": 0.0,
                 "bpp_analytic": 1e-6, "hq_ratio": 1e-5, "bpp_container": 0.0}


def test_codec_shootout_cli_matches_jax(tmp_path):
    """DCT, GAN (the fixture), storable GAN (the fixture, zero skips) and
    AE (runs/ae_ref) series on two 32^2 images; the JSON rows within the
    evaluation bars, and the plot written after the JSON."""
    argv = ["--synthetic", "2", "--img-size", "32", "--model-dir", str(FIXTURE),
            "--skipfree-dir", str(FIXTURE), "--ae-dir", str(AE_DIR)]
    outs = {}
    for pkg, run, script in (("contextual_image_compression_tpu", _run_jax, "codec_shootout.py"),
                             ("contextual_image_compression_tpu_torch", _run_port,
                              "torch_codec_shootout.py")):
        out = run(script, argv + ["--out", f"{pkg}.json", "--plot", f"{pkg}.png"], tmp_path,
                  _tiny_prelude(pkg))
        assert "GAN weights: trained" in out
        assert (tmp_path / f"{pkg}.png").exists()
        outs[pkg] = json.loads((tmp_path / f"{pkg}.json").read_text())
    want, got = outs.values()
    assert got["provenance"] == want["provenance"]
    for series in ("dct", "gan", "gan_storable", "ae"):
        assert got[series], series
        _rows_close(got[series], want[series], SHOOTOUT_BARS)


def _torchrun_port(script, argv, tmp_path, nproc, prelude=""):
    """scripts/<script>'s main(argv, device="cpu") on nproc ranks under
    `python -m torch.distributed.run --standalone` (a free local port)."""
    wrapper = tmp_path / f"run_{script}"
    wrapper.write_text(f"import runpy, sys\nsys.path.insert(0, {str(REPO)!r})\n{prelude}"
                       f"sys.exit(runpy.run_path({str(REPO / 'scripts' / script)!r})['main']"
                       f"(sys.argv[1:], device='cpu'))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          f"--nproc-per-node={nproc}", str(wrapper), *argv], cwd=tmp_path,
                         env=env, timeout=600, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    assert res.returncode == 0, res.stdout[-4000:]
    return res.stdout


def test_train_gan_cli_on_a_mesh_under_torchrun(tmp_path):
    """torch_train_gan.py --model-parallel 2 on two gloo ranks under
    torchrun: the files of the one-process run (figures and checkpoints
    written once, by rank 0) and its history within the train bars."""
    prelude = _tiny_prelude("contextual_image_compression_tpu_torch")
    argv = ["--synthetic", "4", "--epochs", "1", "--batch-size", "4", "--img-size", "32",
            "--no-perceptual", "--no-fine-tune"]

    def dirs(name):
        return ["--results-dir", str(tmp_path / name / "results"), "--model-dir",
                str(tmp_path / name / "ckpt")]

    one = _run_port("torch_train_gan.py", argv + dirs("one"), tmp_path, prelude)
    two = _torchrun_port("torch_train_gan.py", argv + dirs("mesh") + [
        "--backend", "gloo", "--model-parallel", "2"], tmp_path, 2, prelude)
    assert "Mesh {'data': 1, 'model': 2}" in two and two.count("Training completed!") == 2
    assert "Training completed!" in one
    assert _files(tmp_path / "mesh") == _files(tmp_path / "one")
    jh = json.loads((tmp_path / "one" / "ckpt" / "metadata_final.json").read_text())
    th = json.loads((tmp_path / "mesh" / "ckpt" / "metadata_final.json").read_text())
    assert th["epoch"] == jh["epoch"] == 1
    for k, want in jh["history"].items():
        assert all(_close(g, w) for g, w in zip(th["history"][k], want, strict=True)), k


def test_train_gan_cli_model_parallel_needs_torchrun(tmp_path):
    """--model-parallel 2 without a process group exits non-zero naming
    torchrun; it never trains on one device as if nothing were asked."""
    code = (f"import runpy, sys\nsys.path.insert(0, {str(REPO)!r})\n"
            f"sys.exit(runpy.run_path({str(REPO / 'scripts' / 'torch_train_gan.py')!r})['main']"
            f"(['--model-parallel', '2', '--synthetic', '4', '--model-dir', 'ckpt'], "
            f"device='cpu'))\n")
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, timeout=300,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert res.returncode != 0 and "torchrun" in res.stdout, res.stdout[-2000:]
    assert "Computing saliency masks" not in res.stdout and not (tmp_path / "ckpt").exists()
