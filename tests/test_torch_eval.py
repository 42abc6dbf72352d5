"""The port's evaluation path against the JAX package's: `EvalConfig` and
`analytic_bpp`, `CodecEvaluator` (eval/harness.py) loading the committed
JAX-trained tiny GAN (tests/fixtures/jax_tiny_gan) from its directory, the
bpp sweep with its metrics.txt, compressed images and figures, the
rate-distortion CSV and the rate-control sweep, `evaluate_autoencoder` on
the trained autoencoder of runs/ae_ref, and the two CLIs
(scripts/torch_test_gan.py, scripts/torch_test_autoencoder.py) as
subprocesses on the CPU. Images come from numpy seeds; both evaluators get
the JAX package's masks, so the codec alone is compared (the port's masks
are held to JAX's at 1e-4 here and in tests/test_torch_masks.py).

Bars: the float32 codec agrees with JAX's to ~1e-5 of its outputs
(tests/test_torch_checkpoint.py); measured here, the per-image metrics
differ by at most 2.9e-6 dB PSNR, 1.1e-6 SSIM, 3.7e-8 MSE, 1.1e-5 in the
compression ratio, 3.6e-7 in the analytic bpp and 7.2e-7 in the HQ ratio,
so the bars (BARS) sit 10-35x above that; the fixture's latents round to 0
at every bpp (four steps of training), so the measured bpp is equal.
metrics.txt and the CSV must match line for line: the same labels and
numbers within those bars.
"""

import csv
import dataclasses
import glob
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from contextual_image_compression_tpu.config import EvalConfig as JEvalConfig
from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.config import SaliencyConfig as JSaliencyConfig
from contextual_image_compression_tpu.config import analytic_bpp as janalytic_bpp
from contextual_image_compression_tpu.data import images as jimages
from contextual_image_compression_tpu.data.pipeline import prepare_masks as jprepare_masks
from contextual_image_compression_tpu.eval.harness import CodecEvaluator as JEvaluator
from contextual_image_compression_tpu_torch.config import (
    EvalConfig,
    ModelConfig,
    SaliencyConfig,
    analytic_bpp,
)
from contextual_image_compression_tpu_torch.data.pipeline import prepare_masks
from contextual_image_compression_tpu_torch.eval import plots
from contextual_image_compression_tpu_torch.eval.harness import CodecEvaluator
from contextual_image_compression_tpu_torch.models.adaptive import (
    ALL_CODEC_COMPONENTS,
    AdaptiveCodec,
)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_tiny_gan"
TINY_KW = dict(
    img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
    generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32,
)
SWEEP = dict(bpp_values=(0.1, 1.0, 2.0), rate_control_bpps=3, rate_control_max_images=2,
             batch_size=4)
# |port - JAX| per metric (see the module docstring)
BARS = {"psnr": 1e-4, "ssim": 1e-5, "mse": 1e-6, "compression_ratio": 1e-4,
        "actual_bpp": 1e-6, "measured_bpp": 0.0, "hq_ratio": 1e-5}
N_IMAGES = 6  # two device batches of 4, the second padded


def test_eval_config_and_analytic_bpp_match_jax():
    port, jax_cfg = dataclasses.asdict(EvalConfig()), dataclasses.asdict(JEvalConfig())
    for key in ("bpp_values", "rate_control_bpps", "rate_control_bpp_range",
                "rate_control_max_images", "results_dir", "model_dir", "test_dir", "batch_size"):
        assert port[key] == jax_cfg[key], key
    assert set(port) == set(jax_cfg)
    ratio = np.random.RandomState(1).rand(7).astype(np.float32)
    for kw in ({}, dict(base_latent_dim=16, img_size=(32, 32))):
        np.testing.assert_array_equal(analytic_bpp(ratio, **kw), janalytic_bpp(ratio, **kw))
    assert analytic_bpp(0.0) == 0.25 and analytic_bpp(1.0) == 0.5


def test_codec_refuses_other_param_dtypes():
    """ModelConfig.param_dtype 'bfloat16' builds the codec's parameters in
    bf16 as the JAX codec does (it raised here before the port had bf16
    parameters; the name is kept): every leaf of the port's variables in
    JAX's layout has the dtype of JAX's leaf at that path (parameters bf16,
    BatchNorm statistics float32), for bf16 and for mixed precision."""
    from contextual_image_compression_tpu.models.adaptive import AdaptiveCodec as JCodec
    from contextual_image_compression_tpu_torch.convert import codec_variables, placeholder

    for dt in (dict(dtype="bfloat16", param_dtype="bfloat16"),
               dict(dtype="bfloat16", param_dtype="float32")):
        want = jax.eval_shape(lambda: JCodec(JModelConfig(**TINY_KW, **dt)).init(
            jax.random.PRNGKey(0)))
        got = codec_variables(AdaptiveCodec(ModelConfig(**TINY_KW, **dt)), leaf=placeholder)
        flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_got = dict(jax.tree_util.tree_flatten_with_path(
            got, is_leaf=lambda x: not isinstance(x, dict))[0])
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_want:
            assert str(flat_got[path].dtype).replace("torch.", "") == str(leaf.dtype), path


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Both evaluators on the fixture's files: masks, the bpp sweep with
    artifacts and the rate-control sweep with artifacts, the RD plot."""
    root = tmp_path_factory.mktemp("eval")
    imgs = jimages.synthetic_images(N_IMAGES, (32, 32), seed=2)
    names = [f"img_{i}.png" for i in range(N_IMAGES)]
    jmasks = np.asarray(jprepare_masks(imgs, JSaliencyConfig()))
    out = {"images": imgs, "masks": jmasks,
           "port_masks": prepare_masks(imgs, SaliencyConfig(), device="cpu")}
    for side in ("port", "jax"):
        res_dir = str(root / side)
        if side == "port":
            ev = CodecEvaluator(EvalConfig(model=ModelConfig(**TINY_KW), model_dir=str(FIXTURE),
                                           results_dir=res_dir, **SWEEP), device="cpu")
        else:
            ev = JEvaluator(JEvalConfig(model=JModelConfig(**TINY_KW), model_dir=str(FIXTURE),
                                        results_dir=res_dir, **SWEEP))
        weights, provenance = ev.load_models()
        os.makedirs(res_dir, exist_ok=True)
        results = ev.test_compression(weights, imgs, jmasks, names)
        rc = ev.test_rate_control(weights, imgs, jmasks, names)
        (plots if side == "port" else _jax_plots()).plot_rate_distortion_curve(
            results["avg_metrics"], res_dir)
        out[side] = dict(dir=res_dir, provenance=provenance, results=results, rc=rc, ev=ev,
                         weights=weights)
    return out


def _jax_plots():
    from contextual_image_compression_tpu.eval import plots as jplots

    return jplots


def test_evaluator_loads_the_fixture_as_jax_does(sweeps):
    assert sweeps["port"]["provenance"] == sweeps["jax"]["provenance"] == {
        c: "final" for c in ALL_CODEC_COMPONENTS}
    np.testing.assert_allclose(sweeps["port_masks"], sweeps["masks"], atol=1e-4)


def test_bpp_sweep_metrics_match_jax(sweeps):
    port, jx = sweeps["port"]["results"], sweeps["jax"]["results"]
    assert list(port["avg_metrics"]) == list(jx["avg_metrics"]) == list(SWEEP["bpp_values"])
    for bpp in SWEEP["bpp_values"]:
        for key, bar in BARS.items():
            got, want = np.array(port["by_bpp"][bpp][key]), np.array(jx["by_bpp"][bpp][key])
            assert got.shape == want.shape == (N_IMAGES,), key
            assert np.abs(got - want).max() <= bar, (bpp, key, got, want)
            assert abs(port["avg_metrics"][bpp][key] - jx["avg_metrics"][bpp][key]) <= bar
    # the rate-control contract: the HQ share grows with the target bpp
    assert port["avg_metrics"][2.0]["hq_ratio"] > port["avg_metrics"][0.1]["hq_ratio"]


def _files(d):
    return sorted(os.path.relpath(p, d) for p in glob.glob(os.path.join(d, "**", "*"),
                                                            recursive=True) if os.path.isfile(p))


def test_artifacts_have_the_jax_layout(sweeps):
    got, want = _files(sweeps["port"]["dir"]), _files(sweeps["jax"]["dir"])
    assert got == want
    assert "rate_distortion_data.csv" in got and "bpp_0.1/metrics.txt" in got
    assert len([f for f in got if f.startswith("bpp_2.0/compressed/")]) == N_IMAGES


_NUM = re.compile(r"-?\d+\.?\d*(?:e-?\d+)?")


def _numbers_close(a_line, b_line):
    """Lines with the same text around their numbers, each pair of numbers
    within one unit of the last printed digit plus the bars."""
    if _NUM.sub("#", a_line) != _NUM.sub("#", b_line):
        return False
    for x, y in zip(_NUM.findall(a_line), _NUM.findall(b_line)):
        digits = len(x.split(".")[1]) if "." in x else 0
        if abs(float(x) - float(y)) > 10.0 ** -digits + 1e-3:
            return False
    return True


@pytest.mark.parametrize("bpp", SWEEP["bpp_values"])
def test_metrics_txt_matches_jax(sweeps, bpp):
    rel = os.path.join(f"bpp_{bpp}", "metrics.txt")
    got = Path(sweeps["port"]["dir"], rel).read_text().splitlines()
    want = Path(sweeps["jax"]["dir"], rel).read_text().splitlines()
    assert len(got) == len(want) > 10
    bad = [(a, b) for a, b in zip(got, want) if not _numbers_close(a, b)]
    assert not bad


def test_rate_distortion_csv_matches_jax(sweeps):
    def rows(side):
        with open(os.path.join(sweeps[side]["dir"], "rate_distortion_data.csv")) as f:
            return list(csv.reader(f))

    got, want = rows("port"), rows("jax")
    assert got[0] == want[0] == ["Target BPP", "Actual BPP", "Measured BPP", "PSNR", "SSIM",
                                 "HQ Ratio (%)"]
    assert len(got) == len(want) == 1 + len(SWEEP["bpp_values"])
    bars = [0.0, BARS["actual_bpp"], BARS["measured_bpp"], BARS["psnr"], BARS["ssim"],
            100 * BARS["hq_ratio"]]
    for g, w in zip(got[1:], want[1:]):
        assert all(abs(float(a) - float(b)) <= bar for a, b, bar in zip(g, w, bars)), (g, w)


def test_rate_control_sweep_matches_jax(sweeps):
    port, jx = sweeps["port"]["rc"], sweeps["jax"]["rc"]
    assert port["target_bpp"] == jx["target_bpp"] and port["image"] == jx["image"]
    assert len(port["target_bpp"]) == SWEEP["rate_control_bpps"] * SWEEP["rate_control_max_images"]
    for key in ("actual_bpp", "hq_ratio"):
        assert np.abs(np.array(port[key]) - np.array(jx[key])).max() <= BARS[key]


def test_run_batch_pads_the_last_batch(sweeps):
    """The padded last batch gives each image what a batch of its own gives."""
    ev, codec = sweeps["port"]["ev"], sweeps["port"]["weights"]
    imgs, masks = sweeps["images"], sweeps["masks"]
    outs = ev.run_batch(codec, imgs, masks, 1.0)
    assert [o.blended.shape[0] for o in outs] == [4, 2]
    alone = ev.run_batch(codec, imgs[4:], masks[4:], 1.0, batch_size=2)[0]
    for key in ("blended", "hq_latent", "dynamic_threshold"):
        np.testing.assert_allclose(getattr(outs[1], key).numpy(), getattr(alone, key).numpy(),
                                   atol=1e-6, rtol=0, err_msg=key)


def test_artifacts_without_matplotlib(sweeps, tmp_path, monkeypatch):
    """Where matplotlib does not import, metrics.txt, the compressed images
    and the CSV are written and the first figure raises, naming matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ev, codec = sweeps["port"]["ev"], sweeps["port"]["weights"]
    ev = CodecEvaluator(dataclasses.replace(ev.cfg, bpp_values=(1.0,)), device="cpu")
    ev.codec = codec
    names = [f"img_{i}.png" for i in range(N_IMAGES)]
    with pytest.raises(RuntimeError, match="matplotlib"):
        ev.test_compression(codec, sweeps["images"], sweeps["masks"], names,
                            results_dir=str(tmp_path))
    assert (tmp_path / "bpp_1.0" / "metrics.txt").exists()
    assert len(list((tmp_path / "bpp_1.0" / "compressed").iterdir())) == N_IMAGES
    avg = sweeps["port"]["results"]["avg_metrics"]
    with pytest.raises(RuntimeError, match="matplotlib"):
        plots.plot_rate_distortion_curve(avg, str(tmp_path))
    assert (tmp_path / "rate_distortion_data.csv").read_text() == Path(
        sweeps["port"]["dir"], "rate_distortion_data.csv").read_text()


def test_run_matches_jax_on_a_folder(tmp_path):
    """CodecEvaluator.run: the fixture's files, a folder of PNGs read by
    load_folder_gan, each package's own masks, the sweeps and the RD plot.
    The masks differ by ~2e-5, which moves the HQ ratio by up to 7.2e-6,
    the analytic bpp by 3.6e-6 and the compression ratio by 1.2e-4
    (measured), so those bars are wider than BARS; the files are JAX's."""
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i, img in enumerate(jimages.synthetic_images(4, (32, 32), seed=4)):
        jimages.save_image(img, str(folder / f"t{i}.png"))
    kw = dict(bpp_values=(0.5,), rate_control_bpps=2, rate_control_max_images=2, batch_size=4,
              model_dir=str(FIXTURE), test_dir=str(folder))
    got = CodecEvaluator(EvalConfig(model=ModelConfig(**TINY_KW), results_dir=str(tmp_path / "p"),
                                    **kw), device="cpu").run()
    want = JEvaluator(JEvalConfig(model=JModelConfig(**TINY_KW), results_dir=str(tmp_path / "j"),
                                  **kw)).run()
    bars = dict(BARS, compression_ratio=1e-3, actual_bpp=1e-5, hq_ratio=2e-5)
    for key, bar in bars.items():
        assert abs(got["avg_metrics"][0.5][key] - want["avg_metrics"][0.5][key]) <= bar, key
    files = _files(str(tmp_path / "p"))
    assert files == _files(str(tmp_path / "j"))
    assert "rate_distortion_curves.png" in files and "bpp_0.5/compressed/t3.png" in files


def test_evaluate_autoencoder_matches_jax(tmp_path):
    """runs/ae_ref's autoencoder in both packages on 4 seeded 128^2 images
    written as JPEGs: MSE / PSNR / SSIM within 1e-3 (relative, for MSE) and
    the size reductions within 0.5 percentage points (a reconstruction
    differs from JAX's by ~1e-6, which can move a uint8 value and a JPEG's
    bytes), the same output files."""
    from contextual_image_compression_tpu.eval.ae_eval import evaluate_autoencoder as jeval
    from contextual_image_compression_tpu.train.ae_trainer import AETrainer as JAETrainer
    from contextual_image_compression_tpu_torch.eval.ae_eval import evaluate_autoencoder
    from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer

    model_dir = str(REPO / "runs" / "ae_ref" / "model")
    imgs = ((jimages.synthetic_images(4, (128, 128), seed=8) + 1) / 2).astype(np.float32)
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"orig_{i}.jpg"))
        jimages.save_image_unit(img, paths[-1])
    port = AETrainer(device="cpu", log_fn=lambda *_: None)
    port.load(model_dir)
    jtrainer = JAETrainer(log_fn=lambda *_: None)
    jtrainer.load(model_dir)
    got = evaluate_autoencoder(port, imgs, paths, str(tmp_path / "port"))
    want = jeval(jtrainer, imgs, paths, str(tmp_path / "jax"))
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3 and abs(got["ssim"] - want["ssim"]) <= 1e-3
    assert abs(got["mse"] - want["mse"]) <= 1e-3 * want["mse"]
    assert abs(got["size_reduction"] - want["size_reduction"]) <= 0.5
    assert np.isfinite(got["psnr"]) and got["psnr"] > 20
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert len(got["per_image"]["psnr"]) == 4


def _run_cli(args, tmp_path):
    """Run a CLI's main(argv, device="cpu") in a subprocess of its own."""
    script, argv = args[0], args[1:]
    code = (f"import runpy, sys; sys.exit(runpy.run_path({script!r})['main']"
            f"({argv!r}, device='cpu'))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, timeout=600,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert res.returncode == 0, res.stdout[-3000:]
    return res.stdout


def test_torch_test_gan_cli_writes_the_jax_layout(tmp_path):
    """scripts/torch_test_gan.py --synthetic 2 on the CPU (a small codec by
    the CLI's own --img-size and --base-latent-dim, seeded weights: no
    checkpoint) writes the files scripts/test_gan.py writes."""
    res = tmp_path / "results"
    out = _run_cli(["scripts/torch_test_gan.py", "--synthetic", "2", "--img-size", "32",
                    "--base-latent-dim", "16", "--results-dir", str(res),
                    "--model-dir", str(tmp_path / "no_ckpt")], tmp_path)
    assert "bpp 2.0: PSNR" in out
    want = ["rate_control_test/hq_ratio_by_bpp.png", "rate_control_test/rate_control_accuracy.png",
            "rate_distortion_curves.png", "rate_distortion_data.csv"]
    for bpp in (0.1, 1.0, 2.0):
        want.append(f"bpp_{bpp}/metrics.txt")
        for i in range(2):
            want += [f"bpp_{bpp}/compressed/synthetic_{i}.png",
                     f"bpp_{bpp}/visualizations/synthetic_{i}_vis.png"]
    want += [f"rate_control_test/synthetic_{i}_bit_allocation.png" for i in range(2)]
    assert _files(str(res)) == sorted(want)


def test_torch_test_autoencoder_cli(tmp_path):
    out = _run_cli(["scripts/torch_test_autoencoder.py", "--synthetic", "2", "--model-dir",
                    str(REPO / "runs" / "ae_ref" / "model"), "--output-dir",
                    str(tmp_path / "out")], tmp_path)
    assert "Average Peak Signal-to-Noise Ratio (PSNR)" in out
    assert sorted(os.listdir(tmp_path / "out")) == ["synthetic_0.jpg", "synthetic_1.jpg"]
