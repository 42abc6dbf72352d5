"""The harness on the CPU: work counts against torch's FLOP counter, no JAX
in a run, cells added by files alone, BENCHMARK.json against the files, the
trace's reduction, and the refusals of run.py."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, tiny_cell
from portbench.harness import common, inputs, runner, trace, train
from portbench.reference import codec as ref_codec
from portbench.reference import train as ref_train

SEED = 2 ** 33 + 5


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_serving_work_matches_flop_counter():
    cell = tiny_cell("serve_b16")
    spec, m = cell["config_spec"], cell["config_spec"]["model"]
    params, tails = ref_codec.serving_params(
        inputs.make_weights(ref_codec.codec_shapes(m), SEED, "codec", "cpu"), m)
    b = 3
    images = inputs.structured_images(SEED, b, 64, "cpu")
    mask = torch.rand(b, 64, 64)
    counted = _count(lambda: ref_codec.serve(params, tails, m, images, mask, 1.0, 3.0))
    work = common.work_module(cell["config"])
    assert counted == pytest.approx(b * work.flops_per_image(m), rel=1e-9)
    flops, _ = work.attention(m, b)
    attn = _count(lambda: ref_codec.attention(
        params, "hq_encoder.attention", torch.randn(b, m["encoder_channels"][2], 8, 8)))
    assert attn == pytest.approx(flops, rel=1e-9)


@pytest.mark.parametrize("name,do_d", [("train_b16", True), ("train_b16", False),
                                       ("train_b16_noperc", True)])
def test_training_work_matches_flop_counter(name, do_d):
    cell = tiny_cell(name)
    spec, traffic = cell["config_spec"], cell["traffic_spec"]
    m, b = spec["model"], spec["train"]["batch_size"]
    codec, disc, vgg = train.seed_weights(spec, traffic, SEED, "cpu")
    tr = ref_train.Trainer(codec, disc, vgg, m, spec["train"])
    img, mask, bpp, _ = train.reference_batches(spec, traffic, SEED, "cpu", steps=1)[0]
    counted = _count(lambda: tr.step(img, mask, bpp, do_d, traffic["use_perceptual"]))
    work = common.work_module(cell["config"])
    assert counted == pytest.approx(work.step_flops(m, b, do_d, traffic["use_perceptual"]),
                                    rel=1e-9)


def test_cell_setup_loads_no_jax():
    """The harness's set-up of a cell, at a tiny size, in a fresh process:
    no module whose top-level name is jax, jaxlib, flax or the JAX package,
    and the reference alone loads nothing of the port."""
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'portbench' / 'tests')!r}]
import portbench.reference.codec, portbench.reference.masks, portbench.reference.train
assert not [m for m in sys.modules if m.split('.')[0] == {common.PROGRAM!r}]
from conftest import tiny_cell
from portbench.harness import common, runner
runner.execute(tiny_cell('serve_b16'), 3, 0.1, False, 'cpu', time.perf_counter())
print('LOADED', common.forbidden_loaded())
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_forbidden_names_compare_whole():
    assert common.PROGRAM.split(".")[0] not in common.FORBIDDEN
    sys.modules["contextual_image_compression_tpu_probe_x"] = sys
    try:
        assert "contextual_image_compression_tpu" not in common.forbidden_loaded()
    finally:
        del sys.modules["contextual_image_compression_tpu_probe_x"]


def _digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_files_alone(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digest(bench)
    cfg = json.loads((bench / "configs" / "gan256_bf16w8.json").read_text())
    cfg["model"]["hq_attention"] = False
    (bench / "configs" / "gan256_noattn.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "work" / "gan256_bf16w8.py", bench / "work" / "gan256_noattn.py")
    traffic = json.loads((bench / "traffic" / "serve_closed_b16.json").read_text())
    traffic["batch"] = 4
    (bench / "traffic" / "serve_closed_b4.json").write_text(json.dumps(traffic))
    (bench / "workloads" / "noattn_b4.json").write_text(json.dumps({
        "config": "gan256_noattn", "traffic": "serve_closed_b4", "chips": 1,
        "why": "a cell added by files", "limits": {"mask_gap": 1.0}}))
    (bench / "metrics" / "calls_traced.serve.py").write_text(
        'META = {"name": "calls_traced.serve", "unit": "calls", "better": "higher",\n'
        '        "source": "program_span", "layer": "benchmark", "moves": "serve_img_per_s",\n'
        '        "workloads": ["noattn_b4"], "driver": "serve"}\n\n\n'
        'def read(summary):\n'
        '    r = summary["ranges"].get("serve.call")\n'
        '    return float(r["count"]) if r else None\n')
    after = _digest(bench)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    assert "noattn_b4" in common.list_names("workloads", ".json", bench)
    cell = common.load_cell("noattn_b4", bench)
    assert cell["traffic_spec"]["batch"] == 4 and not cell["config_spec"]["model"]["hq_attention"]
    assert common.work_module("gan256_noattn", bench).flops_per_image(
        cell["config_spec"]["model"]) > 0
    summary = {"ranges": {"serve.call": {"count": 3, "device_s": 0.1}}, "busy_s": 0.05,
               "window_s": 0.1, "work": {"flops_per_image": 1.0, "peak_flops": 1.0,
                                         "attention_flops": 1.0, "attention_bytes": 1.0,
                                         "peak_bytes_per_s": 1.0},
               "untraced": {"images": 10, "calls": 5, "seconds": 1.0}}
    got = runner.per_layer(cell, summary, bench)
    assert got["calls_traced.serve"]["value"] == 3.0
    assert "codec_device_ms.serve" not in got
    assert got["idle_pct.serve"]["value"] == pytest.approx(50.0)


def test_benchmark_json_matches_the_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    for w in bench["workloads"]:
        cell = common.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
    for c in bench["configs"]:
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["source"] == c["source"] and spec["reduced"] == c["reduced"]
    mods = common.metric_modules()
    assert sorted(mods) == sorted(m["name"] for m in bench["per_layer"])
    for m in bench["per_layer"]:
        meta = mods[m["name"]].META
        for key in ("unit", "better", "source", "layer", "moves", "workloads"):
            assert meta[key] == m[key], (m["name"], key)


def _event(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def test_trace_summary():
    events = [
        _event(trace.WINDOW, "user_annotation", 0, 100),
        _event("codec.apply", "user_annotation", 10, 30),
        _event("Optimizer.step", "user_annotation", 60, 10),
        _event("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=1),
        _event("cudaLaunchKernel", "cuda_runtime", 50, 1, correlation=2),
        _event("k1", "kernel", 20, 10, correlation=1),
        _event("k2", "kernel", 55, 20, correlation=2),
    ]
    s = trace.summarize(events, {"codec.apply"})
    assert s["ranges"]["codec.apply"] == {"count": 1, "device_s": pytest.approx(10e-6)}
    assert s["busy_s"] == pytest.approx(30e-6) and s["window_s"] == pytest.approx(100e-6)
    assert s["device_ops"][0] == ["k2", pytest.approx(20e-6)]
    gaps = dict(s["idle_gaps"])  # 0-20 (mid 10: codec.apply), 30-55, 75-100
    assert gaps["codec.apply"] == pytest.approx(20e-6)
    assert gaps["outside every range"] == pytest.approx(50e-6)


def _run_py(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "serve_b16",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_run_refuses_without_a_card():
    out = _run_py(ROOT)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run_py(tmp_path)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


def test_setup_marks_before_the_window():
    cell = tiny_cell("serve_b16")
    t0 = time.perf_counter()
    res = runner.execute(cell, SEED, 0.3, False, "cpu", t0)
    assert 0 < res["metrics"]["setup_s"]["value"] < time.perf_counter() - t0
    assert list(res)[-2:] == ["check", "_details"]
