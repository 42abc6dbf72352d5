"""The data-parallel training cell (harness/train_dp.py) on the CPU: four
gloo ranks at the tiny width, one process each, started by rank 0 as on the
cards; one result line, from rank 0, correct against the reference's step
on the global batch, and not correct with a planted fault; the cell's
readers."""

import copy
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, TINY_MODEL
from portbench.harness import common, runner, train_dp

SEED = 2 ** 33 + 41


def tiny_cell(per_rank: int = 2) -> dict:
    cell = copy.deepcopy(common.load_cell("train_dp4"))
    cell["config_spec"]["model"].update(TINY_MODEL)
    cell["config_spec"]["saliency"]["spectral_resolution"] = 16
    cell["traffic_spec"].update(corpus=16, use_perceptual=False, per_rank=per_rank,
                                setup_steps=3, trace_steps=2, init_timeout_s=120)
    return cell


def _run(cell, extra: str = "") -> subprocess.CompletedProcess:
    code = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT)!r}]
from portbench.harness import runner
cell = json.loads({json.dumps(json.dumps(cell))})
res = runner.execute(cell, {SEED}, 0.5, True, 'cpu', time.perf_counter(){extra})
res.pop('_details')
print(json.dumps(res))
"""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(ROOT))


def test_four_gloo_ranks_give_one_correct_line():
    out = _run(tiny_cell())
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out.stdout
    res = json.loads(lines[0])
    assert res["correct"], (res["check"], out.stderr[-3000:])
    assert res["device"]["count"] == 4 and res["attempted"] >= 1
    assert "mfu.train_dp" in res["metrics"]


@pytest.mark.parametrize("fault", sorted(train_dp.FAULTS))
def test_dp_fault_is_incorrect(fault):
    out = _run(tiny_cell(), f", fault={fault!r}")
    assert out.returncode == 0, out.stderr[-4000:]
    (line,) = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    res = json.loads(line)
    assert not res["correct"], res["check"]


def test_dp_readers():
    ranges = {"train.step": (4, 1.0), "step.allreduce": (6, 0.04), "train.g_backward": (4, 0.6),
              "train.g_update": (4, 0.056), "train.d_phase": (2, 0.05),
              "hq_attention": (4, 0.002)}
    summary = {"ranges": {k: {"count": c, "device_s": d} for k, (c, d) in ranges.items()},
               "window_s": 1.0, "busy_s": 0.8, "device_ops": [], "idle_gaps": [],
               "work": {"step_flops_d": 4e13, "step_flops_no_d": 2e13, "peak_flops": 4 * 495e12,
                        "attention_flops": 99e9, "attention_bytes": 1e6,
                        "card_peak_flops": 495e12, "peak_bytes_per_s": 3.35e12},
               "untraced": {"steps": 10, "steps_with_d": 5, "seconds": 2.0, "images": 640}}
    got = runner.per_layer(tiny_cell(), summary)
    assert {k: v["value"] for k, v in got.items()} == pytest.approx({
        "mfu.train_dp": 100 * (5 * 4e13 + 5 * 2e13) / 2.0 / (4 * 495e12),
        "allreduce_device_ms.train_dp": 10.0,
        "g_backward_device_ms.train_dp": 150.0,
        "update_device_ms.train_dp": 14.0,
        "d_phase_device_ms.train_dp": 25.0,
        "attn_roofline_pct.train_dp": 40.0,
        "idle_pct.train_dp": 20.0})


def test_a_failed_rank_ends_the_run():
    """A rank that cannot start (an unknown device) ends rank 0 with the
    watchdog's exit code instead of a hang."""
    out = _run(tiny_cell(), ", devices=['cpu', 'cpu', 'nodevice', 'cpu']")
    assert out.returncode == 5, out.stderr[-3000:]
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
