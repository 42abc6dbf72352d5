"""The HiFiC serving cell (harness/serve_hific.py) on the CPU at a tiny
width, in float32 (whose reference rounds nowhere): a run is correct and
reports its metrics, a traced run its per-layer metrics; the float8
control and the planted faults are incorrect; the work counts against
torch's FLOP counter; the weights and the shape table are the program's."""

import copy
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import check, common, runner, serve_hific
from portbench.reference import hific as ref_hific

SEED = 2 ** 33 + 29
TINY_MODEL = {"encoder_filters": [8, 16, 16, 32, 32], "latent_channels": 8,
              "hyper_channels": 8, "residual_blocks": 2, "dtype": "float32"}
TINY_TRAFFIC = {"batch": 2, "pool": 4, "height": 128, "width": 192, "warmup_calls": 1,
                "check_calls": 2, "trace_calls": 2}
CELL = "hific_2048x1536_b4"


def tiny_cell() -> dict:
    cell = copy.deepcopy(common.load_cell(CELL))
    cell["config_spec"]["model"].update(TINY_MODEL)
    cell["traffic_spec"].update(TINY_TRAFFIC)
    return cell


def _run(cell, trace=False, **kw):
    torch.manual_seed(0)
    return runner.execute(cell, SEED, 0.2, trace, "cpu", time.perf_counter(), **kw)


def test_hific_cell_is_correct_on_the_cpu():
    res = _run(tiny_cell())
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"serve_img_per_s", "serve_call_p95_ms", "setup_s"}
    assert res["check"]["symbol_mismatch"]["value"] == 0.0
    assert res["_details"]["decoded_clipped"] < 0.01
    assert res["_details"]["sigma_at_bound"] < 0.01


def test_hific_traced_run_on_the_cpu():
    """The CPU launches nothing on a device: the device readers read
    nothing, and do not raise; mfu reads the untraced window."""
    res = _run(tiny_cell(), trace=True)
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"mfu.serve_hific"}


def test_hific_readers():
    ranges = {"serve.call": (8, 0.5), "hific.resblocks": (8, 0.08), "hific.norm": (232, 0.16),
              "hific.hyper": (8, 0.016), "pipeline.codec": (8, 1.2)}
    summary = {"ranges": {k: {"count": c, "device_s": d} for k, (c, d) in ranges.items()},
               "window_s": 1.0, "busy_s": 0.75, "device_ops": [], "idle_gaps": [],
               "work": {"flops_per_image": 4.8e12, "resblock_flops": 989e10,
                        "resblock_bytes": 3.35e9, "peak_flops": 989e12,
                        "peak_bytes_per_s": 3.35e12},
               "untraced": {"images": 206.0, "seconds": 2.0}}
    got = runner.per_layer(tiny_cell(), summary)
    assert {k: v["value"] for k, v in got.items()} == pytest.approx({
        "mfu.serve_hific": 100 * 4.8e12 * 103 / 989e12,
        "resblock_roofline_pct.serve_hific": 100 * 0.01 / 0.01,
        "norm_device_ms.serve_hific": 20.0,
        "hyper_device_ms.serve_hific": 2.0,
        "codec_device_ms.serve_hific": 150.0,
        "idle_pct.serve_hific": 25.0})
    summary["ranges"] = {"serve.call": {"count": 8, "device_s": 0.5}}  # a parent's program
    assert set(runner.per_layer(tiny_cell(), summary)) == {"mfu.serve_hific",
                                                           "idle_pct.serve_hific"}


@pytest.mark.parametrize("fault", sorted(serve_hific.FAULTS))
def test_hific_fault_is_incorrect(fault):
    res = _run(tiny_cell(), fault=serve_hific.FAULTS[fault])
    assert not res["correct"], res["check"]


def test_hific_control_is_incorrect():
    cell = tiny_cell()
    gaps = serve_hific.control(cell, SEED, "cpu")
    assert not check.verdict(gaps, cell["limits"]), gaps


def test_hific_work_matches_flop_counter():
    from contextual_image_compression_tpu_torch.models.hific import HiFiCCodec

    cell = tiny_cell()
    m = cell["config_spec"]["model"]
    codec = HiFiCCodec(serve_hific.hific_config(cell["config_spec"]))
    codec.load_state_dict(serve_hific.make_weights(m, SEED, "cpu"))
    with FlopCounterMode(display=False) as fc:
        codec.apply(torch.rand(2, 3, 128, 192))
    work = common.work_module(cell["config"])
    assert fc.get_total_flops() == pytest.approx(2 * work.flops_per_image(m, 128, 192),
                                                 rel=1e-9)


def test_hific_shape_table_is_the_programs():
    from contextual_image_compression_tpu_torch.config import HiFiCConfig
    from contextual_image_compression_tpu_torch.models.hific import HiFiCCodec

    spec = common.load_cell(CELL)["config_spec"]
    with torch.device("meta"):
        codec = HiFiCCodec(serve_hific.hific_config(spec))
    assert {k: tuple(v.shape) for k, v in codec.state_dict().items()} == \
        ref_hific.shapes(spec["model"])
    assert serve_hific.hific_config(spec) == HiFiCConfig()
