"""The TCM serving cell (harness/serve_tcm.py) on the CPU at a tiny width,
in float32 (whose reference rounds nowhere): a run is correct and reports
its metrics, a traced run its per-layer metrics; the float8 control and
the planted faults are incorrect; the work counts against torch's FLOP
counter; the weights and the shape table are the program's."""

import copy
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import check, common, runner, serve_tcm
from portbench.reference import tcm as ref_tcm

SEED = 2 ** 33 + 31
TINY_MODEL = {"n": 16, "m": 20, "head_dims": [8, 8, 16, 16, 8, 8], "hyper_head_dim": 8,
              "swatten_dim": 16, "swatten_head_dim": 8, "cc_widths": [12, 8],
              "z_channels": 12, "dtype": "float32"}
TINY_TRAFFIC = {"batch": 2, "pool": 4, "height": 128, "width": 256, "warmup_calls": 1,
                "check_calls": 2, "trace_calls": 2}
CELL = "tcm_2048x1536_b4"


def tiny_cell() -> dict:
    cell = copy.deepcopy(common.load_cell(CELL))
    cell["config_spec"]["model"].update(TINY_MODEL)
    cell["traffic_spec"].update(TINY_TRAFFIC)
    return cell


def _run(cell, trace=False, **kw):
    torch.manual_seed(0)
    return runner.execute(cell, SEED, 0.2, trace, "cpu", time.perf_counter(), **kw)


def test_tcm_cell_is_correct_on_the_cpu():
    res = _run(tiny_cell())
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"serve_img_per_s", "serve_call_p95_ms", "setup_s"}
    assert res["check"]["symbol_mismatch"]["value"] == 0.0
    assert res["check"]["symbol_mismatch_free"]["value"] == 0.0
    # the weights are seeded for the published widths; at these the image
    # head's input spreads wider, and a few percent of values clip
    assert res["_details"]["decoded_clipped"] < 0.1
    assert res["_details"]["sigma_at_bound"] < 0.01


def test_tcm_traced_run_on_the_cpu():
    """The CPU launches nothing on a device: the device readers read
    nothing, and do not raise; mfu reads the untraced window."""
    res = _run(tiny_cell(), trace=True)
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"mfu.serve_tcm"}


def test_tcm_readers():
    ranges = {"serve.call": (8, 2.0), "tcm.swin": (8 * 56, 0.4), "tcm.slices": (8, 0.16),
              "pipeline.codec": (8, 2.4)}
    summary = {"ranges": {k: {"count": c, "device_s": d} for k, (c, d) in ranges.items()},
               "window_s": 1.0, "busy_s": 0.75, "device_ops": [], "idle_gaps": [],
               "work": {"flops_per_image": 11.6e12, "swin_flops": 989e9,
                        "swin_bytes": 3.35e9, "peak_flops": 989e12,
                        "peak_bytes_per_s": 3.35e12},
               "untraced": {"images": 40.0, "seconds": 2.0}}
    got = runner.per_layer(tiny_cell(), summary)
    assert {k: v["value"] for k, v in got.items()} == pytest.approx({
        "mfu.serve_tcm": 100 * 11.6e12 * 20 / 989e12,
        "swin_roofline_pct.serve_tcm": 100 * 1e-3 / 0.05,
        "slices_device_ms.serve_tcm": 20.0,
        "codec_device_ms.serve_tcm": 300.0,
        "idle_pct.serve_tcm": 25.0})
    summary["ranges"] = {"serve.call": {"count": 8, "device_s": 0.5}}  # a parent's program
    assert set(runner.per_layer(tiny_cell(), summary)) == {"mfu.serve_tcm", "idle_pct.serve_tcm"}


@pytest.mark.parametrize("fault", sorted(serve_tcm.FAULTS))
def test_tcm_fault_is_incorrect(fault):
    res = _run(tiny_cell(), fault=serve_tcm.FAULTS[fault])
    assert not res["correct"], res["check"]


def test_tcm_control_is_incorrect():
    cell = tiny_cell()
    gaps = serve_tcm.control(cell, SEED, "cpu")
    assert not check.verdict(gaps, cell["limits"]), gaps


def test_tcm_work_matches_flop_counter():
    """Every convolution, linear and attention product as the counter counts
    them (the attention on the library's plain route, which it counts),
    less the shifted Blocks' second pass over their last window row and
    column (the program's way of applying the region masks, not model
    work); the windowed Blocks' FLOPs as the counter counts them inside
    the Block modules."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from contextual_image_compression_tpu_torch.models.tcm import Block, TCMCodec

    cell = tiny_cell()
    m = cell["config_spec"]["model"]
    codec = TCMCodec(serve_tcm.tcm_config(cell["config_spec"]))
    codec.load_state_dict(serve_tcm.make_weights(m, SEED, "cpu"))
    h, w = 128, 256
    fc = FlopCounterMode(display=False)
    blocks = [mod for mod in codec.modules() if isinstance(mod, Block)]
    inside = []  # each Block call's FLOPs, from the counter's running total
    for mod in blocks:
        mod.register_forward_pre_hook(lambda *_: inside.append(-fc.get_total_flops()))
        mod.register_forward_hook(lambda *_: inside.append(fc.get_total_flops()))
    with sdpa_kernel(SDPBackend.MATH), fc:
        codec.apply(torch.rand(2, 3, h, w))
    in_blocks, total = sum(inside), fc.get_total_flops()
    work = common.work_module(cell["config"])
    sb = m["stage_blocks"]
    # (stride, width, window, Blocks) of each stage's windowed Blocks
    stages = ((2, m["n"], m["window"], sb[0] + sb[5]), (4, m["n"], m["window"], sb[1] + sb[4]),
              (8, m["n"], m["window"], sb[2] + sb[3]),
              (32, m["n"], m["hyper_window"], sb[0] + 2 * sb[3]),
              (16, m["swatten_dim"], m["window"], 4 * m["num_slices"]))
    redone = 0.0
    for f, d, win, count in stages:
        last = (h // f // win + w // f // win - 1) * win * win  # last window row and column
        redone += count // 2 * 4.0 * last * win * win * d  # half the Blocks are shifted
    assert len(blocks) == sum(c for *_, c in stages)
    assert in_blocks - 2 * redone == pytest.approx(2 * work.swin(m, h, w)[0], rel=1e-9)
    assert total - 2 * redone == pytest.approx(2 * work.flops_per_image(m, h, w), rel=1e-9)


def test_tcm_shape_table_is_the_programs():
    from contextual_image_compression_tpu_torch.config import TCMConfig
    from contextual_image_compression_tpu_torch.models.tcm import TCMCodec

    spec = common.load_cell(CELL)["config_spec"]
    with torch.device("meta"):
        codec = TCMCodec(serve_tcm.tcm_config(spec))
    assert {k: tuple(v.shape) for k, v in codec.state_dict().items()} == \
        ref_tcm.shapes(spec["model"])
    assert serve_tcm.tcm_config(spec) == TCMConfig()
