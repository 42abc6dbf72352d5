"""The ragged serving cell (harness/serve_ragged.py) on the CPU at the tiny
sizes of conftest.py, with its own tiny traffic: a run is correct and
reports its metrics, a traced run its per-layer metrics, padded_pct the
share the pipeline's counters give and mfu the images the codec ran; the
planted faults are incorrect; the plan's batch sizes follow P(b) ~ 1 / b;
a program without the counters runs the cell and only padded_pct and mfu
read nothing."""

import copy
import time

import numpy as np
import pytest
import torch

from conftest import TINY_MODEL
from portbench.harness import common, faults, runner, serve_ragged

SEED = 2 ** 33 + 37
TINY_TRAFFIC = {"max_batch": 4, "pool": 8, "warmup_batches": [1, 2, 4], "check_calls": 2,
                "trace_calls": 6}
CELL = "serve_ragged"


def tiny_cell() -> dict:
    cell = copy.deepcopy(common.load_cell(CELL))
    cell["config_spec"]["model"].update(TINY_MODEL)
    cell["config_spec"]["saliency"]["spectral_resolution"] = 16
    cell["traffic_spec"].update(TINY_TRAFFIC)
    return cell


def _run(cell, trace=False, seconds=0.3, **kw):
    torch.manual_seed(0)
    return runner.execute(cell, SEED, seconds, trace, "cpu", time.perf_counter(), **kw)


def test_ragged_cell_is_correct_on_the_cpu():
    res = _run(tiny_cell())
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"serve_img_per_s", "serve_call_p95_ms", "setup_s"}


def test_ragged_traced_run_reads_the_padding_share(monkeypatch):
    """The traced tail's padding share is the counters' and the plan's:
    padding over all the codec ran, with no new batch size after warm-up."""
    seen = {}
    summary_of = serve_ragged._traced_tail

    def traced(*args):
        summary = summary_of(*args)
        seen.update(summary["counters"])
        return summary

    monkeypatch.setattr(serve_ragged, "_traced_tail", traced)
    res = _run(tiny_cell(), trace=True)
    assert res["correct"], res["check"]
    # the CPU has no device ops: the counters' and the host clock's metrics
    assert set(res["metrics"]) == {"padded_pct.serve_ragged", "mfu.serve_ragged"}
    assert seen["new_batches"] == 0 and seen["images"] > 0
    want = 100.0 * seen["padding"] / (seen["images"] + seen["padding"])
    assert res["metrics"]["padded_pct.serve_ragged"]["value"] == pytest.approx(want)


def test_ragged_padding_follows_the_buckets():
    """After warm-up at 1, 2 and 4, a call of 3 pads 1 and runs no new
    batch size; the counters add up over a plan's calls."""
    cell = tiny_cell()
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    mcfg, scfg = serve_ragged.model_config(cell["config_spec"])
    pipe = CompressionPipeline(model_config=mcfg, saliency_config=scfg, device="cpu", seed=1)
    imgs = np.zeros((4, 64, 64, 3), np.uint8)
    for b in (1, 2, 4):
        pipe(imgs[:b])
    assert pipe.counts() == {"images": 7, "padding": 0, "new_batches": 3}
    pipe.reset_counts()
    sizes = serve_ragged.sizes(SEED, 4, n=12)
    for b in sizes:
        pipe(imgs[:b])
    pad = {1: 0, 2: 0, 3: 1, 4: 0}
    assert pipe.counts() == {"images": int(sizes.sum()),
                             "padding": sum(pad[int(b)] for b in sizes), "new_batches": 0}


def test_ragged_sizes_follow_one_over_b():
    b = serve_ragged.sizes(SEED, 16)
    assert b.min() == 1 and b.max() == 16
    freq = np.bincount(b, minlength=17)[1:] / len(b)
    want = (1.0 / np.arange(1, 17)) / (1.0 / np.arange(1, 17)).sum()
    assert np.abs(freq - want).max() < 0.01
    assert b.mean() == pytest.approx(16 / (1.0 / np.arange(1, 17)).sum(), rel=0.02)
    assert np.array_equal(serve_ragged.sizes(SEED, 16), b)  # the seed's


def test_ragged_readers():
    summary = {"ranges": {"codec.apply": {"count": 32, "device_s": 0.16}},
               "window_s": 1.0, "busy_s": 0.6, "device_ops": [], "idle_gaps": [],
               "counters": {"images": 150, "padding": 38, "new_batches": 0},
               "untraced": {"images": 1000, "seconds": 2.0,
                            "counters": {"images": 1000, "padding": 200, "new_batches": 0}},
               "work": {"flops_per_image": 1e9, "peak_flops": 1e12}}
    got = {k: v["value"] for k, v in runner.per_layer(tiny_cell(), summary).items()}
    assert got == pytest.approx({"padded_pct.serve_ragged": 100 * 38 / 188,
                                 "idle_pct.serve_ragged": 40.0,
                                 "codec_device_ms.serve_ragged": 5.0,
                                 "mfu.serve_ragged": 100 * 1e9 * 1200 / 2.0 / 1e12})
    summary["counters"] = None  # a program without the counters
    summary["untraced"]["counters"] = None
    assert set(runner.per_layer(tiny_cell(), summary)) == {"idle_pct.serve_ragged",
                                                           "codec_device_ms.serve_ragged"}


def test_ragged_runs_without_the_programs_counters(monkeypatch):
    """A pipeline with no counters (a program before them) runs the cell;
    only padded_pct and mfu read nothing."""
    from contextual_image_compression_tpu_torch import serve

    real = serve.CompressionPipeline

    class NoCounters:
        def __init__(self, *args, **kwargs):
            self._pipe = real(*args, **kwargs)
            self.codec = self._pipe.codec

        def __call__(self, *args, **kwargs):
            return self._pipe(*args, **kwargs)

    monkeypatch.setattr(serve, "CompressionPipeline", NoCounters)
    res = _run(tiny_cell(), trace=True)
    assert res["correct"], res["check"]
    assert not {"padded_pct.serve_ragged", "mfu.serve_ragged"} & set(res["metrics"])


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_ragged_fault_is_incorrect(fault, monkeypatch):
    """Calls of one image are raised to two: half of one image is the whole
    of it, so half_batch changes nothing there, and the kept calls of a
    short window could all be such calls."""
    sizes = serve_ragged.sizes
    monkeypatch.setattr(serve_ragged, "sizes",
                        lambda seed, top, n=1 << 16: np.maximum(sizes(seed, top, n), 2))
    res = _run(tiny_cell(), fault=faults.SERVE[fault])
    assert not res["correct"], res["check"]
