"""Per-layer readers against synthetic summaries: the value they give, and
None where the range they read is absent or empty."""

import pytest

from conftest import tiny_cell
from portbench.harness import common


def _summary(**ranges):
    return {"ranges": {k: {"count": c, "device_s": s} for k, (c, s) in ranges.items()},
            "window_s": 1.0, "busy_s": 0.5, "device_ops": [], "idle_gaps": []}


def test_d_phase_reads_device_ms_per_phase():
    read = common.metric_modules()["d_phase_device_ms.train"].read
    assert read(_summary(**{"train.d_phase": (2, 0.012)})) == pytest.approx(6.0)
    assert read(_summary(**{"train.g_backward": (2, 0.1)})) is None
    assert read(_summary(**{"train.d_phase": (0, 0.0)})) is None


def test_d_phase_is_a_train_metric():
    meta = common.metric_modules()["d_phase_device_ms.train"].META
    assert meta["driver"] == tiny_cell("train_b16_noperc")["traffic_spec"]["driver"]
    assert meta["driver"] != tiny_cell("serve_b16")["traffic_spec"]["driver"]
