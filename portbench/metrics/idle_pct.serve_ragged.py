"""Share of the traced ragged serve tail in which no kernel, copy or memset
ran on the card."""

META = {"name": "idle_pct.serve_ragged", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "serve_img_per_s",
        "workloads": ["serve_ragged"], "driver": "serve_ragged"}


def read(summary):
    if summary["busy_s"] <= 0 or summary["window_s"] <= 0:
        return None
    return 100.0 * (summary["window_s"] - summary["busy_s"]) / summary["window_s"]
