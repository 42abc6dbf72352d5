"""Share of the traced TCM serve tail in which no kernel, copy or memset
ran on the card."""

META = {"name": "idle_pct.serve_tcm", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "serve_img_per_s",
        "workloads": ["tcm_2048x1536_b4"], "driver": "serve_tcm"}


def read(summary):
    if summary["busy_s"] <= 0 or summary["window_s"] <= 0:
        return None
    return 100.0 * (summary["window_s"] - summary["busy_s"]) / summary["window_s"]
