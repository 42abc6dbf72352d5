"""Share of rank 0's traced train tail in which no kernel, copy or memset
ran on its card."""

META = {"name": "idle_pct.train_dp", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "train_img_per_s",
        "workloads": ["train_dp4"], "driver": "train_dp"}


def read(summary):
    if summary["busy_s"] <= 0 or summary["window_s"] <= 0:
        return None
    return 100.0 * (summary["window_s"] - summary["busy_s"]) / summary["window_s"]
