"""Share of the traced train tail in which no kernel, copy or memset ran
on the card. The profiler's own host work slows a host-bound step (by a
quarter to a half here), so in a host-bound cell this reads above the idle
share of an untraced step; parent and change are traced alike."""

META = {"name": "idle_pct.train", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "train_img_per_s",
        "workloads": ["train_b16", "train_b16_noperc"], "driver": "train"}


def read(summary):
    if summary["busy_s"] <= 0 or summary["window_s"] <= 0:
        return None
    return 100.0 * (summary["window_s"] - summary["busy_s"]) / summary["window_s"]
