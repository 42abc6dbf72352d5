"""Share of the traced serve tail in which no kernel, copy or memset ran
on the card. The profiler's own host work slows a host-bound call (by a
quarter to a half here), so in a host-bound cell this reads above the idle
share of an untraced call; parent and change are traced alike."""

META = {"name": "idle_pct.serve", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "serve_img_per_s",
        "workloads": ["serve_b16", "serve_b128"], "driver": "serve"}


def read(summary):
    if summary["busy_s"] <= 0 or summary["window_s"] <= 0:
        return None
    return 100.0 * (summary["window_s"] - summary["busy_s"]) / summary["window_s"]
