"""Device milliseconds of `GANStepBuilder.d_phase` per D phase: D's
forward on the real and the detached fake batch, its loss and backward,
and its keras Adam. Steps without a D phase count nothing."""

META = {"name": "d_phase_device_ms.train", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "train: GANStepBuilder.d_phase",
        "moves": "train_img_per_s", "workloads": ["train_b16", "train_b16_noperc"],
        "driver": "train"}


def read(summary):
    r = summary["ranges"].get("train.d_phase")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["count"]
