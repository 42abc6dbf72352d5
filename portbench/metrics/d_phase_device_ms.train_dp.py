"""Device milliseconds of `GANStepBuilder.d_phase` per D phase on rank 0 of
the data-parallel cell: D's forward on the rank's real and detached fake
images, its loss and backward, the all-reduce of D's gradients and its
keras Adam. Steps without a D phase count nothing."""

META = {"name": "d_phase_device_ms.train_dp", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "train: GANStepBuilder.d_phase",
        "moves": "train_img_per_s", "workloads": ["train_dp4"], "driver": "train_dp"}


def read(summary):
    r = summary["ranges"].get("train.d_phase")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["count"]
