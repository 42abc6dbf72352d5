"""Device milliseconds of `GANStepBuilder.g_update` per step on rank 0 of
the data-parallel cell: the three keras Adams of the codec's groups on the
summed gradients, and the BatchNorm statistics' commit."""

META = {"name": "update_device_ms.train_dp", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "train: optimizers via GANStepBuilder.g_update",
        "moves": "train_img_per_s", "workloads": ["train_dp4"], "driver": "train_dp"}


def read(summary):
    r = summary["ranges"].get("train.g_update")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["count"]
