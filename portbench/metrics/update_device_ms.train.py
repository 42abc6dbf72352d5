"""Device milliseconds of `GANStepBuilder.g_update` per step: the three
keras Adams (per-tensor clip, then Adam) of the codec's groups and the
BatchNorm statistics' commit."""

META = {"name": "update_device_ms.train", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "train: optimizers via GANStepBuilder.g_update",
        "moves": "train_img_per_s", "workloads": ["train_b16", "train_b16_noperc"],
        "driver": "train"}


def read(summary):
    r = summary["ranges"].get("train.g_update")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["count"]
