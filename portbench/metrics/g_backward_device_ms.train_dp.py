"""Device milliseconds of `GANStepBuilder.g_backward` per step on rank 0 of
the data-parallel cell: the G / LS / RD losses, VGG19 on both images, the
one backward through the codec at the rank's batch, and the all-reduce of
the codec's gradients that ends it (`step.allreduce`, read alone by
allreduce_device_ms.train_dp)."""

META = {"name": "g_backward_device_ms.train_dp", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "train: GANStepBuilder.g_backward",
        "moves": "train_img_per_s", "workloads": ["train_dp4"], "driver": "train_dp"}


def read(summary):
    r = summary["ranges"].get("train.g_backward")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["count"]
