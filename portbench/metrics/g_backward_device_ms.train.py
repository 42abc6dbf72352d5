"""Device milliseconds of `GANStepBuilder.g_backward` per step: the G / LS /
RD losses, VGG19 on both images, the one backward through the codec (K3b
on both latents)."""

META = {"name": "g_backward_device_ms.train", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "train: GANStepBuilder.g_backward",
        "moves": "train_img_per_s", "workloads": ["train_b16", "train_b16_noperc"],
        "driver": "train"}


def read(summary):
    r = summary["ranges"].get("train.g_backward")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["count"]
