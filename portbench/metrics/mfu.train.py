"""The model FLOPs of the untraced window's steps (work/<config>.py, with
and without D's phase as the schedule ran them) over its seconds, as a
share of the card's peak for float32 inputs (TF32, 495 TFLOP/s)."""

META = {"name": "mfu.train", "unit": "%", "better": "higher", "source": "host_clock",
        "layer": "device", "moves": "train_img_per_s",
        "workloads": ["train_b16", "train_b16_noperc"], "driver": "train"}


def read(summary):
    u, w = summary.get("untraced"), summary["work"]
    if not u or u["seconds"] <= 0 or not u["steps"]:
        return None
    flops = (u["steps_with_d"] * w["step_flops_d"]
             + (u["steps"] - u["steps_with_d"]) * w["step_flops_no_d"])
    return 100.0 * flops / u["seconds"] / w["peak_flops"]
