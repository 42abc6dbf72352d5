"""The model FLOPs of the untraced window's steps on every rank
(work/<config>.py at the per-rank batch, with and without D's phase as the
schedule ran them, times the ranks) over its seconds, as a share of the
ranks' summed peak for float32 inputs (TF32, 495 TFLOP/s a card)."""

META = {"name": "mfu.train_dp", "unit": "%", "better": "higher", "source": "host_clock",
        "layer": "device", "moves": "train_img_per_s", "workloads": ["train_dp4"],
        "driver": "train_dp"}


def read(summary):
    u, w = summary.get("untraced"), summary["work"]
    if not u or u["seconds"] <= 0 or not u["steps"]:
        return None
    flops = (u["steps_with_d"] * w["step_flops_d"]
             + (u["steps"] - u["steps_with_d"]) * w["step_flops_no_d"])
    return 100.0 * flops / u["seconds"] / w["peak_flops"]
