"""Device milliseconds rank 0 spends summing gradients over the mesh a
step: the operations launched inside the program's `step.allreduce` spans
(the codec's reduction every step, D's on its steps), over the `train.step`
ranges of rank 0's traced tail. A collective waits for the slowest rank,
so the wait counts too. Reads nothing where the program has no such span."""

META = {"name": "allreduce_device_ms.train_dp", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "parallel: gradient all-reduce",
        "moves": "train_img_per_s", "workloads": ["train_dp4"], "driver": "train_dp"}


def read(summary):
    r, steps = summary["ranges"].get("step.allreduce"), summary["ranges"].get("train.step")
    if not r or not steps or not steps["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / steps["count"]
