"""The HQ encoder's attention block against its roofline on rank 0 of the
data-parallel cell, its forward only: the block's work at the rank's batch,
float32 at one card's TF32 peak of 495 TFLOP/s, or its bytes at 3.35 TB/s,
whichever bounds it (work/<config>.py), over the device time of the
kernels launched inside the module's forward."""

META = {"name": "attn_roofline_pct.train_dp", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels: SAGAN attention block (K2)",
        "moves": "train_img_per_s", "workloads": ["train_dp4"], "driver": "train_dp"}


def read(summary):
    r = summary["ranges"].get("hq_attention")
    w = summary["work"]
    if not r or not r["count"] or r["device_s"] <= 0 or "attention_flops" not in w:
        return None
    bound = max(w["attention_flops"] / w["card_peak_flops"],
                w["attention_bytes"] / w["peak_bytes_per_s"])
    return 100.0 * bound / (r["device_s"] / r["count"])
