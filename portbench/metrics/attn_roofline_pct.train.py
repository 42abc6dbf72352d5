"""The HQ encoder's attention block against its roofline in training, its
forward only: the block's work at the batch, float32 at the TF32 peak of
495 TFLOP/s, or its bytes at 3.35 TB/s, whichever bounds it (work/<config>.py),
over the device time of the kernels launched inside the module's forward."""

META = {"name": "attn_roofline_pct.train", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels: SAGAN attention block (K2)",
        "moves": "train_img_per_s", "workloads": ["train_b16", "train_b16_noperc"],
        "driver": "train"}


def read(summary):
    r = summary["ranges"].get("hq_attention")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    w = summary["work"]
    bound = max(w["attention_flops"] / w["peak_flops"],
                w["attention_bytes"] / w["peak_bytes_per_s"])
    return 100.0 * bound / (r["device_s"] / r["count"])
