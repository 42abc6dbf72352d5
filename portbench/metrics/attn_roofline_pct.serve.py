"""The HQ encoder's attention block against its roofline in serving: the
least time the card could take for the block's work (projections and both
products at the cell's batch, bf16 at 989 TFLOP/s, or its bytes at 3.35
TB/s, whichever is larger; work/<config>.py) over the device time of the
kernels launched inside the attention module's forward."""

META = {"name": "attn_roofline_pct.serve", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels: SAGAN attention block (K2)",
        "moves": "serve_img_per_s", "workloads": ["serve_b16", "serve_b128"],
        "driver": "serve"}


def read(summary):
    r = summary["ranges"].get("hq_attention")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    w = summary["work"]
    bound = max(w["attention_flops"] / w["peak_flops"],
                w["attention_bytes"] / w["peak_bytes_per_s"])
    return 100.0 * bound / (r["device_s"] / r["count"])
