"""TCM's windowed attention Blocks against their roofline: the least time
the card could take for all of a call's windowed Blocks (QKV, both window
products, the projection and the MLP in bf16 at 989 TFLOP/s, or each
Block's input, output and weights once at 3.35 TB/s, whichever is larger;
work/<config>.py), over the device time of the operations launched inside
the program's `tcm.swin` spans, a call. Reads nothing where the program
has no such span."""

META = {"name": "swin_roofline_pct.serve_tcm", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "models: TCM windowed attention Blocks",
        "moves": "serve_img_per_s", "workloads": ["tcm_2048x1536_b4"],
        "driver": "serve_tcm"}


def read(summary):
    r, calls = summary["ranges"].get("tcm.swin"), summary["ranges"].get("serve.call")
    if not r or not calls or not calls["count"] or r["device_s"] <= 0:
        return None
    w = summary["work"]
    bound = max(w["swin_flops"] / w["peak_flops"], w["swin_bytes"] / w["peak_bytes_per_s"])
    return 100.0 * bound / (r["device_s"] / calls["count"])
