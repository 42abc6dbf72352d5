"""HiFiC's 9 residual blocks against their roofline: the least time the
card could take for their 18 convolutions at the call's batch (bf16 at 989
TFLOP/s, or their bytes at 3.35 TB/s, whichever is larger;
work/<config>.py), over the device time of the operations launched inside
the program's `hific.resblocks` span, a call. Reads nothing where the
program has no such span."""

META = {"name": "resblock_roofline_pct.serve_hific", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "models: HiFiC residual blocks",
        "moves": "serve_img_per_s", "workloads": ["hific_2048x1536_b4"],
        "driver": "serve_hific"}


def read(summary):
    r = summary["ranges"].get("hific.resblocks")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    w = summary["work"]
    bound = max(w["resblock_flops"] / w["peak_flops"],
                w["resblock_bytes"] / w["peak_bytes_per_s"])
    return 100.0 * bound / (r["device_s"] / r["count"])
