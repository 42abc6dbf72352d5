"""TCM's served FLOPs (work/<config>.py, per photo at the traffic's size)
times the photos decoded in the untraced window, over its seconds, as a
share of the card's bf16 peak (989 TFLOP/s)."""

META = {"name": "mfu.serve_tcm", "unit": "%", "better": "higher", "source": "host_clock",
        "layer": "device", "moves": "serve_img_per_s",
        "workloads": ["tcm_2048x1536_b4"], "driver": "serve_tcm"}


def read(summary):
    u, w = summary.get("untraced"), summary["work"]
    if not u or u["seconds"] <= 0 or not u["images"]:
        return None
    return 100.0 * w["flops_per_image"] * u["images"] / u["seconds"] / w["peak_flops"]
