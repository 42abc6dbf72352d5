"""The served model's FLOPs (work/<config>.py, per image) times the images
decoded in the untraced window, over its seconds, as a share of the card's
peak for the configuration's precision."""

META = {"name": "mfu.serve", "unit": "%", "better": "higher", "source": "host_clock",
        "layer": "device", "moves": "serve_img_per_s",
        "workloads": ["serve_b16", "serve_b128"], "driver": "serve"}


def read(summary):
    u, w = summary.get("untraced"), summary["work"]
    if not u or u["seconds"] <= 0 or not u["images"]:
        return None
    return 100.0 * w["flops_per_image"] * u["images"] / u["seconds"] / w["peak_flops"]
