"""The served model's FLOPs (work/<config>.py, per image) times the images
the codec ran in the untraced window, the padding images `_padded_batch`
added included (the pipeline's counters), over its seconds, as a share of
the card's peak for the configuration's precision. Reads nothing where the
pipeline has no counters."""

META = {"name": "mfu.serve_ragged", "unit": "%", "better": "higher", "source": "host_clock",
        "layer": "device", "moves": "serve_img_per_s", "workloads": ["serve_ragged"],
        "driver": "serve_ragged"}


def read(summary):
    u, w = summary.get("untraced"), summary.get("work")
    c = (u or {}).get("counters")
    if not w or not c or u["seconds"] <= 0 or c["images"] + c["padding"] <= 0:
        return None
    ran = c["images"] + c["padding"]
    return 100.0 * w["flops_per_image"] * ran / u["seconds"] / w["peak_flops"]
