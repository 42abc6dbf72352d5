"""Device milliseconds a TCM serving call spends in its channel-wise
autoregressive slice chain: the operations launched inside the program's
`tcm.slices` span (the 5 slices' SWAttens, cc transforms, LRPs, the
roundings and the likelihoods, and the bits), per call of the traced tail.
Reads nothing where the program has no such span."""

META = {"name": "slices_device_ms.serve_tcm", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "models: TCM slice chain",
        "moves": "serve_img_per_s", "workloads": ["tcm_2048x1536_b4"],
        "driver": "serve_tcm"}


def read(summary):
    r = summary["ranges"].get("tcm.slices")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["count"]
