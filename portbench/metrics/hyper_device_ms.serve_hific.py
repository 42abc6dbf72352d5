"""Device milliseconds a HiFiC serving call spends in the hyperprior and
the entropy model: the operations launched inside the program's
`hific.hyper` span (h_a, z_hat, both syntheses, y_hat, the likelihoods and
bits), per call of the traced tail."""

META = {"name": "hyper_device_ms.serve_hific", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "models: HiFiC hyperprior and entropy model",
        "moves": "serve_img_per_s", "workloads": ["hific_2048x1536_b4"],
        "driver": "serve_hific"}


def read(summary):
    r = summary["ranges"].get("hific.hyper")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["count"]
