"""Device milliseconds a HiFiC serving call spends in ChannelNorm: the
operations launched inside the program's 29 `hific.norm` spans of a call
(E's 5, G's 24), per `serve.call` of the traced tail. The layer a fused
ChannelNorm kernel would take."""

META = {"name": "norm_device_ms.serve_hific", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "models: HiFiC ChannelNorm",
        "moves": "serve_img_per_s", "workloads": ["hific_2048x1536_b4"],
        "driver": "serve_hific"}


def read(summary):
    r, calls = summary["ranges"].get("hific.norm"), summary["ranges"].get("serve.call")
    if not r or not calls or not calls["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / calls["count"]
