"""Device milliseconds a ragged serving call spends in the codec: the
kernels launched inside `pipe.codec.apply` on the padded batch (padding
images included), per call of the traced tail."""

META = {"name": "codec_device_ms.serve_ragged", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "models: AdaptiveCodec.apply",
        "moves": "serve_img_per_s", "workloads": ["serve_ragged"], "driver": "serve_ragged"}


def read(summary):
    r = summary["ranges"].get("codec.apply")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["count"]
