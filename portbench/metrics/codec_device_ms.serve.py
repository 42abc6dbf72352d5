"""Device milliseconds a serving call spends in the codec: the kernels
launched inside `pipe.codec.apply` (encoders, latent saliency, RD net,
quantizer, generators), per call of the traced tail."""

META = {"name": "codec_device_ms.serve", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "models: AdaptiveCodec.apply",
        "moves": "serve_img_per_s", "workloads": ["serve_b16", "serve_b128"],
        "driver": "serve"}


def read(summary):
    r = summary["ranges"].get("codec.apply")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["count"]
