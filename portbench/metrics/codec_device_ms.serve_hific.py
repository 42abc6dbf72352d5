"""Device milliseconds a HiFiC serving call spends in the codec: the
operations launched inside the program's `pipeline.codec` span (the
image's normalisation and reflection padding, E, the hyperprior, G with
its full-resolution upsampling and 7x7 head, the layout transposes around
every convolution, the crop and the uint8 rounding), per `serve.call` of
the traced tail. Reads nothing where the program has no such span."""

META = {"name": "codec_device_ms.serve_hific", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "models: HiFiCCodec.apply",
        "moves": "serve_img_per_s", "workloads": ["hific_2048x1536_b4"],
        "driver": "serve_hific"}


def read(summary):
    r, calls = summary["ranges"].get("pipeline.codec"), summary["ranges"].get("serve.call")
    if not r or not calls or not calls["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / calls["count"]
