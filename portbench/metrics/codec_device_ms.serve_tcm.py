"""Device milliseconds a TCM serving call spends in the codec: the
operations launched inside the program's `pipeline.codec` span (the
image's normalisation and reflection padding, g_a, the hyperprior, the
slice chain, g_s, the crop and the uint8 rounding), per `serve.call` of
the traced tail. Reads nothing where the program has no such span."""

META = {"name": "codec_device_ms.serve_tcm", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "models: TCMCodec.apply",
        "moves": "serve_img_per_s", "workloads": ["tcm_2048x1536_b4"],
        "driver": "serve_tcm"}


def read(summary):
    r, calls = summary["ranges"].get("pipeline.codec"), summary["ranges"].get("serve.call")
    if not r or not calls or not calls["count"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / calls["count"]
