"""Share of the images the codec ran in the traced tail that were padding
added by `CompressionPipeline._padded_batch` (its power-of-two buckets),
from the pipeline's counters: padding / (images served + padding). Reads
nothing where the pipeline has no counters."""

META = {"name": "padded_pct.serve_ragged", "unit": "%", "better": "lower",
        "source": "program_counter", "layer": "serve: CompressionPipeline batch padding",
        "moves": "serve_img_per_s", "workloads": ["serve_ragged"], "driver": "serve_ragged"}


def read(summary):
    c = summary.get("counters")
    if not c or c["images"] + c["padding"] <= 0:
        return None
    return 100.0 * c["padding"] / (c["images"] + c["padding"])
