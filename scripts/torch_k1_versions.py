#!/usr/bin/env python
"""K1 of this tree against K1 built from other copies of csrc/fused_mask.cu,
on the card, in one process.

    python3 scripts/torch_k1_versions.py OTHER.cu [OTHER.cu ...]

Each OTHER.cu (for example the parent's, from `git show
<commit>:contextual_image_compression_tpu_torch/csrc/fused_mask.cu`) is
compiled with nvcc and this tree's csrc/ headers into a library of its own.
On seeded structured images at (16, 256^2), (2, 512^2) (the tiled route),
(3, 200^2) and (1, 64^2) the script prints, for the float32 route, whether
this tree's mask equals the other's bit for bit, and for the bf16 route
(where the other source has its entry points) whether this tree's equals
the other's and the bf16 twin's. At (16, 256^2) it times each route of both
in turns (this, other, other, this) with measure.event_ms (the host's launch
inside) and measure.device_ms (the device alone). The card's name and power
limit come first.
"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sources", nargs="+", help="other copies of csrc/fused_mask.cu")
    args = p.parse_args()

    import numpy as np
    import torch

    from contextual_image_compression_tpu_torch.measure import (
        card_name_and_power, device_ms, event_ms, structured_images)
    from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck
    from contextual_image_compression_tpu_torch.ops import fused_mask, image_ops, saliency

    if not torch.cuda.is_available():
        print("torch_k1_versions: CUDA is not available", file=sys.stderr)
        return 1
    print(card_name_and_power(), flush=True)
    ck.library()
    tmp = Path(tempfile.mkdtemp(prefix="k1-versions-"))
    others = {}
    for i, src in enumerate(args.sources):
        lib_path = tmp / f"libother{i}.so"
        res = subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-I", str(ck.CSRC_DIR), "-shared", src,
                              "-o", str(lib_path)], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in ck._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        others[src] = lib

    def run_with(lib, fn):
        saved = ck.library
        ck.library = lambda: lib
        try:
            return fn()
        finally:
            ck.library = saved

    bf = torch.bfloat16
    rng = np.random.RandomState(0)
    for b, size in [(16, 256), (2, 512), (3, 200), (1, 64)]:
        u8 = torch.from_numpy(structured_images(rng, b, size)).to("cuda")
        gray = image_ops.rgb_to_gray(u8.float()).contiguous()
        spec = saliency.spectral_residual_small(gray, min(64, size), 3.0).contiguous()
        calls = {"float32": lambda: fused_mask.contextual_mask(gray, spec),
                 "bf16": lambda: fused_mask.contextual_mask(gray, spec, compute_dtype=bf)}
        twin = fused_mask.contextual_mask_plain(gray, spec, compute_dtype=bf)
        mine = {route: call() for route, call in calls.items()}
        print(f"({b}, {size}, {size}): this tree's bf16 mask equals the bf16 twin bit for bit: "
              f"{torch.equal(mine['bf16'], twin)}", flush=True)
        for src, lib in others.items():
            for route, call in calls.items():
                if route == "bf16" and not hasattr(lib, "cic_contextual_mask_cluster_bf16"):
                    continue
                other = run_with(lib, call)
                print(f"  {route} vs {src}: bitwise {torch.equal(mine[route], other)}, max |diff| "
                      f"{(mine[route] - other).abs().max().item():.3e}", flush=True)
                if b == 16 and size == 256:
                    for turn in ("this", "other", "other", "this"):
                        fn = call if turn == "this" else (lambda: run_with(lib, call))
                        print(f"    {turn}: {event_ms(fn):.4f} ms, device alone "
                              f"{device_ms(fn):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
