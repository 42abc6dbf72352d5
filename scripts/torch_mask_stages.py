"""Where the cluster-route mask kernel's time goes, stage by stage, on one GPU.

    python3 scripts/torch_mask_stages.py [--out-dir profile_out/mask_stages]

Copies csrc/fused_mask.cu, inserts a clock64() read by thread 0 of every
block at each stage boundary of mask_cluster_kernel, builds that copy with
nvcc into its own library (the port's library is not touched), and runs K1
on 16 structured 256^2 images and K4 on 64 random 256^2 maps with the plan
`ops/fused_mask.py::_mask_plan` gives, K1 once more with clusters of 8
blocks (32 rows each) in place of the plan's 6, and K1's bf16 route (its
own instantiation of the same kernel, so the same stage boundaries). It prints for each run the
clusters the card holds at once (cudaOccupancyMaxActiveClusters), the
call's time (CUDA events over 30 back-to-back launches), its error against
the twin, and per stage the mean cycles of a block:

  K1: stage 1 staging (gray rows from device memory), stage 1 (box sums),
      max 1, stage 2 (comb) + max 2, stage 3 staging (comb rows, DSMEM),
      bilateral + cluster barrier, stage 4 staging (bilateral rows, DSMEM),
      Gaussian rows, Gaussian columns, max 3, normalize + write + barrier;
  K4: the same from stage 3 staging (the map's rows from device memory).

The stage boundaries are found by exact source lines; the script fails if
one is missing, so a change to those lines needs the same change here. It
needs a CUDA device and the CUDA toolkit and exits 1 without them.
"""

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (source text, clock slot): the clock is read right after the text
MARKS = [
    ("  float m2 = 0.f;\n", 0),
    ("                 [](float v) { return v * (1.0f / 255.0f); });\n    __syncthreads();\n", 1),
    ("    const float m1 = cluster_max(local_max, slots, warp_max, 0, cluster);\n", 3),
    ("    m2 = cluster_max(local_max, slots, warp_max, 1, cluster);\n", 4),
    ("  __syncthreads();\n  // two vertically adjacent outputs per thread (a pair of columns on the\n", 5),
    ("  // by a neighbour is done\n  cluster.sync();\n", 6),
    ("        [](int x) { return x; }, [](float v) { return v; });\n  __syncthreads();\n", 7),
    ("      b1[(size_t)y * S + C0 + x] = acc;\n    }\n  }\n  __syncthreads();\n", 8),
    ("  const float m3 = cluster_max(local_max, slots, warp_max, 2, cluster);\n", 10),
    ("  // no block leaves while another still reads its slots\n  cluster.sync();\n", 11),
]
# (source text, clock slot): the clock is read right before the text
BEFORE = [
    ("    const float m1 = cluster_max(", 2),
    ("  const float m3 = cluster_max(", 9),
]
K1_STAGES = ["stage 1 staging", "stage 1", "max 1", "stage 2 + max 2", "stage 3 staging",
             "bilateral + barrier", "stage 4 staging", "Gaussian rows", "Gaussian columns", "max 3",
             "write + barrier"]
SLOTS = 12


def instrumented(src: str) -> str:
    read = "  if (threadIdx.x == 0) g_clk[clk_base + {}] = clock64();\n"
    for text, slot in MARKS:
        if src.count(text) != 1:
            raise RuntimeError(f"stage boundary not found once in fused_mask.cu: {text!r}")
        src = src.replace(text, text + read.format(slot))
    for text, slot in BEFORE:
        if src.count(text) != 1:
            raise RuntimeError(f"stage boundary not found once in fused_mask.cu: {text!r}")
        src = src.replace(text, read.format(slot) + text)
    src = src.replace("  float m2 = 0.f;\n",
                      f"  const int clk_base = (blockIdx.y * gridDim.x + blockIdx.x) * {SLOTS};\n"
                      "  float m2 = 0.f;\n", 1)
    src = src.replace("namespace {\n", f"namespace {{\n__device__ long long g_clk[4096 * {SLOTS}];\n", 1)
    return src + ('\nextern "C" int stage_clocks(long long* host, int n) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, g_clk, sizeof(long long) * n);\n}\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="profile_out/mask_stages")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from contextual_image_compression_tpu_torch.measure import card_name_and_power, structured_images
    from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck
    from contextual_image_compression_tpu_torch.ops import fused_mask as fm
    from contextual_image_compression_tpu_torch.ops import image_ops, saliency

    print(card_name_and_power(), flush=True)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "common.cuh").write_text((ck.CSRC_DIR / "common.cuh").read_text())
    cu = out_dir / "fused_mask_stages.cu"
    cu.write_text(instrumented((ck.CSRC_DIR / "fused_mask.cu").read_text()))
    so = out_dir / "libfused_mask_stages.so"
    res = subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-I", str(out_dir), "-shared", str(cu), "-o",
                          str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        print(res.stdout[-4000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    for name in ("cic_contextual_mask_cluster", "cic_contextual_mask_cluster_bf16",
                 "cic_smooth_mask_cluster"):
        getattr(lib, name).argtypes = ck._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int

    dev = torch.device("cuda")
    u8 = torch.from_numpy(structured_images(np.random.RandomState(0), 16, 256)).to(dev)
    gray = image_ops.rgb_to_gray(u8.float()).contiguous()
    spec = saliency.spectral_residual_small(gray, 64, 3.0).contiguous()
    sal = torch.rand(64, 256, 256, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    up = fm._upsample_tables(dev, 64, 64, 256, 256)
    tap_w, gk, n_taps = fm._host_filter_tables(9, 75.0, 75.0, 31)
    tap_b, gk_b, _ = fm._host_filter_tables(9, 75.0, 75.0, 31, True)  # the bf16 route's
    stream = ck.stream_ptr(dev)
    k1_plan = fm._mask_plan(256, 256, 6, 4, 31)
    k4_plan = fm._mask_plan(256, 256, 0, 4, 31)
    sizes, fm.CLUSTER_SIZES = fm.CLUSTER_SIZES, (8,)
    k1_plan8 = fm._mask_plan.__wrapped__(256, 256, 6, 4, 31)  # uncached: clusters of 8
    fm.CLUSTER_SIZES = sizes
    k1_out, k4_out = torch.empty_like(gray), torch.empty_like(sal)

    def k1(k1_plan=k1_plan, bf16=False):
        launch = lib.cic_contextual_mask_cluster_bf16 if bf16 else lib.cic_contextual_mask_cluster
        taps, g = (tap_b, gk_b) if bf16 else (tap_w, gk)
        ck.check(launch(
            gray.data_ptr(), spec.data_ptr(), 16, 256, 256, 64, 64, up[0].data_ptr(),
            up[1].data_ptr(), up[2].data_ptr(), up[3].data_ptr(), sum(1 << r for r in range(1, 7)),
            6, 0.6, 0.4, 4, taps.ctypes.data, n_taps, g.ctypes.data, 31,
            *fm._cluster_args(k1_plan), k1_out.data_ptr(), stream), "K1 (instrumented)")

    def k4():
        ck.check(lib.cic_smooth_mask_cluster(
            sal.data_ptr(), 64, 256, 256, 4, tap_w.ctypes.data, n_taps, gk.ctypes.data, 31,
            *fm._cluster_args(k4_plan), k4_out.data_ptr(), stream), "K4 (instrumented)")

    k1_want = fm.contextual_mask_plain(gray, spec)
    runs = [("K1", k1, k1_plan, 16, k1_out, k1_want, list(range(SLOTS))),
            ("K1", lambda: k1(k1_plan8), k1_plan8, 16, k1_out, k1_want, list(range(SLOTS))),
            ("K1 bf16", lambda: k1(bf16=True), k1_plan, 16, k1_out,
             fm.contextual_mask_plain(gray, spec, compute_dtype=torch.bfloat16),
             list(range(SLOTS))),
            ("K4", k4, k4_plan, 64, k4_out, fm.smooth_mask_plain(sal), [0, 5, 6, 7, 8, 9, 10, 11])]
    for name, fn, plan, batch, got, want, slots in runs:
        held = ctypes.c_int(0)
        ck.check(ck.library().cic_mask_max_clusters(
            int(name != "K4"), 256, 256, 0 if name == "K4" else 6, 4, 31, *fm._cluster_args(plan),
            ctypes.addressof(held)), "cic_mask_max_clusters")
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(30):
            fn()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / 30
        err = (got - want).abs().max().item()
        clk = np.zeros(4096 * SLOTS, np.int64)
        ck.check(lib.stage_clocks(clk.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), clk.size),
                 "stage_clocks")
        blocks = batch * plan.cluster
        c = clk[:blocks * SLOTS].reshape(blocks, SLOTS)[:, slots].astype(np.float64)
        cycles = np.diff(c, axis=1).mean(0)
        labels = K1_STAGES[4:] if name == "K4" else K1_STAGES
        print(f"{name} B={batch} 256x256, {plan.cluster} blocks x {plan.rows} rows per image "
              f"({held.value} such clusters at once): "
              f"{ms:.4f} ms a call, max |kernel - twin| {err:.2e}; a block's mean cycles "
              f"{(c[:, -1] - c[:, 0]).mean():.0f}: "
              + ", ".join(f"{label} {v:.0f}" for label, v in zip(labels, cycles)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
