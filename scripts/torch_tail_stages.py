"""Where the K8 (fused generator tail, bf16 and float32) and bf16 K7 (fused
SAGAN block) kernels' time goes, on one GPU.

    python3 scripts/torch_tail_stages.py

Copies csrc/packed_tail.cu and csrc/sagan_block.cu (with csrc/attention.cu),
inserts clock64() reads by thread 0 of every block at the phase boundaries
of tail_tc_kernel, tail_tf32_kernel and qkv_proj_kernel, builds the copies
with nvcc into
their own libraries (the port's library is not touched) and runs them at
the entry points' full-width shapes with seeded inputs:

  K8 on a (16, 128, 128, 128) bf16 input, Cmid 32, Co 3: per tile of a
     block, the mean cycles of stage A (the four tap products and their
     combine), the activation pass, stage B (the out-conv; the next tile's
     window loads are started before it) and the window store (which waits
     for those loads);
  K8 in float32 (three TF32 passes) on the same shapes: per tile and
     consumer warpgroup, the mean cycles of waiting for the window, stage
     A, the planar store, stage B (the T GEMM and each output's tap sum)
     and the output store;
  K7 on a (16, 1024, 256) bf16 activation, C/8 = 32, as the (B, N, C) view
     and as the NCHW view: per block of the QKV GEMM, the mean cycles of
     staging x and W, the products and the epilogue; and the device time of
     each of K7's two kernels (torch.profiler).

It prints the card, each instrumented call's time on the device alone
(`measure.device_ms`) and the cycles. The phase boundaries are found by
exact source lines; the script fails if one is missing, so a change to
those lines needs the same change here. It needs a CUDA device and the
CUDA toolkit and exits 1 without them.
"""

import ctypes
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "contextual_image_compression_tpu_torch" / "csrc"

COUNTERS = '''
__device__ unsigned long long g_prof[8];
extern "C" int cic_prof_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
}
extern "C" int cic_prof_zero() {
  unsigned long long z[8] = {};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''
STAMP = "{{ unsigned long long t = clock64(); ph[{k}] += t - tp; tp = t; }}\n"

# K8: (source text, text put in its place); slot 4 counts blocks
TAIL_MARKS = [
    ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n' + COUNTERS),
    ("  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {\n",
     "  unsigned long long ph[4] = {0, 0, 0, 0}, tp = clock64();\n"
     "  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {\n"),
    ("    __syncthreads();  // the window is in; the last tile's planar tile is read out\n",
     "    __syncthreads();  // the window is in; the last tile's planar tile is read out\n    "
     + STAMP.format(k=3)),
    ("      }\n    }\n    __syncthreads();\n\n    // + shift, LeakyReLU",
     "      }\n    }\n    __syncthreads();\n    " + STAMP.format(k=0) + "\n    // + shift, LeakyReLU"),
    ("    __syncthreads();  // the planar tile is in; the window is free\n",
     "    __syncthreads();  // the planar tile is in; the window is free\n    " + STAMP.format(k=1)),
    ("    if (next < total) store_window(win, xs, ltid, cin_pad, L.xs_stride);\n  }\n}",
     "    __syncthreads();\n    " + STAMP.format(k=2)
     + "    if (next < total) store_window(win, xs, ltid, cin_pad, L.xs_stride);\n  }\n"
       "  if (threadIdx.x == 0) {\n    for (int k = 0; k < 4; ++k) atomicAdd(&g_prof[k], ph[k]);\n"
       "    atomicAdd(&g_prof[4], 1ull);\n  }\n}"),
]
TAIL_PHASES = ["stage A", "activation", "stage B (+ starting the next window's loads)",
               "window store (+ waiting for its loads)"]

# K8 float32 (the same copy): per consumer warpgroup's thread 0; slot 5
# counts tiles x warpgroups
TAIL32_MARKS = [
    ("  int chunk = 0, k = 0;\n  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++k) {\n",
     "  unsigned long long ph[5] = {0, 0, 0, 0, 0}, tp = clock64();\n"
     "  int chunk = 0, k = 0;\n  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++k) {\n"),
    ("    mbar_wait(wfull, k & 1);\n", "    mbar_wait(wfull, k & 1);\n    " + STAMP.format(k=0)),
    ("    // both warpgroups are done with the window: the planar tile takes its place\n",
     "    " + STAMP.format(k=1)
     + "    // both warpgroups are done with the window: the planar tile takes its place\n"),
    ("    store_planar(z, y, 1, prow, pcol, qd, M0, J0, H, W, shs, slope);\n    bar_sync(1, CONSUMERS);\n",
     "    store_planar(z, y, 1, prow, pcol, qd, M0, J0, H, W, shs, slope);\n"
     "    bar_sync(1, CONSUMERS);\n    " + STAMP.format(k=2)),
    ("    // + bias, tanh, the NCHW store\n", "    " + STAMP.format(k=3) + "    // + bias, tanh, the NCHW store\n"),
    ("              tanhf(__fadd_rn(osum[h][co], bs[co]));\n    }\n  }\n}\n",
     "              tanhf(__fadd_rn(osum[h][co], bs[co]));\n    }\n    " + STAMP.format(k=4) + "  }\n"
     "  if ((tid & 127) == 0) {\n    for (int q = 0; q < 5; ++q) atomicAdd(&g_prof[q], ph[q]);\n"
     "    atomicAdd(&g_prof[5], (unsigned long long)k);\n  }\n}\n"),
]
TAIL32_PHASES = ["window wait", "stage A", "planar store", "stage B", "output store"]

# K7's GEMM; slot 4 counts blocks
GEMM_MARKS = [
    ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n' + COUNTERS),
    ("  const uint16_t* ws = reinterpret_cast<const uint16_t*>(wqkv);\n",
     "  const uint16_t* ws = reinterpret_cast<const uint16_t*>(wqkv);\n"
     "  unsigned long long ph[3] = {0, 0, 0}, tp = clock64();\n"),
    ("  fence_proxy_async();\n  __syncthreads();\n\n  float d[32];",
     "  fence_proxy_async();\n  __syncthreads();\n  " + STAMP.format(k=0) + "\n  float d[32];"),
    ("  wgmma_commit();\n  wgmma_wait_all();\n  fence_regs(d);\n",
     "  wgmma_commit();\n  wgmma_wait_all();\n  fence_regs(d);\n  " + STAMP.format(k=1)),
    ("        if (col + e < nout) *dest(g, col + e) = (uint16_t)(w[e >> 1] >> (16 * (e & 1)));\n"
     "    }\n  }\n}\n",
     "        if (col + e < nout) *dest(g, col + e) = (uint16_t)(w[e >> 1] >> (16 * (e & 1)));\n"
     "    }\n  }\n  __syncthreads();\n  " + STAMP.format(k=2)
     + "  if (threadIdx.x == 0) {\n    for (int k = 0; k < 3; ++k) atomicAdd(&g_prof[k], ph[k]);\n"
       "    atomicAdd(&g_prof[4], 1ull);\n  }\n}\n"),
]
GEMM_PHASES = ["staging x and W", "products", "epilogue"]


def instrument(text, marks):
    for old, new in marks:
        if text.count(old) != 1:
            raise RuntimeError(f"phase marker not found once in the source: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def build(out_dir, name, sources):
    from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck

    lib = out_dir / f"{name}.so"
    cmd = [ck._nvcc(), *ck.NVCC_FLAGS, "-shared", "-I", str(CSRC), *map(str, sources),
           "-o", str(lib)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout[-4000:]}")
    return ctypes.CDLL(str(lib))


def read(lib):
    buf = (ctypes.c_ulonglong * 8)()
    if lib.cic_prof_read(ctypes.byref(buf)) != 0:
        raise RuntimeError("reading the cycle counters failed")
    return np.array(buf[:], dtype=np.float64)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from contextual_image_compression_tpu_torch.measure import card_name_and_power, device_ms
    from contextual_image_compression_tpu_torch.ops.attention import _pack_qkv
    from contextual_image_compression_tpu_torch.ops.generator_tail import (
        _pack_out_conv_tf32, _pack_tap_tiles, _pack_taps_tf32, tc_tile_grid)

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_name_and_power(), flush=True)
    out_dir = Path(tempfile.mkdtemp(prefix="tail_stages-"))
    tail_src = out_dir / "packed_tail_stages.cu"
    tail_src.write_text(instrument((CSRC / "packed_tail.cu").read_text(),
                                   TAIL_MARKS + TAIL32_MARKS))
    gemm_src = out_dir / "sagan_block_stages.cu"
    gemm_src.write_text(instrument((CSRC / "sagan_block.cu").read_text(), GEMM_MARKS))
    tail = build(out_dir, "tail_stages", [tail_src])
    gemm = build(out_dir, "gemm_stages", [gemm_src, CSRC / "attention.cu"])
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tail.cic_packed_tail_bf16.argtypes = [P] * 6 + [I] * 6 + [ctypes.c_float, P]
    tail.cic_packed_tail.argtypes = [P] * 6 + [I] * 6 + [ctypes.c_float, P]
    gemm.cic_sagan_block_bf16.argtypes = [P, L, L, L, P, P, P, P, P, P, P, L, L, L, I, I, I, I, P]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, scale=0.1):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    bf = torch.bfloat16
    B, cin, h, cmid, co = 16, 128, 128, 32, 3
    x = r(B, cin, h, h, scale=0.5).to(bf)
    tiles, shift = _pack_tap_tiles(r(cin, cmid, 4, 4).to(bf)), r(cmid).to(bf)
    wo, bias = r(co, cmid, 4, 4).to(bf), r(co)
    out = torch.empty(B, co, 2 * h, 2 * h, device=dev, dtype=bf)

    def k8():
        err = tail.cic_packed_tail_bf16(x.data_ptr(), tiles.data_ptr(), shift.data_ptr(),
                                        wo.data_ptr(), bias.data_ptr(), out.data_ptr(), B, cin,
                                        h, h, cmid, co, 0.2, stream)
        if err:
            raise RuntimeError(f"instrumented K8 failed with cudaError_t {err}")

    k8()
    ms = device_ms(k8)
    tail.cic_prof_zero()
    k8()
    torch.cuda.synchronize()
    v = read(tail)
    ty, tx, _, _ = tc_tile_grid(h, h)
    per_tile = v[4] / (B * ty * tx)  # blocks / tiles: a block's share of one tile
    cyc = ", ".join(f"{name} {v[k] / v[4] * per_tile:.0f}" for k, name in enumerate(TAIL_PHASES))
    print(f"K8 bf16 x {(B, cin, h, h)}: instrumented call {ms:.4f} ms on the device; "
          f"{v[4]:.0f} blocks; mean cycles a tile: {cyc}", flush=True)

    x32 = x.float()
    taps32 = _pack_taps_tf32(r(cin, cmid, 4, 4))
    wo32 = _pack_out_conv_tf32(r(co, cmid, 4, 4))
    shift32 = torch.nn.functional.pad(r(cmid), (0, 32 - cmid))
    bias32 = torch.nn.functional.pad(bias, (0, 8 - co))
    out32 = torch.empty(B, co, 2 * h, 2 * h, device=dev)

    def k8_f32():
        err = tail.cic_packed_tail(x32.data_ptr(), taps32.data_ptr(), shift32.data_ptr(),
                                   wo32.data_ptr(), bias32.data_ptr(), out32.data_ptr(), B, cin,
                                   h, h, cmid, co, 0.2, stream)
        if err:
            raise RuntimeError(f"instrumented K8 float32 failed with cudaError_t {err}")

    k8_f32()
    ms = device_ms(k8_f32)
    tail.cic_prof_zero()
    k8_f32()
    torch.cuda.synchronize()
    v = read(tail)
    cyc = ", ".join(f"{name} {v[k] / v[5]:.0f}" for k, name in enumerate(TAIL32_PHASES))
    print(f"K8 float32 x {(B, cin, h, h)}: instrumented call {ms:.4f} ms on the device; "
          f"mean cycles a tile and consumer warpgroup: {cyc}", flush=True)

    C, inner, N = 256, 32, 1024
    wqkv, qkv_bias = _pack_qkv(r(C, inner), r(inner), r(C, inner), r(inner), r(C, C), r(C), bf)
    g = torch.tensor([0.5], device=dev)
    scratch = torch.empty(B * N * (2 * inner + C), device=dev, dtype=bf)
    views = {"(B, N, C)": r(B, N, C, scale=0.5).to(bf),
             "NCHW": r(B, C, N, scale=0.5).to(bf).permute(0, 2, 1)}
    for name, xv in views.items():
        o = torch.empty_like(xv)
        sx, so, q = xv.stride(), o.stride(), scratch.data_ptr()

        def k7():
            err = gemm.cic_sagan_block_bf16(
                xv.data_ptr(), *sx, wqkv.data_ptr(), qkv_bias.data_ptr(), g.data_ptr(), q,
                q + B * N * inner * 2, q + 2 * B * N * inner * 2, o.data_ptr(), *so, B, N, C,
                inner, stream)
            if err:
                raise RuntimeError(f"instrumented K7 failed with cudaError_t {err}")

        k7()
        ms = device_ms(k7)
        gemm.cic_prof_zero()
        k7()
        torch.cuda.synchronize()
        v = read(gemm)
        cyc = ", ".join(f"{p} {v[k] / v[4]:.0f}" for k, p in enumerate(GEMM_PHASES))
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                k7()
            torch.cuda.synchronize()
        kernels = ", ".join(f"{re.search(r'\w*kernel\w*', e.key).group(0)} "
                            f"{e.device_time_total / e.count:.2f} us"
                            for e in prof.key_averages()
                            if e.device_time_total > 0 and re.search(r"\w*kernel\w*", e.key))
        print(f"K7 bf16 {name} view {(B, N, C)}: instrumented call {ms:.4f} ms on the device; "
              f"QKV GEMM {v[4]:.0f} blocks, mean cycles a block: {cyc}; kernels (torch.profiler): "
              f"{kernels}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
