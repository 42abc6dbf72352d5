// K8: the generator's fused inference tail
//   z = LeakyReLU(deconv4x4s2(x, W_folded) + shift), zero outside the image,
//   out = tanh(conv4x4 SAME(z, W_out) + bias)
// in one kernel, the phase-planar intermediate kept in shared memory.
//
// Replaces contextual_image_compression_tpu/models/packed_tail.py::
// fused_tail_pallas (reached by packed_tail_forward(use_pallas=True)).
//
// Layouts. x is the port's NCHW activation (B, Cin, H, W); out is NCHW
// (B, Co, 2H, 2W), so the TPU's depth_to_space4 folds into the store. The
// deconv runs phase-planar as on the TPU: planar entry (m, j) with slab
// (a, b) is output pixel (2m - a, 2j - b), and all four slabs at (m, j) read
// the same 2 x 2 window x[m - 1 .. m, j - 1 .. j] (tap (r, s) reads
// x[m + r - 1, j + s - 1]). The wrapper packs the port's flipped
// conv_transpose2d weight (Cin, Cmid, 4, 4) into wpk[r * 2 + s][ci][n],
// n = (a * 2 + b) * Cmid + o, from kernel index (3 - a - 2r, 3 - b - 2s).
//
// Rounding kept from the TPU kernel (identity in float32): each of the four
// tap products is a float32 sum over Cin rounded to the dtype and added into
// a dtype accumulator in the TPU loop order (r = 0 first; within r = 1 the
// tap s = 1 first on even planar columns, s = 0 first on odd ones; within
// r = 0 the order cannot matter); then + shift in the dtype, LeakyReLU in
// float32 rounded to the dtype, zeros at the out-of-range pixels -1 and 2H
// (they must read as zero in the out-conv, not as LeakyReLU(shift)); the
// out-conv accumulates in float32, adds the float32 bias and takes tanhf.
//
// Design. One block of 320 threads per image per 16 x 16 output pixels. The
// tile reads planar rows and columns 8t .. 8t + 9 (10 x 10 positions x 4
// slabs x Cmid, the 4.1 MB planar tensor of a full image never exists) from
// an 11 x 11 x Cin x tile in shared memory; warp w owns planar column w and
// all ten rows, lane l four planar channels, so the x reads of a warp are one
// broadcast and each (ci) step is 40 FMAs for 4 + 10 shared loads. The halo
// costs 100 planar positions for 64 useful ones. Bound on the H100 at
// B = 16, Cin 128, 128^2 -> 256^2, Cmid 32, Co 3: 34.4 + 3.2 GFLOP of useful
// products, operation-bound on the bf16 tensor cores (0.038 ms); this first
// version runs on float32 CUDA cores.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int TILE = 16;         // output pixels per tile side
constexpr int PL = TILE / 2 + 2; // planar positions per tile side (10)
constexpr int XT = PL + 1;       // x rows / cols per tile side (11)
constexpr int THREADS = 32 * PL; // one warp per planar column
constexpr int CIN_MAX = 128;
constexpr int NC_MAX = 128;      // 4 slabs x Cmid
constexpr int CO_MAX = 4;

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T>
__host__ __device__ size_t smem_bytes(int Cin, int NC, int Co, int Cmid) {
  return align16((size_t)Cin * XT * XT * sizeof(T)) + align16((size_t)Cin * NC * sizeof(T)) +
         align16((size_t)PL * PL * NC * sizeof(T)) + (size_t)Co * Cmid * 16 * sizeof(float);
}

template <typename T>
__device__ __forceinline__ float add_round(float a, float b) {
  return cic::round_to<T>(a + b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tail_kernel(const T* __restrict__ x, const T* __restrict__ wpk, const T* __restrict__ shift,
            const T* __restrict__ wo, const float* __restrict__ bias, T* __restrict__ out,
            int Cin, int H, int W, int Cmid, int Co, float slope) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int NC = 4 * Cmid;
  T* xs = reinterpret_cast<T*>(raw);                                      // [Cin][XT][XT]
  T* ws = reinterpret_cast<T*>(raw + align16((size_t)Cin * XT * XT * sizeof(T)));  // [Cin][NC]
  T* ys = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(ws) +
                               align16((size_t)Cin * NC * sizeof(T)));    // [PL][PL][NC]
  float* wos = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ys) +
                                        align16((size_t)PL * PL * NC * sizeof(T)));  // [Co][Cmid][4][4]

  const int b = blockIdx.z;
  const int M0 = blockIdx.y * (TILE / 2), J0 = blockIdx.x * (TILE / 2);
  const int tid = threadIdx.x;
  const int jl = tid / 32, cg = tid % 32;
  const bool active = cg * 4 < NC;
  const int j = J0 + jl;  // global planar column of this warp

  // x tile rows M0 - 1 .. M0 + 9, columns J0 - 1 .. J0 + 9, zero outside the image
  const T* xb = x + (size_t)b * Cin * H * W;
  for (int i = tid; i < Cin * XT * XT; i += THREADS) {
    const int ci = i / (XT * XT), rem = i % (XT * XT), rr = rem / XT, cc = rem % XT;
    const int row = M0 - 1 + rr, col = J0 - 1 + cc;
    xs[i] = (row >= 0 && row < H && col >= 0 && col < W)
                ? xb[((size_t)ci * H + row) * W + col]
                : cic::from_f32<T>(0.f);
  }
  for (int i = tid; i < Co * Cmid * 16; i += THREADS) wos[i] = cic::to_f32(wo[i]);

  float Y[PL][4], acc[PL][4];
  for (int t = 0; t < 4; ++t) {
    const int r = t / 2, s = t % 2;
    __syncthreads();  // the previous tap's weights are consumed
    for (int i = tid; i < Cin * NC; i += THREADS) ws[i] = wpk[(size_t)t * Cin * NC + i];
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int ml = 0; ml < PL; ++ml)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[ml][k] = 0.f;
#pragma unroll 2
    for (int ci = 0; ci < Cin; ++ci) {
      const T* wrow = ws + ci * NC + cg * 4;
      const float w4[4] = {cic::to_f32(wrow[0]), cic::to_f32(wrow[1]), cic::to_f32(wrow[2]),
                           cic::to_f32(wrow[3])};
      const T* xcol = xs + (ci * XT + r) * XT + jl + s;
#pragma unroll
      for (int ml = 0; ml < PL; ++ml) {
        const float xv = cic::to_f32(xcol[ml * XT]);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[ml][k] += xv * w4[k];
      }
    }
#pragma unroll
    for (int ml = 0; ml < PL; ++ml) {
      T* slot = ys + (ml * PL + jl) * NC + cg * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float p = cic::round_to<T>(acc[ml][k]);
        if (t == 0) {
          Y[ml][k] = p;
        } else if (t == 1) {
          Y[ml][k] = add_round<T>(Y[ml][k], p);
        } else if (t == 2) {
          slot[k] = cic::from_f32<T>(p);  // P(1, 0), combined after P(1, 1)
        } else {
          const float p10 = cic::to_f32(slot[k]);
          Y[ml][k] = (j % 2 == 0) ? add_round<T>(add_round<T>(Y[ml][k], p), p10)
                                  : add_round<T>(add_round<T>(Y[ml][k], p10), p);
        }
      }
    }
  }

  // + shift, LeakyReLU, zeros at the out-of-range pixels, into the planar tile
  if (active) {
#pragma unroll
    for (int ml = 0; ml < PL; ++ml) {
      const int m = M0 + ml;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = cg * 4 + k, slab = n / Cmid, o = n % Cmid;
        const int P = 2 * m - slab / 2, Q = 2 * j - slab % 2;
        float v = add_round<T>(Y[ml][k], cic::to_f32(shift[o]));
        v = cic::round_to<T>(v >= 0.f ? v : slope * v);
        if (P < 0 || P >= 2 * H || Q < 0 || Q >= 2 * W) v = 0.f;
        ys[(ml * PL + jl) * NC + n] = cic::from_f32<T>(v);
      }
    }
  }
  __syncthreads();

  // out-conv: pixel (p, q) reads z[p - 1 .. p + 2, q - 1 .. q + 2]
  if (tid >= TILE * TILE) return;
  const int p = blockIdx.y * TILE + tid / TILE, q = blockIdx.x * TILE + tid % TILE;
  if (p >= 2 * H || q >= 2 * W) return;
  float o[CO_MAX];
#pragma unroll
  for (int co = 0; co < CO_MAX; ++co) o[co] = 0.f;
  for (int dy = 0; dy < 4; ++dy) {
    const int P = p - 1 + dy, ml = ((P + 1) >> 1) - M0, a = P & 1;
    for (int dx = 0; dx < 4; ++dx) {
      const int Q = q - 1 + dx, jq = ((Q + 1) >> 1) - J0, bb = Q & 1;
      const T* z = ys + (ml * PL + jq) * NC + (a * 2 + bb) * Cmid;
      for (int c = 0; c < Cmid; ++c) {
        const float zv = cic::to_f32(z[c]);
#pragma unroll
        for (int co = 0; co < CO_MAX; ++co)
          if (co < Co) o[co] += zv * wos[((co * Cmid + c) * 4 + dy) * 4 + dx];
      }
    }
  }
  const size_t plane = (size_t)4 * H * W;
#pragma unroll
  for (int co = 0; co < CO_MAX; ++co)
    if (co < Co)
      out[((size_t)b * Co + co) * plane + (size_t)p * 2 * W + q] =
          cic::from_f32<T>(tanhf(o[co] + bias[co]));
}

template <typename T>
int launch(const void* x, const void* wpk, const void* shift, const void* wo, const float* bias,
           void* out, int B, int Cin, int H, int W, int Cmid, int Co, float slope,
           cudaStream_t st) {
  const size_t smem = smem_bytes<T>(Cin, 4 * Cmid, Co, Cmid);
  cudaError_t err = cudaFuncSetAttribute(tail_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((2 * W + TILE - 1) / TILE, (2 * H + TILE - 1) / TILE, B);
  tail_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wpk), static_cast<const T*>(shift),
      static_cast<const T*>(wo), bias, static_cast<T*>(out), Cin, H, W, Cmid, Co, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wpk, shift, wo, out). x: (B, Cin, H, W);
// wpk: (4, Cin, 4 * Cmid) packed deconv taps with BatchNorm folded in;
// shift: (Cmid,); wo: (Co, Cmid, 4, 4); bias: (Co,) float32; out:
// (B, Co, 2H, 2W). Takes Cin <= 128, Cmid <= 32, Co <= 4.
extern "C" int cic_packed_tail(int dtype, const void* x, const void* wpk, const void* shift,
                               const void* wo, const float* bias, void* out, int B, int Cin, int H,
                               int W, int Cmid, int Co, float slope, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cin > CIN_MAX || Cmid < 1 || 4 * Cmid > NC_MAX ||
      Co < 1 || Co > CO_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, wpk, shift, wo, bias, out, B, Cin, H, W, Cmid, Co, slope, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wpk, shift, wo, bias, out, B, Cin, H, W, Cmid, Co, slope, st);
  return (int)cudaErrorInvalidValue;
}
