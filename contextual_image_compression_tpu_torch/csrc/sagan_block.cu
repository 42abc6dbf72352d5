// K7a / K7b: the whole SAGAN block
//   out = gamma * softmax((x Wq + bq)(x Wk + bk)^T)(x Wv + bv) + x
// for both views of the input, as one kernel pair with element strides.
//
// Replaces contextual_image_compression_tpu/ops/attention.py::
// sagan_block_pallas (body _qkv_attn_kernel, the (B, N, C) view) and
// sagan_block_spatial_pallas (body _qkv_attn_kernel_nbc, the (B, H, W, C)
// view read as (HW, B, C) on the TPU to spare XLA a relayout). On the card
// the input is read in place through its (batch, position, channel) strides:
// a contiguous (B, N, C), a contiguous (B, H, W, C) and the port's NCHW
// activation seen as x.permute(0, 2, 3, 1) all come without a copy, and the
// output is written with the strides the caller gives (its input's layout).
//
// Rounding kept from the TPU kernel: each projection accumulates x . W in
// float32 over the channels, adds the float32 bias and rounds to x's dtype;
// then K2's attention (attention.cuh) with the residual x itself and the
// epilogue (gamma * (1 / l)) * ctx + x in float32.
//
// Design. The TPU kernel caches one image's K and V in VMEM across its query
// blocks. A 1024 x (32 + 256) bf16 K/V is 590 KB, too big for one block's
// 227 KB of shared memory, and recomputing it per 64-key tile in each of an
// image's 16 query blocks would redo the 2.4 GFLOP projection 16 times. So a
// first launch (kv_proj_kernel, a 64 x 64 tiled float32 GEMM) writes K and V
// to a per-image scratch of (N, DK) + (N, DV) in x's dtype, 9.4 MB at B = 16,
// which stays in the 50 MB L2; the second launch (sagan_attn_kernel) projects
// its own 64-row q tile from x in its prologue and runs the flash loop over
// the scratch. Bound on the H100 at B = 16, N = 1024, C = 256: 2.68 GFLOP of
// projections + 9.66 GFLOP of attention, operation-bound on the bf16 tensor
// cores; this first version runs on float32 CUDA cores.

#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "common.cuh"

namespace {

using namespace cic::attn;

constexpr int PT = 64;   // GEMM tile rows (positions) and columns (outputs)
constexpr int PKC = 16;  // GEMM depth chunk (channels)

// K and V of every image: rows n of image b, columns j < DK -> K, else V.
template <typename T>
__global__ void __launch_bounds__(256)
kv_proj_kernel(const T* __restrict__ x, long long sxb, long long sxn, long long sxc,
               const T* __restrict__ wk, const float* __restrict__ bk,
               const T* __restrict__ wv, const float* __restrict__ bv,
               T* __restrict__ kout, T* __restrict__ vout, int N, int C, int DK, int DV) {
  __shared__ __align__(16) float As[PKC][PT];
  __shared__ __align__(16) float Bs[PKC][PT];
  const int b = blockIdx.z, n0 = blockIdx.x * PT, j0 = blockIdx.y * PT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int DKV = DK + DV;
  const bool pos_fast = sxn < sxc;
  const T* xb = x + b * sxb;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += PKC) {
    for (int i = tid; i < PT * PKC; i += 256) {
      int r, kk;
      if (pos_fast) { kk = i / PT; r = i % PT; } else { r = i / PKC; kk = i % PKC; }
      const int n = n0 + r, c = c0 + kk;
      As[kk][r] = (n < N && c < C) ? cic::to_f32(xb[n * sxn + c * sxc]) : 0.f;
    }
    for (int i = tid; i < PT * PKC; i += 256) {
      const int kk = i / PT, jj = i % PT, c = c0 + kk, j = j0 + jj;
      float w = 0.f;
      if (c < C) {
        if (j < DK) w = cic::to_f32(wk[(size_t)c * DK + j]);
        else if (j < DKV) w = cic::to_f32(wv[(size_t)c * DV + (j - DK)]);
      }
      Bs[kk][jj] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PKC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv4[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv4[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx * 4 + j;
      if (col < DK) {
        kout[((size_t)b * N + n) * DK + col] = cic::from_f32<T>(acc[i][j] + bk[col]);
      } else if (col < DKV) {
        const int cv = col - DK;
        vout[((size_t)b * N + n) * DV + cv] = cic::from_f32<T>(acc[i][j] + bv[cv]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sagan_attn_kernel(const T* __restrict__ x, long long sxb, long long sxn, long long sxc,
                  const T* __restrict__ wq, const float* __restrict__ bq,
                  const T* __restrict__ kbuf, const T* __restrict__ vbuf,
                  const float* __restrict__ gamma, T* __restrict__ out,
                  long long sob, long long son, long long soc, int N, int DK, int DV) {
  extern __shared__ float smem[];
  const Tiles s = carve(smem);
  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const int nchunks = DV / 64;
  const int C = DV;  // the residual needs as many value columns as input channels
  const bool pos_fast = sxn < sxc;
  const T* xb = x + b * sxb;

  // prologue: the x tile (BQ x C) into the Vs region, then q = round(x Wq + bq)
  float* xs = s.Vs;
  for (int i = tid; i < BQ * C; i += THREADS) {
    int r, c;
    if (pos_fast) { c = i / BQ; r = i % BQ; } else { r = i / C; c = i % C; }
    const int n = q0 + r;
    xs[r * DV_MAX + c] = n < N ? cic::to_f32(xb[n * sxn + c * sxc]) : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < BQ * DK; i += THREADS) {
    const int r = i / DK, f = i % DK;
    float a = 0.f;
    for (int c = 0; c < C; ++c) a += xs[r * DV_MAX + c] * cic::to_f32(wq[(size_t)c * DK + f]);
    s.Qt[f * BQ + r] = cic::round_to<T>(a + bq[f]);
  }
  // flash_loop's first barrier orders these reads of xs before its V loads

  float m[4], l[4], acc[4][16];
  flash_loop<T>(s, kbuf + (size_t)b * N * DK, vbuf + (size_t)b * N * DV, N, DK, DV, m, l, acc);

  const float g = *gamma;
  T* ob = out + b * sob;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + rg * 4 + i;
    if (n >= N) continue;
    const float scale = g * (1.0f / l[i]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= nchunks) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 64 + cg * 4 + e;
        const float xr = cic::to_f32(xb[n * sxn + col * sxc]);
        ob[n * son + col * soc] = cic::from_f32<T>(scale * acc[i][c * 4 + e] + xr);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const long long* sx, const void* wq, const float* bq, const void* wk,
           const float* bk, const void* wv, const float* bv, const float* gamma, void* kbuf,
           void* vbuf, void* out, const long long* so, int B, int N, int C, int DK, int DV,
           cudaStream_t st) {  // sx, so: host arrays of three element strides
  const dim3 pgrid((N + PT - 1) / PT, (DK + DV + PT - 1) / PT, B);
  kv_proj_kernel<T><<<pgrid, 256, 0, st>>>(
      static_cast<const T*>(x), sx[0], sx[1], sx[2], static_cast<const T*>(wk), bk,
      static_cast<const T*>(wv), bv, static_cast<T*>(kbuf), static_cast<T*>(vbuf), N, C, DK, DV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  err = cudaFuncSetAttribute(sagan_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BQ - 1) / BQ, B);
  sagan_attn_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), sx[0], sx[1], sx[2], static_cast<const T*>(wq), bq,
      static_cast<const T*>(kbuf), static_cast<const T*>(vbuf), gamma, static_cast<T*>(out),
      so[0], so[1], so[2], N, DK, DV);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, the weights, the scratch and out).
// x: (B, N, C) read at element strides sxb, sxn, sxc (batch, position, channel);
// wq, wk: (C, DK) and wv: (C, DV) row-major (in, out); bq, bk, bv float32;
// gamma: one float32 on the device; kbuf (B, N, DK) and vbuf (B, N, DV)
// contiguous scratch; out: (B, N, DV) written at element strides sob, son, soc.
// DV must equal C (the residual), DK <= 64, DV in 64..256 in steps of 64.
extern "C" int cic_sagan_block(int dtype, const void* x, long long sxb, long long sxn,
                               long long sxc, const void* wq, const float* bq, const void* wk,
                               const float* bk, const void* wv, const float* bv,
                               const float* gamma, void* kbuf, void* vbuf, void* out,
                               long long sob, long long son, long long soc, int B, int N, int C,
                               int DK, int DV, void* stream) {
  const long long sx[3] = {sxb, sxn, sxc};
  const long long so[3] = {sob, son, soc};
  if (DK < 1 || DK > DK_MAX || DV != C || DV < 64 || DV > DV_MAX || DV % 64 != 0 || N < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, sx, wq, bq, wk, bk, wv, bv, gamma, kbuf, vbuf, out, so, B, N, C, DK,
                         DV, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, sx, wq, bq, wk, bk, wv, bv, gamma, kbuf, vbuf, out, so, B, N,
                                 C, DK, DV, st);
  return (int)cudaErrorInvalidValue;
}
