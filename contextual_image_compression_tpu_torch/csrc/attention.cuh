// The constants and declarations shared by K2 / K6 (attention.cu) and K7
// (sagan_block.cu), and the flash-style attention loop of K7's float32 route.
//
// A block of THREADS threads owns BQ = 64 query rows of one image. It walks
// the image's keys in tiles of BK = 64 through shared memory and keeps an
// online softmax (float32 running max m and sum l) and a 64 x DV float32
// accumulator in registers (4 query rows x 16 output columns per thread), so
// the N x N scores never reach device memory. The TPU kernels' rounding is
// kept: scores in float32, the numerator e = exp(s - max) rounded to V's dtype
// before the e.V product while the row sum uses the unrounded float32 e, and
// normalization left to the caller's epilogue (after the product).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace cic {
namespace attn {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int DK_MAX = 64;   // largest q/k width taken
constexpr int DV_MAX = 256;  // largest v width taken (multiple of 64)
constexpr int THREADS = 256;
constexpr size_t SMEM_FLOATS = DK_MAX * BQ + DK_MAX * BK + BK * DV_MAX + BK * BQ;

// Element strides (batch, position, channel) of a residual and an output.
struct Strides {
  long long rb, rn, rc, ob, on, oc;
};

// K2's bf16 tensor-core kernel (attention.cu) on contiguous bf16 q, k
// (B, N, DK) and v (B, N, DV), with the residual read and the output written
// contiguous (B, N, DV) (strides null; out 16-byte aligned) or at the given
// element strides; K7's second launch.
int tc_block(const void* q, const void* k, const void* v, const void* res, const float* gamma,
             void* out, int B, int N, int DK, int DV, const Strides* strides,
             cudaStream_t stream);

struct Tiles {
  float* Qt;  // [DK_MAX][BQ]  (transposed q tile, filled by the caller)
  float* Kt;  // [DK_MAX][BK]  (transposed)
  float* Vs;  // [BK][DV_MAX]
  float* Pt;  // [BK][BQ]      (transposed probabilities)
};

__device__ __forceinline__ Tiles carve(float* smem) {
  Tiles t;
  t.Qt = smem;
  t.Kt = t.Qt + DK_MAX * BQ;
  t.Vs = t.Kt + DK_MAX * BK;
  t.Pt = t.Vs + BK * DV_MAX;
  return t;
}

// One query tile against all N keys of one image. kb: (N, DK) and vb: (N, DV)
// contiguous rows. The caller has written its tile into s.Qt; the loop's
// first barrier makes it visible (and lets the caller use s.Vs as scratch
// before the call). On return m, l and acc hold this thread's running max,
// row sum and unnormalized e.V for query rows (tid / 16) * 4 .. + 3 and
// output columns c * 64 + (tid % 16) * 4 + e, c < DV / 64.
template <typename T>
__device__ __forceinline__ void flash_loop(const Tiles& s, const T* __restrict__ kb,
                                           const T* __restrict__ vb, int N, int DK, int DV,
                                           float (&m)[4], float (&l)[4], float (&acc)[4][16]) {
  const int tid = threadIdx.x;
  const int rg = tid / 16;
  const int cg = tid % 16;
  const int nchunks = DV / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous tile's Kt, Vs and Pt are consumed
    for (int i = tid; i < BK * DK; i += THREADS) {
      const int r = i / DK, d = i % DK, n = k0 + r;
      s.Kt[d * BK + r] = n < N ? to_f32(kb[(size_t)n * DK + d]) : 0.f;
    }
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int r = i / DV, c = i % DV, n = k0 + r;
      s.Vs[r * DV_MAX + c] = n < N ? to_f32(vb[(size_t)n * DV + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < DK; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&s.Qt[d * BQ + rg * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&s.Kt[d * BK + cg * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + cg * 4 + j >= N)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i][j] = -INFINITY;

    // online softmax; the 16 threads of a row group are 16 consecutive lanes
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(sc[i][j] - m_new);
        rowsum += e;
        p[i][j] = round_to<T>(e);  // e.astype(v.dtype) for the e.V product
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rowsum += __shfl_xor_sync(0xffffffffu, rowsum, o);
      l[i] = l[i] * alpha + rowsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&s.Pt[(cg * 4 + j) * BQ + rg * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    const int kmax = min(BK, N - k0);
    for (int j = 0; j < kmax; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&s.Pt[j * BQ + rg * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < nchunks) {
          const float4 va = *reinterpret_cast<const float4*>(&s.Vs[j * DV_MAX + c * 64 + cg * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c * 4 + 0] += pv[i] * va.x;
            acc[i][c * 4 + 1] += pv[i] * va.y;
            acc[i][c * 4 + 2] += pv[i] * va.z;
            acc[i][c * 4 + 3] += pv[i] * va.w;
          }
        }
      }
    }
  }
}

}  // namespace attn
}  // namespace cic
