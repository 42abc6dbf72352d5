// K2: the SAGAN attention block  out = gamma * softmax(Q K^T) V + residual,
// and K6: the attention core  out = softmax(Q K^T) V, as one kernel.
//
// K2 replaces contextual_image_compression_tpu/ops/attention.py::
// attention_block_pallas (forward _attention_pallas_fwd, body
// _attn_block_kernel); K6 replaces attention_core_pallas (body _attn_kernel),
// which is K2 without the epilogue. Semantics kept from the TPU kernels: no
// 1/sqrt(d) scaling; scores in float32; the softmax numerator e is rounded to
// V's dtype before the e.V product while the row sum uses the unrounded
// float32 e; normalization after the product. K2's epilogue is
// gamma * (1 / l) * acc + residual in float32; K6's (a null residual) is
// acc * (1 / l), `ctx * recip` of _attn_kernel; one store in the tensors' dtype.
//
// Bound on the H100: per image 2 * N^2 * (DK + DV) = 0.6 GFLOP at N = 1024,
// DK = 32, DV = 256 against ~1.7 MB of q, k, v, residual and output, about
// 350 FLOP per byte: near the balance point of the bf16 tensor cores and far
// above that of float32 CUDA cores. This first version is flash-style on
// CUDA cores (float32 FMA, attention.cuh), so the N x N scores never reach
// device memory; it is bound by FMA throughput and shared-memory bandwidth, and
// mma.sync / wgmma tiles are later work.

#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "common.cuh"

namespace {

using namespace cic::attn;

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ res, const float* __restrict__ gamma, T* __restrict__ out,
            int N, int DK, int DV) {
  extern __shared__ float smem[];
  const Tiles s = carve(smem);
  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const int nchunks = DV / 64;

  const T* qb = q + (size_t)b * N * DK;
  for (int i = tid; i < BQ * DK; i += THREADS) {
    const int r = i / DK, d = i % DK, n = q0 + r;
    s.Qt[d * BQ + r] = n < N ? cic::to_f32(qb[(size_t)n * DK + d]) : 0.f;
  }

  float m[4], l[4], acc[4][16];
  flash_loop<T>(s, k + (size_t)b * N * DK, v + (size_t)b * N * DV, N, DK, DV, m, l, acc);

  const float g = res ? *gamma : 1.f;
  const T* rb = res ? res + (size_t)b * N * DV : nullptr;
  T* ob = out + (size_t)b * N * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + rg * 4 + i;
    if (n >= N) continue;
    const float recip = 1.0f / l[i];
    const float scale = g * recip;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= nchunks) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t o = (size_t)n * DV + c * 64 + cg * 4 + e;
        const float a = acc[i][c * 4 + e];
        ob[o] = cic::from_f32<T>(rb ? scale * a + cic::to_f32(rb[o]) : a * recip);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* res, const float* gamma, void* out,
           int B, int N, int DK, int DV, cudaStream_t st) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BQ - 1) / BQ, B);
  attn_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(res), gamma, static_cast<T*>(out), N, DK, DV);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const void* q, const void* k, const void* v, const void* res,
             const float* gamma, void* out, int B, int N, int DK, int DV, void* stream) {
  if (DK < 1 || DK > DK_MAX || DV < 64 || DV > DV_MAX || DV % 64 != 0 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, res, gamma, out, B, N, DK, DV, st);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, res, gamma, out, B, N, DK, DV, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k: (B, N, DK); v, res, out: (B, N, DV);
// gamma: one float32 on the device.
extern "C" int cic_attention_block(int dtype, const void* q, const void* k, const void* v,
                                   const void* res, const float* gamma, void* out, int B, int N,
                                   int DK, int DV, void* stream) {
  if (res == nullptr || gamma == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, q, k, v, res, gamma, out, B, N, DK, DV, stream);
}

// K6: as cic_attention_block with no residual and no gamma; out: (B, N, DV).
extern "C" int cic_attention_core(int dtype, const void* q, const void* k, const void* v, void* out,
                                  int B, int N, int DK, int DV, void* stream) {
  return dispatch(dtype, q, k, v, nullptr, nullptr, out, B, N, DK, DV, stream);
}
