// K3 (forward) and K3b (backward, reference mode): saliency-adaptive latent
// quantization.
//
// Replaces the forward of contextual_image_compression_tpu/ops/quantize.py::
// _adaptive_quantize_pallas (_pallas_quant_forward, body _quant_fwd_kernel).
// Per row b of latents z (B, D):
//   s = exp(c * (q_b * (1 - sigma_b)))      in float32, in this association
//   out = rint(z * s) / s                   in float32, stored in z's dtype
// rintf rounds half to even like jnp.round; expf is the accurate libm exp
// (the library is built without fast-math, so __expf never replaces it).
//
// Bound on the H100: bytes and launch overhead only, 2 flops per element
// against 2 x 2 bytes per bf16 element (B x D = 16 x 1024 is 64 KB moved,
// about 20 ns of HBM time at 3.35 TB/s, far below a launch). One block per
// row computes s once and streams the row with coalesced loads; nothing is
// worth more than that at these sizes. What a call costs is the host's
// launch, so score and strength are read in their own dtype (the upcast is
// inside, as in JAX's kernel) and the wrapper launches nothing else.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// score, strength, dscore and dstrength are read and written as stored:
// float32 (code 0) or bfloat16 (code 1), one element per row. The read is
// exact; a write rounds to nearest even, as .to(torch.bfloat16) does.
__device__ __forceinline__ float load_row(const void* p, int code, int b) {
  return code ? cic::to_f32(static_cast<const __nv_bfloat16*>(p)[b])
              : static_cast<const float*>(p)[b];
}

__device__ __forceinline__ void store_row(void* p, int code, int b, float v) {
  if (code)
    static_cast<__nv_bfloat16*>(p)[b] = cic::from_f32<__nv_bfloat16>(v);
  else
    static_cast<float*>(p)[b] = v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_fwd_kernel(const T* __restrict__ z, const void* __restrict__ score, int score_code,
                 const void* __restrict__ strength, int strength_code, float coeff,
                 T* __restrict__ out, int D) {
  const int b = blockIdx.x;
  const float eff = load_row(strength, strength_code, b) * (1.0f - load_row(score, score_code, b));
  const float s = expf(coeff * eff);
  const T* zr = z + (size_t)b * D;
  T* orow = out + (size_t)b * D;
  for (int d = threadIdx.x; d < D; d += THREADS)
    orow[d] = cic::from_f32<T>(rintf(cic::to_f32(zr[d]) * s) / s);
}

// K3b replaces contextual_image_compression_tpu/ops/quantize.py::
// _pallas_quant_bwd_scalepath (body _quant_bwd_ref_kernel): the 'reference'
// gradient mode, where rint has zero derivative, so the latent gets none and
// only the scale path carries gradient. Per row b, with s as in K3:
//   g_s     = sum_d g * (-rint(z * s) / (s * s))
//   g_eff   = g_s * c * s
//   dsigma  = g_eff * (-q),   dq = g_eff * (1 - sigma)
// in float32 whatever the storage type of z and g; dsigma and dq are written
// in the storage types of sigma and q, as JAX's out_shape asks.
//
// Bound on the H100: bytes. It reads z and g once (B x D x 2 tensors, 128 KB
// in float32 at B = 16, D = 1024: ~40 ns of HBM time) and writes 2 x B
// values; ~6 flops per element. One block per row: each thread sums its
// strided share of the row, then a warp-shuffle and shared-memory reduction
// forms g_s and thread 0 writes both outputs. At B = 16 the launch, not the
// row, is the cost, so the wrapper launches it alone: no cast before or after.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_bwd_kernel(const T* __restrict__ z, const T* __restrict__ g,
                 const void* __restrict__ score, int score_code,
                 const void* __restrict__ strength, int strength_code, float coeff,
                 void* __restrict__ dscore, void* __restrict__ dstrength, int D) {
  const int b = blockIdx.x;
  const float q = load_row(strength, strength_code, b);
  const float sigma = load_row(score, score_code, b);
  const float s = expf(coeff * (q * (1.0f - sigma)));
  const float s2 = s * s;
  const T* zr = z + (size_t)b * D;
  const T* gr = g + (size_t)b * D;
  float acc = 0.0f;
  for (int d = threadIdx.x; d < D; d += THREADS)
    acc += cic::to_f32(gr[d]) * (-rintf(cic::to_f32(zr[d]) * s) / s2);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < THREADS / 32 ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const float g_eff = acc * coeff * s;
      store_row(dscore, score_code, b, g_eff * (-q));
      store_row(dstrength, strength_code, b, g_eff * (1.0f - sigma));
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 latents; score_dtype and strength_dtype
// likewise for score and strength, one element per row (B,) or (B, 1).
extern "C" int cic_adaptive_quantize(int dtype, const void* z, const void* score,
                                     int score_dtype, const void* strength, int strength_dtype,
                                     float coeff, void* out, int B, int D, void* stream) {
  if (B < 1 || D < 1 || (score_dtype | strength_dtype) & ~1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    quant_fwd_kernel<float><<<B, THREADS, 0, st>>>(static_cast<const float*>(z), score,
                                                   score_dtype, strength, strength_dtype, coeff,
                                                   static_cast<float*>(out), D);
  } else if (dtype == 1) {
    quant_fwd_kernel<__nv_bfloat16><<<B, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(z), score, score_dtype, strength, strength_dtype,
        coeff, static_cast<__nv_bfloat16*>(out), D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 latents and gradients (one type for both);
// dscore is written in score_dtype and dstrength in strength_dtype.
extern "C" int cic_adaptive_quantize_bwd(int dtype, const void* z, const void* g,
                                         const void* score, int score_dtype,
                                         const void* strength, int strength_dtype, float coeff,
                                         void* dscore, void* dstrength, int B, int D,
                                         void* stream) {
  if (B < 1 || D < 1 || (score_dtype | strength_dtype) & ~1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    quant_bwd_kernel<float><<<B, THREADS, 0, st>>>(
        static_cast<const float*>(z), static_cast<const float*>(g), score, score_dtype, strength,
        strength_dtype, coeff, dscore, dstrength, D);
  } else if (dtype == 1) {
    quant_bwd_kernel<__nv_bfloat16><<<B, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(g), score,
        score_dtype, strength, strength_dtype, coeff, dscore, dstrength, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
