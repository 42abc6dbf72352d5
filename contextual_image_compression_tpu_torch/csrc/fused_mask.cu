// K1: the fused contextual mask engine, and K4: the smooth mask.
//
// K1 replaces contextual_image_compression_tpu/ops/fused_mask.py::
// contextual_mask_pallas (Pallas body _make_contextual_kernel). Per image of
// gray255 (B, H, W) and spectral map (B, RH, RW), all float32:
//   fine  = sum_r |g - boxmean_{2r+1}(g)|, g = gray / 255     -> max-normalize
//   comb  = 0.6 * upsample(spec) + 0.4 * fine                  -> max-normalize
//   y     = disk bilateral (radius 4, 49 taps), range weight sw + swc * diff^2
//   out   = Gaussian 31 rows, then columns                     -> max-normalize
// with reflect-101 borders applied per stage to that stage's own input.
//
// Bound on the H100: about 0.5 KFLOP of float32 CUDA-core work per pixel
// (49 bilateral taps x 7, 2 x 31 Gaussian multiply-adds, ~8 per box radius
// with sliding sums) against 12 bytes of device memory traffic per pixel, so
// it is bound by operations, not bytes. This kernel recomputes each box's
// column sums per pixel (~230 adds where sliding sums need ~50). The TPU kernel holds one 256^2 image in VMEM; a 256 KB image does not
// fit in the 232,448 bytes of shared memory a block may use, and each of the
// three max-normalizations is a barrier over the whole image. So this is a
// multi-launch tiled design: six launches per call, each over a grid of
// 32x32-pixel tiles of every image (B x 64 blocks at 256^2, enough to fill
// the 132 SMs), with the float32 intermediates in two (B, H, W) scratch
// buffers that stay L2-resident (16 images x 256 KB = 4 MB of the 50 MB L2).
// The stages that read a neighbourhood (box sums, bilateral) stage their
// tile plus halo in shared memory; each per-image maximum is a block
// reduction folded in with one atomicMax on the float's bits (the values are
// non-negative, so integer order is float order), and the next launch
// normalizes on the fly as it reads.
//
// K4 replaces smooth_mask_pallas of the same file (Pallas body _make_kernel):
// the bilateral, the two Gaussian passes and the final normalization above,
// on a given saliency map read as it is (no division by its max first). It
// reuses K1's last four launches; the bilateral takes that choice as an
// explicit argument. Bound on the H100: ~470 float32 operations per pixel
// against 8 bytes of device memory traffic, so operations bound it too.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int TX = 32;   // tile width = block width
constexpr int TY = 32;   // tile height
constexpr int BY = 8;    // block height: each thread covers TY / BY rows
constexpr int MAXR = 8;  // largest box or bilateral radius taken

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);  // only reached by rows past a ragged edge
}

__device__ __forceinline__ float norm_max(float x, float mx) {
  return mx > 0.f ? x / fmaxf(mx, 1e-12f) : x;
}

// Block-wide maximum of non-negative values, folded into *dst with one atomic.
// Every thread of the block must call it.
__device__ void block_max_to(float v, float* dst) {
  __shared__ float warp_max[32];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x * blockDim.y + 31) >> 5;
    v = lane < nw ? warp_max[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) atomicMax(reinterpret_cast<int*>(dst), __float_as_int(v));
  }
}

// Stage 1: fine-grained center-surround saliency, unnormalized; max -> maxes[0].
__global__ void __launch_bounds__(TX * BY)
fine_kernel(const float* __restrict__ gray, int H, int W, int scale_mask, int rmax,
            float* __restrict__ fine, float* __restrict__ maxes) {
  __shared__ float tile[TY + 2 * MAXR][TX + 2 * MAXR];
  const int b = blockIdx.z, x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const float* g = gray + (size_t)b * H * W;
  const int th = TY + 2 * rmax, tw = TX + 2 * rmax;
  for (int i = threadIdx.y * TX + threadIdx.x; i < th * tw; i += TX * BY) {
    const int ty = i / tw, tx = i % tw;
    const int y = reflect101(y0 - rmax + ty, H), x = reflect101(x0 - rmax + tx, W);
    tile[ty][tx] = g[(size_t)y * W + x] * (1.0f / 255.0f);
  }
  __syncthreads();
  float local_max = 0.f;
  const int x = x0 + threadIdx.x;
  const int X = threadIdx.x + rmax;
  for (int k = 0; k < TY / BY; ++k) {
    const int yl = threadIdx.y + k * BY;
    const int y = y0 + yl, Y = yl + rmax;
    // col[dx]: vertical sum over rows Y-r..Y+r of tile column X+dx, grown with r
    float col[2 * MAXR + 1];
#pragma unroll
    for (int dx = -MAXR; dx <= MAXR; ++dx)
      col[dx + MAXR] = (dx >= -rmax && dx <= rmax) ? tile[Y][X + dx] : 0.f;
    const float gc = tile[Y][X];
    float acc = 0.f;
    for (int r = 1; r <= rmax; ++r) {
#pragma unroll
      for (int dx = -MAXR; dx <= MAXR; ++dx)
        if (dx >= -rmax && dx <= rmax)
          col[dx + MAXR] += tile[Y - r][X + dx] + tile[Y + r][X + dx];
      if (scale_mask & (1 << r)) {
        float s = 0.f;
#pragma unroll
        for (int dx = -MAXR; dx <= MAXR; ++dx)
          if (dx >= -r && dx <= r) s += col[dx + MAXR];
        const int kk = 2 * r + 1;
        acc += fabsf(gc - s * (1.0f / (float)(kk * kk)));
      }
    }
    if (y < H && x < W) {
      fine[((size_t)b * H + y) * W + x] = acc;
      local_max = fmaxf(local_max, acc);
    }
  }
  block_max_to(local_max, maxes + b * 4 + 0);
}

// Stage 2: comb = sw * upsample(spec) + fw * fine / max(fine); max -> maxes[1].
// The upsample is jax.image.resize's linear operator in its two-tap form:
// rows first (uph @ spec), then columns, as the TPU kernel's two matmuls.
__global__ void __launch_bounds__(TX * BY)
combine_kernel(const float* __restrict__ fine, const float* __restrict__ spec, int H, int W,
               int RH, int RW, const int* __restrict__ idx_h, const float* __restrict__ w_h,
               const int* __restrict__ idx_w, const float* __restrict__ w_w, float sw, float fw,
               float* __restrict__ comb, float* __restrict__ maxes) {
  const int b = blockIdx.z, x = blockIdx.x * TX + threadIdx.x;
  const float fmax_b = maxes[b * 4 + 0];
  const float* s = spec + (size_t)b * RH * RW;
  float local_max = 0.f;
  for (int k = 0; k < TY / BY; ++k) {
    const int y = blockIdx.y * TY + threadIdx.y + k * BY;
    if (y < H && x < W) {
      const int i0 = idx_h[y], i1 = min(i0 + 1, RH - 1);
      const int j0 = idx_w[x], j1 = min(j0 + 1, RW - 1);
      const float a0 = w_h[2 * y], a1 = w_h[2 * y + 1];
      const float c0 = w_w[2 * x], c1 = w_w[2 * x + 1];
      const float t0 = a0 * s[i0 * RW + j0] + a1 * s[i1 * RW + j0];
      const float t1 = a0 * s[i0 * RW + j1] + a1 * s[i1 * RW + j1];
      const float up = t0 * c0 + t1 * c1;
      const size_t o = ((size_t)b * H + y) * W + x;
      const float v = sw * up + fw * norm_max(fine[o], fmax_b);
      comb[o] = v;
      local_max = fmaxf(local_max, v);
    }
  }
  block_max_to(local_max, maxes + b * 4 + 1);
}

// Stage 3: disk bilateral with the Taylor range weight, of comb / max(comb)
// when normalize_input is set (K1), of the input as it is otherwise (K4).
// taps holds (sw, swc) per disk tap in (dy, dx) row-major order.
__global__ void __launch_bounds__(TX * BY)
bilateral_kernel(const float* __restrict__ comb, int H, int W, int radius,
                 const float* __restrict__ taps, int ntaps, const float* __restrict__ maxes,
                 int normalize_input, float* __restrict__ out) {
  __shared__ float tile[TY + 2 * MAXR][TX + 2 * MAXR];
  __shared__ float tw_s[2 * (2 * MAXR + 1) * (2 * MAXR + 1)];
  const int b = blockIdx.z, x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < 2 * ntaps; i += TX * BY) tw_s[i] = taps[i];
  const float* c = comb + (size_t)b * H * W;
  const int th = TY + 2 * radius, tw = TX + 2 * radius;
  for (int i = tid; i < th * tw; i += TX * BY) {
    const int ty = i / tw, tx = i % tw;
    const int y = reflect101(y0 - radius + ty, H), x = reflect101(x0 - radius + tx, W);
    const float v = c[(size_t)y * W + x];
    tile[ty][tx] = normalize_input ? norm_max(v, maxes[b * 4 + 1]) : v;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, X = threadIdx.x + radius;
  const int r2max = radius * radius;
  for (int k = 0; k < TY / BY; ++k) {
    const int yl = threadIdx.y + k * BY;
    const int y = y0 + yl, Y = yl + radius;
    const float center = tile[Y][X];
    float num = 0.f, den = 0.f;
    int t = 0;
    for (int dy = -radius; dy <= radius; ++dy) {
      for (int dx = -radius; dx <= radius; ++dx) {
        if (dy * dy + dx * dx > r2max) continue;
        const float sh = tile[Y + dy][X + dx];
        const float diff = sh - center;
        const float wgt = tw_s[2 * t] + tw_s[2 * t + 1] * (diff * diff);
        num += wgt * sh;
        den += wgt;
        ++t;
      }
    }
    if (y < H && x < W) out[((size_t)b * H + y) * W + x] = num / fmaxf(den, 1e-20f);
  }
}

// Stage 4: Gaussian along rows (vertical taps), reflect-101.
__global__ void __launch_bounds__(TX * BY)
gauss_rows_kernel(const float* __restrict__ in, int H, int W, const float* __restrict__ gk,
                  int ksize, float* __restrict__ out) {
  __shared__ float g_s[64];
  const int tid = threadIdx.y * TX + threadIdx.x;
  if (tid < ksize) g_s[tid] = gk[tid];
  __syncthreads();
  const int b = blockIdx.z, x = blockIdx.x * TX + threadIdx.x, pad = ksize / 2;
  const float* src = in + (size_t)b * H * W;
  for (int k = 0; k < TY / BY; ++k) {
    const int y = blockIdx.y * TY + threadIdx.y + k * BY;
    if (y >= H || x >= W) continue;
    float acc = 0.f;
    for (int t = 0; t < ksize; ++t) acc += g_s[t] * src[(size_t)reflect101(y + t - pad, H) * W + x];
    out[((size_t)b * H + y) * W + x] = acc;
  }
}

// Stage 5: Gaussian along columns (horizontal taps); max -> maxes[2].
__global__ void __launch_bounds__(TX * BY)
gauss_cols_kernel(const float* __restrict__ in, int H, int W, const float* __restrict__ gk,
                  int ksize, float* __restrict__ out, float* __restrict__ maxes) {
  __shared__ float g_s[64];
  const int tid = threadIdx.y * TX + threadIdx.x;
  if (tid < ksize) g_s[tid] = gk[tid];
  __syncthreads();
  const int b = blockIdx.z, x = blockIdx.x * TX + threadIdx.x, pad = ksize / 2;
  float local_max = 0.f;
  for (int k = 0; k < TY / BY; ++k) {
    const int y = blockIdx.y * TY + threadIdx.y + k * BY;
    if (y < H && x < W) {
      const float* row = in + ((size_t)b * H + y) * W;
      float acc = 0.f;
      for (int t = 0; t < ksize; ++t) acc += g_s[t] * row[reflect101(x + t - pad, W)];
      out[((size_t)b * H + y) * W + x] = acc;
      local_max = fmaxf(local_max, acc);
    }
  }
  block_max_to(local_max, maxes + b * 4 + 2);
}

// Stage 6: final max-normalization in place.
__global__ void __launch_bounds__(TX * BY)
normalize_kernel(float* __restrict__ out, int H, int W, const float* __restrict__ maxes) {
  const int b = blockIdx.z, x = blockIdx.x * TX + threadIdx.x;
  const float mx = maxes[b * 4 + 2];
  for (int k = 0; k < TY / BY; ++k) {
    const int y = blockIdx.y * TY + threadIdx.y + k * BY;
    if (y < H && x < W) {
      const size_t o = ((size_t)b * H + y) * W + x;
      out[o] = norm_max(out[o], mx);
    }
  }
}

}  // namespace

extern "C" int cic_contextual_mask(
    const float* gray, const float* spec, int B, int H, int W, int RH, int RW,
    const int* idx_h, const float* w_h, const int* idx_w, const float* w_w,
    int scale_mask, int rmax, float spectral_weight, float fine_weight,
    int radius, const float* taps, int ntaps, const float* gk, int ksize,
    float* scratch1, float* scratch2, float* maxes, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rmax > MAXR || radius > MAXR || ksize > 64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(maxes, 0, sizeof(float) * 4 * (size_t)B, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TX, BY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  fine_kernel<<<grid, block, 0, st>>>(gray, H, W, scale_mask, rmax, scratch1, maxes);
  combine_kernel<<<grid, block, 0, st>>>(scratch1, spec, H, W, RH, RW, idx_h, w_h, idx_w, w_w,
                                         spectral_weight, fine_weight, scratch2, maxes);
  bilateral_kernel<<<grid, block, 0, st>>>(scratch2, H, W, radius, taps, ntaps, maxes,
                                           /*normalize_input=*/1, scratch1);
  gauss_rows_kernel<<<grid, block, 0, st>>>(scratch1, H, W, gk, ksize, scratch2);
  gauss_cols_kernel<<<grid, block, 0, st>>>(scratch2, H, W, gk, ksize, out, maxes);
  normalize_kernel<<<grid, block, 0, st>>>(out, H, W, maxes);
  return (int)cudaGetLastError();
}

// K4: bilateral of the map as it is -> out, Gaussian rows -> scratch,
// Gaussian columns -> out (max -> maxes[b * 4 + 2]), then normalize out.
extern "C" int cic_smooth_mask(
    const float* saliency, int B, int H, int W, int radius, const float* taps, int ntaps,
    const float* gk, int ksize, float* scratch, float* maxes, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (radius > MAXR || ksize > 64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(maxes, 0, sizeof(float) * 4 * (size_t)B, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TX, BY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  bilateral_kernel<<<grid, block, 0, st>>>(saliency, H, W, radius, taps, ntaps, maxes,
                                           /*normalize_input=*/0, out);
  gauss_rows_kernel<<<grid, block, 0, st>>>(out, H, W, gk, ksize, scratch);
  gauss_cols_kernel<<<grid, block, 0, st>>>(scratch, H, W, gk, ksize, out, maxes);
  normalize_kernel<<<grid, block, 0, st>>>(out, H, W, maxes);
  return (int)cudaGetLastError();
}
