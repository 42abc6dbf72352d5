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
// K4 replaces smooth_mask_pallas of the same file (Pallas body _make_kernel):
// the bilateral, the two Gaussian passes and the final normalization above,
// on a given saliency map read as it is (no division by its max first).
//
// Bound on the H100: about 0.5 KFLOP of float32 CUDA-core work per pixel
// (49 bilateral taps x 7, 2 x 31 Gaussian multiply-adds, ~8 per box radius
// with sliding sums) against 12 bytes of device memory traffic per pixel (8
// for K4), so both are bound by operations, not bytes.
//
// Two routes, chosen before any launch by ops/fused_mask.py::_mask_plan:
//
// * Cluster route (mask_cluster_kernel), one launch per call. The TPU kernel
//   holds a whole image in VMEM; one block cannot hold a 256^2 image in the
//   232,448 bytes of shared memory it may use, but a cluster of 6 to 8
//   blocks can. Each image goes to one cluster and each block owns a strip
//   of whole rows; every intermediate stays in the strips' shared memory.
//   Halo rows come from the neighbouring blocks' shared memory (DSMEM), each
//   image-wide max is reduced over the cluster through one slot per block
//   (no atomics, no scratch, no memset: the result is deterministic), and
//   the only device-memory traffic is the input, the spectral map and the
//   output. The box sums grow each column's vertical sum from radius to
//   radius and add the neighbouring columns' sums by warp shuffles instead
//   of recomputing each box per pixel; the bilateral and the Gaussian
//   passes compute two and four outputs a thread from one set of loads.
//   The default filter sizes (box radii up to 6, bilateral radius 4,
//   Gaussian 31) are compiled with their loops unrolled, so the taps are
//   constant-bank operands; other sizes take the same code with runtime
//   loops. What bounds it is float32 issue in the bilateral and the box
//   sums (scripts/torch_mask_stages.py times each stage), and at
//   B = 16 the number of clusters the card runs at once (17 of 6 blocks).
// * Tiled route (the *_kernel functions above mask_cluster_kernel), for
//   images whose strips do not fit a cluster's shared memory (336^2 and
//   up at the default filters): six launches over 32x32-pixel tiles with two
//   (B, H, W) scratch buffers in device memory, each per-image maximum a
//   block reduction folded in with one atomicMax on the float's bits (the
//   values are non-negative, so integer order is float order).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// Cluster route: one launch, one cluster of blocks per image.

constexpr int CL_THREADS = 512;
constexpr int CL_MAX_CLUSTER = 8;  // the portable cluster size
constexpr int CL_MAX_TAPS = (2 * MAXR + 1) * (2 * MAXR + 1);
constexpr size_t CL_MAX_SMEM = 232448;

struct ClusterArgs {
  const float* in;  // K1: gray255; K4: the saliency map; (B, H, W)
  const float* spec;  // K1: the spectral map (B, RH, RW)
  const int* idx_h;
  const float* w_h;
  const int* idx_w;
  const float* w_w;
  float* out;  // (B, H, W)
  int H, W, RH, RW;
  int rows;  // rows per block; the last block of a cluster may own fewer
  int stride, halo;  // row stride; halo rows, and reflected columns, each side of a strip
  int scale_mask, rmax;
  float sw, fw;
  int radius, ksize;
  float taps[2 * CL_MAX_TAPS];  // (sw, swc) per disk tap, (dy, dx) row-major
  float gk[64];
};

// Shared memory of one block, in floats: buffer 0 (rows + 2 halo rows + 3
// rows the Gaussian's last group of four outputs may read past), buffers 1
// and 2 (rows each), 4 slots for the image-wide maxima and 32 for the warps'
// maxima. ops/fused_mask.py::_mask_plan computes the same size.
inline size_t cluster_smem_floats(int rows, int halo, int stride) {
  return (size_t)(3 * rows + 2 * halo + 3) * stride + 4 + 32;
}

// The maximum of v over the whole cluster (v >= 0). Every thread of every
// block calls it; slot k of each block holds that block's maximum, and each
// warp reads the slots of all ranks after the cluster barrier.
__device__ float cluster_max(float v, float* slots, float* warp_max, int k,
                             cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (CL_THREADS >> 5) ? warp_max[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) slots[k] = v;
  }
  cluster.sync();
  float m = lane < (int)gridDim.x ? *cluster.map_shared_rank(slots + k, lane) : 0.f;
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Copies rows j = 0 .. nrows - 1 of a strip into buffer 0 (row j at dst + j *
// S), columns x_lo .. x_hi - 1: fix(row_of(j)[col_of(x)]). A thread holds
// STAGE_ROWS rows' loads in flight before it stores them: the sources are
// device memory or another block's shared memory, and one load at a time
// would pay their latency in full.
constexpr int STAGE_ROWS = 8;
constexpr int BLOCK_OUT = 4;  // outputs per thread in the Gaussian passes

template <typename RowOf, typename ColOf, typename Fix>
__device__ __forceinline__ void stage_rows(float* dst, int S, int nrows, int x_lo, int x_hi,
                                           int xt, int yt, int WT, int YT, RowOf row_of,
                                           ColOf col_of, Fix fix) {
  for (int j0 = yt; j0 < nrows; j0 += STAGE_ROWS * YT) {
    const float* src[STAGE_ROWS];
#pragma unroll
    for (int u = 0; u < STAGE_ROWS; ++u) {
      const int j = j0 + u * YT;
      src[u] = row_of(j < nrows ? j : j0);  // past the end: row j0 again, never stored
    }
    for (int x = x_lo + xt; x < x_hi; x += WT) {
      const int xs = col_of(x);
      float v[STAGE_ROWS];
#pragma unroll
      for (int u = 0; u < STAGE_ROWS; ++u) v[u] = src[u][xs];
#pragma unroll
      for (int u = 0; u < STAGE_ROWS; ++u) {
        const int j = j0 + u * YT;
        if (j < nrows) dst[(size_t)j * S + x] = fix(v[u]);
      }
    }
  }
}

// Block `rank` of image b's cluster owns image rows [rank * rows, rank * rows
// + n). Its strip buffers hold rows of W floats at `stride` (odd, so that
// threads on consecutive rows hit distinct banks), column x at halo + x,
// with reflected columns -halo .. -1 and W .. W + halo - 1 where a stage
// needs them. A halo row yy (after reflect-101) belongs to block yy / rows.
// CONTEXTUAL: K1 from stage 1; otherwise K4, entered at stage 3 with the map
// read from device memory. RMAX_T / RAD_T / KS_T: the largest box radius,
// the bilateral radius and the Gaussian size as compile-time constants (the
// loops over taps and radii then unroll, and the weights are constant-bank
// operands), or 0 to read them from the arguments.
template <bool CONTEXTUAL, int RMAX_T, int RAD_T, int KS_T>
__global__ void __launch_bounds__(CL_THREADS, 1)
mask_cluster_kernel(const __grid_constant__ ClusterArgs p) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int H = p.H, W = p.W, R = p.rows, S = p.stride, C0 = p.halo;
  const int r0 = rank * R;
  const int n = min(R, H - r0);
  float* const b0 = smem;
  float* const b1 = b0 + (size_t)(R + 2 * p.halo + BLOCK_OUT - 1) * S;
  float* const b2 = b1 + (size_t)R * S;
  float* const slots = b2 + (size_t)R * S;
  float* const warp_max = slots + 4;
  const int tid = threadIdx.x;
  // the threads as WT columns x YT rows for the per-pixel stages
  const int WT = min(CL_THREADS, (W + 31) & ~31);
  const int YT = CL_THREADS / WT;
  const int xt = tid % WT;
  const int yt = tid / WT < YT ? tid / WT : 1 << 20;  // spare threads skip those loops

  float m2 = 0.f;
  if (CONTEXTUAL) {
    // Stage 1: fine = sum_r |g - box_r(g) / k^2| over the own rows. Buffer 0
    // holds g for rows r0 - rmax .. r0 + n + rmax - 1 with rmax reflected
    // columns each side. One warp takes a row segment, a lane per column
    // (rmax halo lanes each side): each lane grows its column's vertical
    // sum from radius to radius, and the box sum of each radius adds the
    // 2r + 1 neighbouring lanes' vertical sums by shuffles, so fine stays in
    // a register, with no barrier between the radii.
    const int rmax = RMAX_T > 0 ? RMAX_T : p.rmax;
    const float* img = p.in + (size_t)b * H * W;
    stage_rows(
        b0 + C0, S, n + 2 * rmax, -rmax, W + rmax, xt, yt, WT, YT,
        [&](int j) { return img + (size_t)reflect101(r0 - rmax + j, H) * W; },
        [&](int x) { return reflect101(x, W); }, [](float v) { return v * (1.0f / 255.0f); });
    __syncthreads();
    float local_max = 0.f;
    {
      const int lane = tid & 31;
      const int span = 32 - 2 * rmax;  // output columns per warp task
      const int nseg = (W + span - 1) / span;
      for (int task = tid >> 5; task < n * nseg; task += CL_THREADS / 32) {
        const int y = task / nseg, seg = task - y * nseg;
        const int x = seg * span - rmax + lane;
        const float* col = b0 + (size_t)(y + rmax) * S + C0 + min(x, W + rmax - 1);
        const float g = col[0];
        float v = g, fine = 0.f;
#pragma unroll
        for (int r = 1; r <= rmax; ++r) {
          v += col[-r * S] + col[r * S];
          if (p.scale_mask & (1 << r)) {
            float s = 0.f;
#pragma unroll
            for (int dx = -r; dx <= r; ++dx) s += __shfl_sync(0xffffffffu, v, lane + dx);
            fine += fabsf(g - s * (1.0f / (float)((2 * r + 1) * (2 * r + 1))));
          }
        }
        if (lane >= rmax && lane < 32 - rmax && x < W) {
          b1[(size_t)y * S + C0 + x] = fine;
          local_max = fmaxf(local_max, fine);
        }
      }
    }
    const float m1 = cluster_max(local_max, slots, warp_max, 0, cluster);

    // Stage 2: comb = sw * upsample(spec) + fw * fine / max(fine), in place.
    // The spectral rows the strip's upsample reads (a nondecreasing index
    // that steps by at most one a row) go to buffer 0 first.
    const int RW = p.RW;
    const int sr0 = __ldg(p.idx_h + r0);
    const int sr1 = min(__ldg(p.idx_h + r0 + n - 1) + 1, p.RH - 1);
    const float* spec = p.spec + ((size_t)b * p.RH + sr0) * RW;
    for (int i = tid; i < (sr1 - sr0 + 1) * RW; i += CL_THREADS) b0[i] = __ldg(spec + i);
    __syncthreads();
    local_max = 0.f;
    for (int x = xt; x < W; x += WT) {
      const int j0 = __ldg(p.idx_w + x), j1 = min(j0 + 1, RW - 1);
      const float c0 = __ldg(p.w_w + 2 * x), c1 = __ldg(p.w_w + 2 * x + 1);
      for (int y = yt; y < n; y += YT) {
        const int Y = r0 + y;
        const int i0 = __ldg(p.idx_h + Y);
        const float* s0 = b0 + (i0 - sr0) * RW;
        const float* s1 = b0 + (min(i0 + 1, p.RH - 1) - sr0) * RW;
        const float a0 = __ldg(p.w_h + 2 * Y), a1 = __ldg(p.w_h + 2 * Y + 1);
        const float t0 = a0 * s0[j0] + a1 * s1[j0];
        const float t1 = a0 * s0[j1] + a1 * s1[j1];
        float* f = b1 + (size_t)y * S + C0 + x;
        const float v = p.sw * (t0 * c0 + t1 * c1) + p.fw * norm_max(*f, m1);
        *f = v;
        local_max = fmaxf(local_max, v);
      }
    }
    // its cluster barrier also publishes comb to the neighbouring blocks
    m2 = cluster_max(local_max, slots, warp_max, 1, cluster);
  }

  // Stage 3: bilateral. Buffer 0 takes the input rows r0 - radius .. r0 + n +
  // radius - 1 with reflected columns: K1's comb / max(comb) from the owning
  // blocks' buffer 1, K4's map from device memory as it is.
  const int rad = RAD_T > 0 ? RAD_T : p.radius;
  if (CONTEXTUAL) {
    stage_rows(
        b0 + C0, S, n + 2 * rad, -rad, W + rad, xt, yt, WT, YT,
        [&](int j) {
          const int yy = reflect101(r0 - rad + j, H);
          const int o = yy / R;
          return (o == rank ? b1 : cluster.map_shared_rank(b1, o)) + (size_t)(yy - o * R) * S + C0;
        },
        [&](int x) { return reflect101(x, W); }, [&](float v) { return norm_max(v, m2); });
  } else {
    const float* img = p.in + (size_t)b * H * W;
    stage_rows(
        b0 + C0, S, n + 2 * rad, -rad, W + rad, xt, yt, WT, YT,
        [&](int j) { return img + (size_t)reflect101(r0 - rad + j, H) * W; },
        [&](int x) { return reflect101(x, W); }, [](float v) { return v; });
  }
  __syncthreads();
  // two vertically adjacent outputs per thread: the union of their disks is
  // loaded once (58 loads for 98 taps at radius 4), and each output still
  // takes its taps in the twin's (dy, dx) row-major order
  const int r2max = rad * rad;
  for (int y0 = yt * 2; y0 < n; y0 += YT * 2) {
    const float* crow = b0 + (size_t)(y0 + rad) * S + C0;
    for (int x = xt; x < W; x += WT) {
      const float* c = crow + x;
      const float center0 = c[0], center1 = c[S];
      float num0 = 0.f, den0 = 0.f, num1 = 0.f, den1 = 0.f;
      int t0 = 0, t1 = 0;
#pragma unroll
      for (int dy = -rad; dy <= rad + 1; ++dy) {
#pragma unroll
        for (int dx = -rad; dx <= rad; ++dx) {
          const bool in0 = dy <= rad && dy * dy + dx * dx <= r2max;
          const bool in1 = dy > -rad && (dy - 1) * (dy - 1) + dx * dx <= r2max;
          if (!in0 && !in1) continue;
          const float sh = c[dy * S + dx];
          if (in0) {
            const float diff = sh - center0;
            const float wgt = p.taps[2 * t0] + p.taps[2 * t0 + 1] * (diff * diff);
            num0 += wgt * sh;
            den0 += wgt;
            ++t0;
          }
          if (in1) {
            const float diff = sh - center1;
            const float wgt = p.taps[2 * t1] + p.taps[2 * t1 + 1] * (diff * diff);
            num1 += wgt * sh;
            den1 += wgt;
            ++t1;
          }
        }
      }
      b2[(size_t)y0 * S + C0 + x] = num0 / fmaxf(den0, 1e-20f);
      if (y0 + 1 < n) b2[(size_t)(y0 + 1) * S + C0 + x] = num1 / fmaxf(den1, 1e-20f);
    }
  }
  // every block's bilateral output is complete, and every read of buffer 1
  // by a neighbour is done
  cluster.sync();

  // Stage 4: Gaussian along rows. Buffer 0 takes the bilateral rows r0 - pad
  // .. r0 + n + pad - 1 from the owning blocks' buffer 2; the result goes to
  // buffer 1, with its pad reflected columns each side for stage 5.
  const int ks = KS_T > 0 ? KS_T : p.ksize;
  const int gpad = ks / 2;
  stage_rows(
      b0 + C0, S, n + 2 * gpad, 0, W, xt, yt, WT, YT,
      [&](int j) {
        const int yy = reflect101(r0 - gpad + j, H);
        const int o = yy / R;
        return (o == rank ? b2 : cluster.map_shared_rank(b2, o)) + (size_t)(yy - o * R) * S + C0;
      },
      [](int x) { return x; }, [](float v) { return v; });
  __syncthreads();
  // four consecutive rows of one column per thread: ks + 3 loads for four
  // outputs (the last group may read up to 3 rows past the strip's, inside
  // shared memory, for outputs it does not store)
  for (int y0 = yt * BLOCK_OUT; y0 < n; y0 += YT * BLOCK_OUT) {
    for (int x = xt; x < W; x += WT) {
      const float* top = b0 + (size_t)y0 * S + C0 + x;
      float acc[BLOCK_OUT] = {};
#pragma unroll
      for (int t = 0; t < ks + BLOCK_OUT - 1; ++t) {
        const float v = top[t * S];
#pragma unroll
        for (int o = 0; o < BLOCK_OUT; ++o)
          if (t - o >= 0 && t - o < ks) acc[o] += p.gk[t - o] * v;
      }
#pragma unroll
      for (int o = 0; o < BLOCK_OUT; ++o)
        if (y0 + o < n) b1[(size_t)(y0 + o) * S + C0 + x] = acc[o];
    }
  }
  if (gpad > 0) {
    // the reflected columns, computed from their source columns (so equal
    // to them bit for bit) rather than copied after another barrier
    for (int i = tid; i < n * 2 * gpad; i += CL_THREADS) {
      const int y = i / (2 * gpad), k = i - y * 2 * gpad;
      const int x = k < gpad ? k - gpad : W + k - gpad;
      const float* top = b0 + (size_t)y * S + C0 + reflect101(x, W);
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < ks; ++t) acc += p.gk[t] * top[t * S];
      b1[(size_t)y * S + C0 + x] = acc;
    }
  }
  __syncthreads();

  // Stage 5: Gaussian along columns into buffer 0, the image max, then the
  // normalized mask to device memory.
  // four consecutive columns of one row per thread, consecutive threads on
  // consecutive rows (the odd stride keeps them on distinct banks)
  float local_max = 0.f;
  const int ncg = (W + BLOCK_OUT - 1) / BLOCK_OUT;
  for (int i = tid; i < n * ncg; i += CL_THREADS) {
    const int y = i % n, x0 = (i / n) * BLOCK_OUT;
    const float* row = b1 + (size_t)y * S + C0 - gpad + x0;
    float acc[BLOCK_OUT] = {};
#pragma unroll
    for (int t = 0; t < ks + BLOCK_OUT - 1; ++t) {
      const float v = row[t];
#pragma unroll
      for (int o = 0; o < BLOCK_OUT; ++o)
        if (t - o >= 0 && t - o < ks) acc[o] += p.gk[t - o] * v;
    }
#pragma unroll
    for (int o = 0; o < BLOCK_OUT; ++o) {
      if (x0 + o < W) {
        b0[(size_t)y * S + C0 + x0 + o] = acc[o];
        local_max = fmaxf(local_max, acc[o]);
      }
    }
  }
  const float m3 = cluster_max(local_max, slots, warp_max, 2, cluster);
  float* out = p.out + ((size_t)b * H + r0) * W;
  for (int y = yt; y < n; y += YT)
    for (int x = xt; x < W; x += WT)
      out[(size_t)y * W + x] = norm_max(b0[(size_t)y * S + C0 + x], m3);
  // no block leaves while another still reads its slots
  cluster.sync();
}

// Raises the kernel's dynamic shared memory limit to the most a block may use
// and checks that a cluster of that shape can be scheduled, once per (kernel,
// device, cluster size, bytes); *max_clusters (if given) receives
// cudaOccupancyMaxActiveClusters. (The limit is not set to `smem`: a cached
// larger shape would then launch above the limit a smaller one left.)
cudaError_t cluster_ready(const void* fn, int cluster, size_t smem, int* max_clusters) {
  struct Entry {
    const void* fn;
    int dev, cluster, count;
    size_t smem;
  };
  static std::mutex mu;
  static Entry seen[32];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i) {
    const Entry& e = seen[i];
    if (e.fn == fn && e.dev == dev && e.cluster == cluster && e.smem == smem) {
      if (max_clusters) *max_clusters = e.count;
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CL_MAX_SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(CL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (count < 1) return cudaErrorLaunchOutOfResources;  // no SM group takes such a cluster
  if (n_seen < 32) seen[n_seen++] = Entry{fn, dev, cluster, count, smem};
  if (max_clusters) *max_clusters = count;
  return cudaSuccess;
}

template <bool CONTEXTUAL, int RMAX_T, int RAD_T, int KS_T>
cudaError_t launch_cluster(const ClusterArgs& a, int B, int cluster, size_t smem,
                           cudaStream_t st, int* max_clusters) {
  void (*kernel)(ClusterArgs) = mask_cluster_kernel<CONTEXTUAL, RMAX_T, RAD_T, KS_T>;
  cudaError_t err = cluster_ready((const void*)kernel, cluster, smem, max_clusters);
  if (err != cudaSuccess || B == 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(CL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Checks the plan handed in against this file's layout, copies the filter
// tables (host arrays) into the arguments and launches the instantiation for
// the filter sizes. B == 0 only checks the cluster (and reports *max_clusters).
cudaError_t run_cluster(bool contextual, ClusterArgs& a, int B, const float* taps, int ntaps,
                        const float* gk, int cluster, size_t smem, cudaStream_t st,
                        int* max_clusters) {
  const int gpad = a.ksize / 2;
  const int halo = std::max(std::max(a.rmax, a.radius), gpad);
  const bool ok = a.rmax <= MAXR && a.radius <= MAXR && a.ksize <= 63 && a.ksize >= 1 &&
                  ntaps >= 1 && ntaps <= CL_MAX_TAPS && cluster >= 1 &&
                  cluster <= CL_MAX_CLUSTER && a.rows >= 1 && (cluster - 1) * a.rows < a.H &&
                  cluster * a.rows >= a.H && a.H > halo && a.W > halo &&
                  a.halo == halo && a.stride >= a.W + 2 * a.halo &&
                  smem == 4 * cluster_smem_floats(a.rows, a.halo, a.stride) &&
                  smem <= CL_MAX_SMEM;
  if (!ok) return cudaErrorInvalidValue;
  for (int i = 0; i < 2 * ntaps; ++i) a.taps[i] = taps[i];
  for (int i = 0; i < a.ksize; ++i) a.gk[i] = gk[i];
  const bool dflt = a.radius == 4 && a.ksize == 31;
  if (contextual)
    return dflt && a.rmax == 6
               ? launch_cluster<true, 6, 4, 31>(a, B, cluster, smem, st, max_clusters)
               : launch_cluster<true, 0, 0, 0>(a, B, cluster, smem, st, max_clusters);
  return dflt ? launch_cluster<false, 0, 4, 31>(a, B, cluster, smem, st, max_clusters)
              : launch_cluster<false, 0, 0, 0>(a, B, cluster, smem, st, max_clusters);
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

// K1, cluster route: one launch of B clusters of `cluster` blocks (rows per
// block, shared memory bytes and layout from ops/fused_mask.py::_mask_plan).
// taps (2 x ntaps floats) and gk (ksize floats) are host arrays.
extern "C" int cic_contextual_mask_cluster(
    const float* gray, const float* spec, int B, int H, int W, int RH, int RW,
    const int* idx_h, const float* w_h, const int* idx_w, const float* w_w,
    int scale_mask, int rmax, float spectral_weight, float fine_weight,
    int radius, const float* taps, int ntaps, const float* gk, int ksize,
    int cluster, int rows, int stride, int halo, int smem_bytes, float* out, void* stream) {
  ClusterArgs a = {};
  a.in = gray; a.spec = spec; a.idx_h = idx_h; a.w_h = w_h; a.idx_w = idx_w; a.w_w = w_w;
  a.out = out; a.H = H; a.W = W; a.RH = RH; a.RW = RW;
  a.rows = rows; a.stride = stride; a.halo = halo;
  a.scale_mask = scale_mask; a.rmax = rmax; a.sw = spectral_weight; a.fw = fine_weight;
  a.radius = radius; a.ksize = ksize;
  if (B < 1 || rmax < 1 || RH > H || RW > W) return (int)cudaErrorInvalidValue;
  return (int)run_cluster(true, a, B, taps, ntaps, gk, cluster, (size_t)smem_bytes,
                          static_cast<cudaStream_t>(stream), nullptr);
}

// K4, cluster route (as above, entered at the bilateral).
extern "C" int cic_smooth_mask_cluster(
    const float* saliency, int B, int H, int W, int radius, const float* taps, int ntaps,
    const float* gk, int ksize, int cluster, int rows, int stride, int halo, int smem_bytes,
    float* out, void* stream) {
  ClusterArgs a = {};
  a.in = saliency; a.out = out; a.H = H; a.W = W;
  a.rows = rows; a.stride = stride; a.halo = halo;
  a.radius = radius; a.ksize = ksize;
  if (B < 1) return (int)cudaErrorInvalidValue;
  return (int)run_cluster(false, a, B, taps, ntaps, gk, cluster, (size_t)smem_bytes,
                          static_cast<cudaStream_t>(stream), nullptr);
}

// cudaOccupancyMaxActiveClusters of the cluster kernel that a K1 (contextual
// = 1) or K4 call with these filter sizes and this plan launches, into
// *max_clusters; nothing is launched.
extern "C" int cic_mask_max_clusters(int contextual, int H, int W, int rmax, int radius,
                                     int ksize, int cluster, int rows, int stride, int halo,
                                     int smem_bytes, int* max_clusters) {
  ClusterArgs a = {};
  a.H = H; a.W = W; a.rows = rows; a.stride = stride; a.halo = halo;
  a.rmax = contextual ? rmax : 0; a.radius = radius; a.ksize = ksize;
  static const float zeros[2 * CL_MAX_TAPS] = {};
  return (int)run_cluster(contextual != 0, a, 0, zeros, 1, zeros, cluster, (size_t)smem_bytes,
                          nullptr, max_clusters);
}
