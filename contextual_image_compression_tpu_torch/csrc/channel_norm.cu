// K9: HiFiC's ChannelNorm (models/hific.py::ChannelNorm) as one kernel.
//
// Replaces no TPU kernel: the JAX package has no HiFiC. It takes the place
// of the eager body of ChannelNorm.forward, now its plain twin
// ops/channel_norm.py::channel_norm_plain, whose float32 cast, var_mean,
// subtract, rsqrt multiply, addcmul, ReLU and cast back crossed device
// memory about six times (~54 bytes an element in bf16). For each pixel
// (b, :, h, w) of x (B, C, H, W), bfloat16 or float32, in either layout:
//   mean = sum_c x / C,   var = sum_c (x - mean)^2 / C      (biased)
//   y_c  = (x_c - mean) * rsqrt(var + eps) * alpha_c + beta_c,
// ReLU'd if asked, all in float32, rounded once to x's dtype.
//
// Bound on the H100: bytes. About ten float32 operations an element
// against one read and one write of it (4 bytes in bf16): far below the
// card's operations-per-byte line, so all the design does is cross device
// memory once each way and keep enough bytes in flight. Both routes share
// that plan: a block owns a tile of P adjacent pixels with all C channels,
// staged in shared memory by 16-byte cp.async (L2 only); STAGES tiles are
// in flight (the next two load while this one is computed); a persistent
// grid walks the tiles in order, adjacent blocks on adjacent tiles.
//
// NCHW route (`cic_channel_norm`, x contiguous):
//  * Each channel's P pixels are contiguous, so the tile is C rows of
//    P * sizeof(T) bytes. P comes from C (ops/channel_norm.py::tile_pixels):
//    a power of two that keeps one tile within 64 KB, so that STAGES of them
//    fill one block an SM (C = 960 takes 32 pixels in bf16, rows of 64
//    bytes; C = 60 takes 512). Wider rows beat more blocks: at 32 KB tiles
//    and two blocks an SM every width but 220 ran 4-9 points further below
//    its bound.
//  * A thread takes 4 adjacent pixels (one 8- or 16-byte shared access)
//    over every K-th channel. Each pixel's float32 sum is combined in a
//    fixed order (the thread's channels in turn, then shuffles across the
//    warp, then the warps' rows in order); from the mean, the squared
//    deviations are summed the same way: two passes over shared memory and
//    none over device memory. The third pass writes each output from
//    registers, 8 or 16 bytes a thread, adjacent threads on adjacent
//    addresses.
//  * A tensor whose channel rows are not 16-byte aligned (H * W * sizeof(T)
//    a multiple of 16) takes the same walk with element loads (VEC = false);
//    HiFiC's shapes never do.
//
// NHWC route (`cic_channel_norm_nhwc`, x channels_last, the served form):
//  * The batch is B * H * W pixels in a row, each pixel's channels one
//    contiguous row of S elements (S > C: zero padding channels, HiFiC's
//    60-channel rows padded to 64, left out of the statistics and written
//    0), so a tile is one span of P * S elements, copied by 16-byte
//    cp.async with adjacent threads on adjacent addresses: no strided
//    channel rows. P (ops/channel_norm.py::nhwc_plan) is a multiple of 8
//    pixels, which keeps every tile 16-byte aligned whatever S, and of the
//    block's round below, within 32 KB: two blocks an SM, where one of 64
//    KB tiles ran 12-25 points further below its bound at every width.
//  * Channels go by quads (4 adjacent: one 8- or 16-byte shared access and
//    one such store). L lanes own a pixel, L the least power of two that
//    holds the row's quads at 4 a lane, at most 32 (4 at C 60, 32 from C
//    480); a lane takes quads q, q + L, ... (NQ slots) of LANE_QUADS / NQ
//    pixels at once, so every lane holds 8 quads in registers and the
//    pixels' shuffle chains interleave. At C 60, 2, 8 and 16 lanes ran 1.6,
//    1.2 and 1.3 times as long as 4: per-pixel work (the butterfly, the
//    divisions) outweighs the channels' at this width.
//    alpha and beta sit in shared memory (in registers they cost the second
//    block an SM at NQ 8). A round of the block is WARPS * (32 / L) *
//    (LANE_QUADS / NQ) pixels.
//  * Each pixel's values are read from shared memory once. Its sum: each
//    lane's quads in turn into 4 float32 partials (a quad's i-th channel
//    into the i-th), combined (p0 + p1) + (p2 + p3), then an xor butterfly
//    over the pixel's L lanes (every lane ends with the same sum); the
//    squared deviations from the mean the same way, by fmaf. The outputs
//    go from registers, a quad a lane, adjacent lanes on adjacent
//    addresses.
//  * S not a multiple of 4, or x or out not 16-byte aligned, takes the same
//    walk with element loads and stores (VEC = false); HiFiC's rows never
//    do. S is at most 4 * 32 * LANE_QUADS = 1024.
// Bound, either route: a HiFiC call's 29 norms move 15.1 GB in bf16 (15.5
// with the padded rows), 4.52 ms (4.64) at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QUAD = 4;     // adjacent pixels a thread (NCHW); adjacent channels (NHWC)
constexpr int STAGES = 3;   // tiles a block holds: one computed, two loading
constexpr int LANE_QUADS = 8;  // NHWC: quads a lane holds, NQ slots x pixels
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four adjacent elements of one channel row, as float32.
__device__ __forceinline__ void load_quad(const float* p, float (&v)[QUAD]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load_quad(const __nv_bfloat16* p, float (&v)[QUAD]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xffff0000u);
}

__device__ __forceinline__ void store_quad(float* p, const float (&y)[QUAD]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}

__device__ __forceinline__ void store_quad(__nv_bfloat16* p, const float (&y)[QUAD]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// alpha and beta are read as stored: float32 (code 0) or bfloat16 (code 1).
__device__ __forceinline__ float load_param(const void* p, int code, int c) {
  return code ? cic::to_f32(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

// Shared memory: STAGES tiles of C x P elements, then the partial sums
// (THREADS * QUAD floats: rows of P), each pixel's mean and rsqrt, alpha
// and beta.
template <typename T>
size_t smem_bytes(int C, int P) {
  return (size_t)STAGES * C * P * sizeof(T) + sizeof(float) * (THREADS * QUAD + 2 * P + 2 * C);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
channel_norm_kernel(const T* __restrict__ x, const void* __restrict__ alpha,
                    const void* __restrict__ beta, int param_code, T* __restrict__ out, int C,
                    int HW, int P, int tiles_per_image, int ntiles, float eps, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_elems = C * P;
  T* tiles = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + (size_t)STAGES * tile_elems * sizeof(T));
  float* mean_s = red + THREADS * QUAD;
  float* rstd_s = mean_s + P;
  float* alpha_s = rstd_s + P;
  float* beta_s = alpha_s + C;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < C; c += THREADS) {
    alpha_s[c] = load_param(alpha, param_code, c);
    beta_s[c] = load_param(beta, param_code, c);
  }
  // The tile's P / 4 pixel quads (a power of two, at most THREADS): thread
  // tid takes quad g over channels k, k + K, ...
  const int G = P / QUAD;
  const int g = tid & (G - 1);
  const int K = THREADS / G;
  const int k = tid / G;
  // Where a warp holds several threads of one quad (G < 32) they combine by
  // shuffles first and the rows of partial sums are the warps; otherwise a
  // warp lies within one k and the rows are the k's.
  const bool in_warp = G < 32;
  const int rows = in_warp ? WARPS : K;
  const int row = in_warp ? warp : k;
  const bool writer = !in_warp || lane < G;

  auto load_tile = [&](int tile, int stage) {
    const int img = tile / tiles_per_image;
    const int p0 = (tile - img * tiles_per_image) * P;
    const T* src = x + ((size_t)img * C) * HW + p0;
    T* dst = tiles + (size_t)stage * tile_elems;
    if constexpr (VEC) {
      constexpr int CH = 16 / sizeof(T);  // elements a 16-byte copy
      const int shift = __ffs(P / CH) - 1;  // chunks a row: a power of two
      const int valid = min(P, HW - p0) / CH;  // HW is a multiple of CH here
      for (int i = tid; i < (C << shift); i += THREADS) {
        const int c = i >> shift, j = i & ((1 << shift) - 1);
        if (j < valid) cp_async16(dst + c * P + j * CH, src + (size_t)c * HW + j * CH);
      }
    } else {
      const int shift = __ffs(P) - 1;
      for (int i = tid; i < (C << shift); i += THREADS) {
        const int c = i >> shift, j = i & (P - 1);
        dst[c * P + j] = p0 + j < HW ? src[(size_t)c * HW + j] : cic::from_f32<T>(0.f);
      }
    }
  };

  // Each pixel's sum of v over the block's threads, in a fixed order, over
  // C into dst[p]: the mean, or with to_rstd rsqrt(variance + eps).
  auto reduce = [&](float (&v)[QUAD], float* dst, bool to_rstd) {
    if (in_warp) {
      for (int off = G; off < 32; off <<= 1) {
#pragma unroll
        for (int i = 0; i < QUAD; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
      }
    }
    if (writer)
      *reinterpret_cast<float4*>(red + row * P + QUAD * g) = make_float4(v[0], v[1], v[2], v[3]);
    __syncthreads();
    for (int p = tid; p < P; p += THREADS) {
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc += red[r * P + p];
      acc = acc / (float)C;
      dst[p] = to_rstd ? rsqrtf(acc + eps) : acc;
    }
    __syncthreads();
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    const int tile = blockIdx.x + s * gridDim.x;
    if (tile < ntiles) load_tile(tile, s);
    cp_async_commit();
  }
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of the tile landed
    __syncthreads();              // everyone's; and the previous tile is done with
    const int ahead = tile + (STAGES - 1) * gridDim.x;
    if (ahead < ntiles) load_tile(ahead, (stage + STAGES - 1) % STAGES);
    cp_async_commit();

    const T* t = tiles + (size_t)stage * tile_elems + QUAD * g;
    float v[QUAD], acc[QUAD] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = k; c < C; c += K) {
      load_quad(t + c * P, v);
#pragma unroll
      for (int i = 0; i < QUAD; ++i) acc[i] += v[i];
    }
    reduce(acc, mean_s, false);

    float m[QUAD], r[QUAD];
#pragma unroll
    for (int i = 0; i < QUAD; ++i) {
      m[i] = mean_s[QUAD * g + i];
      acc[i] = 0.f;
    }
#pragma unroll 4
    for (int c = k; c < C; c += K) {
      load_quad(t + c * P, v);
#pragma unroll
      for (int i = 0; i < QUAD; ++i) {
        const float d = v[i] - m[i];
        acc[i] = fmaf(d, d, acc[i]);
      }
    }
    reduce(acc, rstd_s, true);

#pragma unroll
    for (int i = 0; i < QUAD; ++i) r[i] = rstd_s[QUAD * g + i];
    const int img = tile / tiles_per_image;
    const int p = (tile - img * tiles_per_image) * P + QUAD * g;
    T* o = out + ((size_t)img * C) * HW + p;
    if (p < HW) {
#pragma unroll 4
      for (int c = k; c < C; c += K) {
        load_quad(t + c * P, v);
        const float a = alpha_s[c], b = beta_s[c];
        float y[QUAD];
#pragma unroll
        for (int i = 0; i < QUAD; ++i) {
          y[i] = fmaf((v[i] - m[i]) * r[i], a, b);
          if (relu && y[i] < 0.f) y[i] = 0.f;
        }
        T* oc = o + (size_t)c * HW;
        if constexpr (VEC) {
          store_quad(oc, y);
        } else {
#pragma unroll
          for (int i = 0; i < QUAD; ++i)
            if (p + i < HW) oc[i] = cic::from_f32<T>(y[i]);
        }
      }
    }
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();
}

// NHWC route: shared memory holds STAGES tiles of P rows of S elements,
// then alpha and beta as float32, padded with zeros to whole quads.
template <typename T>
size_t nhwc_smem_bytes(int S, int P) {
  return (size_t)STAGES * S * P * sizeof(T) + sizeof(float) * 2 * QUAD * ((S + QUAD - 1) / QUAD);
}

// NHWC route: quad q of a pixel's row in shared memory, as float32, with
// the channels from C on read as 0 (padding, or past a ragged row's end).
template <bool VEC, typename T>
__device__ __forceinline__ void load_row_quad(const T* row, int q, int C, float (&v)[QUAD]) {
  const int c0 = QUAD * q;
  if constexpr (VEC) {
    load_quad(row + c0, v);
    if (c0 + QUAD > C) {
#pragma unroll
      for (int i = 0; i < QUAD; ++i)
        if (c0 + i >= C) v[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < QUAD; ++i) v[i] = c0 + i < C ? cic::to_f32(row[c0 + i]) : 0.f;
  }
}

// NHWC route. x, out: B * H * W pixels a row of S elements each, the first
// C of them the pixel's channels (S > C: padding channels, written 0).
// L lanes a pixel, each holding NQ quad slots of LANE_QUADS / NQ pixels.
template <typename T, int NQ, bool VEC>
__global__ void __launch_bounds__(THREADS)
channel_norm_nhwc_kernel(const T* __restrict__ x, const void* __restrict__ alpha,
                         const void* __restrict__ beta, int param_code, T* __restrict__ out,
                         int C, int S, int L, long long npix, int P, int ntiles, float eps,
                         int relu) {
  constexpr int R = LANE_QUADS / NQ;  // pixels a lane at once
  extern __shared__ __align__(16) unsigned char smem[];
  const int QS = (S + QUAD - 1) / QUAD;  // quads a row
  const int tile_elems = S * P;
  T* tiles = reinterpret_cast<T*>(smem);
  float* alpha_s = reinterpret_cast<float*>(smem + (size_t)STAGES * tile_elems * sizeof(T));
  float* beta_s = alpha_s + QUAD * QS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = 32 / L;                 // pixels a warp takes in one slot
  const int sub = lane / L, ql = lane & (L - 1);
  const int per_round = WARPS * G * R;  // pixels the block takes at once
  // alpha and beta after the tiles, 0 past C (in registers they would
  // cost the second block an SM at NQ 8)
  for (int c = tid; c < QUAD * QS; c += THREADS) {
    alpha_s[c] = c < C ? load_param(alpha, param_code, c) : 0.f;
    beta_s[c] = c < C ? load_param(beta, param_code, c) : 0.f;
  }

  // Tile `tile`'s pixels, one contiguous span (the last may be short).
  auto load_tile = [&](int tile, int stage) {
    const long long p0 = (long long)tile * P;
    const int n = (int)min((long long)P, npix - p0) * S;
    const T* src = x + (size_t)p0 * S;
    T* dst = tiles + (size_t)stage * tile_elems;
    int i = tid;
    if constexpr (VEC) {
      constexpr int CH = 16 / sizeof(T);  // elements a 16-byte copy
      const int chunks = n / CH;
      for (int j = tid; j < chunks; j += THREADS) cp_async16(dst + j * CH, src + j * CH);
      i = chunks * CH + tid;  // a ragged last tile's last elements
    }
    for (; i < n; i += THREADS) dst[i] = src[i];
  };

  // s[r]: each pixel's sum over its L lanes, xor butterfly.
  auto butterfly = [&](float (&s)[R]) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off < L) {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
      }
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    const int tile = blockIdx.x + s * gridDim.x;
    if (tile < ntiles) load_tile(tile, s);
    cp_async_commit();
  }
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of the tile landed
    __syncthreads();              // everyone's; and the previous tile is done with
    const int ahead = tile + (STAGES - 1) * gridDim.x;
    if (ahead < ntiles) load_tile(ahead, (stage + STAGES - 1) % STAGES);
    cp_async_commit();

    const T* t = tiles + (size_t)stage * tile_elems;
    const long long p0 = (long long)tile * P;
    const int valid = (int)min((long long)P, npix - p0);
    for (int r0 = 0; r0 < valid; r0 += per_round) {
      float v[R][NQ][QUAD];
      int px[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        px[r] = r0 + (r * WARPS + warp) * G + sub;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int q = ql + j * L;
          if (px[r] < valid && q < QS) {
            load_row_quad<VEC>(t + (size_t)px[r] * S, q, C, v[r][j]);
          } else {
#pragma unroll
            for (int i = 0; i < QUAD; ++i) v[r][j][i] = 0.f;
          }
        }
      }
      // Each pixel's sum: the lane's quads in turn into four partials, then
      // (p0 + p1) + (p2 + p3), then the pixel's lanes; so the squared
      // deviations, over its C channels only.
      float s[R], m[R], rs[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a[QUAD] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
#pragma unroll
          for (int i = 0; i < QUAD; ++i) a[i] += v[r][j][i];
        }
        s[r] = (a[0] + a[1]) + (a[2] + a[3]);
      }
      butterfly(s);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] = s[r] / (float)C;
        float a[QUAD] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int c0 = QUAD * (ql + j * L);
          const bool whole = c0 + QUAD <= C;
#pragma unroll
          for (int i = 0; i < QUAD; ++i) {
            if (whole || c0 + i < C) {
              const float d = v[r][j][i] - m[r];
              a[i] = fmaf(d, d, a[i]);
            }
          }
        }
        s[r] = (a[0] + a[1]) + (a[2] + a[3]);
      }
      butterfly(s);
#pragma unroll
      for (int r = 0; r < R; ++r) rs[r] = rsqrtf(s[r] / (float)C + eps);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (px[r] >= valid) continue;
        T* o = out + (size_t)(p0 + px[r]) * S;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int q = ql + j * L;
          if (q >= QS) continue;
          const int c0 = QUAD * q;
          const bool whole = c0 + QUAD <= C;
          const float4 a4 = *reinterpret_cast<const float4*>(alpha_s + c0);
          const float4 b4 = *reinterpret_cast<const float4*>(beta_s + c0);
          const float a[QUAD] = {a4.x, a4.y, a4.z, a4.w}, b[QUAD] = {b4.x, b4.y, b4.z, b4.w};
          float y[QUAD];
#pragma unroll
          for (int i = 0; i < QUAD; ++i) {
            y[i] = fmaf((v[r][j][i] - m[r]) * rs[r], a[i], b[i]);
            if ((relu && y[i] < 0.f) || !(whole || c0 + i < C)) y[i] = 0.f;
          }
          if constexpr (VEC) {
            store_quad(o + c0, y);
          } else {
#pragma unroll
            for (int i = 0; i < QUAD; ++i)
              if (c0 + i < S) o[c0 + i] = cic::from_f32<T>(y[i]);
          }
        }
      }
    }
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();
}

int sm_count() {
  static int count[MAX_DEVICES] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= MAX_DEVICES) return 0;
  if (!count[device] &&
      cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return count[device];
}

// The persistent grid of `kernel` over ntiles tiles with `bytes` of shared
// memory a block: as many blocks as fit on the card, at most one a tile.
template <typename K>
int grid_blocks(K kernel, size_t bytes, long long ntiles, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (per_sm < 1 || sms == 0) return (int)cudaErrorInvalidConfiguration;
  if (ntiles > 0x7fffffffLL - (long long)STAGES * per_sm * sms) return (int)cudaErrorInvalidValue;
  *blocks = (int)(ntiles < (long long)per_sm * sms ? ntiles : (long long)per_sm * sms);
  return 0;
}

template <typename T, bool VEC>
int launch(const void* x, const void* alpha, const void* beta, int param_code, void* out, int B,
           int C, int HW, int P, float eps, int relu, cudaStream_t st) {
  auto kernel = channel_norm_kernel<T, VEC>;
  const size_t bytes = smem_bytes<T>(C, P);
  const int tiles_per_image = (HW + P - 1) / P;
  const long long ntiles = (long long)B * tiles_per_image;
  int blocks = 0;
  if (const int err = grid_blocks(kernel, bytes, ntiles, &blocks)) return err;
  kernel<<<blocks, THREADS, bytes, st>>>(static_cast<const T*>(x), alpha, beta, param_code,
                                         static_cast<T*>(out), C, HW, P, tiles_per_image,
                                         (int)ntiles, eps, relu);
  return (int)cudaGetLastError();
}

template <typename T, int NQ, bool VEC>
int launch_nhwc(const void* x, const void* alpha, const void* beta, int param_code, void* out,
                long long npix, int C, int S, int L, int P, float eps, int relu, cudaStream_t st) {
  auto kernel = channel_norm_nhwc_kernel<T, NQ, VEC>;
  const size_t bytes = nhwc_smem_bytes<T>(S, P);
  const long long ntiles = (npix + P - 1) / P;
  int blocks = 0;
  if (const int err = grid_blocks(kernel, bytes, ntiles, &blocks)) return err;
  kernel<<<blocks, THREADS, bytes, st>>>(static_cast<const T*>(x), alpha, beta, param_code,
                                         static_cast<T*>(out), C, S, L, npix, P, (int)ntiles,
                                         eps, relu);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int dispatch_nhwc(int nq, const void* x, const void* alpha, const void* beta, int param_code,
                  void* out, long long npix, int C, int S, int L, int P, float eps, int relu,
                  cudaStream_t st) {
#define CIC_NHWC(NQ) \
  launch_nhwc<T, NQ, VEC>(x, alpha, beta, param_code, out, npix, C, S, L, P, eps, relu, st)
  switch (nq) {
    case 1: return CIC_NHWC(1);
    case 2: return CIC_NHWC(2);
    case 4: return CIC_NHWC(4);
    case 8: return CIC_NHWC(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CIC_NHWC
}

}  // namespace

// x, out: (B, C, H, W) contiguous, dtype 0 = float32, 1 = bfloat16; alpha,
// beta: (C,) in param_dtype (the same codes). P: pixels a tile, a power of
// two from 4 (float32) or 8 (bfloat16) up to 4 * THREADS.
extern "C" int cic_channel_norm(int dtype, const void* x, const void* alpha, const void* beta,
                                int param_dtype, void* out, int B, int C, int H, int W, int P,
                                float eps, int relu, void* stream) {
  const long long hw = (long long)H * W;
  const int item = dtype == 0 ? 4 : 2;
  if ((dtype & ~1) || (param_dtype & ~1) || B < 1 || C < 1 || H < 1 || W < 1 ||
      hw > 0x7fffffffLL || (long long)C * P > 0x7fffffffLL / 4)
    return (int)cudaErrorInvalidValue;
  if (P < 16 / item || P > QUAD * THREADS || (P & (P - 1))) return (int)cudaErrorInvalidValue;
  const int HW = (int)hw;
  const bool vec = (HW * item) % 16 == 0 &&
                   !((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch<float, true>(x, alpha, beta, param_dtype, out, B, C, HW, P, eps, relu, st)
               : launch<float, false>(x, alpha, beta, param_dtype, out, B, C, HW, P, eps, relu, st);
  return vec ? launch<__nv_bfloat16, true>(x, alpha, beta, param_dtype, out, B, C, HW, P, eps,
                                           relu, st)
             : launch<__nv_bfloat16, false>(x, alpha, beta, param_dtype, out, B, C, HW, P, eps,
                                            relu, st);
}

// x, out: (B, S, H, W) in channels_last strides, B * H * W pixels of S
// contiguous elements: the C channels alpha and beta (C,) normalize, then
// S - C padding channels, written 0. Dtype codes as above. P: pixels a
// tile, a multiple of 8; L: lanes a pixel, a power of two up to 32 with
// L * LANE_QUADS quads at least a row's.
extern "C" int cic_channel_norm_nhwc(int dtype, const void* x, const void* alpha,
                                     const void* beta, int param_dtype, void* out, int B, int C,
                                     int S, int H, int W, int P, int L, float eps, int relu,
                                     void* stream) {
  const long long npix = (long long)B * H * W;
  if ((dtype & ~1) || (param_dtype & ~1) || B < 1 || C < 1 || S < C || H < 1 || W < 1 ||
      P < 8 || P % 8 || L < 1 || L > 32 || (L & (L - 1)) || (long long)S * P > 0x7fffffffLL / 4)
    return (int)cudaErrorInvalidValue;
  const int QS = (S + QUAD - 1) / QUAD;
  int nq = 1;
  while (nq * L < QS) nq <<= 1;
  if (nq > LANE_QUADS) return (int)cudaErrorInvalidValue;
  const bool vec = S % QUAD == 0 &&
                   !((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? dispatch_nhwc<float, true>(nq, x, alpha, beta, param_dtype, out, npix, C, S, L,
                                            P, eps, relu, st)
               : dispatch_nhwc<float, false>(nq, x, alpha, beta, param_dtype, out, npix, C, S, L,
                                             P, eps, relu, st);
  return vec ? dispatch_nhwc<__nv_bfloat16, true>(nq, x, alpha, beta, param_dtype, out, npix, C,
                                                  S, L, P, eps, relu, st)
             : dispatch_nhwc<__nv_bfloat16, false>(nq, x, alpha, beta, param_dtype, out, npix, C,
                                                   S, L, P, eps, relu, st);
}
