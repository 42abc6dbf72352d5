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
// 227 KB of shared memory, and recomputing it in each of an image's query
// blocks would redo the projection many times, so both routes write the
// projections to a scratch in x's dtype that stays in the 50 MB L2 (10.5 MB
// at B = 16, N = 1024, C = 256) and run the attention from there.
//
// bf16, two launches on the tensor cores. (1) qkv_proj_kernel: one wgmma GEMM
// x (B N x C) . [Wq | Wk | Wv] (C x (2 DK + C)), a block per 64 positions x
// 64 outputs with the whole depth C in shared memory. x is staged into one
// 128-byte-swizzled K-major layout from either stride pattern (16-byte loads
// where channels are contiguous, 8-channel gathers along positions for the
// NCHW view), so the products, and Q, K and V, are bitwise the same whatever
// the caller's layout. The wrapper packs the three weights K-major,
// (2 DK + C) x C, with a float32 bias beside them; the epilogue adds the
// bias in float32 and rounds to bf16 into contiguous Q, K and V through
// shared memory, 16 bytes a store. At the path shape it takes ~30 us, most
// of it staging (clock64 stamps, PERF.md): a version that kept x and all of
// W in shared memory for 128 positions (each read once) measured no faster.
// (2) K2's attn_tc_kernel (attention.cu) on that scratch, with x as the
// residual: its contiguous epilogue for a contiguous (B, N, C) x, its strided
// one (residual read and output written at element strides, the same float32
// arithmetic) for any other layout. Bound on the H100 at B = 16, N = 1024,
// C = 256: 2.68 GFLOP of projections + 9.66 GFLOP of attention, 0.0125 ms on
// the bf16 tensor cores; the attention launch takes most of the time.
//
// float32 (bar 1e-5 against the twin) keeps the CUDA-core route: a first
// launch (kv_proj_kernel, a 64 x 64 tiled float32 GEMM) writes K and V; the
// second (sagan_attn_kernel) projects its own 64-row q tile from x in its
// prologue and runs attention.cuh's flash loop over the scratch; it is bound
// by float32 FMA throughput.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------- bf16: the QKV projection

namespace tcp {

using namespace cic::hop;

constexpr int ROWS = 64;      // positions per block
constexpr int COLS = 64;      // outputs per block
constexpr int THREADS = 128;  // one warpgroup
constexpr int KT_MAX = 4;     // 64-channel slices of C <= 256
constexpr int SMEM = 2 * KT_MAX * TILE_BYTES + 1024;

// Q (B N, DK), K (B N, DK), V (B N, C) = x . wqkv^T + bias, rounded to bf16,
// for 64 positions x 64 outputs. x at element strides (batch, position,
// channel); wqkv (NOUT = 2 DK + C, C) K-major with rows [Wq^T; Wk^T; Wv^T]
// (rows past NOUT read as zeros), bias (NOUT) float32.
__global__ void __launch_bounds__(THREADS)
qkv_proj_kernel(const __nv_bfloat16* __restrict__ x, long long sxb, long long sxn, long long sxc,
                int vec_x, const __nv_bfloat16* __restrict__ wqkv, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ qo, __nv_bfloat16* __restrict__ ko,
                __nv_bfloat16* __restrict__ vo, int B, int N, int C, int DK) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* at = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* wt = at + KT_MAX * TILE_BYTES;
  const int tid = threadIdx.x, KT = C / 64;
  const int nout = 2 * DK + C;
  const int rows = B * N, row0 = blockIdx.x * ROWS;  // B N < 2^31 (the entry point checks)
  const int j0 = blockIdx.y * COLS;
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
  const uint16_t* ws = reinterpret_cast<const uint16_t*>(wqkv);

  // x rows row0 .. + 63, all C channels: KT swizzled 64 x 64 tiles; piece
  // tid + i * THREADS, 8 pieces' loads in flight before any is stored
  constexpr int PER = KT_MAX * 512 / THREADS;  // 16 pieces a thread at C = 256
#pragma unroll
  for (int i0 = 0; i0 < PER; i0 += 8) {
    uint16_t raw[8][8];
    uint4 vec[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = tid + (i0 + i) * THREADS;
      int kt, r, ch;
      if (vec_x) {  // neighbouring threads on neighbouring 16-byte channel pieces
        kt = c >> 9, r = (c >> 3) & 63, ch = c & 7;
      } else {      // neighbouring threads on neighbouring positions
        kt = c >> 9, ch = (c >> 6) & 7, r = c & 63;
      }
      const int g = row0 + r;
      const bool in = kt < KT && g < rows;
      const int b = g / N, n = g % N, col = kt * 64 + ch * 8;
      const uint16_t* p = xs + b * sxb + n * sxn + col * sxc;
      vec[i] = make_uint4(0u, 0u, 0u, 0u);
      if (vec_x) {
        if (in) vec[i] = *reinterpret_cast<const uint4*>(p);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) raw[i][e] = in ? p[e * sxc] : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = tid + (i0 + i) * THREADS;
      const int kt = c >> 9;
      if (kt >= KT) continue;
      const int r = vec_x ? (c >> 3) & 63 : c & 63, ch = vec_x ? c & 7 : (c >> 6) & 7;
      uint4 val = vec[i];
      if (!vec_x)
        val = make_uint4(raw[i][0] | ((uint32_t)raw[i][1] << 16), raw[i][2] | ((uint32_t)raw[i][3] << 16),
                         raw[i][4] | ((uint32_t)raw[i][5] << 16), raw[i][6] | ((uint32_t)raw[i][7] << 16));
      store_chunk_sw128(at + kt * TILE_BYTES, r, ch, val);
    }
  }
  // weight rows j0 .. + 63 (outputs), all C channels
  {
    uint4 val[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * THREADS, kt = c >> 9, r = (c >> 3) & 63, ch = c & 7;
      val[i] = kt < KT && j0 + r < nout
                   ? *reinterpret_cast<const uint4*>(ws + (size_t)(j0 + r) * C + kt * 64 + ch * 8)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * THREADS, kt = c >> 9;
      if (kt < KT) store_chunk_sw128(wt + kt * TILE_BYTES, (c >> 3) & 63, c & 7, val[i]);
    }
  }
  fence_proxy_async();
  __syncthreads();

  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < KT_MAX; ++kt) {
    if (kt < KT) {
      const uint64_t da = sw128_desc(at + kt * TILE_BYTES, 16, 1024);
      const uint64_t db = sw128_desc(wt + kt * TILE_BYTES, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_m64n64k16(d, da + 2 * kk, db + 2 * kk, 1);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);

  // Epilogue: + bias in float32, rounded to bf16, through shared memory (the
  // first x tile, consumed) as a 64 x 64 tile of 128-byte rows, swizzled by
  // row; then 16-byte pieces of 8 outputs into Q, K or V where a piece lies
  // in one of them at a 16-byte boundary, single values elsewhere.
  // d[i]: row 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
  const int warp = tid >> 5, lane = tid & 31;
  __syncthreads();  // every warp's products have read the x tiles
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1), cl = 8 * (i >> 2) + 2 * (lane & 3);
    const int col = j0 + cl;
    const float b0 = col < nout ? bias[col] : 0.f, b1 = col + 1 < nout ? bias[col + 1] : 0.f;
    const __nv_bfloat162 y = __floats2bfloat162_rn(__fadd_rn(d[i], b0), __fadd_rn(d[i + 1], b1));
    *reinterpret_cast<__nv_bfloat162*>(at + r * 128 + (((cl >> 3) ^ (r & 7)) << 4) + (cl & 7) * 2) = y;
  }
  __syncthreads();
  uint16_t* q16 = reinterpret_cast<uint16_t*>(qo);
  uint16_t* k16 = reinterpret_cast<uint16_t*>(ko);
  uint16_t* v16 = reinterpret_cast<uint16_t*>(vo);
  auto dest = [&](int g, int col) -> uint16_t* {
    if (col < DK) return q16 + (size_t)g * DK + col;
    if (col < 2 * DK) return k16 + (size_t)g * DK + col - DK;
    return v16 + (size_t)g * C + col - 2 * DK;
  };
  for (int piece = tid; piece < 64 * 8; piece += THREADS) {
    const int r = piece >> 3, ch = piece & 7, col = j0 + ch * 8;
    const int g = row0 + r;
    if (g >= rows || col >= nout) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(at + r * 128 + ((ch ^ (r & 7)) << 4));
    uint16_t* to = dest(g, col);
    const bool one = (col + 7 < DK) || (col >= DK && col + 7 < 2 * DK) ||
                     (col >= 2 * DK && col + 7 < nout);
    if (one && (reinterpret_cast<uintptr_t>(to) & 15) == 0) {
      *reinterpret_cast<uint4*>(to) = val;
    } else {
      const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e < nout) *dest(g, col + e) = (uint16_t)(w[e >> 1] >> (16 * (e & 1)));
    }
  }
}

int launch(const void* x, const long long* sx, const void* wqkv, const float* bias,
           const float* gamma, void* qbuf, void* kbuf, void* vbuf, void* out, const long long* so,
           int B, int N, int C, int DK, cudaStream_t st) {
  static int smem_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(qkv_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = 1;
  }
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec_x = sx[2] == 1 && sx[1] % 8 == 0 && sx[0] % 8 == 0 && aligned(x);
  const dim3 grid((unsigned)(((long long)B * N + ROWS - 1) / ROWS), (2 * DK + C + COLS - 1) / COLS);
  qkv_proj_kernel<<<grid, THREADS, SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x), sx[0], sx[1], sx[2], vec_x,
      static_cast<const __nv_bfloat16*>(wqkv), bias, static_cast<__nv_bfloat16*>(qbuf),
      static_cast<__nv_bfloat16*>(kbuf), static_cast<__nv_bfloat16*>(vbuf), B, N, C, DK);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a contiguous (B, N, C) x and output take K2's own epilogue, any other
  // layout the strided one
  const bool dense = sx[0] == (long long)N * C && sx[1] == C && sx[2] == 1 &&
                     so[0] == (long long)N * C && so[1] == C && so[2] == 1 && aligned(out);
  const cic::attn::Strides strides{sx[0], sx[1], sx[2], so[0], so[1], so[2]};
  return cic::attn::tc_block(qbuf, kbuf, vbuf, x, gamma, out, B, N, DK, C,
                             dense ? nullptr : &strides, st);
}

}  // namespace tcp

}  // namespace

// float32 (x, the weights, the scratch and out). x: (B, N, C) read at element
// strides sxb, sxn, sxc (batch, position, channel); wq, wk: (C, DK) and wv:
// (C, DV) row-major (in, out); bq, bk, bv float32; gamma: one float32 on the
// device; kbuf (B, N, DK) and vbuf (B, N, DV) contiguous scratch; out:
// (B, N, DV) written at element strides sob, son, soc. DV must equal C (the
// residual), DK <= 64, DV in 64..256 in steps of 64.
extern "C" int cic_sagan_block(const void* x, long long sxb, long long sxn, long long sxc,
                               const void* wq, const float* bq, const void* wk, const float* bk,
                               const void* wv, const float* bv, const float* gamma, void* kbuf,
                               void* vbuf, void* out, long long sob, long long son, long long soc,
                               int B, int N, int C, int DK, int DV, void* stream) {
  const long long sx[3] = {sxb, sxn, sxc};
  const long long so[3] = {sob, son, soc};
  if (DK < 1 || DK > DK_MAX || DV != C || DV < 64 || DV > DV_MAX || DV % 64 != 0 || N < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  return launch<float>(x, sx, wq, bq, wk, bk, wv, bv, gamma, kbuf, vbuf, out, so, B, N, C, DK,
                       DV, static_cast<cudaStream_t>(stream));
}

// bf16. x and out as cic_sagan_block; wqkv: (2 DK + C, C) bf16, rows
// [Wq^T; Wk^T; Wv^T]; bias: the same rows' float32 biases; qbuf,
// kbuf (B, N, DK) and vbuf (B, N, C) contiguous bf16 scratch. DK <= 64, C in
// 64..256 in steps of 64.
extern "C" int cic_sagan_block_bf16(const void* x, long long sxb, long long sxn, long long sxc,
                                    const void* wqkv, const float* bias, const float* gamma,
                                    void* qbuf, void* kbuf, void* vbuf, void* out, long long sob,
                                    long long son, long long soc, int B, int N, int C, int DK,
                                    void* stream) {
  const long long sx[3] = {sxb, sxn, sxc};
  const long long so[3] = {sob, son, soc};
  if (DK < 1 || DK > DK_MAX || C < 64 || C > DV_MAX || C % 64 != 0 || N < 1 || B < 1 ||
      (long long)B * N >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return tcp::launch(x, sx, wqkv, bias, gamma, qbuf, kbuf, vbuf, out, so, B, N, C, DK,
                     static_cast<cudaStream_t>(stream));
}
