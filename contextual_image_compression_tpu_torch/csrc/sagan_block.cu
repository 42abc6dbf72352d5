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
// float32 (training's dtype, bar 1e-5 against the twin), two launches on the
// tensor cores, every product as three TF32 passes a_hi b_hi + a_hi b_lo +
// a_lo b_hi (hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi), summed in
// float32): (1) qkv_tf32_kernel, one GEMM x (B N x C) . [Wq | Wk | Wv]^T, a
// block per 64 positions x 64 outputs, the depth C in chunks of 64 channels
// (51,200 bytes of shared memory and 204 registers a thread, two blocks an
// SM, so one block's staging overlaps the other's products): the chunk's weight tiles, TF32 hi and lo
// that the wrapper splits once a call, K-major and 128-byte swizzled, by
// TMA; its x values in float32 with every load of a thread in flight, from
// either stride pattern into one layout (so K7a and K7b get bitwise the same
// Q, K and V; rows 68 floats apart, so the A fragments' loads are free of
// bank conflicts), split into hi and lo in registers as the A operand. Q's
// and K's columns are zero-padded to 32 or 64 so that each 64-column tile is
// all Q / K or all V. The epilogue adds the float32 bias and writes the TF32
// hi and lo of Q, K and V^T straight into the scratch layout of K2's float32
// kernel (attention.cuh Tf32Scratch: V^T's keys in the fragment order, zeros
// at keys >= N), so K2's pre-pass is not needed. (2) K2's attn_tf32_kernel on
// that scratch with x as the residual, its strided epilogue for any layout
// but a contiguous (B, N, C). Bound at B = 16, N = 1024, C = 256: 3 x 12.35
// GFLOP at the TF32 rate, 0.0748 ms; 0.184 ms at the CUDA cores' float32
// rate.
//
// Order of the float32 sums. The tensor cores' float32 sums are not exact:
// every k8 step aligns its terms to the largest (the running sum included)
// and drops the low bits, so each step loses bits at the scale of the
// running sum. Summed in one accumulator each, the projections over C, the
// scores and e.V over all N keys sat up to 1.5e-5 from the twin at the
// path's scale (PERF.md, scripts/torch_k7_f32_error.py). So the GEMM keeps
// its lo terms in an accumulator of their own and restarts the hi.hi sum
// every 64-channel chunk, adding the chunks in float32; K2's kernel runs
// with K7's order (attention.cu score_mma_apart: the lo terms of the scores
// first; e.V in segments of TF32_SEG_TILES key tiles, each from zero, added
// in float32 through the scratch's acc).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

using namespace cic::attn;

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

// ------------------------------------------ float32: three TF32 passes

namespace tfp {

using namespace cic::hop;

constexpr int ROWS = 64;      // positions per block
constexpr int COLS = 64;      // outputs per block
constexpr int THREADS = 128;  // one warpgroup
constexpr int KC = 64;        // channels a chunk of the depth
constexpr int KCB = KC / 32;  // 32-channel blocks a chunk
constexpr int XSTR = KC + 4;  // floats between rows of the x chunk (4 mod 32 banks)
constexpr int W_TILE = 64 * 128;  // 64 outputs x 32 channels of one weight half, swizzled
constexpr int TS = ROWS + 1;      // the epilogue's transposed V tile: floats a column
constexpr int SMEM = 2 * KCB * W_TILE + ROWS * XSTR * 4 + 1024;  // 51,200 bytes
static_assert(COLS * TS <= ROWS * XSTR, "V's tile fits the place of x");

// Key n % 8 of a group of 8 goes to slot key_slot(n % 8) of V^T: key 2t to
// t, key 2t + 1 to t + 4 (attention.cuh Tf32Scratch).
__device__ __forceinline__ int key_slot(int e) { return (e >> 1) + ((e & 1) << 2); }

// x . wqkv^T + bias for 64 positions x 64 outputs, as TF32 hi and lo into the
// scratch s. x at element strides (batch, position, channel); wmap: the
// weights (2, NOUT, C), the hi then the lo half, rows [Wq^T; 0; Wk^T; 0;
// Wv^T] with Q's and K's rows zero-padded to dkp, NOUT = 2 dkp + C, as a
// (C, NOUT, 2) map with 32 x 64 x 1 boxes, 128-byte swizzled; bias (NOUT)
// float32, zeros in the padding. The depth goes in chunks of KC channels:
// the chunk's weight tiles by TMA, its x values with every load of a thread
// in flight, then 6 KC / 8 products; two blocks share an SM, so one's
// staging overlaps the other's products.
__global__ void __launch_bounds__(THREADS)
qkv_tf32_kernel(__grid_constant__ const CUtensorMap wmap, const float* __restrict__ x,
                long long sxb, long long sxn, long long sxc, int vec_x,
                const float* __restrict__ bias, const Tf32Scratch s, int B, int N, int C) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t wbar;
  unsigned char* wt = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* xs = reinterpret_cast<float*>(wt + 2 * KCB * W_TILE);
  const int tid = threadIdx.x;
  const int dkp = s.dkp;
  const int rows = B * N, row0 = blockIdx.x * ROWS;  // B N < 2^31 (the entry point checks)
  const int j0 = blockIdx.y * COLS;
  const int warp = tid >> 5, lane = tid & 31, qd = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);

  if (tid == 0) {
    mbar_init(&wbar, 1);
    mbar_init_fence();
  }
  // this thread's x rows: the vectorized path's piece i = tid + u THREADS is
  // row i / 16, channels 4 (i % 16) of the chunk; the strided one's, row
  // tid % 64, channels tid / 64 + 2 u
  const int vr = tid >> 4, sr = tid % ROWS;
  long long vbase[ROWS * KC / 4 / THREADS], sbase;
#pragma unroll
  for (int u = 0; u < ROWS * KC / 4 / THREADS; ++u) {
    const int g = row0 + vr + 8 * u;
    vbase[u] = g < rows ? (long long)(g / N) * sxb + (long long)(g % N) * sxn : -1;
  }
  {
    const int g = row0 + sr;
    sbase = g < rows ? (long long)(g / N) * sxb + (long long)(g % N) * sxn : -1;
  }

  // D = x . W^T: per 32-channel block, the A fragments of its four k8
  // slices from xs, split in registers, and 12 products: lo.hi and hi.lo
  // into dc over the whole depth, hi.hi into d from zero in each chunk,
  // added to dsum in float32 after the chunk. The tensor cores' float32
  // sums align their terms to the largest and drop the low bits, so a
  // product added into a large running sum loses more: the running sum of
  // the big terms is kept off the tensor cores, the small ones sum apart.
  float d[32], dc[32], dsum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = dc[i] = dsum[i] = 0.f;
  uint32_t ah[KCB][4][4], al[KCB][4][4];
  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the chunk before is read: its x by every thread, its W by the products
    if (tid == 0) {
      mbar_arrive_tx(&wbar, 2 * KCB * W_TILE);
      for (int h = 0; h < 2; ++h)
        for (int j = 0; j < KCB; ++j)
          tma_load_3d(wt + (h * KCB + j) * W_TILE, &wmap, &wbar, c0 + 32 * j, j0, h);
    }
    if (vec_x) {  // channels contiguous: neighbouring threads on neighbouring 16-byte pieces
      constexpr int PER = ROWS * KC / 4 / THREADS;  // 8
      float4 v[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u)
        v[u] = vbase[u] >= 0 ? *reinterpret_cast<const float4*>(x + vbase[u] + c0 + (tid & 15) * 4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < PER; ++u)
        *reinterpret_cast<float4*>(xs + (vr + 8 * u) * XSTR + (tid & 15) * 4) = v[u];
    } else {  // any strides: neighbouring threads on neighbouring positions (the NCHW view)
      constexpr int PER = KC / 2;  // 32
      float v[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u)
        v[u] = sbase >= 0 ? x[sbase + (long long)(c0 + tid / ROWS + 2 * u) * sxc] : 0.f;
#pragma unroll
      for (int u = 0; u < PER; ++u) xs[sr * XSTR + tid / ROWS + 2 * u] = v[u];
    }
    __syncthreads();
    mbar_wait(&wbar, (c0 / KC) & 1);

    const float* xa = xs + r0 * XSTR + qd;
#pragma unroll
    for (int j = 0; j < KCB; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* p = xa + j * 32 + kk * 8;
        tf32_split(p[0], ah[j][kk][0], al[j][kk][0]);
        tf32_split(p[8 * XSTR], ah[j][kk][1], al[j][kk][1]);
        tf32_split(p[4], ah[j][kk][2], al[j][kk][2]);
        tf32_split(p[8 * XSTR + 4], ah[j][kk][3], al[j][kk][3]);
      }
    fence_regs(d);
    fence_regs(dc);
#pragma unroll
    for (int j = 0; j < KCB; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ah[j][kk]);
        fence_regs(al[j][kk]);
      }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KCB; ++j) {
      const uint64_t dh = sw128_desc(wt + j * W_TILE, 16, 1024);
      const uint64_t dl = sw128_desc(wt + (KCB + j) * W_TILE, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_m64n64k8_tf32(dc, al[j][kk], dh + 2 * kk);
        wgmma_rs_m64n64k8_tf32(dc, ah[j][kk], dl + 2 * kk);
        wgmma_rs_m64n64k8_tf32(d, ah[j][kk], dh + 2 * kk, j > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    fence_regs(dc);
#pragma unroll
    for (int i = 0; i < 32; ++i) dsum[i] = __fadd_rn(dsum[i], d[i]);
#pragma unroll
    for (int j = 0; j < KCB; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ah[j][kk]);
        fence_regs(al[j][kk]);
      }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = __fadd_rn(dsum[i], dc[i]);

  // Epilogue: + bias in float32, then TF32 hi and lo into the scratch.
  // d[i]: row r0 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 qd + i % 2.
  if (j0 < 2 * dkp) {  // Q or K columns: (B N, dkp) rows, two columns a store
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int g = row0 + r0 + 8 * ((i >> 1) & 1), col = j0 + 8 * (i >> 2) + 2 * qd;
      if (g >= rows) continue;
      uint32_t h0, l0, h1, l1;
      tf32_split(__fadd_rn(d[i], bias[col]), h0, l0);
      tf32_split(__fadd_rn(d[i + 1], bias[col + 1]), h1, l1);
      const bool is_q = col < dkp;
      const size_t at = (size_t)g * dkp + (is_q ? col : col - dkp);
      *reinterpret_cast<float2*>((is_q ? s.qh : s.kh) + at) =
          make_float2(__uint_as_float(h0), __uint_as_float(h1));
      *reinterpret_cast<float2*>((is_q ? s.ql : s.kl) + at) =
          make_float2(__uint_as_float(l0), __uint_as_float(l1));
    }
    return;
  }
  // V columns: transposed through shared memory (x's place, read out), then
  // each key's hi and lo to its slot of V^T, neighbouring threads on
  // neighbouring keys; the block with an image's last key also writes the
  // zeros of its keys N .. np - 1
  __syncthreads();  // every thread's fragments of the last chunk are loaded
  float* ts = xs;  // [COLS][TS]
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = r0 + 8 * ((i >> 1) & 1), cl = 8 * (i >> 2) + 2 * qd + (i & 1);
    ts[cl * TS + r] = __fadd_rn(d[i], bias[j0 + cl]);
  }
  __syncthreads();
  const int cv0 = j0 - 2 * dkp;
  for (int idx = tid; idx < ROWS * COLS; idx += THREADS) {
    const int cl = idx >> 6, r = idx & 63, g = row0 + r;
    if (g >= rows) continue;
    const int b = g / N, n = g - b * N;
    const size_t vrow = ((size_t)b * C + cv0 + cl) * s.np;
    uint32_t hi, lo;
    tf32_split(ts[cl * TS + r], hi, lo);
    const int slot = (n & ~7) + key_slot(n & 7);
    s.vh[vrow + slot] = __uint_as_float(hi);
    s.vl[vrow + slot] = __uint_as_float(lo);
    if (n == N - 1)
      for (int nk = N; nk < s.np; ++nk) {
        const int pad = (nk & ~7) + key_slot(nk & 7);
        s.vh[vrow + pad] = 0.f;
        s.vl[vrow + pad] = 0.f;
      }
  }
}

int launch(const void* x, const long long* sx, const float* wqkv, const float* bias,
           const float* gamma, void* scratch, long long scratch_elems, void* out,
           const long long* so, int B, int N, int C, int DK, cudaStream_t st) {
  static int smem_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(qkv_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = 1;
  }
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (scratch == nullptr || scratch_elems < tf32_scratch_elems(B, N, DK, C, true))
    return (int)cudaErrorInvalidValue;
  if (!aligned(scratch) || !aligned(wqkv)) return (int)cudaErrorMisalignedAddress;
  const Tf32Scratch s = tf32_scratch(scratch, B, N, DK, C, true);
  CUtensorMap wmap;
  const long long wdims[3] = {C, 2 * s.dkp + C, 2};
  const int wbox[3] = {32, COLS, 1};
  const int e = encode_f32_map(&wmap, wqkv, 3, wdims, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  const int vec_x = sx[2] == 1 && sx[1] % 4 == 0 && sx[0] % 4 == 0 && aligned(x);
  const dim3 grid((unsigned)(((long long)B * N + ROWS - 1) / ROWS), (2 * s.dkp + C) / COLS);
  qkv_tf32_kernel<<<grid, THREADS, SMEM, st>>>(wmap, static_cast<const float*>(x), sx[0], sx[1],
                                               sx[2], vec_x, bias, s, B, N, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a contiguous (B, N, C) x and output take K2's own epilogue, any other
  // layout the strided one
  const bool dense = sx[0] == (long long)N * C && sx[1] == C && sx[2] == 1 &&
                     so[0] == (long long)N * C && so[1] == C && so[2] == 1;
  const cic::attn::Strides strides{sx[0], sx[1], sx[2], so[0], so[1], so[2]};
  return cic::attn::tf32_block(s, x, gamma, out, B, N, DK, C, dense ? nullptr : &strides, st);
}

}  // namespace tfp

}  // namespace

// float32. x: (B, N, C) read at element strides sxb, sxn, sxc (batch,
// position, channel); wqkv: (2, 2 dkp + C, C), TF32 hi then lo of the rows
// [Wq^T; 0; Wk^T; 0; Wv^T] (Q's and K's rows zero-padded to dkp = 32 for
// DK <= 32, else 64); bias: (2 dkp + C) float32, zeros in the padding; gamma:
// one float32 on the device; scratch: float32, scratch_elems of them (the
// TF32 scratch of attention.cuh, 16-byte aligned); out: (B, N, C) written at
// element strides sob, son, soc. DK <= 64, C in 64..256 in steps of 64.
extern "C" int cic_sagan_block(const void* x, long long sxb, long long sxn, long long sxc,
                               const void* wqkv, const float* bias, const float* gamma,
                               void* scratch, long long scratch_elems, void* out, long long sob,
                               long long son, long long soc, int B, int N, int C, int DK,
                               void* stream) {
  const long long sx[3] = {sxb, sxn, sxc};
  const long long so[3] = {sob, son, soc};
  if (DK < 1 || DK > DK_MAX || C < 64 || C > DV_MAX || C % 64 != 0 || N < 1 || B < 1 ||
      (long long)B * N >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return tfp::launch(x, sx, static_cast<const float*>(wqkv), bias, gamma, scratch, scratch_elems,
                     out, so, B, N, C, DK, static_cast<cudaStream_t>(stream));
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
