// K2: the SAGAN attention block  out = gamma * softmax(Q K^T) V + residual,
// and K6: the attention core  out = softmax(Q K^T) V, as one kernel.
//
// K2 replaces contextual_image_compression_tpu/ops/attention.py::
// attention_block_pallas (forward _attention_pallas_fwd, body
// _attn_block_kernel); K6 replaces attention_core_pallas (body _attn_kernel),
// which is K2 without the epilogue. Semantics kept from the TPU kernels: no
// 1/sqrt(d) scaling; scores in float32; the softmax numerator e = exp(s - m),
// with m the row's max over all keys, rounded to V's dtype before the e.V
// product while the row sum uses the unrounded float32 e; normalization after
// the product. K2's epilogue is gamma * (1 / l) * acc + residual in float32;
// K6's (a null residual) is acc * (1 / l), `ctx * recip` of _attn_kernel; one
// store in the tensors' dtype.
//
// What bounds it on the H100: per image 2 * N^2 * (DK + DV) = 0.6 GFLOP at
// N = 1024, DK = 32, DV = 256 against ~1.7 MB of q, k, v, residual and
// output, about 350 FLOP per byte, above the bf16 tensor cores' balance point
// (~295): the products bound it, and next to them the N^2 exponentials.
//
// bf16 (the serving path) runs on the tensor cores (attn_tc_kernel): a block
// owns 128 query rows of one image, as two consumer warpgroups of 64 rows and
// a producer warpgroup whose one working warp streams 64-key tiles of K (and,
// in the second pass, V) by TMA into a ring of STAGES shared-memory stages,
// 128-byte swizzled, signalled by mbarriers. Pass 1 computes S = Q K^T with
// wgmma and keeps the row max m only, the global max of _attn_kernel; pass 2
// recomputes S, forms e = expf(s - m) in float32, adds the unrounded e to the
// row sum and accumulates O += bf16(e) . V with wgmma, taking bf16(e) from
// registers: so the rounding is the TPU kernel's and the twin's, and the
// accumulator is never rescaled. Recomputing S costs DK / (DK + DV) more
// products (11% at DK = 32, DV = 256). The two warpgroups take turns on the
// tensor cores (named barriers): one runs its exponentials while the other's
// products run. The epilogue goes through shared memory so that the residual
// is read and the output written in 16-byte pieces. A K tile whose rows are
// not 16-byte multiples (DK % 8 != 0), or a tensor whose address is not
// 16-byte aligned, is staged by the producer warp with ordinary loads into the
// same swizzled layout instead of by TMA.
//
// Where its time goes at the serving shape (clock64 stamps on an H100; see
// PERF.md): pass 2 most of it, each 64-key tile a chain of products and
// accurate expf that the two warpgroups' turns overlap only in part; pass 1
// a smaller share; the epilogue, which writes the whole output at once, and
// the first loads the rest. The exponentials are expf, not exp2f, so that e is the
// twin's. The kernel is templated on DV / 64 only: DK's 16-wide slices are a
// runtime bound, around which ptxas adds wgmma fences (its C7519 notes); a
// template on ceil(DK / 16) as well built four times as many instantiations
// for a slightly faster S. 384 threads start at 168 registers, and setmaxnreg
// moves the producer's to the consumers, whose 64 x DV float32 accumulator
// needs up to 128 of them; the launcher refuses a build that starts at
// another count.
//
// float32 (training, one call a step, bar 1e-5 with TF32 off) runs on the
// tensor cores too (attn_tf32_kernel), as three TF32 passes per product:
// a_hi b_hi + a_hi b_lo + a_lo b_hi, with hi = cvt.rna.tf32(x) and lo =
// cvt.rna.tf32(x - hi), accumulated in float32 (see namespace tf below). Its
// bound is the tensor cores' TF32 rate for three passes: 3 * 2 * N^2 * (DK +
// DV) per image at 495 TFLOP/s, 0.0586 ms at B = 16 against 0.0163 ms for the
// 54.5 MB of float32 q, k, v, residual and output. K7's float32 attention
// (cic::attn::tf32_block) runs the same kernel with another order of sums
// (APART: score_mma_apart, e.V in segments added in float32), which holds
// K7's bar at the scale of its scores; K2 / K6 keep theirs, bit for bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

using namespace cic::attn;

// ------------------------------------------------------ bf16: tensor cores

namespace tc {

using namespace cic::hop;

constexpr int ROWS = 128;                 // query rows per block
constexpr int KEYS = 64;                  // keys per tile
constexpr int STAGES = 4;                 // ring depth
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup (one warp loads)
// Registers a thread: at 384 threads a block starts at 168; the producer
// gives up all but 40, the consumers take 232 (128 * 40 + 256 * 232 = 384 * 168).
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int BAR_TURN = 1;               // named barriers 1, 2: whose turn on the tensor cores
constexpr int BAR_Q = 3;                  // named barriers 3, 4: within one warpgroup

template <int NCH>
constexpr int smem_bytes() {
  return (2 + STAGES * (1 + NCH)) * TILE_BYTES + 2 * STAGES * 8 + 1024;
}

// Rows row0 .. row0 + 63, columns col0 .. col0 + 63 of a row-major (nrows,
// width) bf16 array into a swizzled tile, zero outside the array; chunks idx,
// idx + stride, ... of the tile's 512. 16-byte loads where the rows allow.
__device__ __forceinline__ void stage_tile(unsigned char* tile, const uint16_t* __restrict__ src,
                                           int row0, int nrows, int width, int col0, int idx,
                                           int stride) {
  const bool vec = width % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int c = idx; c < 64 * 8; c += stride) {
    const int r = c >> 3, ch = c & 7, n = row0 + r, col = col0 + ch * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n < nrows && col < width) {
      const uint16_t* at = src + (size_t)n * width + col;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(at);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t lo = col + 2 * e < width ? at[2 * e] : 0u;
          const uint32_t hi = col + 2 * e + 1 < width ? at[2 * e + 1] : 0u;
          w[e] = lo | (hi << 16);
        }
        val = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    store_chunk_sw128(tile, r, ch, val);
  }
}

// S = Q K^T over ksteps (1..4) slices of 16 of DK; the Q and K tiles are
// zero beyond DK, so any ksteps >= ceil(DK / 16) gives the same S.
__device__ __forceinline__ void score_mma(float (&s)[32], uint64_t dq, uint64_t dk, int ksteps) {
  wgmma_ss_m64n64k16(s, dq, dk, 0);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    if (kk < ksteps) wgmma_ss_m64n64k16(s, dq + 2 * kk, dk + 2 * kk, 1);
}

// O += P V over a 64-key tile: 4 slices of 16 keys, NCH 64-column chunks of V.
template <int NCH>
__device__ __forceinline__ void value_mma(float (&o)[NCH][32], const uint32_t (&p)[4][4],
                                          const unsigned char* vtile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      wgmma_rs_m64n64k16_tb(o[c], p[kk],
                            sw128_desc(vtile + c * TILE_BYTES + kk * 16 * 128, TILE_BYTES, 1024));
}

// Keys >= N of the tile at key0 score -inf.
__device__ __forceinline__ void mask_keys(float (&s)[32], int key0, int N, int qd) {
  if (key0 + KEYS <= N) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (key0 + 8 * j + 2 * qd + e >= N) {
        s[4 * j + e] = -INFINITY;
        s[4 * j + 2 + e] = -INFINITY;
      }
}

// e = exp(s - m) of the tile at key0 in float32 into the row sums l, and
// bf16(e) into the A fragments p of the e.V product.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float m0, float m1, float& l0,
                                             float& l1, uint32_t (&p)[4][4], int key0, int N,
                                             int qd) {
  mask_keys(s, key0, N, qd);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float e0 = expf(s[4 * j + e] - m0);
      const float e1 = expf(s[4 * j + 2 + e] - m1);
      l0 += e0;
      l1 += e1;
      s[4 * j + e] = e0;
      s[4 * j + 2 + e] = e1;
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Pins the products' registers (see fence_regs) before wgmma_fence and
// after wgmma_wait_all.
template <int NCH>
__device__ __forceinline__ void fence_operands(float (&o)[NCH][32], uint32_t (&p)[4][4],
                                               float (&s)[32]) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) fence_regs(o[c]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(p[kk]);
  fence_regs(s);
}

template <int NCH, bool STRIDED>
__global__ void __launch_bounds__(THREADS, 1)
attn_tc_kernel(__grid_constant__ const CUtensorMap kmap, __grid_constant__ const CUtensorMap vmap,
               const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ res,
               const float* __restrict__ gamma, __nv_bfloat16* __restrict__ out, int N, int DK,
               int ksteps, int k_tma, int v_tma, const Strides st) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base + 2 * TILE_BYTES;  // stage s: K tile, then NCH V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * (1 + NCH) * TILE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int T = (N + KEYS - 1) / KEYS;  // key tiles; pass 1 and pass 2 stream them all
  const int DV = NCH * 64;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ------------------------------------------------------------ producer
    reg_dealloc<PRODUCER_REGS>();
    if (tid >= CONSUMERS + 32) return;
    const int lane = tid & 31;
    const uint16_t* kb = reinterpret_cast<const uint16_t*>(k) + (size_t)b * N * DK;
    const uint16_t* vb = reinterpret_cast<const uint16_t*>(v) + (size_t)b * N * DV;
    for (int i = 0; i < 2 * T; ++i) {
      const int s = i % STAGES;
      mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      const bool pass2 = i >= T;
      const int key0 = (pass2 ? i - T : i) * KEYS;
      unsigned char* kt = ring + s * (1 + NCH) * TILE_BYTES;
      const bool v_here = pass2 && !v_tma, k_here = !k_tma;
      if (k_here) stage_tile(kt, kb, key0, N, DK, 0, lane, 32);
      if (v_here)
        for (int c = 0; c < NCH; ++c)
          stage_tile(kt + (1 + c) * TILE_BYTES, vb, key0, N, DV, c * 64, lane, 32);
      if (k_here || v_here) {
        fence_proxy_async();
        __syncwarp();
      }
      if (lane == 0) {
        const uint32_t bytes =
            (k_tma ? TILE_BYTES : 0) + (pass2 && v_tma ? NCH * TILE_BYTES : 0);
        if (bytes)
          mbar_arrive_tx(&full[s], bytes);
        else
          mbar_arrive(&full[s]);
        if (k_tma) tma_load_3d(kt, &kmap, &full[s], 0, key0, b);
        if (pass2 && v_tma)
          for (int c = 0; c < NCH; ++c)
            tma_load_3d(kt + (1 + c) * TILE_BYTES, &vmap, &full[s], c * 64, key0, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  reg_alloc<CONSUMER_REGS>();
  const int wg = tid >> 7;  // rows q0 + 64 wg .. + 63
  const int warp = (tid & 127) >> 5, lane = tid & 31, qd = lane & 3;

  unsigned char* qt = base + wg * TILE_BYTES;
  stage_tile(qt, reinterpret_cast<const uint16_t*>(q) + (size_t)b * N * DK, q0 + wg * 64, N, DK,
             0, tid & 127, 128);
  fence_proxy_async();
  bar_sync(BAR_Q + wg, 128);

  const uint64_t dq = sw128_desc(qt, 16, 1024);
  auto kdesc = [&](int i) {
    return sw128_desc(ring + (i % STAGES) * (1 + NCH) * TILE_BYTES, 16, 1024);
  };
  auto vtile = [&](int i) { return ring + ((i % STAGES) * (1 + NCH) + 1) * TILE_BYTES; };
  auto full_wait = [&](int i) { mbar_wait(&full[i % STAGES], (i / STAGES) & 1); };

  // Turns on the tensor cores: warpgroup 0 goes first; each turn ends by
  // handing over to the other. Both take 2T + 1 turns; warpgroup 1 skips the
  // hand-over after its last, which warpgroup 0's first turn took in advance.
  if (wg == 1) bar_arrive(BAR_TURN, CONSUMERS);
  auto turn_begin = [&]() { bar_sync(BAR_TURN + wg, CONSUMERS); };
  auto turn_end = [&](bool last) {
    if (!(last && wg == 1)) bar_arrive(BAR_TURN + (wg ^ 1), CONSUMERS);
  };

  float s[32];

  // Pass 1: the row max over all keys.
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int t = 0; t < T; ++t) {
    full_wait(t);
    turn_begin();
    fence_regs(s);
    wgmma_fence();
    score_mma(s, dq, kdesc(t), ksteps);
    wgmma_commit();
    turn_end(false);
    wgmma_wait_all();
    fence_regs(s);
    mbar_arrive(&empty[t % STAGES]);
    mask_keys(s, t * KEYS, N, qd);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
      m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }

  // Pass 2: e = exp(s - m); l += e; O += bf16(e) V. The turn of tile t runs
  // the products of tile t - 1's e with its V and tile t's scores.
  float o[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  uint32_t p[4][4];

  full_wait(T);
  turn_begin();
  fence_regs(s);
  wgmma_fence();
  score_mma(s, dq, kdesc(T), ksteps);
  wgmma_commit();
  turn_end(false);
  wgmma_wait_all();
  fence_regs(s);
  softmax_tile(s, m0, m1, l0, l1, p, 0, N, qd);
  for (int t = 1; t < T; ++t) {
    const int i = T + t;
    full_wait(i);
    turn_begin();
    fence_operands(o, p, s);
    wgmma_fence();
    value_mma<NCH>(o, p, vtile(i - 1));
    score_mma(s, dq, kdesc(i), ksteps);
    wgmma_commit();
    turn_end(false);
    wgmma_wait_all();
    fence_operands(o, p, s);
    mbar_arrive(&empty[(i - 1) % STAGES]);
    softmax_tile(s, m0, m1, l0, l1, p, t * KEYS, N, qd);
  }
  turn_begin();
  fence_operands(o, p, s);
  wgmma_fence();
  value_mma<NCH>(o, p, vtile(2 * T - 1));
  wgmma_commit();
  turn_end(true);
  wgmma_wait_all();
  fence_operands(o, p, s);
  mbar_arrive(&empty[(2 * T - 1) % STAGES]);

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }

  // Epilogue: K2 (gamma / l) * acc + residual, K6 acc * (1 / l), in float32
  // with the twin's roundings, one bf16 store. It goes in 32-column slices
  // through this warpgroup's Q tile, free now: the scaled float32 values in
  // the accumulator's layout (16-byte chunks swizzled by row), then rows of 8
  // columns, so the residual is read and the output written 16 bytes a thread.
  const float g = res ? *gamma : 1.f;
  const float sc[2] = {__fmul_rn(g, 1.0f / l0), __fmul_rn(g, 1.0f / l1)};
  float* slice = reinterpret_cast<float*>(qt);  // 64 rows x 32 floats
  const int lrow = warp * 16 + (lane >> 2);      // local row of the fragment's first half
  const bool vec_res = res && (reinterpret_cast<uintptr_t>(res) & 15) == 0;
#pragma unroll
  for (int half = 0; half < 2 * NCH; ++half) {
    bar_sync(BAR_Q + wg, 128);  // the slice before is read out
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = (half & 1) * 4 + jj, r = lrow + 8 * h, col = 8 * jj + 2 * qd;
        *reinterpret_cast<float2*>(slice + r * 32 + (((col >> 2) ^ (r & 7)) << 2) + (col & 3)) =
            make_float2(__fmul_rn(sc[h], o[half >> 1][4 * j + 2 * h]),
                        __fmul_rn(sc[h], o[half >> 1][4 * j + 2 * h + 1]));
      }
    bar_sync(BAR_Q + wg, 128);
    if constexpr (STRIDED) {
      // residual and output at element strides: 4 positions of one channel
      // a thread, neighbouring threads on neighbouring positions, with
      // 8-byte accesses where the positions are contiguous and aligned (the
      // NCHW view); the same float32 arithmetic as the contiguous store
      // below, so either layout gives the same bits
      const uint16_t* rs = reinterpret_cast<const uint16_t*>(res);
      uint16_t* os = reinterpret_cast<uint16_t*>(out);
      for (int idx = tid & 127; idx < 16 * 32; idx += 128) {
        const int r0 = (idx & 15) * 4, cc = idx >> 4, n0 = q0 + wg * 64 + r0;
        if (n0 >= N) continue;
        const long long col = half * 32 + cc;
        const long long ri = b * st.rb + n0 * st.rn + col * st.rc;
        const long long oi = b * st.ob + n0 * st.on + col * st.oc;
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = slice[(r0 + e) * 32 + (((cc >> 2) ^ ((r0 + e) & 7)) << 2) + (cc & 3)];
        const bool vec = st.rn == 1 && st.on == 1 && n0 + 4 <= N && ((ri | oi) & 3) == 0 &&
                         ((reinterpret_cast<uintptr_t>(rs) | reinterpret_cast<uintptr_t>(os)) & 7) == 0;
        if (vec) {
          if (res) {
            const uint2 rr = *reinterpret_cast<const uint2*>(rs + ri);
            y[0] = __fadd_rn(y[0], __uint_as_float(rr.x << 16));
            y[1] = __fadd_rn(y[1], __uint_as_float(rr.x & 0xffff0000u));
            y[2] = __fadd_rn(y[2], __uint_as_float(rr.y << 16));
            y[3] = __fadd_rn(y[3], __uint_as_float(rr.y & 0xffff0000u));
          }
          *reinterpret_cast<uint2*>(os + oi) = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (n0 + e >= N) continue;
            float v = y[e];
            if (res) v = __fadd_rn(v, __uint_as_float((uint32_t)rs[ri + e * st.rn] << 16));
            out[oi + e * st.on] = __float2bfloat16_rn(v);
          }
        }
      }
    } else {
      for (int piece = tid & 127; piece < 256; piece += 128) {
        const int r = piece >> 2, seg = piece & 3, n = q0 + wg * 64 + r;
        if (n >= N) continue;
        const float* row = slice + r * 32;
        const float4 x0 = *reinterpret_cast<const float4*>(row + (((2 * seg) ^ (r & 7)) << 2));
        const float4 x1 = *reinterpret_cast<const float4*>(row + (((2 * seg + 1) ^ (r & 7)) << 2));
        float y[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const size_t at = ((size_t)b * N + n) * DV + half * 32 + seg * 8;
        if (res) {
          uint4 rr;
          if (vec_res) {
            rr = *reinterpret_cast<const uint4*>(res + at);
          } else {
            const uint16_t* rs = reinterpret_cast<const uint16_t*>(res + at);
            rr = make_uint4(rs[0] | (uint32_t)rs[1] << 16, rs[2] | (uint32_t)rs[3] << 16,
                            rs[4] | (uint32_t)rs[5] << 16, rs[6] | (uint32_t)rs[7] << 16);
          }
          const uint32_t rw[4] = {rr.x, rr.y, rr.z, rr.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // bf16 -> float32 is exact: the high 16 bits
            y[2 * e] = __fadd_rn(y[2 * e], __uint_as_float(rw[e] << 16));
            y[2 * e + 1] = __fadd_rn(y[2 * e + 1], __uint_as_float(rw[e] & 0xffff0000u));
          }
        }
        const uint4 ov = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                                    pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
        *reinterpret_cast<uint4*>(out + at) = ov;
      }
    }
  }
}

// The (B, rows, W) tensor at ptr, of elements `bytes` wide, as a 3-D map
// with boxes of box_w x box_rows, 128-byte swizzle (box_w * bytes = 128), and
// zero fill outside (the ragged key tile, DK below the box).
int encode_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int bytes, int B,
               int rows, int W, int box_w, int box_rows) {
  const long long dims[3] = {W, rows, B};
  const int box[3] = {box_w, box_rows, 1};
  return cic::hop::encode_map(map, ptr, type, bytes, 3, dims, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Once per device and instantiation: the dynamic shared-memory limit, and a
// check that the build starts a thread at START_REGS registers. That count is
// the pool setmaxnreg deals from; a build that started lower could not serve
// the consumers' increase, and the block would stall until an mbarrier wait
// traps, so such a build is refused before its first launch.
constexpr int START_REGS = 168;
static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS == THREADS * START_REGS,
              "setmaxnreg must deal out exactly the block's starting registers");
constexpr int MAX_DEVICES = 64;

template <int NCH, bool STRIDED>
int prepare(int device) {
  static int ready[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (ready[device]) return 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, attn_tc_kernel<NCH, STRIDED>);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs != START_REGS) return (int)cudaErrorInvalidKernelImage;
  err = cudaFuncSetAttribute(attn_tc_kernel<NCH, STRIDED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<NCH>());
  if (err != cudaSuccess) return (int)err;
  ready[device] = 1;
  return 0;
}

template <int NCH, bool STRIDED>
int launch_one(const CUtensorMap& kmap, const CUtensorMap& vmap, const void* q, const void* k,
               const void* v, const void* res, const float* gamma, void* out, int B, int N,
               int DK, int k_tma, int v_tma, const Strides& strides, cudaStream_t st) {
  int device = 0;
  cudaError_t dev_err = cudaGetDevice(&device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int err = prepare<NCH, STRIDED>(device);
  if (err != 0) return err;
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  attn_tc_kernel<NCH, STRIDED><<<grid, THREADS, smem_bytes<NCH>(), st>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(res), gamma,
      static_cast<__nv_bfloat16*>(out), N, DK, (DK + 15) / 16, k_tma, v_tma, strides);
  return (int)cudaGetLastError();
}

template <bool STRIDED>
int launch_dv(const CUtensorMap& kmap, const CUtensorMap& vmap, const void* q, const void* k,
              const void* v, const void* res, const float* gamma, void* out, int B, int N,
              int DK, int DV, int k_tma, int v_tma, const Strides& sd, cudaStream_t st) {
  switch (DV / 64) {
    case 1:
      return launch_one<1, STRIDED>(kmap, vmap, q, k, v, res, gamma, out, B, N, DK, k_tma, v_tma,
                                    sd, st);
    case 2:
      return launch_one<2, STRIDED>(kmap, vmap, q, k, v, res, gamma, out, B, N, DK, k_tma, v_tma,
                                    sd, st);
    case 3:
      return launch_one<3, STRIDED>(kmap, vmap, q, k, v, res, gamma, out, B, N, DK, k_tma, v_tma,
                                    sd, st);
    default:
      return launch_one<4, STRIDED>(kmap, vmap, q, k, v, res, gamma, out, B, N, DK, k_tma, v_tma,
                                    sd, st);
  }
}

// strides: null for a contiguous (B, N, DV) residual and output, else their
// element strides (the strided epilogue; any alignment).
int launch(const void* q, const void* k, const void* v, const void* res, const float* gamma,
           void* out, int B, int N, int DK, int DV, const Strides* strides, cudaStream_t st) {
  CUtensorMap kmap = {}, vmap = {};
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (!strides && !aligned(out)) return (int)cudaErrorMisalignedAddress;  // 16-byte stores
  const int k_tma = DK % 8 == 0 && aligned(k);
  const int v_tma = aligned(v);
  int err = 0;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (k_tma && (err = encode_map(&kmap, k, bf16, 2, B, N, DK, 64, 64)) != 0) return err;
  if (v_tma && (err = encode_map(&vmap, v, bf16, 2, B, N, DV, 64, 64)) != 0) return err;
  if (strides)
    return launch_dv<true>(kmap, vmap, q, k, v, res, gamma, out, B, N, DK, DV, k_tma, v_tma,
                           *strides, st);
  return launch_dv<false>(kmap, vmap, q, k, v, res, gamma, out, B, N, DK, DV, k_tma, v_tma,
                          Strides{}, st);
}

}  // namespace tc

// ------------------------------------------------- float32: three TF32 passes

// The bf16 kernel's plan (two consumer warpgroups of 64 query rows taking
// turns on the tensor cores, a producer streaming key tiles by TMA into a
// ring, pass 1 the row max, pass 2 e = expf(s - m) and O += e V) with every
// product as three TF32 wgmma passes. What TF32 changes:
//  * wgmma takes TF32 operands K-major only. Q and K are K-major for S = Q K^T
//    already; V (N, DV) is not for O = P V. A pre-pass (split_kernel) writes
//    hi and lo of q and k, and hi and lo of V^T (B, DV, NP), into scratch the
//    wrapper allocates; the main kernel loads all of it by TMA, so unaligned
//    inputs and any DK (zero-padded to 32 or 64) take the same path.
//  * P comes from S's accumulator. A thread holds the keys 2t, 2t + 1 of each
//    group of 8; the A fragment of m64n64k8 wants the k positions t, t + 4.
//    The pre-pass stores V^T's keys of each group of 8 in the order 0, 2, 4,
//    6, 1, 3, 5, 7, so S's registers, split into hi and lo, serve as A as
//    they are.
//  * A 64-key float32 V tile with its lo half is 128 KB: tiles here are 32
//    keys (one 128-byte swizzled row of V^T), 64 KB of V^T hi and lo at
//    DV = 256, in a ring of its own beside K's (see vstages) and the 64 KB
//    of Q: two V^T stages and two to four K stages.
//  * The accumulator (128 registers a thread at DV = 256), S (16) and P's hi
//    and lo (16 each) fit the bf16 kernel's 232-register consumer budget.
// The global max of pass 1 is the bf16 kernel's; in float32 a running max
// would do as well, but the two passes keep one plan for both types at the
// cost of recomputing S (DK / (DK + DV) more products).
namespace tf {

using namespace cic::hop;

constexpr int ROWS = 128;                 // query rows per block
constexpr int KEYS = 32;                  // keys per tile
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup (one thread loads)
constexpr int BAR_TURN = 1;               // named barriers 1, 2: whose turn on the tensor cores
constexpr int BAR_SLICE = 3;              // named barriers 3, 4: the strided epilogue's slices
constexpr int Q_PART = 64 * 128;          // 64 rows x 32 floats of Q, hi or lo, swizzled
constexpr int Q_BYTES = 4 * Q_PART;       // a warpgroup's Q: hi, lo x two 32-column blocks
constexpr int K_PART = KEYS * 128;        // 32 keys x 32 floats of K, hi or lo
constexpr int K_BYTES = 4 * K_PART;       // hi, lo x two 32-column blocks
constexpr int V_PART = 64 * 128;          // 64 columns of V (rows of V^T) x 32 keys, hi or lo
constexpr int SMEM_LIMIT = 232448;        // an H100 block's dynamic shared memory

constexpr int STAGES_MAX = 4;
constexpr int HEAD = 1024;                // the barriers, ahead of Q
static_assert(KEYS == TF32_KEYS, "attention.cuh's scratch layout pads N to this key tile");

// K and V^T stream through rings of their own. A turn runs tile t's scores
// and tile t - 1's e.V, so a V^T tile is held for one turn more than its K
// tile: with one ring, tile t + 1 could load only after tile t - 1's e.V, and
// each turn would wait for its load. With two, V^T tile t loads during the
// turn that uses tile t - 1.
template <int NCH>
__host__ __device__ constexpr int vstage_bytes() { return 2 * NCH * V_PART; }

template <int NCH>
__host__ __device__ constexpr int vstages() {
  return (SMEM_LIMIT - 1024 - HEAD - 2 * Q_BYTES - 2 * K_BYTES) / vstage_bytes<NCH>() <
                 STAGES_MAX
             ? (SMEM_LIMIT - 1024 - HEAD - 2 * Q_BYTES - 2 * K_BYTES) / vstage_bytes<NCH>()
             : STAGES_MAX;
}

// K stages (hi and lo of kblocks 32-column blocks each) in what V^T leaves.
template <int NCH>
__host__ __device__ constexpr int kstages(int kblocks) {
  return (SMEM_LIMIT - 1024 - HEAD - 2 * Q_BYTES - vstages<NCH>() * vstage_bytes<NCH>()) /
                     (2 * kblocks * K_PART) <
                 STAGES_MAX
             ? (SMEM_LIMIT - 1024 - HEAD - 2 * Q_BYTES - vstages<NCH>() * vstage_bytes<NCH>()) /
                   (2 * kblocks * K_PART)
             : STAGES_MAX;
}
static_assert(vstages<4>() >= 2 && kstages<4>(2) >= 2, "two stages of each ring at DV = 256");

// q, k (B, N, DK) -> hi and lo (B, N, DKP), zero beyond DK; v (B, N, DV) ->
// hi and lo of V^T (B, DV, NP), zero beyond N, each group of 8 keys in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (position p < 4 holds key 2p, p >= 4 key
// 2p - 7). A block: 32 keys of one image. Any alignment.
__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ qh, float* __restrict__ ql,
             float* __restrict__ kh, float* __restrict__ kl, float* __restrict__ vh,
             float* __restrict__ vl, int N, int DK, int DV, int DKP, int NP) {
  __shared__ float vs[KEYS][65];
  const int b = blockIdx.y, n0 = blockIdx.x * KEYS, tid = threadIdx.x;
  uint32_t hi, lo;
  for (int i = tid; i < KEYS * DKP; i += 256) {
    const int r = i / DKP, d = i - r * DKP, n = n0 + r;
    if (n >= N) break;
    const size_t src = ((size_t)b * N + n) * DK + d, dst = ((size_t)b * N + n) * DKP + d;
    tf32_split(d < DK ? q[src] : 0.f, hi, lo);
    qh[dst] = __uint_as_float(hi);
    ql[dst] = __uint_as_float(lo);
    tf32_split(d < DK ? k[src] : 0.f, hi, lo);
    kh[dst] = __uint_as_float(hi);
    kl[dst] = __uint_as_float(lo);
  }
  for (int c0 = 0; c0 < DV; c0 += 64) {
    __syncthreads();  // the previous columns are written out
    for (int i = tid; i < KEYS * 64; i += 256) {
      const int r = i >> 6, c = i & 63, n = n0 + r;
      vs[r][c] = n < N ? v[((size_t)b * N + n) * DV + c0 + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < 64 * KEYS; i += 256) {
      const int col = i / KEYS, p = i % KEYS, e = p & 7;
      tf32_split(vs[(p & ~7) + (e < 4 ? 2 * e : 2 * e - 7)][col], hi, lo);
      const size_t dst = ((size_t)b * DV + c0 + col) * NP + n0 + p;
      vh[dst] = __uint_as_float(hi);
      vl[dst] = __uint_as_float(lo);
    }
  }
}

// Descriptor offset (16-byte units) of k8 slice kk of a tile whose 32-float
// column blocks lie `part` bytes apart.
__device__ __forceinline__ uint64_t slice(int kk, int part) {
  return (uint64_t)(((kk >> 2) * part + (kk & 3) * 32) >> 4);
}

// S = Q K^T over ksteps (1..8) slices of 8 of DK, each as lo.hi + hi.lo +
// hi.hi; the tiles are zero beyond DK.
__device__ __forceinline__ void score_mma(float (&s)[16], uint64_t dqh, uint64_t dql,
                                          uint64_t dkh, uint64_t dkl, int ksteps) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk < ksteps) {
      const uint64_t oq = slice(kk, Q_PART), ok = slice(kk, K_PART);
      wgmma_ss_m64n32k8_tf32(s, dqh + oq, dkl + ok, kk > 0);
      wgmma_ss_m64n32k8_tf32(s, dql + oq, dkh + ok, 1);
      wgmma_ss_m64n32k8_tf32(s, dqh + oq, dkh + ok, 1);
    }
  }
}

// K7's S: the same products, the lo terms of every slice first and the
// hi.hi ones after them. The tensor cores' float32 sums align their terms
// to the largest and drop the low bits, so every product added into a
// running score of tens (K7's widths) loses bits at that scale: here the
// lo terms sum at their own scale, and only the ksteps hi.hi products meet
// the large sum (score_mma's order adds all 3 ksteps into it).
__device__ __forceinline__ void score_mma_apart(float (&s)[16], uint64_t dqh, uint64_t dql,
                                                uint64_t dkh, uint64_t dkl, int ksteps) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk < ksteps) {
      const uint64_t oq = slice(kk, Q_PART), ok = slice(kk, K_PART);
      wgmma_ss_m64n32k8_tf32(s, dqh + oq, dkl + ok, kk > 0);
      wgmma_ss_m64n32k8_tf32(s, dql + oq, dkh + ok, 1);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    if (kk < ksteps)
      wgmma_ss_m64n32k8_tf32(s, dqh + slice(kk, Q_PART), dkh + slice(kk, K_PART), 1);
}

// O += P V over a 32-key tile: 4 slices of 8 keys, NCH 64-column chunks,
// each as lo.hi + hi.lo + hi.hi. vt: the stage's V^T hi, then its lo.
// fresh: O = P V, O's values before ignored.
template <int NCH>
__device__ __forceinline__ void value_mma(float (&o)[NCH][32], const uint32_t (&ph)[4][4],
                                          const uint32_t (&pl)[4][4], const unsigned char* vt,
                                          int fresh = 0) {
  const uint64_t dvh = sw128_desc(vt, 16, 1024), dvl = sw128_desc(vt + NCH * V_PART, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const uint64_t off = (uint64_t)((c * V_PART + kk * 32) >> 4);
      wgmma_rs_m64n64k8_tf32(o[c], pl[kk], dvh + off, kk > 0 || !fresh);
      wgmma_rs_m64n64k8_tf32(o[c], ph[kk], dvl + off);
      wgmma_rs_m64n64k8_tf32(o[c], ph[kk], dvh + off);
    }
}

// Keys >= N of the tile at key0 score -inf.
__device__ __forceinline__ void mask_keys(float (&s)[16], int key0, int N, int qd) {
  if (key0 + KEYS <= N) return;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (key0 + 8 * j + 2 * qd + e >= N) {
        s[4 * j + e] = -INFINITY;
        s[4 * j + 2 + e] = -INFINITY;
      }
}

// e = exp(s - m) of the tile at key0 in float32 into the row sums l, and its
// TF32 hi and lo into the A fragments of the e.V product: slice j's position
// qd is key 8j + 2qd (s[4j], s[4j + 2] for rows r, r + 8), position qd + 4
// key 8j + 2qd + 1 (s[4j + 1], s[4j + 3]), the order of V^T's keys.
__device__ __forceinline__ void softmax_tile(float (&s)[16], float m0, float m1, float& l0,
                                             float& l1, uint32_t (&ph)[4][4],
                                             uint32_t (&pl)[4][4], int key0, int N, int qd) {
  mask_keys(s, key0, N, qd);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float e0 = expf(s[4 * j + e] - m0);
      const float e1 = expf(s[4 * j + 2 + e] - m1);
      l0 += e0;
      l1 += e1;
      s[4 * j + e] = e0;
      s[4 * j + 2 + e] = e1;
    }
    tf32_split(s[4 * j + 0], ph[j][0], pl[j][0]);
    tf32_split(s[4 * j + 2], ph[j][1], pl[j][1]);
    tf32_split(s[4 * j + 1], ph[j][2], pl[j][2]);
    tf32_split(s[4 * j + 3], ph[j][3], pl[j][3]);
  }
}

template <int NCH>
__device__ __forceinline__ void fence_operands(float (&o)[NCH][32], uint32_t (&ph)[4][4],
                                               uint32_t (&pl)[4][4], float (&s)[16]) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) fence_regs(o[c]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(ph[kk]);
    fence_regs(pl[kk]);
  }
  fence_regs(s);
}

struct Maps {
  CUtensorMap qh, ql, kh, kl, vh, vl;
};

template <int NCH, bool STRIDED, bool APART>
__global__ void __launch_bounds__(THREADS, 1)
attn_tf32_kernel(__grid_constant__ const Maps maps, const float* __restrict__ res,
                 const float* __restrict__ gamma, float* __restrict__ out, int N, int ksteps,
                 int kblocks, const Strides st, float* __restrict__ acc) {
  constexpr int VST = vstages<NCH>();
  constexpr int DV = NCH * 64;
  const int KST = kstages<NCH>(kblocks), kstage = 2 * kblocks * K_PART;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(base);
  uint64_t* kempty = kfull + STAGES_MAX;
  uint64_t* vfull = kempty + STAGES_MAX;
  uint64_t* vempty = vfull + STAGES_MAX;
  uint64_t* qfull = vempty + STAGES_MAX;
  unsigned char* qtiles = base + HEAD;                  // per warpgroup: hi, lo
  unsigned char* vring = qtiles + 2 * Q_BYTES;          // stage: V^T hi, V^T lo
  unsigned char* kring = vring + VST * vstage_bytes<NCH>();  // stage: K hi, K lo

  const int tid = threadIdx.x;
  const int b = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int T = (N + KEYS - 1) / KEYS;  // key tiles; pass 1 and pass 2 stream K, pass 2 V

  if (tid == 0) {
    for (int s = 0; s < STAGES_MAX; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], CONSUMERS);
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], CONSUMERS);
    }
    mbar_init(qfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ------------------------------------------------------------ producer
    reg_dealloc<tc::PRODUCER_REGS>();
    if (tid != CONSUMERS) return;
    mbar_arrive_tx(qfull, 2 * 2 * kblocks * Q_PART);
    for (int wg = 0; wg < 2; ++wg)
      for (int cb = 0; cb < kblocks; ++cb) {
        unsigned char* qt = qtiles + wg * Q_BYTES + cb * Q_PART;
        tma_load_3d(qt, &maps.qh, qfull, cb * 32, q0 + 64 * wg, b);
        tma_load_3d(qt + 2 * Q_PART, &maps.ql, qfull, cb * 32, q0 + 64 * wg, b);
      }
    // K tile i (pass 1: i < T, pass 2: T + t) into the K ring
    auto load_k = [&](int i) {
      const int s = i % KST, key0 = (i < T ? i : i - T) * KEYS;
      mbar_wait(&kempty[s], ((i / KST) & 1) ^ 1);
      unsigned char* st = kring + s * kstage;
      mbar_arrive_tx(&kfull[s], kstage);
      for (int cb = 0; cb < kblocks; ++cb) {
        tma_load_3d(st + cb * K_PART, &maps.kh, &kfull[s], cb * 32, key0, b);
        tma_load_3d(st + (kblocks + cb) * K_PART, &maps.kl, &kfull[s], cb * 32, key0, b);
      }
    };
    for (int t = 0; t < T; ++t) load_k(t);
    for (int t = 0; t < T; ++t) {
      load_k(T + t);
      const int s = t % VST;
      mbar_wait(&vempty[s], ((t / VST) & 1) ^ 1);
      unsigned char* st = vring + s * vstage_bytes<NCH>();
      mbar_arrive_tx(&vfull[s], vstage_bytes<NCH>());
      tma_load_3d(st, &maps.vh, &vfull[s], t * KEYS, 0, b);
      tma_load_3d(st + NCH * V_PART, &maps.vl, &vfull[s], t * KEYS, 0, b);
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  reg_alloc<tc::CONSUMER_REGS>();
  const int wg = tid >> 7;  // rows q0 + 64 wg .. + 63
  const int warp = (tid & 127) >> 5, lane = tid & 31, qd = lane & 3;

  const unsigned char* qt = qtiles + wg * Q_BYTES;
  const uint64_t dqh = sw128_desc(qt, 16, 1024), dql = sw128_desc(qt + 2 * Q_PART, 16, 1024);
  auto kdesc = [&](int i, int lo) {
    return sw128_desc(kring + (i % KST) * kstage + lo * kblocks * K_PART, 16, 1024);
  };
  auto vtile = [&](int t) { return vring + (t % VST) * vstage_bytes<NCH>(); };
  auto k_wait = [&](int i) { mbar_wait(&kfull[i % KST], (i / KST) & 1); };
  auto v_wait = [&](int t) { mbar_wait(&vfull[t % VST], (t / VST) & 1); };
  mbar_wait(qfull, 0);

  // Turns on the tensor cores, as in the bf16 kernel.
  if (wg == 1) bar_arrive(BAR_TURN, CONSUMERS);
  auto turn_begin = [&]() { bar_sync(BAR_TURN + wg, CONSUMERS); };
  auto turn_end = [&](bool last) {
    if (!(last && wg == 1)) bar_arrive(BAR_TURN + (wg ^ 1), CONSUMERS);
  };

  // S: K2's as score_mma forms it, K7's (APART) as score_mma_apart
  float s[16];
  auto scores = [&](int i) {
    if constexpr (APART)
      score_mma_apart(s, dqh, dql, kdesc(i, 0), kdesc(i, 1), ksteps);
    else
      score_mma(s, dqh, dql, kdesc(i, 0), kdesc(i, 1), ksteps);
  };

  // Pass 1: the row max over all keys.
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int t = 0; t < T; ++t) {
    k_wait(t);
    turn_begin();
    fence_regs(s);
    wgmma_fence();
    scores(t);
    wgmma_commit();
    turn_end(false);
    wgmma_wait_all();
    fence_regs(s);
    mbar_arrive(&kempty[t % KST]);
    mask_keys(s, t * KEYS, N, qd);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
      m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }

  // Pass 2: e = exp(s - m); l += e; O += e V. The turn of tile t runs the
  // products of tile t - 1's e with its V and tile t's scores.
  float o[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  uint32_t ph[4][4], pl[4][4];

  // K7 (APART): e.V in segments of TF32_SEG_TILES key tiles, each summed on
  // the tensor cores from zero (value_mma's fresh); every segment but the
  // last is stored to its slice of acc ((segments - 1, B, N, DV), streaming
  // stores: read once, at the end) and added in float32 in segment order to
  // the last one. The tensor cores' float32 sums drop the low bits of every
  // product at the running sum's scale, so one sum over all N keys would
  // lose bits at the scale of the whole e.V.
  const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const size_t seg_elems = (size_t)gridDim.y * N * DV;
  float* arow = acc ? acc + ((size_t)b * N + row0) * DV + 2 * qd : nullptr;
  auto store_segment = [&](int g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row0 + 8 * h >= N) continue;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          __stcs(reinterpret_cast<float2*>(arow + g * seg_elems + 8 * h * DV + c * 64 + 8 * j),
                 make_float2(o[c][4 * j + 2 * h], o[c][4 * j + 2 * h + 1]));
    }
  };
  // o = ((seg 0 + seg 1) + ...) + o, a row's 8 values of one 64-column
  // chunk at a time with the loads of 4 segments in flight
  auto add_segments = [&](int stored) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row0 + 8 * h >= N) continue;
        const float* a = arow + 8 * h * DV + c * 64;
        float2 sum[8];
        for (int g0 = 0; g0 < stored; g0 += 4) {
          float2 v[4][8];
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (g0 + g < stored)
                v[g][j] =
                    __ldcs(reinterpret_cast<const float2*>(a + (g0 + g) * seg_elems + 8 * j));
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (g0 + g < stored)
                sum[j] = g0 + g == 0 ? v[g][j]
                                     : make_float2(__fadd_rn(sum[j].x, v[g][j].x),
                                                   __fadd_rn(sum[j].y, v[g][j].y));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j + 2 * h] = __fadd_rn(sum[j].x, o[c][4 * j + 2 * h]);
          o[c][4 * j + 2 * h + 1] = __fadd_rn(sum[j].y, o[c][4 * j + 2 * h + 1]);
        }
      }
  };

  k_wait(T);
  turn_begin();
  fence_regs(s);
  wgmma_fence();
  scores(T);
  wgmma_commit();
  turn_end(false);
  wgmma_wait_all();
  fence_regs(s);
  mbar_arrive(&kempty[T % KST]);
  softmax_tile(s, m0, m1, l0, l1, ph, pl, 0, N, qd);
  for (int t = 1; t < T; ++t) {
    const int i = T + t;
    k_wait(i);
    v_wait(t - 1);
    turn_begin();
    fence_operands(o, ph, pl, s);
    wgmma_fence();
    value_mma<NCH>(o, ph, pl, vtile(t - 1), APART && t > 1 && (t - 1) % TF32_SEG_TILES == 0);
    scores(i);
    wgmma_commit();
    turn_end(false);
    wgmma_wait_all();
    fence_operands(o, ph, pl, s);
    mbar_arrive(&kempty[i % KST]);
    mbar_arrive(&vempty[(t - 1) % VST]);
    if constexpr (APART)
      if (t % TF32_SEG_TILES == 0) store_segment(t / TF32_SEG_TILES - 1);
    softmax_tile(s, m0, m1, l0, l1, ph, pl, t * KEYS, N, qd);
  }
  v_wait(T - 1);
  turn_begin();
  fence_operands(o, ph, pl, s);
  wgmma_fence();
  value_mma<NCH>(o, ph, pl, vtile(T - 1), APART && T > 1 && (T - 1) % TF32_SEG_TILES == 0);
  wgmma_commit();
  turn_end(true);
  wgmma_wait_all();
  fence_operands(o, ph, pl, s);
  mbar_arrive(&vempty[(T - 1) % VST]);
  if constexpr (APART)
    if (T > TF32_SEG_TILES) add_segments((T - 1) / TF32_SEG_TILES);

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }

  // Epilogue: K2 (gamma / l) * o + residual, K6 o * (1 / l), in float32
  // with the twin's roundings, straight from the accumulator: a thread's two
  // neighbouring columns as one 8-byte access where res and out allow.
  const float g = res ? *gamma : 1.f;
  const float sc[2] = {__fmul_rn(g, 1.0f / l0), __fmul_rn(g, 1.0f / l1)};
  if constexpr (STRIDED) {
    // K7's residual (not null) and output at element strides: 32-column
    // slices of the scaled accumulator through this warpgroup's Q tiles (free
    // now; rows 33 floats apart), then neighbouring threads on neighbouring
    // groups of 4 positions (the NCHW view's contiguous axis). The same float32
    // arithmetic as the contiguous store below, so either layout gives the
    // same bits.
    float* slice = reinterpret_cast<float*>(qtiles + wg * Q_BYTES);
    const int lrow = warp * 16 + (lane >> 2);
#pragma unroll
    for (int part = 0; part < 2 * NCH; ++part) {
      bar_sync(BAR_SLICE + wg, 128);  // the slice before is read out
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = (part & 1) * 4 + jj, at = (lrow + 8 * h) * 33 + 8 * jj + 2 * qd;
          slice[at] = __fmul_rn(sc[h], o[part >> 1][4 * j + 2 * h]);
          slice[at + 1] = __fmul_rn(sc[h], o[part >> 1][4 * j + 2 * h + 1]);
        }
      bar_sync(BAR_SLICE + wg, 128);
      // 4 positions of one channel a thread, 16-byte accesses where the
      // positions are contiguous and aligned (the NCHW view)
      for (int idx = tid & 127; idx < 16 * 32; idx += 128) {
        const int r0 = (idx & 15) * 4, cc = idx >> 4, n0 = q0 + wg * 64 + r0;
        if (n0 >= N) continue;
        const long long col = part * 32 + cc;
        const long long ri = b * st.rb + n0 * st.rn + col * st.rc;
        const long long oi = b * st.ob + n0 * st.on + col * st.oc;
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = slice[(r0 + e) * 33 + cc];
        const bool vec = st.rn == 1 && st.on == 1 && n0 + 4 <= N &&
                         (((uintptr_t)(res + ri) | (uintptr_t)(out + oi)) & 15) == 0;
        if (vec) {
          const float4 rr = *reinterpret_cast<const float4*>(res + ri);
          *reinterpret_cast<float4*>(out + oi) =
              make_float4(__fadd_rn(y[0], rr.x), __fadd_rn(y[1], rr.y), __fadd_rn(y[2], rr.z),
                          __fadd_rn(y[3], rr.w));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n0 + e < N) out[oi + e * st.on] = __fadd_rn(y[e], res[ri + e * st.rn]);
        }
      }
    }
    return;
  }
  const bool vec =
      ((reinterpret_cast<uintptr_t>(res) | reinterpret_cast<uintptr_t>(out)) & 7) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = q0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    if (n >= N) continue;
    const size_t row = ((size_t)b * N + n) * DV;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t at = row + c * 64 + 8 * j + 2 * qd;
        float y0 = __fmul_rn(sc[h], o[c][4 * j + 2 * h]);
        float y1 = __fmul_rn(sc[h], o[c][4 * j + 2 * h + 1]);
        if (vec) {
          if (res) {
            const float2 r = *reinterpret_cast<const float2*>(res + at);
            y0 = __fadd_rn(y0, r.x);
            y1 = __fadd_rn(y1, r.y);
          }
          *reinterpret_cast<float2*>(out + at) = make_float2(y0, y1);
        } else {
          if (res) {
            y0 = __fadd_rn(y0, res[at]);
            y1 = __fadd_rn(y1, res[at + 1]);
          }
          out[at] = y0;
          out[at + 1] = y1;
        }
      }
  }
}

template <int NCH, bool STRIDED, bool APART>
int prepare(int device) {
  static int ready[tc::MAX_DEVICES] = {};
  if (device < 0 || device >= tc::MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (ready[device]) return 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, attn_tf32_kernel<NCH, STRIDED, APART>);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs != tc::START_REGS) return (int)cudaErrorInvalidKernelImage;
  err = cudaFuncSetAttribute(attn_tf32_kernel<NCH, STRIDED, APART>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  ready[device] = 1;
  return 0;
}

template <int NCH, bool STRIDED, bool APART>
int launch_one(const Maps& maps, const float* res, const float* gamma, float* out, int B, int N,
               int ksteps, int kblocks, const Strides& sd, float* acc, cudaStream_t st) {
  int device = 0;
  cudaError_t dev_err = cudaGetDevice(&device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int err = prepare<NCH, STRIDED, APART>(device);
  if (err != 0) return err;
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  attn_tf32_kernel<NCH, STRIDED, APART><<<grid, THREADS, SMEM_LIMIT, st>>>(
      maps, res, gamma, out, N, ksteps, kblocks, sd, acc);
  return (int)cudaGetLastError();
}

template <bool STRIDED, bool APART>
int launch_dv(const Maps& maps, const float* r, const float* gamma, float* o, int B, int N,
              int ksteps, int kblocks, int DV, const Strides& sd, float* acc,
              cudaStream_t st) {
  switch (DV / 64) {
    case 1:
      return launch_one<1, STRIDED, APART>(maps, r, gamma, o, B, N, ksteps, kblocks, sd, acc, st);
    case 2:
      return launch_one<2, STRIDED, APART>(maps, r, gamma, o, B, N, ksteps, kblocks, sd, acc, st);
    case 3:
      return launch_one<3, STRIDED, APART>(maps, r, gamma, o, B, N, ksteps, kblocks, sd, acc, st);
    default:
      return launch_one<4, STRIDED, APART>(maps, r, gamma, o, B, N, ksteps, kblocks, sd, acc, st);
  }
}

// The main kernel on scratch that holds the TF32 hi and lo of q, k and V^T
// (Tf32Scratch, attention.cuh). K2 (apart false): its contiguous epilogue.
// K7 (apart): K7's scores (score_mma_apart) and e.V in segments of
// TF32_SEG_TILES key tiles added in float32 in s.acc; strides: null for a
// contiguous (B, N, DV) residual and output, else their element strides.
int run(const Tf32Scratch& s, const void* res, const float* gamma, void* out, int B, int N,
        int DK, int DV, bool apart, const Strides* strides, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(out) & 3) return (int)cudaErrorMisalignedAddress;
  Maps maps;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int DKP = s.dkp, NP = s.np;
  int err = 0;
  if ((err = tc::encode_map(&maps.qh, s.qh, f32, 4, B, N, DKP, 32, 64)) != 0 ||
      (err = tc::encode_map(&maps.ql, s.ql, f32, 4, B, N, DKP, 32, 64)) != 0 ||
      (err = tc::encode_map(&maps.kh, s.kh, f32, 4, B, N, DKP, 32, KEYS)) != 0 ||
      (err = tc::encode_map(&maps.kl, s.kl, f32, 4, B, N, DKP, 32, KEYS)) != 0 ||
      (err = tc::encode_map(&maps.vh, s.vh, f32, 4, B, DV, NP, 32, DV)) != 0 ||
      (err = tc::encode_map(&maps.vl, s.vl, f32, 4, B, DV, NP, 32, DV)) != 0)
    return err;
  const float* r = static_cast<const float*>(res);
  float* o = static_cast<float*>(out);
  const int ksteps = (DK + 7) / 8, kblocks = DKP / 32;
  if (!apart)
    return launch_dv<false, false>(maps, r, gamma, o, B, N, ksteps, kblocks, DV, Strides{},
                                   nullptr, st);
  if (tf32_segments(N) > 1 && s.acc == nullptr) return (int)cudaErrorInvalidValue;
  if (strides)
    return launch_dv<true, true>(maps, r, gamma, o, B, N, ksteps, kblocks, DV, *strides, s.acc,
                                 st);
  return launch_dv<false, true>(maps, r, gamma, o, B, N, ksteps, kblocks, DV, Strides{}, s.acc,
                                st);
}

// Scratch (float32 elements): hi and lo of q and k, (B, N, DKP) each, then hi
// and lo of V^T, (B, DV, NP) each; ops/attention.py::_tf32_scratch_elems.
int launch(const void* q, const void* k, const void* v, const void* res, const float* gamma,
           void* out, void* scratch, long long scratch_elems, int B, int N, int DK, int DV,
           cudaStream_t st) {
  if (scratch == nullptr || scratch_elems < tf32_scratch_elems(B, N, DK, DV))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(scratch) & 15) return (int)cudaErrorMisalignedAddress;
  const Tf32Scratch s = tf32_scratch(scratch, B, N, DK, DV);
  split_kernel<<<dim3(s.np / KEYS, B), 256, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      s.qh, s.ql, s.kh, s.kl, s.vh, s.vl, N, DK, DV, s.dkp, s.np);
  cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  return run(s, res, gamma, out, B, N, DK, DV, false, nullptr, st);
}

}  // namespace tf

int dispatch(int dtype, const void* q, const void* k, const void* v, const void* res,
             const float* gamma, void* out, void* scratch, long long scratch_elems, int B, int N,
             int DK, int DV, void* stream) {
  if (DK < 1 || DK > DK_MAX || DV < 64 || DV > DV_MAX || DV % 64 != 0 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tf::launch(q, k, v, res, gamma, out, scratch, scratch_elems, B, N, DK, DV, st);
  if (dtype == 1) return tc::launch(q, k, v, res, gamma, out, B, N, DK, DV, nullptr, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

int cic::attn::tc_block(const void* q, const void* k, const void* v, const void* res,
                        const float* gamma, void* out, int B, int N, int DK, int DV,
                        const Strides* strides, cudaStream_t stream) {
  if (DK < 1 || DK > DK_MAX || DV < 64 || DV > DV_MAX || DV % 64 != 0 || N < 1)
    return (int)cudaErrorInvalidValue;
  return tc::launch(q, k, v, res, gamma, out, B, N, DK, DV, strides, stream);
}

int cic::attn::tf32_block(const Tf32Scratch& s, const void* res, const float* gamma, void* out,
                          int B, int N, int DK, int DV, const Strides* strides,
                          cudaStream_t stream) {
  if (DK < 1 || DK > DK_MAX || DV < 64 || DV > DV_MAX || DV % 64 != 0 || N < 1 || !res)
    return (int)cudaErrorInvalidValue;
  return tf::run(s, res, gamma, out, B, N, DK, DV, true, strides, stream);
}

// dtype: 0 = float32, 1 = bfloat16. q, k: (B, N, DK); v, res, out: (B, N, DV);
// gamma: one float32 on the device. scratch: float32 for the float32 route
// (scratch_elems of them, 16-byte aligned; tf::launch), null for bf16.
extern "C" int cic_attention_block(int dtype, const void* q, const void* k, const void* v,
                                   const void* res, const float* gamma, void* out, void* scratch,
                                   long long scratch_elems, int B, int N, int DK, int DV,
                                   void* stream) {
  if (res == nullptr || gamma == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, q, k, v, res, gamma, out, scratch, scratch_elems, B, N, DK, DV, stream);
}

// K6: as cic_attention_block with no residual and no gamma; out: (B, N, DV).
extern "C" int cic_attention_core(int dtype, const void* q, const void* k, const void* v, void* out,
                                  void* scratch, long long scratch_elems, int B, int N, int DK,
                                  int DV, void* stream) {
  return dispatch(dtype, q, k, v, nullptr, nullptr, out, scratch, scratch_elems, B, N, DK, DV,
                  stream);
}
