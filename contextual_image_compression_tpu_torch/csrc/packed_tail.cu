// K8: the generator's fused inference tail
//   z = LeakyReLU(deconv4x4s2(x, W_folded) + shift), zero outside the image,
//   out = tanh(conv4x4 SAME(z, W_out) + bias)
// in one kernel, the phase-planar intermediate kept in shared memory.
//
// Replaces contextual_image_compression_tpu/models/packed_tail.py::
// fused_tail_pallas (reached by packed_tail_forward(use_pallas=True)).
//
// Layouts. x is the port's NCHW activation (B, Cin, H, W); out is NCHW
// (B, Co, 2H, 2W), so the TPU's depth_to_space4 folds into the store. The
// deconv runs phase-planar as on the TPU: planar entry (m, j) with slab
// (a, b) is output pixel (2m - a, 2j - b), and all four slabs at (m, j) read
// the same 2 x 2 window x[m - 1 .. m, j - 1 .. j] (tap (r, s) reads
// x[m + r - 1, j + s - 1]). The wrapper packs the port's flipped
// conv_transpose2d weight (Cin, Cmid, 4, 4) into wpk[r * 2 + s][ci][n],
// n = (a * 2 + b) * Cmid + o, from kernel index (3 - a - 2r, 3 - b - 2s).
//
// Rounding kept from the TPU kernel (identity in float32): each of the four
// tap products is a float32 sum over Cin rounded to the dtype and added into
// a dtype accumulator in the TPU loop order (r = 0 first; within r = 1 the
// tap s = 1 first on even planar columns, s = 0 first on odd ones; within
// r = 0 the order cannot matter); then + shift in the dtype, LeakyReLU in
// float32 rounded to the dtype, zeros at the out-of-range pixels -1 and 2H
// (they must read as zero in the out-conv, not as LeakyReLU(shift)); the
// out-conv accumulates in float32, adds the float32 bias and takes tanhf.
//
// Bound on the H100 at B = 16, Cin 128, 128^2 -> 256^2, Cmid 32, Co 3:
// 34.4 + 3.2 GFLOP of useful products, operation-bound on the bf16 tensor
// cores (0.038 ms); x is 67 MB, the output 6.3 MB.
//
// bf16: tail_tc_kernel, both stages on the tensor cores. A persistent grid
// of one 256-thread block per SM loads the four taps' weights once (the
// wrapper packs them as (4, Cmid-groups, Cin padded to 16, 64) tiles; in
// shared memory 128-byte swizzled, MN-major, 131,072 bytes at full width)
// and walks tiles of 12 x 28 output pixels: 8 x 16 = 128 planar positions,
// one per wgmma row, 64 to each of the two warpgroups. Per tile:
//   * the x window (9 x 17 positions x Cin) is staged position-major from
//     NCHW (a transpose during staging, 4-byte column pairs of 8 channels a
//     thread, rows padded by 16 bytes so ldmatrix is free of bank
//     conflicts); the next tile's loads are in flight during stage B;
//   * stage A: per 64-column group and tap (r, s), the warpgroup loads its A
//     rows, shifted by (r, s) positions, with ldmatrix into registers and
//     runs D_t = X_t . W_t (wgmma m64n64k16, a fresh float32 accumulator per
//     tap, the next tap's product started before this one is combined),
//     rounds D_t to bf16 and combines it in the TPU order in registers;
//   * a pass over the planar tile in shared memory adds shift, applies
//     LeakyReLU and zeros the out-of-image pixels; it never reaches device
//     memory;
//   * stage B, the 4 x 4 out-conv, as a GEMM on wgmma m64n8k16: one output
//     pixel per row, K = 16 taps x Cmid (padded to 16) gathered from the
//     planar tile by ldmatrix, N = Co padded to 8; float32 bias, tanhf,
//     NCHW store.
// What bounds it (PERF.md): the phases run one after another, separated by
// barriers, so the tensor cores idle while the window is staged and the
// activation pass runs; the halo costs 128 planar positions for 84 useful
// ones (1.52x); the x window's loads are 2-byte-channel gathers from NCHW;
// the kernel is at the 255-register limit with a small spill.
//
// float32 (bar 2e-5 against the twin): tail_tf32_kernel, the same plan on the
// tensor cores with every product as three TF32 passes a_hi b_hi + a_hi b_lo
// + a_lo b_hi (hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi), summed in
// float32). What float32 changes:
//   * the four taps' weights in hi and lo are 512 KB at full width, 2.3x a
//     block's shared memory, so they stream from L2 through a ring of STAGES
//     stages (a producer thread, TMA, mbarriers): a stage is one tap's 64
//     planar columns x 32 input channels, hi and lo, K-major and 128-byte
//     swizzled (ops/generator_tail.py::_pack_taps_tf32: Cmid padded to 32,
//     so the planar columns are slab * 32 + o; each group of 8 channels in
//     the order 0, 2, 4, 6, 1, 3, 5, 7);
//   * the x window is one TMA box (20 x 9 positions x Cin padded to 32,
//     zeros outside the image and past Cin; its first column rounded down
//     to a multiple of 4, since a box whose start is not 16-byte aligned
//     faults on the H100; a producer warp's own loads where x's rows are not
//     16-byte multiples), kept once in float32 and
//     channel-major, a channel 180 floats: stage A loads the A fragments with
//     32-bit loads (ldmatrix is a 16-bit load) and splits them into hi and
//     lo in registers (the RS form). A lane's two channels of a k8 slice are
//     2c and 2c + 1 (hence the weights' channel order), which puts the
//     lanes of one load on 32 distinct banks;
//   * stage A: per 64-column group and tap, fresh float32 accumulators over
//     Cin, one for hi.hi and one for the two lo terms, added once: the
//     tensor cores' float32 sums drop low bits, and small terms added into
//     the large sum lose more (with one accumulator the card sat several
//     times further from the twin than an exact sum of the passes); the taps
//     combined in the TPU order in registers; once both warpgroups are
//     done with the window, + shift, LeakyReLU and the out-of-image zeros
//     from registers into the planar tile (128 positions x 4 slabs x 32
//     channels; positions 168 floats apart, slabs 36, so stage B's loads
//     are free of bank conflicts within an output row), which takes the
//     window's place; the next window loads once stage B has read it;
//   * stage B: a GEMM with Co as its N (8 at the least) wastes the tensor
//     cores, and a product costs about what an N = 64 one does (a first
//     version on m64n8k8 spent more cycles there than in stage A). So
//     the out-conv is turned around: T = z . W_o over every z-pixel of the
//     tile (each planar position and slab: 512 rows, K = 32 channels), N =
//     taps x Co padded to 4, in two rounds of 8 taps (m64n32k8, A the planar
//     values split in registers, B the out-conv weights' hi and lo, resident;
//     hi.hi and the lo terms again summed apart); T goes to the ring, which
//     stage A leaves free by holding back its tile's last STAGES stages; each
//     output pixel then sums its 16 T values in tap order, + bias, tanh.
// Shared memory: the window / planar tile 92,160 bytes, the out-conv weights
// 16,384, the ring 5 x 16,384 (stage B's T, 512 x 33 floats a round, in its
// place), stage A's first column group parked while the second runs 32,768
// (in registers it pushed the consumers past their 232), barriers. ptxas
// spills one register (8 bytes) around stage A's tap combine; more registers
// for the consumers (240) spill more. Bound at B = 16: 3 x 37.6 GFLOP at the TF32 rate, 0.228
// ms (0.561 at the CUDA cores' float32 rate).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int CIN_MAX = 128;
constexpr int NC_MAX = 128;      // 4 slabs x Cmid
constexpr int CO_MAX = 4;

// ------------------------------------------------------ bf16: tensor cores

namespace tc {

using namespace cic::hop;

constexpr int PR = 8, PC = 16;         // planar rows and columns of a tile
constexpr int POS = PR * PC;           // 128 planar positions: two warpgroups x 64 rows
constexpr int TH = 2 * (PR - 2);       // 12 output rows a tile
constexpr int TW = 2 * (PC - 2);       // 28 output columns a tile
constexpr int XR = PR + 1, XC = PC + 1;  // the x window, 9 x 17 positions
constexpr int THREADS = 256;
constexpr int KSTEPS_MAX = CIN_MAX / 16;
constexpr int MTILES = (TH * TW + 127) / 128;  // stage B: 64-pixel row tiles per warpgroup (3)
constexpr int SMEM_LIMIT = 232448;

// Shared memory, in bytes from a 1024-aligned base: the tap tiles (4 taps x
// ng 64-column groups x cin_pad rows of 128 bytes, swizzled, MN-major); the
// out-conv weights as stage B's B operand (8 rows of Co, K = 16 taps x kt
// channels, K-major, swizzled: kt / 4 atoms of 1024 bytes); the x window
// ([XR * XC][xs_stride]: the channels of a position); the planar tile ([POS]
// [ys_stride]: 4 slabs of kt channels, zeros beyond Cmid); the place of
// each planar column n in a row; shift and bias in float32.
struct Layout {
  int cin_pad, ng, kt, xs_stride, ys_stride;
  int wo_off, x_off, y_off, tab_off, sh_off, bias_off, total;
};

__host__ __device__ inline Layout layout(int Cin, int Cmid) {
  Layout L;
  L.cin_pad = (Cin + 15) / 16 * 16;
  L.ng = (4 * Cmid + 63) / 64;
  L.kt = (Cmid + 15) / 16 * 16;
  L.xs_stride = 2 * L.cin_pad + 16;  // 16 bytes of padding: ldmatrix rows on distinct banks
  L.ys_stride = 2 * 4 * L.kt + 16;
  L.wo_off = 4 * L.ng * L.cin_pad * 128;
  L.x_off = L.wo_off + L.kt / 4 * 1024;
  L.y_off = L.x_off + XR * XC * L.xs_stride;
  L.tab_off = L.y_off + POS * L.ys_stride;
  L.sh_off = L.tab_off + 2 * 128;
  L.bias_off = L.sh_off + 32 * 4;
  L.total = L.bias_off + 4 * 4 + 1024;  // and the 1024-byte alignment of the base
  return L;
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// bf16(a + b) of two pairs of bf16 values, the sum in float32
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  return pack_bf16(bf_lo(a) + bf_lo(b), bf_hi(a) + bf_hi(b));
}

constexpr int XP = (XC + 1) / 2;  // column pairs of the window (9)
constexpr int WIN_TASKS = (XR * XP * (CIN_MAX / 8) + THREADS - 1) / THREADS;  // 6

// The x window of a tile (rows M0 - 1 .. M0 + PR - 1, columns J0 - 1 ..
// J0 + PC - 1 of image b; zeros outside the image and in the channel padding)
// in tasks of 8 channels at one pair of columns J0 - 2 + 2k, J0 - 1 + 2k
// (window columns 2k - 1 and 2k; J0 is even, so with W even and x 4-byte
// aligned a pair is one 4-byte load): task tid + i * THREADS. All of a
// thread's loads are in flight before any is used, so a window costs about one
// memory latency; the loads of the next tile's window are in flight while
// this tile's stage B runs.
struct Window {
  uint32_t v[WIN_TASKS][8];
};

__device__ __forceinline__ void load_window(Window& w, const uint16_t* __restrict__ x, int tid,
                                            int b, int M0, int J0, int Cin, int cin_pad, int H,
                                            int W, bool pairs) {
  const size_t HW = (size_t)H * W;
  const uint16_t* xb = x + (size_t)b * Cin * HW;
  const int ntasks = XR * XP * (cin_pad / 8);
#pragma unroll
  for (int i = 0; i < WIN_TASKS; ++i) {
    const int task = tid + i * THREADS;
    const int rp = task % (XR * XP), oct = task / (XR * XP);
    const int row = M0 - 1 + rp / XP, col = J0 - 2 + 2 * (rp % XP);
    const bool in_row = task < ntasks && row >= 0 && row < H;
    const bool lo_in = in_row && col >= 0 && col < W, hi_in = in_row && col + 1 < W && col + 1 >= 0;
    const uint16_t* p = xb + (size_t)(oct * 8) * HW + (size_t)row * W + col;
    if (pairs && lo_in && hi_in) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w.v[i][e] = oct * 8 + e < Cin ? *reinterpret_cast<const uint32_t*>(p + (size_t)e * HW) : 0u;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool ch = oct * 8 + e < Cin;
        const uint32_t lo = lo_in && ch ? p[(size_t)e * HW] : 0u;
        const uint32_t hi = hi_in && ch ? p[(size_t)e * HW + 1] : 0u;
        w.v[i][e] = lo | (hi << 16);
      }
    }
  }
}

__device__ __forceinline__ void store_window(const Window& w, unsigned char* xs, int tid,
                                             int cin_pad, int xs_stride) {
  const int ntasks = XR * XP * (cin_pad / 8);
#pragma unroll
  for (int i = 0; i < WIN_TASKS; ++i) {
    const int task = tid + i * THREADS;
    if (task >= ntasks) break;
    const int rp = task % (XR * XP), oct = task / (XR * XP);
    const int pos = (rp / XP) * XC + 2 * (rp % XP);  // window column 2k; 2k - 1 before it
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo[e] = (w.v[i][2 * e] & 0xffffu) | (w.v[i][2 * e + 1] << 16);
      hi[e] = (w.v[i][2 * e] >> 16) | (w.v[i][2 * e + 1] & 0xffff0000u);
    }
    if (rp % XP) *reinterpret_cast<uint4*>(xs + (pos - 1) * xs_stride + oct * 16) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(xs + pos * xs_stride + oct * 16) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

// Stage A, step s = (group g = s / 4, tap t = s % 4): ldmatrix of the
// window shifted by the tap into ab, then D = X_t . W_t[g] into db with a
// fresh float32 accumulator, committed as one group.
template <int NG>
__device__ __forceinline__ void mma_step(int s, uint32_t (&ab)[KSTEPS_MAX][4], float (&db)[32],
                                           uint32_t a_base, const unsigned char* wsm,
                                           int xs_stride, int cin_pad, int ksteps) {
  const int t = s & 3, g = s >> 2;
  const uint32_t at = a_base + ((t >> 1) * XC + (t & 1)) * xs_stride;
#pragma unroll
  for (int kk = 0; kk < KSTEPS_MAX; ++kk)
    if (kk < ksteps) ldmatrix_x4(ab[kk], at + kk * 32);
#pragma unroll
  for (int kk = 0; kk < KSTEPS_MAX; ++kk) fence_regs(ab[kk]);
  fence_regs(db);
  wgmma_fence();
  const unsigned char* wtap = wsm + (size_t)(t * NG + g) * cin_pad * 128;
#pragma unroll
  for (int kk = 0; kk < KSTEPS_MAX; ++kk)
    if (kk < ksteps)
      wgmma_rs_m64n64k16_tb(db, ab[kk], sw128_desc(wtap + kk * 16 * 128, cin_pad * 128, 1024),
                            kk > 0);
  wgmma_commit();
}

// NG: the 64-column groups of the 4 Cmid planar channels (1 or 2), a template
// argument so that stage A's steps unroll with their buffers in registers.
template <int NG>
__global__ void __launch_bounds__(THREADS, 1)
tail_tc_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wt,
               const uint16_t* __restrict__ shift, const uint16_t* __restrict__ wo,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B, int Cin,
               int H, int W, int Cmid, int Co, float slope, int tiles_y, int tiles_x) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = layout(Cin, Cmid);
  unsigned char* wsm = base;
  unsigned char* wob = base + L.wo_off;
  unsigned char* xs = base + L.x_off;
  unsigned char* ys = base + L.y_off;
  uint16_t* colmap = reinterpret_cast<uint16_t*>(base + L.tab_off);  // planar column n -> slab kt + o
  float* shs = reinterpret_cast<float*>(base + L.sh_off);
  float* bs = reinterpret_cast<float*>(base + L.bias_off);
  const int tid = threadIdx.x, NC = 4 * Cmid, cin_pad = L.cin_pad;
  constexpr int KT = 16 * NG;                // channels a slab in the planar tile
  constexpr int YS = 2 * 4 * KT + 16;        // its row stride in bytes (L.ys_stride)
  const size_t HW = (size_t)H * W;

  // once per block: the tap tiles (16-byte chunks into the swizzled layout),
  // stage B's weights (element (n, k = tap * kt + c) of the swizzled K-major
  // tile), zeros over the planar tile (its channel padding stays zero), the
  // column table, shift and bias
  for (int c = tid; c < 4 * L.ng * cin_pad * 8; c += THREADS) {
    const int row = c >> 3, ch = c & 7, ci = row % cin_pad;
    const uint4 val = *reinterpret_cast<const uint4*>(wt + (size_t)row * 64 + ch * 8);
    store_chunk_sw128(wsm + (size_t)(row / cin_pad) * cin_pad * 128, ci, ch, val);
  }
  for (int i = tid; i < 8 * 16 * KT; i += THREADS) {
    const int n = i / (16 * KT), k = i % (16 * KT), tap = k / KT, c = k % KT;
    const uint16_t v = n < Co && c < Cmid ? wo[(n * Cmid + c) * 16 + tap] : 0;
    *reinterpret_cast<uint16_t*>(wob + (k >> 6) * 1024 + n * 128 +
                                 ((((k & 63) >> 3) ^ (n & 7)) << 4) + (k & 7) * 2) = v;
  }
  for (int i = tid; i < POS * YS / 16; i += THREADS)
    reinterpret_cast<uint4*>(ys)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int n = tid; n < NC; n += THREADS) colmap[n] = (uint16_t)(n / Cmid * KT + n % Cmid);
  for (int i = tid; i < 32; i += THREADS) shs[i] = i < Cmid ? __uint_as_float((uint32_t)shift[i] << 16) : 0.f;
  if (tid < 4) bs[tid] = tid < Co ? bias[tid] : 0.f;
  fence_proxy_async();
  __syncthreads();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // this thread's accumulator rows: planar positions p0 and p0 + 8, one
  // planar column parity (PC and the tile origin J0 are even)
  const int p0 = wg * 64 + 16 * warp + (lane >> 2);
  const bool odd_col = p0 & 1;
  const int ksteps = cin_pad / 16;
  const bool pairs = W % 2 == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  const int per_image = tiles_y * tiles_x, total = B * per_image;

  auto origin = [&](int tile, int& b, int& M0, int& J0) {
    b = tile / per_image;
    M0 = ((tile % per_image) / tiles_x) * (PR - 2);
    J0 = (tile % tiles_x) * (PC - 2);
  };
  if ((int)blockIdx.x < total) {
    int b, M0, J0;
    origin(blockIdx.x, b, M0, J0);
    Window win;
    load_window(win, x, tid, b, M0, J0, Cin, cin_pad, H, W, pairs);
    store_window(win, xs, tid, cin_pad, L.xs_stride);
  }

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int b, M0, J0;
    origin(tile, b, M0, J0);
    // Addresses that depend on the thread alone are rebuilt on every tile
    // from an opaque zero: hoisted out of the loop they would hold some
    // hundred registers through every stage and spill.
    int zero = 0;
    asm volatile("" : "+r"(zero));
    const int ltid = tid + zero;
    // stage A: this lane's ldmatrix row (a planar position) and 8-channel
    // half of a k step
    const int arow = wg * 64 + 16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7) + zero;
    const uint32_t a_base = smem_u32(xs) + ((arow / PC) * XC + arow % PC) * L.xs_stride +
                            (lane >> 4) * 16;
    // the weight tiles, whose descriptors would otherwise be hoisted too
    const unsigned char* wsm_t = wsm + zero;
    const unsigned char* wob_t = wob + zero;
    __syncthreads();  // the window is in; the last tile's planar tile is read out

    // ---------------------------------------------------------------- stage A
    // Step s = (group g = s / 4, tap t = s % 4): D = X_t . W_t[g] with a fresh
    // float32 accumulator, A from registers (ldmatrix of the window shifted
    // by the tap), B the tap tile. Step s + 1 is started into the other pair
    // of A and D buffers before step s is waited for, rounded to bf16 and
    // combined in the TPU order (pairs of bf16 in yv, P(1, 0) held in p10),
    // so the combine overlaps the next products; after a group's fourth tap
    // the sums go to the planar tile.
    uint32_t a[2][KSTEPS_MAX][4];
    float d[2][32];
    uint32_t yv[16], p10[16];
    mma_step<NG>(0, a[0], d[0], a_base, wsm_t, L.xs_stride, cin_pad, ksteps);
#pragma unroll
    for (int s = 0; s < 4 * NG; ++s) {
      const int cur = s & 1, t = s & 3;
      if (s + 1 < 4 * NG) {
        mma_step<NG>(s + 1, a[cur ^ 1], d[cur ^ 1], a_base, wsm_t, L.xs_stride, cin_pad, ksteps);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(d[cur]);
#pragma unroll
      for (int kk = 0; kk < KSTEPS_MAX; ++kk) fence_regs(a[cur][kk]);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const uint32_t pk = pack_bf16(d[cur][2 * q], d[cur][2 * q + 1]);
        if (t == 0) {
          yv[q] = pk;
        } else if (t == 1) {
          yv[q] = add2(yv[q], pk);
        } else if (t == 2) {
          p10[q] = pk;  // P(1, 0), combined after P(1, 1) on even columns
        } else {
          yv[q] = odd_col ? add2(add2(yv[q], p10[q]), pk) : add2(add2(yv[q], pk), p10[q]);
        }
      }
      if (t == 3) {  // pair q: row p0 + 8 (q % 2), columns n, n + 1 (NC is even)
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int n = (s >> 2) * 64 + 8 * (q >> 1) + 2 * (lane & 3);
          if (n >= NC) continue;
          uint16_t* row = reinterpret_cast<uint16_t*>(ys + (p0 + 8 * (q & 1)) * YS);
          row[colmap[n]] = (uint16_t)yv[q];
          row[colmap[n + 1]] = (uint16_t)(yv[q] >> 16);
        }
      }
    }
    __syncthreads();

    // + shift, LeakyReLU, zeros at the out-of-range pixels (-1 and 2H): 8
    // channels of one slab at one planar position a step
    for (int c = tid; c < POS * 4 * (KT / 8); c += THREADS) {
      const int p = c / (4 * (KT / 8)), slab = (c / (KT / 8)) & 3, o8 = (c % (KT / 8)) * 8;
      if (o8 >= Cmid) continue;
      const int P = 2 * (M0 + p / PC) - (slab >> 1), Q = 2 * (J0 + p % PC) - (slab & 1);
      const bool outside = P < 0 || P >= 2 * H || Q < 0 || Q >= 2 * W;
      uint4* at = reinterpret_cast<uint4*>(ys + p * YS + (slab * KT + o8) * 2);
      const uint4 v4 = *at;
      uint32_t w[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o8 + 2 * e;
        const float2 sh = *reinterpret_cast<const float2*>(shs + o);  // zeros past Cmid
        const uint32_t v = add2(w[e], pack_bf16(sh.x, sh.y));  // exact: shift is bf16
        const float lo = bf_lo(v), hi = bf_hi(v);
        const uint32_t r = pack_bf16(lo >= 0.f ? lo : slope * lo, hi >= 0.f ? hi : slope * hi);
        w[e] = outside ? 0u : (r & (o < Cmid ? 0xffffu : 0u)) | (r & (o + 1 < Cmid ? 0xffff0000u : 0u));
      }
      *at = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();  // the planar tile is in; the window is free

    // the next tile's window: loads in flight during stage B, stored after it
    const int next = tile + gridDim.x;
    Window win;
    if (next < total) {
      int nb, nM0, nJ0;
      origin(next, nb, nM0, nJ0);
      load_window(win, x, ltid, nb, nM0, nJ0, Cin, cin_pad, H, W, pairs);
    }

    // ---------------------------------------------------------------- stage B
    // The 4 x 4 out-conv as a GEMM: row = output pixel (pp, qq) of the tile,
    // K = 16 taps x KT channels gathered from the planar tile (pixel (P, Q)
    // reads z[P - 1 .. P + 2, Q - 1 .. Q + 2]), N = 8 (Co, zero-padded).
    // Per tap, ldmatrix of every row tile's A into one of two buffers, then
    // wgmma m64n8k16 into the row tile's accumulator (three independent
    // chains a warpgroup); a buffer is reused once the products two taps
    // back are done.
    // this lane's ldmatrix rows: the output pixels (pp, qq) of the tile in
    // its warpgroup's row tiles (rows past the tile repeat pixel 0)
    int bpp[MTILES], bqq[MTILES];
#pragma unroll
    for (int mt = 0; mt < MTILES; ++mt) {
      int pix = (2 * mt + wg) * 64 + 16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7) + zero;
      if (pix >= TH * TW) pix = 0;
      bpp[mt] = pix / TW;
      bqq[mt] = pix % TW;
    }
    const uint32_t ys_u32 = smem_u32(ys) + (lane >> 4) * 16;
    float acc[MTILES][4];
    uint32_t ab[2][MTILES][NG][4];
#pragma unroll
    for (int tap = 0; tap < 16; ++tap) {
      const int dy = tap >> 2, dx = tap & 3, buf = tap & 1;
      if (tap >= 2) {  // the products two taps back are done: their A may go
        wgmma_wait<1>();
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
          for (int ks = 0; ks < NG; ++ks) fence_regs(ab[buf][mt][ks]);
      }
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        const int r = bpp[mt] + dy, c = bqq[mt] + dx;
        const uint32_t at = ys_u32 + ((r >> 1) * PC + (c >> 1)) * YS +
                            ((((r + 1) & 1) * 2 + ((c + 1) & 1)) * KT) * 2;
#pragma unroll
        for (int ks = 0; ks < NG; ++ks) ldmatrix_x4(ab[buf][mt][ks], at + ks * 32);
      }
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        if (tap == 0) fence_regs(acc[mt]);
#pragma unroll
        for (int ks = 0; ks < NG; ++ks) fence_regs(ab[buf][mt][ks]);
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NG; ++ks) {
        const int S = tap * NG + ks;  // k step of the whole K
        const uint64_t desc = sw128_desc(wob_t + (S >> 2) * 1024, 16, 1024) + 2 * (S & 3);
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt)
          wgmma_rs_m64n8k16(acc[mt], ab[buf][mt][ks], desc, tap > 0 || ks > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MTILES; ++mt) {
      fence_regs(acc[mt]);
#pragma unroll
      for (int ks = 0; ks < NG; ++ks) {
        fence_regs(ab[0][mt][ks]);
        fence_regs(ab[1][mt][ks]);
      }
    }

    // acc[mt][i]: pixel row 16 warp + lane / 4 + 8 (i / 2) of row tile
    // 2 mt + wg, output channel 2 (lane % 4) + i % 2
    const size_t plane = (size_t)4 * HW;
#pragma unroll
    for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pix = (2 * mt + wg) * 64 + 16 * warp + (lane >> 2) + 8 * (i >> 1);
        const int co = 2 * (lane & 3) + (i & 1);
        if (pix >= TH * TW || co >= Co) continue;
        const int P = 2 * M0 + pix / TW, Q = 2 * J0 + pix % TW;
        if (P >= 2 * H || Q >= 2 * W) continue;
        out[((size_t)b * Co + co) * plane + (size_t)P * 2 * W + Q] =
            __float2bfloat16_rn(tanhf(acc[mt][i] + bs[co]));
      }
    if (next < total) store_window(win, xs, ltid, cin_pad, L.xs_stride);
  }
}

int launch(const void* x, const void* wt, const void* shift, const void* wo, const float* bias,
           void* out, int B, int Cin, int H, int W, int Cmid, int Co, float slope,
           cudaStream_t st) {
  static int smem_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[device]) {  // once, to the card's limit: any shape may follow any other
    err = cudaFuncSetAttribute(tail_tc_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tail_tc_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = 1;
  }
  const Layout L = layout(Cin, Cmid);
  if (L.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (2 * H + TH - 1) / TH, tiles_x = (2 * W + TW - 1) / TW;
  const long long total = (long long)B * tiles_y * tiles_x;
  if (total > (1ll << 31) - 1) return (int)cudaErrorInvalidValue;
  const int grid = (int)(total < sms ? total : sms);
  auto kernel = L.ng == 1 ? tail_tc_kernel<1> : tail_tc_kernel<2>;
  kernel<<<grid, THREADS, L.total, st>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wt),
      static_cast<const uint16_t*>(shift), static_cast<const uint16_t*>(wo), bias,
      static_cast<__nv_bfloat16*>(out), B, Cin, H, W, Cmid, Co, slope, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------------- float32: three TF32 passes

namespace tf {

using namespace cic::hop;

constexpr int PR = tc::PR, PC = tc::PC, POS = PR * PC;  // the bf16 kernel's tile
constexpr int TH = tc::TH, TW = tc::TW;
constexpr int ZTILES = 4 * POS / 64;  // stage B's row m-tiles: every (position, slab) of the tile
constexpr int XR = PR + 1;           // window rows (9)
constexpr int XW = 20;               // window columns loaded: 17 used after 0..3 of alignment
constexpr int CH = XR * XW;          // floats a channel of the window (180)
constexpr int NP = 128;              // planar columns: 4 slabs x Cmid padded to 32
constexpr int CHUNK = 2 * 64 * 128;  // a ring stage: 64 planar columns x 32 channels, hi and lo
constexpr int STAGES = 5;
constexpr int ZP = 168;              // the planar tile: floats between positions (8 mod 32)
constexpr int ZS = 36;               // and between slabs (4 mod 32)
constexpr int WO_PART = 32 * 128;    // out-conv weights of a round, hi or lo: 8 taps x 4 co rows
constexpr int TST = 33;              // floats between rows of stage B's T
constexpr int CONSUMERS = 256;       // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup (two warps load)
constexpr int START_REGS = 168;      // at 384 threads; setmaxnreg deals them out as:
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int WIN_BYTES = CIN_MAX * CH * 4;
constexpr int WO_OFF = WIN_BYTES;
constexpr int RING_OFF = WO_OFF + 4 * WO_PART;
constexpr int Y0_OFF = RING_OFF + STAGES * CHUNK;  // stage A's first column group, parked
constexpr int BAR_OFF = Y0_OFF + CONSUMERS * 32 * 4;
constexpr int SMEM = BAR_OFF + 512 + 1024;  // barriers, shift and bias; the base's alignment
static_assert(POS * ZP * 4 <= WIN_BYTES, "the planar tile fits the window's place");
static_assert(ZTILES * 64 * TST * 4 <= STAGES * CHUNK, "stage B's T fits the ring");
static_assert(TH * TW <= 2 * CONSUMERS, "two output pixels a consumer thread");
static_assert(WO_OFF % 1024 == 0 && RING_OFF % 1024 == 0, "swizzled tiles start 1024-aligned");
static_assert(SMEM <= tc::SMEM_LIMIT, "one block's shared memory");
static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS == THREADS * START_REGS,
              "setmaxnreg must deal out exactly the block's starting registers");

// The planar tile from one 64-column group's sums v (rows p0, p0 + 8 of the
// accumulator layout): + shift, LeakyReLU, zeros at the out-of-image pixels
// (-1 and 2H; they must read as zero in the out-conv), two columns a store.
__device__ __forceinline__ void store_planar(float* __restrict__ z, const float (&v)[32], int g,
                                             int prow, int pcol, int qd, int M0, int J0, int H,
                                             int W, const float* __restrict__ shs, float slope) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int pc = pcol + 8 * ((i >> 1) & 1);
    const int n = g * 64 + 8 * (i >> 2) + 2 * qd, slab = n >> 5, o = n & 31;
    const int P = 2 * (M0 + prow) - (slab >> 1), Q = 2 * (J0 + pc) - (slab & 1);
    float a = __fadd_rn(v[i], shs[o]), c = __fadd_rn(v[i + 1], shs[o + 1]);
    a = a >= 0.f ? a : __fmul_rn(slope, a);
    c = c >= 0.f ? c : __fmul_rn(slope, c);
    const bool outside = P < 0 || P >= 2 * H || Q < 0 || Q >= 2 * W;
    *reinterpret_cast<float2*>(z + (prow * PC + pc) * ZP + slab * ZS + o) =
        outside ? make_float2(0.f, 0.f) : make_float2(a, c);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
tail_tf32_kernel(__grid_constant__ const CUtensorMap xmap, __grid_constant__ const CUtensorMap wmap,
                 const float* __restrict__ x, int x_tma, const float* __restrict__ wo,
                 const float* __restrict__ shift, const float* __restrict__ bias,
                 float* __restrict__ out, int B, int Cin, int cin_pad, int H, int W, int Co,
                 float slope, int tiles_y, int tiles_x) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* win = reinterpret_cast<float*>(base);  // [cin_pad][XR][XW]; later the planar tile [POS][ZP]
  unsigned char* wob = base + WO_OFF;
  unsigned char* ring = base + RING_OFF;
  float* y0s = reinterpret_cast<float*>(base + Y0_OFF);  // [32][CONSUMERS]
  uint64_t* wfull = reinterpret_cast<uint64_t*>(base + BAR_OFF);
  uint64_t* wempty = wfull + 1;
  uint64_t* full = wfull + 2;
  uint64_t* empty = full + STAGES;
  float* shs = reinterpret_cast<float*>(empty + STAGES);  // shift (32), then bias (8)
  float* bs = shs + 32;
  const int tid = threadIdx.x;
  const int per_image = tiles_y * tiles_x, total = B * per_image;
  const int KB = cin_pad / 32;

  if (tid == 0) {
    mbar_init(wfull, 1);
    mbar_init(wempty, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  // once per block: the out-conv weights (2, 16, 4, 32) (half, tap, co,
  // channel) as 16-byte pieces into a 32-row swizzled K-major tile per round
  // of 8 taps and half (row (tap % 8) * 4 + co); shift and bias
  for (int i = tid; i < 2 * 16 * 4 * 8; i += THREADS) {
    const int half = i >> 9, tap = (i >> 5) & 15, row = (tap & 7) * 4 + ((i >> 3) & 3);
    store_chunk_sw128(wob + ((tap >> 3) * 2 + half) * WO_PART, row, i & 7,
                      *reinterpret_cast<const uint4*>(wo + (size_t)i * 4));
  }
  if (tid < 32) shs[tid] = shift[tid];
  if (tid < 8) bs[tid] = bias[tid];
  fence_proxy_async();
  __syncthreads();

  auto origin = [&](int tile, int& b, int& M0, int& J0) {
    b = tile / per_image;
    M0 = ((tile % per_image) / tiles_x) * (PR - 2);
    J0 = (tile % tiles_x) * (PC - 2);
  };

  if (tid >= CONSUMERS) {
    // ------------------------------------------------------------ producers
    reg_dealloc<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      // the weight ring, in the consumers' order: per tile, column group g,
      // tap t, 32-channel block kb
      int i = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x)
        for (int g = 0; g < 2; ++g)
          for (int t = 0; t < 4; ++t)
            for (int kb = 0; kb < KB; ++kb, ++i) {
              const int s = i % STAGES;
              mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
              unsigned char* stage = ring + s * CHUNK;
              mbar_arrive_tx(&full[s], CHUNK);
              tma_load_3d(stage, &wmap, &full[s], kb * 32, t * NP + g * 64, 0);
              tma_load_3d(stage + CHUNK / 2, &wmap, &full[s], kb * 32, t * NP + g * 64, 1);
            }
    } else if (tid >= CONSUMERS + 32 && tid < CONSUMERS + 64) {
      // the x windows, each once stage B of the tile before has read the
      // planar tile out of their place
      const int lane = tid & 31;
      int k = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++k) {
        int b, M0, J0;
        origin(tile, b, M0, J0);
        mbar_wait(wempty, (k & 1) ^ 1);
        const int x0 = (J0 - 1) & ~3;  // a box starts 16-byte aligned (TMA)
        if (x_tma) {
          if (lane == 0) {
            mbar_arrive_tx(wfull, cin_pad * CH * 4);
            tma_load_4d(win, &xmap, wfull, x0, M0 - 1, 0, b);
          }
        } else {
          const float* xb = x + (size_t)b * Cin * H * W;
          for (int e = lane; e < cin_pad * CH; e += 32) {
            const int c = e / CH, rem = e - c * CH;
            const int row = M0 - 1 + rem / XW, col = x0 + rem % XW;
            win[e] = c < Cin && row >= 0 && row < H && col >= 0 && col < W
                         ? xb[((size_t)c * H + row) * W + col]
                         : 0.f;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(wfull);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------------- consumers
  reg_alloc<CONSUMER_REGS>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, qd = lane & 3;
  // this thread's accumulator rows in stage A: planar positions p0 = 16 prow
  // + pcol and p0 + 8 of the tile (one planar column parity: J0 is even)
  const int prow = wg * 4 + warp, pcol = lane >> 2;
  const bool odd_col = pcol & 1;
  int chunk = 0, k = 0;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++k) {
    int b, M0, J0;
    origin(tile, b, M0, J0);
    mbar_wait(wfull, k & 1);
    // the accumulators live in this tile's stage A only (the products read
    // them, as far as the compiler knows, so they are set here)
    float y[32], hold[32], d[32], dc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) d[q] = dc[q] = 0.f;

    // ---------------------------------------------------------------- stage A
    // Per column group g and tap t = (r, s): D = X_t . W_t[g] with a fresh
    // float32 accumulator, A from the window shifted by the tap (a[0], a[1]:
    // channel 2 qd of the slice at columns pcol, pcol + 8; a[2], a[3]:
    // channel 2 qd + 1), B the ring's stage; each 32-channel block's 12
    // products are one group, waited for before its stage goes back.
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* xa =
            win + 2 * qd * CH + (prow + (t >> 1)) * XW + ((J0 - 1) & 3) + pcol + (t & 1);
        for (int kb = 0; kb < KB; ++kb, ++chunk) {
          const int s = chunk % STAGES;
          mbar_wait(&full[s], (chunk / STAGES) & 1);
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* p = xa + (kb * 32 + kk * 8) * CH;
            tf32_split(p[0], ah[kk][0], al[kk][0]);
            tf32_split(p[8], ah[kk][1], al[kk][1]);
            tf32_split(p[CH], ah[kk][2], al[kk][2]);
            tf32_split(p[CH + 8], ah[kk][3], al[kk][3]);
          }
          fence_regs(d);
          fence_regs(dc);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(ah[kk]);
            fence_regs(al[kk]);
          }
          wgmma_fence();
          const unsigned char* stage = ring + s * CHUNK;
          const uint64_t dh = sw128_desc(stage, 16, 1024);
          const uint64_t dl = sw128_desc(stage + CHUNK / 2, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int acc = kb > 0 || kk > 0;
            wgmma_rs_m64n64k8_tf32(dc, al[kk], dh + 2 * kk, acc);
            wgmma_rs_m64n64k8_tf32(dc, ah[kk], dl + 2 * kk, 1);
            wgmma_rs_m64n64k8_tf32(d, ah[kk], dh + 2 * kk, acc);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(d);
          fence_regs(dc);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(ah[kk]);
            fence_regs(al[kk]);
          }
          // the tile's last STAGES stages stay held: stage B keeps T there
          if ((g * 4 + t) * KB + kb < 8 * KB - STAGES) mbar_arrive(&empty[s]);
        }
        // the tap's product (hi.hi + the lo terms), into the sums in the TPU
        // order: P(0, 0) + P(0, 1), then P(1, 1) before P(1, 0) on even
        // planar columns and after it on odd ones
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const float pt = __fadd_rn(d[q], dc[q]);
          if (t == 0) {
            y[q] = pt;
          } else if (t == 1) {
            y[q] = __fadd_rn(y[q], pt);
          } else if (t == 2) {
            hold[q] = pt;  // P(1, 0)
          } else {
            y[q] = odd_col ? __fadd_rn(__fadd_rn(y[q], hold[q]), pt)
                           : __fadd_rn(__fadd_rn(y[q], pt), hold[q]);
          }
        }
      }
      if (g == 0) {  // parked in shared memory: in registers it would crowd group 1's
#pragma unroll
        for (int q = 0; q < 32; ++q) y0s[q * CONSUMERS + tid] = y[q];
      }
    }

    // both warpgroups are done with the window: the planar tile takes its place
    float* z = win;
    bar_sync(1, CONSUMERS);
    {
      float y0[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) y0[q] = y0s[q * CONSUMERS + tid];
      store_planar(z, y0, 0, prow, pcol, qd, M0, J0, H, W, shs, slope);
    }
    store_planar(z, y, 1, prow, pcol, qd, M0, J0, H, W, shs, slope);
    bar_sync(1, CONSUMERS);

    // ---------------------------------------------------------------- stage B
    // The 4 x 4 out-conv, out[P][Q][co] = sum over taps (dy, dx) of
    // T[z-pixel (P - 1 + dy, Q - 1 + dx)][tap, co], where T = z . W_o is a
    // GEMM on the tensor cores: a row per z-pixel (each planar position and
    // slab of the tile, 512), K = 32 channels, N = taps x 4 (Co padded) in
    // two rounds of 8 taps; then each output sums its 16 T values in tap
    // order. T goes to the ring, which the weights leave free: stage A held
    // back the ring's last STAGES stages. Row m-tile mt: slab mt / 2,
    // positions 64 (mt % 2) + 0 .. 63.
    float* ts = reinterpret_cast<float*>(ring);  // T of a round: [512][TST]
    // What depends on the thread alone is rebuilt on every tile from an
    // opaque zero: hoisted out of the tile loop, it would hold registers
    // through stage A and spill.
    int zero = 0;
    asm volatile("" : "+r"(zero));
    const int ltid = tid + zero;
    float osum[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    int pp[2], qq[2];  // this thread's output pixels: tid and tid + 256 (if in the tile)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pix = h ? ltid + CONSUMERS : ltid;
      pp[h] = pix / TW;
      qq[h] = pix % TW;
    }
#pragma unroll 1
    for (int round = 0; round < 2; ++round) {
      const unsigned char* wr = wob + round * 2 * WO_PART;
      const uint64_t dh = sw128_desc(wr, 16, 1024), dl = sw128_desc(wr + WO_PART, 16, 1024);
#pragma unroll 1
      for (int i = 0; i < ZTILES / 2; ++i) {
        const int mt = 2 * i + wg, slab = mt >> 1;
        const int pos = (mt & 1) * 64 + 16 * warp + (lane >> 2) + zero;
        const float* za = z + pos * ZP + slab * ZS + qd;
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          tf32_split(za[kk * 8], ah[kk][0], al[kk][0]);
          tf32_split(za[8 * ZP + kk * 8], ah[kk][1], al[kk][1]);
          tf32_split(za[kk * 8 + 4], ah[kk][2], al[kk][2]);
          tf32_split(za[8 * ZP + kk * 8 + 4], ah[kk][3], al[kk][3]);
        }
        float t[16], tc[16];  // hi.hi, and the lo terms
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(ah[kk]);
          fence_regs(al[kk]);
        }
        fence_regs(t);
        fence_regs(tc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_m64n32k8_tf32(tc, al[kk], dh + 2 * kk, kk > 0);
          wgmma_rs_m64n32k8_tf32(tc, ah[kk], dl + 2 * kk, 1);
          wgmma_rs_m64n32k8_tf32(t, ah[kk], dh + 2 * kk, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(t);
        fence_regs(tc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(ah[kk]);
          fence_regs(al[kk]);
        }
        // t[j]: z-pixel row mt * 64 + 16 warp + lane / 4 + 8 ((j / 2) % 2),
        // column 8 (j / 4) + 2 qd + j % 2 (tap 8 round + column / 4, co column % 4)
        const int zi = mt * 64 + 16 * warp + (lane >> 2) + zero;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          ts[(zi + 8 * ((j >> 1) & 1)) * TST + 8 * (j >> 2) + 2 * qd + (j & 1)] =
              __fadd_rn(t[j], tc[j]);
      }
      bar_sync(1, CONSUMERS);  // T of the round is in (and, after round 1, z is read out)
      if (round == 1) {
        // the planar tile is read out: the next window may take its place
        fence_proxy_async();
        mbar_arrive(wempty);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h && tid + CONSUMERS >= TH * TW) continue;
#pragma unroll
        for (int tl = 0; tl < 8; ++tl) {
          const int tap = round * 8 + tl, r = pp[h] + (tap >> 2), c = qq[h] + (tap & 3);
          const int zi = (((r + 1) & 1) * 2 + ((c + 1) & 1)) * POS + (r >> 1) * PC + (c >> 1);
          const float* row = ts + zi * TST + tl * 4;
#pragma unroll
          for (int co = 0; co < 4; ++co) osum[h][co] = __fadd_rn(osum[h][co], row[co]);
        }
      }
      bar_sync(1, CONSUMERS);  // T of the round is read out
    }
    // the ring's last STAGES stages go back to the producer
    fence_proxy_async();
#pragma unroll 1
    for (int q = 0; q < STAGES; ++q) mbar_arrive(&empty[(chunk - STAGES + q) % STAGES]);

    // + bias, tanh, the NCHW store
    const size_t plane = (size_t)4 * H * W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pix = h ? tid + CONSUMERS : tid;
      const int P = 2 * M0 + pp[h], Q = 2 * J0 + qq[h];
      if (pix >= TH * TW || P >= 2 * H || Q >= 2 * W) continue;
#pragma unroll
      for (int co = 0; co < 4; ++co)
        if (co < Co)
          out[((size_t)b * Co + co) * plane + (size_t)P * 2 * W + Q] =
              tanhf(__fadd_rn(osum[h][co], bs[co]));
    }
  }
}

int launch(const void* x, const float* taps, const float* wo, const float* shift,
           const float* bias, void* out, int B, int Cin, int H, int W, int Co, float slope,
           cudaStream_t st) {
  static int ready[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    // the build must start a thread at START_REGS registers, the pool
    // setmaxnreg deals from; a block that started lower would stall in its
    // first increase, so such a build is refused before its first launch
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, tail_tf32_kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs != START_REGS) return (int)cudaErrorInvalidKernelImage;
    err = cudaFuncSetAttribute(tail_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    ready[device] = 1;
  }
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (!aligned(taps) || !aligned(wo)) return (int)cudaErrorMisalignedAddress;
  const int cin_pad = (Cin + 31) / 32 * 32;
  CUtensorMap xmap = {}, wmap = {};
  const int x_tma = W % 4 == 0 && aligned(x);
  if (x_tma) {
    const long long dims[4] = {W, H, Cin, B};
    const int box[4] = {XW, XR, cin_pad, 1};
    const int e = encode_f32_map(&xmap, x, 4, dims, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != 0) return e;
  }
  const long long wdims[3] = {cin_pad, 4 * NP, 2};
  const int wbox[3] = {32, 64, 1};
  const int e = encode_f32_map(&wmap, taps, 3, wdims, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (2 * H + TH - 1) / TH, tiles_x = (2 * W + TW - 1) / TW;
  const long long total = (long long)B * tiles_y * tiles_x;
  if (total > (1ll << 31) - 1) return (int)cudaErrorInvalidValue;
  const int grid = (int)(total < sms ? total : sms);
  tail_tf32_kernel<<<grid, THREADS, SMEM, st>>>(
      xmap, wmap, static_cast<const float*>(x), x_tma, wo, shift, bias, static_cast<float*>(out),
      B, Cin, cin_pad, H, W, Co, slope, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace tf

}  // namespace

// float32. x: (B, Cin, H, W); taps: (2, 4, 128, Cin padded to 32), TF32 hi
// then lo of the BN-folded deconv taps r * 2 + s, rows slab * 32 + o (Cmid
// padded to 32), input channels of each group of 8 in the order 0, 2, 4, 6,
// 1, 3, 5, 7 (ops/generator_tail.py::_pack_taps_tf32); shift: (32,) and bias:
// (8,) float32, zeros in the padding; wo: (2, 16, 4, 32), hi then lo of the
// out-conv weight at tap dy * 4 + dx, output channel co, channel c (zeros
// past Co and Cmid); out: (B, Co, 2H, 2W). Takes Cin <= 128, Cmid <= 32, Co <= 4.
extern "C" int cic_packed_tail(const void* x, const void* taps, const void* shift, const void* wo,
                               const float* bias, void* out, int B, int Cin, int H, int W,
                               int Cmid, int Co, float slope, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cin > CIN_MAX || Cmid < 1 || 4 * Cmid > NC_MAX ||
      Co < 1 || Co > CO_MAX)
    return (int)cudaErrorInvalidValue;
  return tf::launch(x, static_cast<const float*>(taps), static_cast<const float*>(wo),
                    static_cast<const float*>(shift), bias, out, B, Cin, H, W, Co, slope,
                    static_cast<cudaStream_t>(stream));
}

// bf16 (x, wt, shift, wo, out). x: (B, Cin, H, W); the taps as tiles wt:
// (4, ceil(4 Cmid / 64), Cin padded to 16, 64), tap r * 2 + s, column group
// g holding columns g * 64 .. + 63 of (a * 2 + b) * Cmid + o, zeros in the
// padding; shift: (Cmid,); wo: (Co, Cmid, 4, 4); bias: (Co,) float32; out:
// (B, Co, 2H, 2W). Takes Cin <= 128, Cmid <= 32, Co <= 4.
extern "C" int cic_packed_tail_bf16(const void* x, const void* wt, const void* shift,
                                    const void* wo, const float* bias, void* out, int B, int Cin,
                                    int H, int W, int Cmid, int Co, float slope, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cin > CIN_MAX || Cmid < 1 || 4 * Cmid > NC_MAX ||
      Co < 1 || Co > CO_MAX)
    return (int)cudaErrorInvalidValue;
  return tc::launch(x, wt, shift, wo, bias, out, B, Cin, H, W, Cmid, Co, slope,
                    static_cast<cudaStream_t>(stream));
}
