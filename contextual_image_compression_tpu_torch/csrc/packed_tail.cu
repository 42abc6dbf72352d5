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
// float32 (bar 2e-5 against the twin): tail_kernel, one block of 320 threads
// per image per 16 x 16 output pixels on float32 CUDA cores. The tile reads
// planar rows and columns 8t .. 8t + 9 (10 x 10 positions x 4 slabs x Cmid,
// the 4.1 MB planar tensor of a full image never exists) from an 11 x 11 x
// Cin x tile in shared memory; warp w owns planar column w and all ten rows,
// lane l four planar channels, so the x reads of a warp are one broadcast and
// each (ci) step is 40 FMAs for 4 + 10 shared loads; it is bound by float32
// FMA throughput.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TILE = 16;         // output pixels per tile side
constexpr int PL = TILE / 2 + 2; // planar positions per tile side (10)
constexpr int XT = PL + 1;       // x rows / cols per tile side (11)
constexpr int THREADS = 32 * PL; // one warp per planar column
constexpr int CIN_MAX = 128;
constexpr int NC_MAX = 128;      // 4 slabs x Cmid
constexpr int CO_MAX = 4;

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T>
__host__ __device__ size_t smem_bytes(int Cin, int NC, int Co, int Cmid) {
  return align16((size_t)Cin * XT * XT * sizeof(T)) + align16((size_t)Cin * NC * sizeof(T)) +
         align16((size_t)PL * PL * NC * sizeof(T)) + (size_t)Co * Cmid * 16 * sizeof(float);
}

template <typename T>
__device__ __forceinline__ float add_round(float a, float b) {
  return cic::round_to<T>(a + b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tail_kernel(const T* __restrict__ x, const T* __restrict__ wpk, const T* __restrict__ shift,
            const T* __restrict__ wo, const float* __restrict__ bias, T* __restrict__ out,
            int Cin, int H, int W, int Cmid, int Co, float slope) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int NC = 4 * Cmid;
  T* xs = reinterpret_cast<T*>(raw);                                      // [Cin][XT][XT]
  T* ws = reinterpret_cast<T*>(raw + align16((size_t)Cin * XT * XT * sizeof(T)));  // [Cin][NC]
  T* ys = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(ws) +
                               align16((size_t)Cin * NC * sizeof(T)));    // [PL][PL][NC]
  float* wos = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ys) +
                                        align16((size_t)PL * PL * NC * sizeof(T)));  // [Co][Cmid][4][4]

  const int b = blockIdx.z;
  const int M0 = blockIdx.y * (TILE / 2), J0 = blockIdx.x * (TILE / 2);
  const int tid = threadIdx.x;
  const int jl = tid / 32, cg = tid % 32;
  const bool active = cg * 4 < NC;
  const int j = J0 + jl;  // global planar column of this warp

  // x tile rows M0 - 1 .. M0 + 9, columns J0 - 1 .. J0 + 9, zero outside the image
  const T* xb = x + (size_t)b * Cin * H * W;
  for (int i = tid; i < Cin * XT * XT; i += THREADS) {
    const int ci = i / (XT * XT), rem = i % (XT * XT), rr = rem / XT, cc = rem % XT;
    const int row = M0 - 1 + rr, col = J0 - 1 + cc;
    xs[i] = (row >= 0 && row < H && col >= 0 && col < W)
                ? xb[((size_t)ci * H + row) * W + col]
                : cic::from_f32<T>(0.f);
  }
  for (int i = tid; i < Co * Cmid * 16; i += THREADS) wos[i] = cic::to_f32(wo[i]);

  float Y[PL][4], acc[PL][4];
  for (int t = 0; t < 4; ++t) {
    const int r = t / 2, s = t % 2;
    __syncthreads();  // the previous tap's weights are consumed
    for (int i = tid; i < Cin * NC; i += THREADS) ws[i] = wpk[(size_t)t * Cin * NC + i];
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int ml = 0; ml < PL; ++ml)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[ml][k] = 0.f;
#pragma unroll 2
    for (int ci = 0; ci < Cin; ++ci) {
      const T* wrow = ws + ci * NC + cg * 4;
      const float w4[4] = {cic::to_f32(wrow[0]), cic::to_f32(wrow[1]), cic::to_f32(wrow[2]),
                           cic::to_f32(wrow[3])};
      const T* xcol = xs + (ci * XT + r) * XT + jl + s;
#pragma unroll
      for (int ml = 0; ml < PL; ++ml) {
        const float xv = cic::to_f32(xcol[ml * XT]);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[ml][k] += xv * w4[k];
      }
    }
#pragma unroll
    for (int ml = 0; ml < PL; ++ml) {
      T* slot = ys + (ml * PL + jl) * NC + cg * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float p = cic::round_to<T>(acc[ml][k]);
        if (t == 0) {
          Y[ml][k] = p;
        } else if (t == 1) {
          Y[ml][k] = add_round<T>(Y[ml][k], p);
        } else if (t == 2) {
          slot[k] = cic::from_f32<T>(p);  // P(1, 0), combined after P(1, 1)
        } else {
          const float p10 = cic::to_f32(slot[k]);
          Y[ml][k] = (j % 2 == 0) ? add_round<T>(add_round<T>(Y[ml][k], p), p10)
                                  : add_round<T>(add_round<T>(Y[ml][k], p10), p);
        }
      }
    }
  }

  // + shift, LeakyReLU, zeros at the out-of-range pixels, into the planar tile
  if (active) {
#pragma unroll
    for (int ml = 0; ml < PL; ++ml) {
      const int m = M0 + ml;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = cg * 4 + k, slab = n / Cmid, o = n % Cmid;
        const int P = 2 * m - slab / 2, Q = 2 * j - slab % 2;
        float v = add_round<T>(Y[ml][k], cic::to_f32(shift[o]));
        v = cic::round_to<T>(v >= 0.f ? v : slope * v);
        if (P < 0 || P >= 2 * H || Q < 0 || Q >= 2 * W) v = 0.f;
        ys[(ml * PL + jl) * NC + n] = cic::from_f32<T>(v);
      }
    }
  }
  __syncthreads();

  // out-conv: pixel (p, q) reads z[p - 1 .. p + 2, q - 1 .. q + 2]
  if (tid >= TILE * TILE) return;
  const int p = blockIdx.y * TILE + tid / TILE, q = blockIdx.x * TILE + tid % TILE;
  if (p >= 2 * H || q >= 2 * W) return;
  float o[CO_MAX];
#pragma unroll
  for (int co = 0; co < CO_MAX; ++co) o[co] = 0.f;
  for (int dy = 0; dy < 4; ++dy) {
    const int P = p - 1 + dy, ml = ((P + 1) >> 1) - M0, a = P & 1;
    for (int dx = 0; dx < 4; ++dx) {
      const int Q = q - 1 + dx, jq = ((Q + 1) >> 1) - J0, bb = Q & 1;
      const T* z = ys + (ml * PL + jq) * NC + (a * 2 + bb) * Cmid;
      for (int c = 0; c < Cmid; ++c) {
        const float zv = cic::to_f32(z[c]);
#pragma unroll
        for (int co = 0; co < CO_MAX; ++co)
          if (co < Co) o[co] += zv * wos[((co * Cmid + c) * 4 + dy) * 4 + dx];
      }
    }
  }
  const size_t plane = (size_t)4 * H * W;
#pragma unroll
  for (int co = 0; co < CO_MAX; ++co)
    if (co < Co)
      out[((size_t)b * Co + co) * plane + (size_t)p * 2 * W + q] =
          cic::from_f32<T>(tanhf(o[co] + bias[co]));
}

template <typename T>
int launch(const void* x, const void* wpk, const void* shift, const void* wo, const float* bias,
           void* out, int B, int Cin, int H, int W, int Cmid, int Co, float slope,
           cudaStream_t st) {
  const size_t smem = smem_bytes<T>(Cin, 4 * Cmid, Co, Cmid);
  cudaError_t err = cudaFuncSetAttribute(tail_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((2 * W + TILE - 1) / TILE, (2 * H + TILE - 1) / TILE, B);
  tail_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wpk), static_cast<const T*>(shift),
      static_cast<const T*>(wo), bias, static_cast<T*>(out), Cin, H, W, Cmid, Co, slope);
  return (int)cudaGetLastError();
}

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

}  // namespace

// float32 (x, wpk, shift, wo, out). x: (B, Cin, H, W); wpk: (4, Cin, 4 * Cmid)
// packed deconv taps with BatchNorm folded in; shift: (Cmid,); wo: (Co, Cmid,
// 4, 4); bias: (Co,) float32; out: (B, Co, 2H, 2W). Takes Cin <= 128,
// Cmid <= 32, Co <= 4.
extern "C" int cic_packed_tail(const void* x, const void* wpk, const void* shift, const void* wo,
                               const float* bias, void* out, int B, int Cin, int H, int W,
                               int Cmid, int Co, float slope, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cin > CIN_MAX || Cmid < 1 || 4 * Cmid > NC_MAX ||
      Co < 1 || Co > CO_MAX)
    return (int)cudaErrorInvalidValue;
  return launch<float>(x, wpk, shift, wo, bias, out, B, Cin, H, W, Cmid, Co, slope,
                       static_cast<cudaStream_t>(stream));
}

// bf16 (x, wt, shift, wo, out), arguments as cic_packed_tail but the taps as
// tiles wt: (4, ceil(4 Cmid / 64), Cin padded to 16, 64), tap r * 2 + s,
// column group g holding columns g * 64 .. + 63 of (a * 2 + b) * Cmid + o,
// zeros in the padding.
extern "C" int cic_packed_tail_bf16(const void* x, const void* wt, const void* shift,
                                    const void* wo, const float* bias, void* out, int B, int Cin,
                                    int H, int W, int Cmid, int Co, float slope, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cin > CIN_MAX || Cmid < 1 || 4 * Cmid > NC_MAX ||
      Co < 1 || Co > CO_MAX)
    return (int)cudaErrorInvalidValue;
  return tc::launch(x, wt, shift, wo, bias, out, B, Cin, H, W, Cmid, Co, slope,
                    static_cast<cudaStream_t>(stream));
}
