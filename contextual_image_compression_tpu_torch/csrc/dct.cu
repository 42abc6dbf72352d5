// K5: the DCT baseline codec's 8x8 block transform.
//
// Replaces contextual_image_compression_tpu/ops/dct.py::_dct_strips_pallas
// (Pallas body _dct_strip_kernel). For each 8x8 tile X of channel c of the
// level-shifted YCbCr planes (B, C, H, W), float32:
//   coef = D X D^T                 (D the orthonormal 8x8 DCT-II)
//   sym  = rint(coef / q_c)        (IEEE division, round half to even)
//   rec  = D^T (sym * q_c) D
// and writes rec and sym, both float32, in the planes' layout (which is also
// the (B*C*H/8, 8, W) strip layout of the TPU kernel).
//
// Bound on the H100: each pixel is read once (4 bytes) and two float32 values
// are written (8 bytes), against ~70 float32 operations (four 8-term
// products, the divide, the rounding and the dequantize), so it is bound by
// bytes: 12 bytes per pixel at 3.35 TB/s. The design keeps the memory busy:
//  * a persistent grid (two blocks of 256 threads an SM) walks the tiles in
//    one flattened order over (strip, tile column), a ragged W included; a
//    warp takes 4 tiles at a time, a thread one tile row of 8 floats, read
//    and written as two 16-byte accesses (streaming stores: nothing reads
//    rec or sym again here);
//  * the next 4 tiles' loads are issued before the current tiles' arithmetic;
//  * D lives in registers (64 a thread, loaded once), the channel tables in
//    shared memory (loaded once a block);
//  * the four 8-term products run in registers: the column transforms
//    (t D^T and its inverse deq D) on the thread's own row, the row
//    transforms (D X and its inverse D^T u) on a column, which the warp
//    hands over through a per-warp shared transpose (XOR-swizzled, so that
//    rows as float4s and columns as floats both hit 32 distinct banks) under
//    __syncwarp; no block barrier after the tables are loaded.
// Every sum is an fmaf chain over its 8 terms in index order;
// tests/test_torch_fp32_dct_plans.py emulates that order and the walk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int TILES_PER_WARP = 4;
constexpr int MAX_C = 16;  // channels whose tables the block holds
constexpr int MAX_DEVICES = 64;

// Word of row i, column cc (0..31: 4 tiles of 8 columns) of a warp's
// transpose buffer.
__device__ __forceinline__ int at(int i, int cc) { return i * 32 + (cc ^ (4 * i)); }

// The warp's 4 tiles handed over through buf: thread (tile k, lane r) gives
// row r of its tile and takes column r (rows_to_columns), or the reverse.
__device__ __forceinline__ void rows_to_columns(float* buf, const float (&row)[8], float (&col)[8],
                                                int k, int r) {
  *reinterpret_cast<float4*>(buf + at(r, 8 * k)) = make_float4(row[0], row[1], row[2], row[3]);
  *reinterpret_cast<float4*>(buf + at(r, 8 * k + 4)) = make_float4(row[4], row[5], row[6], row[7]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) col[i] = buf[at(i, 8 * k + r)];
}

__device__ __forceinline__ void columns_to_rows(float* buf, const float (&col)[8], float (&row)[8],
                                                int k, int c) {
#pragma unroll
  for (int i = 0; i < 8; ++i) buf[at(i, 8 * k + c)] = col[i];
  __syncwarp();
  const float4 a = *reinterpret_cast<const float4*>(buf + at(c, 8 * k));
  const float4 b = *reinterpret_cast<const float4*>(buf + at(c, 8 * k + 4));
  row[0] = a.x; row[1] = a.y; row[2] = a.z; row[3] = a.w;
  row[4] = b.x; row[5] = b.y; row[6] = b.z; row[7] = b.w;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
dct_strip_kernel(const float* __restrict__ planes, const float* __restrict__ dmat,
                 const float* __restrict__ tables, float* __restrict__ rec,
                 float* __restrict__ sym, int C, int H, int W, int ntiles) {
  __shared__ __align__(16) float q_s[MAX_C * 64];
  __shared__ __align__(16) float bufs[WARPS][2][256];  // ping-pong transpose buffers
  for (int i = threadIdx.x; i < C * 64; i += THREADS) q_s[i] = tables[i];
  float d[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) d[i][j] = __ldg(dmat + 8 * i + j);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = lane >> 3, r = lane & 7;  // this thread: row r (or column r) of tile k
  float* buf0 = bufs[warp][0];
  float* buf1 = bufs[warp][1];
  const int tiles_w = W / 8, strips_c = H / 8;
  const int tasks = (ntiles + TILES_PER_WARP - 1) / TILES_PER_WARP;
  const int stride = gridDim.x * WARPS;

  // Row r of tile k of a task: its 8 floats, element offset and channel
  // (off < 0: past the last tile).
  auto load = [&](int task, float4& a, float4& b, long long& off, int& ch) {
    const int t = task * TILES_PER_WARP + k;
    off = -1;
    ch = 0;
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
    if (task < tasks && t < ntiles) {
      const int strip = t / tiles_w, tc = t - strip * tiles_w;
      off = ((long long)strip * 8 + r) * W + tc * 8;
      ch = (strip / strips_c) % C;
      a = __ldcs(reinterpret_cast<const float4*>(planes + off));
      b = __ldcs(reinterpret_cast<const float4*>(planes + off + 4));
    }
  };

  int task = blockIdx.x * WARPS + warp;
  float4 a, b;
  long long off;
  int ch;
  load(task, a, b, off, ch);
  for (; task < tasks; task += stride) {
    float4 na, nb;
    long long noff;
    int nch;
    load(task + stride, na, nb, noff, nch);  // in flight during this task's arithmetic

    // 1. rows: t = D X, on column r of the tile
    const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float col[8], row[8];
    rows_to_columns(buf0, x, col, k, r);
    float tcol[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) acc = fmaf(d[i][m], col[m], acc);
      tcol[i] = acc;
    }
    columns_to_rows(buf1, tcol, row, k, r);

    // 2. columns: coef = t D^T on row r, then quantize and dequantize
    const float4 q0 = *reinterpret_cast<const float4*>(q_s + ch * 64 + r * 8);
    const float4 q1 = *reinterpret_cast<const float4*>(q_s + ch * 64 + r * 8 + 4);
    const float q[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    float s[8], deq[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) acc = fmaf(row[w], d[j][w], acc);
      s[j] = rintf(__fdiv_rn(acc, q[j]));
      deq[j] = s[j] * q[j];
    }

    // 3. undo the columns: u = deq D on row r
    float u[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(deq[j], d[j][w], acc);
      u[w] = acc;
    }

    // 4. undo the rows: rec = D^T u, on column r. (Each transpose's
    // __syncwarp also orders the previous reads of the other buffer before
    // its writes, so the two buffers need no barrier of their own.)
    rows_to_columns(buf0, u, col, k, r);
    float rcol[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) acc = fmaf(d[m][i], col[m], acc);
      rcol[i] = acc;
    }
    columns_to_rows(buf1, rcol, row, k, r);

    if (off >= 0) {
      __stcs(reinterpret_cast<float4*>(rec + off), make_float4(row[0], row[1], row[2], row[3]));
      __stcs(reinterpret_cast<float4*>(rec + off + 4), make_float4(row[4], row[5], row[6], row[7]));
      __stcs(reinterpret_cast<float4*>(sym + off), make_float4(s[0], s[1], s[2], s[3]));
      __stcs(reinterpret_cast<float4*>(sym + off + 4), make_float4(s[4], s[5], s[6], s[7]));
    }
    a = na;
    b = nb;
    off = noff;
    ch = nch;
  }
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

}  // namespace

// planes, rec, sym: (B, C, H, W) float32, contiguous and 16-byte aligned;
// dmat: the 8x8 D; tables: (C, 8, 8).
extern "C" int cic_dct_strips(const float* planes, const float* dmat, const float* tables,
                              float* rec, float* sym, int B, int C, int H, int W,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % 8 != 0 || W % 8 != 0 || B < 1 || H < 8 || W < 8 || C < 1 || C > MAX_C)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(planes) | reinterpret_cast<uintptr_t>(rec) |
       reinterpret_cast<uintptr_t>(sym)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const long long ntiles = (long long)B * C * (H / 8) * (W / 8);
  if (ntiles > 0x7fffffffLL - TILES_PER_WARP * WARPS * BLOCKS_PER_SM * (long long)sms)
    return (int)cudaErrorInvalidValue;  // tile and task indices stay in int
  const long long want = (ntiles + TILES_PER_WARP * WARPS - 1) / (TILES_PER_WARP * WARPS);
  const int blocks = (int)(want < (long long)BLOCKS_PER_SM * sms ? want : BLOCKS_PER_SM * sms);
  dct_strip_kernel<<<blocks, THREADS, 0, st>>>(planes, dmat, tables, rec, sym, C, H, W,
                                               (int)ntiles);
  return (int)cudaGetLastError();
}
