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
// bytes: 12 bytes per pixel at 3.35 TB/s. The TPU kernel runs the column
// transform as one (8, W) x (W, W) product with a block-diagonal matrix,
// which suits its 128x128 matrix unit; here each thread owns one coefficient
// of an 8x8 tile, a block covers four tiles side by side (an 8 x 32 patch of
// one strip, 128-byte coalesced rows), D and the channel's table sit in
// shared memory, and the four products run as 8-term FMA sums over a tile
// staged in shared memory. Nothing but the planes, rec and sym touches
// device memory: no tiled quantization tensor and no W x W matrix.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILES = 4;          // 8x8 tiles per block along W
constexpr int SPAN = 8 * TILES;   // columns per block

__global__ void __launch_bounds__(SPAN * 8)
dct_strip_kernel(const float* __restrict__ planes, const float* __restrict__ dmat,
                 const float* __restrict__ tables, float* __restrict__ rec,
                 float* __restrict__ sym, int C, int H, int W) {
  __shared__ float d_s[8][9];          // D, rows padded against bank conflicts
  __shared__ float q_s[8][8];          // this strip's channel table
  __shared__ float a_s[8][SPAN + 1];
  __shared__ float b_s[8][SPAN + 1];
  const int r = threadIdx.y, c = threadIdx.x;
  const int tid = r * SPAN + c;
  const long long strip = blockIdx.x;  // ((b * C + ch) * (H / 8) + row of tiles)
  const int ch = (int)((strip / (H / 8)) % C);
  const int x = blockIdx.y * SPAN + c;
  if (tid < 64) {
    d_s[tid / 8][tid % 8] = dmat[tid];
  } else if (tid < 128) {
    q_s[(tid - 64) / 8][(tid - 64) % 8] = tables[ch * 64 + tid - 64];
  }
  const bool inside = x < W;  // W is a multiple of 8: a tile is all in or all out
  const size_t o = ((size_t)strip * 8 + r) * (size_t)W + x;
  a_s[r][c] = inside ? planes[o] : 0.f;
  __syncthreads();

  const int t0 = c & ~7, j = c & 7;
  // 1. rows: t = D X
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(d_s[r][i], a_s[i][c], acc);
  b_s[r][c] = acc;
  __syncthreads();
  // 2. columns: coef = t D^T, then quantize and dequantize
  float coef = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) coef = fmaf(b_s[r][t0 + w], d_s[j][w], coef);
  const float q = q_s[r][j];
  const float s = rintf(coef / q);
  a_s[r][c] = s * q;
  __syncthreads();
  // 3. undo the columns: u = deq D
  float u = 0.f;
#pragma unroll
  for (int v = 0; v < 8; ++v) u = fmaf(a_s[r][t0 + v], d_s[v][j], u);
  b_s[r][c] = u;
  __syncthreads();
  // 4. undo the rows: rec = D^T u
  float out = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) out = fmaf(d_s[i][r], b_s[i][c], out);
  if (inside) {
    rec[o] = out;
    sym[o] = s;
  }
}

}  // namespace

extern "C" int cic_dct_strips(const float* planes, const float* dmat, const float* tables,
                              float* rec, float* sym, int B, int C, int H, int W,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long strips = (long long)B * C * (H / 8);
  const int col_blocks = (W + SPAN - 1) / SPAN;
  if (H % 8 != 0 || W % 8 != 0 || strips <= 0 || strips > 0x7fffffffLL || col_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(SPAN, 8);
  const dim3 grid((unsigned)strips, col_blocks);
  dct_strip_kernel<<<grid, block, 0, st>>>(planes, dmat, tables, rec, sym, C, H, W);
  return (int)cudaGetLastError();
}
