// The constants and declarations shared by K2 / K6 (attention.cu) and K7
// (sagan_block.cu): the widths the attention kernels take, the layout of the
// float32 route's TF32 scratch, and the two entries K7 launches its attention
// through.
#pragma once

#include <cuda_runtime.h>

namespace cic {
namespace attn {

constexpr int DK_MAX = 64;   // largest q/k width taken
constexpr int DV_MAX = 256;  // largest v width taken (multiple of 64)
constexpr int TF32_KEYS = 32;  // keys a tile of the float32 route (attention.cu tf::KEYS)
// key tiles a segment of K7's float32 e.V: each segment sums 96 TF32
// products a value on the tensor cores, and the segments add in float32
constexpr int TF32_SEG_TILES = 8;

// Element strides (batch, position, channel) of a residual and an output.
struct Strides {
  long long rb, rn, rc, ob, on, oc;
};

// The float32 route's scratch, all float32 and contiguous: TF32 hi and lo of
// q and k, (B, N, dkp) each with dkp = DK rounded up to 32 or 64 and zeros
// beyond DK; then hi and lo of V^T, (B, DV, np) each with np = N rounded up
// to TF32_KEYS and zeros at keys >= N, each group of 8 keys stored in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (the order in which S's accumulator hands e
// over as the A operand of e.V; attention.cu namespace tf).
// K7's scratch (with_acc) then holds, where N takes more than one segment
// of TF32_SEG_TILES key tiles, e.V of every segment but the last, (segments
// - 1, B, N, DV) float32; acc is null otherwise.
// ops/attention.py::_tf32_scratch_elems counts the same elements.
struct Tf32Scratch {
  float *qh, *ql, *kh, *kl, *vh, *vl, *acc;
  int dkp, np;
};

inline int tf32_segments(int N) {
  return ((N + TF32_KEYS - 1) / TF32_KEYS + TF32_SEG_TILES - 1) / TF32_SEG_TILES;
}

inline long long tf32_scratch_elems(int B, int N, int DK, int DV, bool with_acc = false) {
  const long long dkp = DK <= 32 ? 32 : 64, np = (N + TF32_KEYS - 1) / TF32_KEYS * TF32_KEYS;
  const long long acc = with_acc ? (tf32_segments(N) - 1LL) * B * N * DV : 0;
  return 4LL * B * N * dkp + 2LL * B * DV * np + acc;
}

inline Tf32Scratch tf32_scratch(void* base, int B, int N, int DK, int DV, bool with_acc = false) {
  Tf32Scratch s;
  s.dkp = DK <= 32 ? 32 : 64;
  s.np = (N + TF32_KEYS - 1) / TF32_KEYS * TF32_KEYS;
  const long long nq = (long long)B * N * s.dkp, nv = (long long)B * DV * s.np;
  s.qh = static_cast<float*>(base);
  s.ql = s.qh + nq;
  s.kh = s.ql + nq;
  s.kl = s.kh + nq;
  s.vh = s.kl + nq;
  s.vl = s.vh + nv;
  s.acc = with_acc && tf32_segments(N) > 1 ? s.vl + nv : nullptr;
  return s;
}

// K2's bf16 tensor-core kernel (attention.cu) on contiguous bf16 q, k
// (B, N, DK) and v (B, N, DV), with the residual read and the output written
// contiguous (B, N, DV) (strides null; out 16-byte aligned) or at the given
// element strides; K7's second launch in bf16.
int tc_block(const void* q, const void* k, const void* v, const void* res, const float* gamma,
             void* out, int B, int N, int DK, int DV, const Strides* strides,
             cudaStream_t stream);

// K2's float32 kernel (three TF32 passes, attention.cu namespace tf) on a
// scratch (with_acc) that already holds the hi and lo of q, k and V^T, with
// K7's order of the score products (score_mma_apart) and e.V in segments of
// TF32_SEG_TILES key tiles added in float32 (acc), a float32 residual (not
// null) and output contiguous (B, N, DV) (strides null) or at the given
// element strides; K7's float32 attention.
int tf32_block(const Tf32Scratch& s, const void* res, const float* gamma, void* out, int B,
               int N, int DK, int DV, const Strides* strides, cudaStream_t stream);

}  // namespace attn
}  // namespace cic
