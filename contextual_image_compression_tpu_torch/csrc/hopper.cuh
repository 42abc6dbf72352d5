// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tile loads,
// the proxy fence, named barriers, setmaxnreg and warpgroup matrix multiplies
// (wgmma) with 128-byte-swizzled shared-memory operands; and on the host,
// the driver's tensor-map encoder.
//
// Tiles handed to wgmma here are rows of 128 bytes (64 bf16 or 32 TF32),
// 1024-byte aligned, with the 128-byte swizzle: the 16-byte chunk `ch` of row `r` lies at
// r * 128 + ((ch ^ (r % 8)) * 16). TMA writes that layout with
// CU_TENSOR_MAP_SWIZZLE_128B and a 64 x 64 box; `store_chunk_sw128` writes it
// from registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cic {
namespace hop {

constexpr int TILE_BYTES = 64 * 128;  // one 64 x 64 bf16 tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// more than 2^32 clocks (seconds) traps, so a fault in the pipeline ends the
// kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

// ------------------------------------------------------- copies and fences

// One TMA load of a box of a 3-D tensor map into shared memory; completion is
// reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One TMA load of a box of a 4-D tensor map (coordinates fastest first).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Makes this thread's ordinary shared-memory stores visible to the async
// proxy (TMA, wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Register rebalancing between warpgroups: the caller's warpgroup takes N
// registers a thread from here on (all its threads execute it).
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Two floats rounded to bf16 (round to nearest even), low half the first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 16 bytes (8 bf16) into chunk `ch` of row `r` of a 128-byte-swizzled tile.
__device__ __forceinline__ void store_chunk_sw128(unsigned char* tile, int r, int ch, uint4 val) {
  *reinterpret_cast<uint4*>(tile + r * 128 + ((ch ^ (r & 7)) << 4)) = val;
}

// Four 8 x 8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 (16 bytes, 16-byte aligned). As the A fragment of
// wgmma_rs_m64n64k16_tb: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7),
// (rows 0-7, k 8-15), (rows 8-15, k 8-15) of the warp's 16 rows.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// ------------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled operand. `lbo` and
// `sbo` in bytes: for a K-major operand sbo is the 1024 bytes between 8-row
// groups (lbo unused); for an MN-major one sbo is the 1024 bytes between groups
// of 8 K-rows and lbo the distance between 64-column groups.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operands across
// the asynchronous product (an empty asm that "modifies" them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define CIC_WGMMA_D32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define CIC_WGMMA_ACC32(d)                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// D (64 x 64, float32) (+)= A (64 x 16, K-major in shared memory)
//                          * B (16 x 64, K-major in shared memory), bf16 inputs.
// D's fragment: d[i] is row 16 * warp + lane / 4 + 8 * ((i / 2) % 2),
// column 8 * (i / 4) + 2 * (lane % 4) + i % 2. scale_d = 0 ignores D's value.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CIC_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : CIC_WGMMA_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major in
// shared memory). A's fragment, as bf16 pairs (low half the lower column):
// a[0] row r, columns 2c, 2c+1; a[1] row r + 8, the same columns; a[2], a[3]
// the same rows at columns + 8; r = 16 * warp + lane / 4, c = lane % 4.
// scale_d = 0 ignores D's value (a fresh accumulator).
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CIC_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : CIC_WGMMA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x 8, float32) (+)= A (64 x 16 bf16, registers, fragment as above)
// * B (16 x 8, K-major in shared memory: 8 rows of the swizzled layout).
// d[i] is row 16 * warp + lane / 4 + 8 * (i / 2), column 2 * (lane % 4) + i % 2.
__device__ __forceinline__ void wgmma_rs_m64n8k16(float (&d)[4], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// ------------------------------------------------------------- TF32 wgmma
//
// TF32 operands are K-major only (the transpose immediates exist for 16-bit
// types alone); a k8 slice is 32 bytes of a 128-byte swizzled row, so slice
// kk of a 32-float-wide tile starts 32 * kk bytes in (descriptor + 2 * kk).

// x rounded to TF32 (10 mantissa bits, round to nearest, ties away from
// zero), as a float32 bit pattern whose low 13 bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The three-pass split x = hi + lo, both TF32: hi = rna(x), lo = rna(x - hi)
// (x - hi is exact).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

#define CIC_WGMMA_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define CIC_WGMMA_ACC16(d)                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// D (64 x 32, float32) (+)= A (64 x 8, K-major in shared memory)
// * B (8 x 32, K-major in shared memory), TF32 inputs. D's fragment as
// wgmma_ss_m64n64k16's, columns 0..31. scale_d = 0 ignores D's value.
__device__ __forceinline__ void wgmma_ss_m64n32k8_tf32(float (&d)[16], uint64_t desc_a,
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " CIC_WGMMA_D16
      ", %16, %17, p, 1, 1;\n"
      "}\n"
      : CIC_WGMMA_ACC16(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32, float32) (+)= A (64 x 8 TF32, registers, fragment as
// wgmma_rs_m64n64k8_tf32's) * B (8 x 32, K-major in shared memory). D's
// fragment as wgmma_ss_m64n32k8_tf32's.
__device__ __forceinline__ void wgmma_rs_m64n32k8_tf32(float (&d)[16], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " CIC_WGMMA_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : CIC_WGMMA_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 8 TF32, registers) * B (8 x 64, K-major in
// shared memory). A's fragment: a[0] row r, column c; a[1] row r + 8, column
// c; a[2] row r, column c + 4; a[3] row r + 8, column c + 4; r = 16 * warp +
// lane / 4, c = lane % 4. scale_d = 0 ignores D's value.
__device__ __forceinline__ void wgmma_rs_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " CIC_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : CIC_WGMMA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#undef CIC_WGMMA_D16
#undef CIC_WGMMA_ACC16
#undef CIC_WGMMA_D32
#undef CIC_WGMMA_ACC32

// ------------------------------------------------------------- tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A dense tensor of `rank` (<= 5) dimensions, dims[0] the fastest, of
// elements `bytes` wide at ptr, as a map with boxes of box[0] x ... elements
// and zero fill outside the tensor. Returns 0 or a cudaError_t.
inline int encode_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int bytes,
                      int rank, const long long* dims, const int* box,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  cuuint64_t d[5], strides[4];
  cuuint32_t b[5], elem[5];
  cuuint64_t stride = (cuuint64_t)bytes;
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    elem[i] = 1;
    if (i > 0) strides[i - 1] = stride;
    stride *= d[i];
  }
  const CUresult r = enc(map, type, (cuuint32_t)rank, const_cast<void*>(ptr), d, strides, b, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A float32 tensor as encode_map's.
inline int encode_f32_map(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
                          const int* box, CUtensorMapSwizzle swizzle) {
  return encode_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, rank, dims, box, swizzle);
}

}  // namespace hop
}  // namespace cic
