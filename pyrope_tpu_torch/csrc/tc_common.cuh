// Hopper pieces shared by the tensor-core scans (flat_scan_tc.cu,
// ivf_list_scan_tc.cu): mbarriers, TMA tile loads, the 128-byte-swizzled
// K-major wgmma descriptors, wgmma.m64n128k16 with fp32 accumulators, the
// plain-load staging of the same swizzled layout, and the host's tensor map
// encoding (cuTensorMapEncodeTiled through the runtime: no libcuda link).
//
// A stage tile is [rows x 64 depths] bf16: 128-byte rows in TMA's 128-byte
// swizzle, the 16-byte piece c of row r at c ^ (r & 7), 8-row groups 1024
// bytes apart. In the m64n128 accumulator layout warp w of a warpgroup holds
// rows (queries) 16 w + lane / 4 and 16 w + 8 + lane / 4 of the A operand at
// columns (corpus rows) 8 j + 2 (lane % 4) + {0, 1}, register 4 j + 2 h + e.
#pragma once

#include <cuda.h>   // CUtensorMap and the tensor map enums; no libcuda link
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TC_RT = 128;        // corpus rows a tile: the wgmma's N
constexpr int TC_DC = 64;         // depths a chunk: a 128-byte bf16 row, the swizzle's span
constexpr int TC_WG = 128;        // threads of a warpgroup
constexpr int TC_QRES_MAX_D = 256;   // q resident up to this depth, streamed above
constexpr int TC_MAX_STAGES = 4;
constexpr int TC_FLUSH_MIN = 32;   // the wide flat scan: buffers flushed at the floor's tiles
constexpr int TC_XTILE = TC_RT * 128;   // bytes of a stage's rows
constexpr int TC_SMEM_LIMIT = 232448;   // a block's shared memory on sm_90
constexpr int TC_SMEM_TWO_BLOCKS = 115712;   // the most for two blocks an SM
constexpr unsigned TC_SPIN_LIMIT = 1u << 28;   // mbarrier polls before a trap

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive and expect `bytes` of TMA on the barrier's current phase.
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `phase` to complete. A lost arrival traps
// (a launch error) after TC_SPIN_LIMIT polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int phase) {
  const uint32_t a = smem_u32(bar);
  for (unsigned n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
    if (done) return;
    if (n > TC_SPIN_LIMIT) __trap();
  }
}

// Generic-proxy writes to shared memory made visible to the tensor cores'
// (async) proxy; each writing thread runs it before the barrier that hands
// the tile over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [c1, c1 + box rows) x depths [c0, c0 + 64) of the map's tensor into
// shared memory at dst, completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            unsigned long long* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A K-major operand in the 128-byte swizzle mode: rows of 128 bytes, 8-row
// groups 1024 bytes apart (the stride byte offset); the leading byte offset
// is unused in this mode.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma boundaries.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both K-major bf16 in shared
// memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Plain-load staging (no TMA): rows [row0, row0 + nrows) x depths [d0,
// d0 + 64) of src [*, D] into the swizzled tile at dst, zeros at rows >=
// row_end and depths >= D; t is the thread's index in the producer.
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint16_t* src, int row0,
                                           int nrows, int row_end, int D, int d0, int t) {
  for (int e = t; e < nrows * 8; e += TC_WG) {
    const int rr = e >> 3, c = e & 7;
    const int row = row0 + rr, dd = d0 + 8 * c;
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = row < row_end;
      const uint32_t lo = ok && dd + 2 * u < D ? src[(size_t)row * D + dd + 2 * u] : 0u;
      const uint32_t hi = ok && dd + 2 * u + 1 < D ? src[(size_t)row * D + dd + 2 * u + 1] : 0u;
      w[u] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst + rr * 128 + ((c ^ (rr & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A row's score from its dot and its row-table entry (+inf: the row is out).
template <bool IP>
__device__ __forceinline__ float tc_score(float dot, float sqv, float qqi) {
  return IP ? (sqv < INFINITY ? dot : -INFINITY) : -fmaxf(qqi - 2.f * dot + sqv, 0.f);
}

// Both loads issued at once: neither waits on the other.
__device__ __forceinline__ float row_sq(const float* sqnorm, const uint8_t* alive,
                                        int row, int limit) {
  if (row >= limit) return INFINITY;
  const float s = sqnorm[row];
  return alive[row] ? s : INFINITY;
}

// The best score a lane holds for its query of half h (accumulator rows g +
// 8 h) in one tile, as the scores' own bits: for L2 -max(t, 0) of the least
// t = |q|^2 - 2 dot + sqnorm (-max(., 0) is monotone), for IP the largest
// dot of a live row. A tile's epilogue takes one warp vote on it.
template <bool IP>
__device__ __forceinline__ float lane_best(const float (&acc)[64], const float2 (&sq)[16],
                                           int h, float qqi) {
  float best = IP ? -INFINITY : INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float dot = acc[4 * j + 2 * h + e];
      const float sqv = e ? sq[j].y : sq[j].x;
      if (IP) best = fmaxf(best, dot + (sqv < INFINITY ? 0.f : -INFINITY));
      else best = fminf(best, qqi - 2.f * dot + sqv);
    }
  }
  return IP ? best : -fmaxf(best, 0.f);
}

// The quad of lanes holding half h's query writes its 128 scores of the
// tile to the warp's staging row (stg[TC_RT]).
template <bool IP>
__device__ __forceinline__ void stage_scores(float* stg, const float (&acc)[64],
                                             const float2 (&sq)[16], int h, int t4,
                                             float qqi) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    *reinterpret_cast<float2*>(stg + 8 * j + 2 * t4) =
        make_float2(tc_score<IP>(acc[4 * j + 2 * h], sq[j].x, qqi),
                    tc_score<IP>(acc[4 * j + 2 * h + 1], sq[j].y, qqi));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime: the library
// need not link libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &qr);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &qr);
#endif
    if (err == cudaSuccess && qr == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2D map over a [rows, d] bf16 tensor: boxes of box_rows rows x 64 depths
// in the 128-byte swizzle, zeros past its edges.
inline int encode_rows(CUtensorMap* map, const void* ptr, int rows, int d, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)TC_DC, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                        dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
