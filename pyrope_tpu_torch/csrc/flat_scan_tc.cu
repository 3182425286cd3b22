// The bf16 flat scan on Hopper's tensor cores (sm_90a), CUDA C++: a
// TMA-fed wgmma main loop under the flat scan's top-k epilogue.
//
// Replaces, of pyrope_tpu/ops/pallas_scan.py, the bf16 slab mode of K1
// pallas_flat_topk (:672, body _scan_kernel :572): the branch x.dtype ==
// bfloat16 of _tile_scores (:232-264), where the MXU multiplies bf16(q) by
// the bf16 rows (dot_general, preferred_element_type=float32), narrow (k <=
// 128) and wide (k > 128: _wide_params :372, _bitonic_merge_wide :192,
// _merge_tile_wide :200, _extract_top :496). It feeds the merge kernels of
// fused_scan.cu, as the fp32 scan does.
//
// What it computes, per query b and corpus row t (fused_scan.cu's scan on
// bf16 operands):
//   dot = bf16(q_b) . x_t, products exact in fp32, sums in fp32
//   score = -max(|q|^2 - 2 dot + sqnorm[t], 0)   (L2; |q|^2 of the fp32 q,
//   qsq)   or   dot   (IP); a row survives iff alive[t] && t < max_scans
// and returns the top k survivors in the total order (score desc, row asc),
// (-inf, -1) where nothing survived. A product of two bf16 values is exact
// in fp32, so the tensor cores compute the MXU's products; only the order
// of the sum differs, as it did on the CUDA cores.
//
// What bounds it on an H100. At 1M x 128, B 1024 the product is 268 GFLOP
// against 256 MB of slab: 0.27 ms of bf16 tensor-core operations (989
// TFLOP/s at 700 W), 0.08 ms of bytes. So it is bound by operations, and by
// the epilogue beside them: every one of the B x N scores is compared with
// its query's threshold (1.07e9 at the main shape, about 4 instructions
// each on the CUDA cores). The kernel it replaces ran the same products as
// fp32 FMAs widened from bf16 (8.47 ms, bound by shared-memory wavefronts).
//
// Shape of the work. Grid = (query tiles of BT = 64 NC queries) x (corpus
// splits); the query tiles of a split are adjacent, so their reads of the
// split's rows meet in L2 (ops/fused_scan._splits: one wave). A block is
// one producer warpgroup and NC consumer warpgroups (NC 2 for B > 64, 1
// for B <= 64 and in the wide mode). setmaxnreg, to move the producer's
// registers to the consumers, changed nothing and went: ptxas compiles
// every role to the launch bound (168 registers a thread at three
// warpgroups, 128 at two with two blocks an SM), with the same spills and
// device time with and without it (one-call A/B, H100, 700 W).
//
//   The ring. A stage is a [128 rows x 64 depths] bf16 tile of the slab
//   (16 KB, 128-byte rows in TMA's 128-byte swizzle: the 16-byte piece c of
//   row r at c ^ (r & 7)), and, above D 256, the same depths of the block's
//   queries. One thread of the producer keeps NST stages in flight by TMA
//   (cp.async.bulk.tensor; tensor maps over x [N, D] and q [B, D], built
//   by the C entry and passed as __grid_constant__ parameters) behind
//   full/empty mbarrier pairs; TMA's zero fill covers rows past N and the
//   depth tail. Two more producer warps write the tile's row table
//   (sqnorm, +inf for a row that is dead or cut) into the stage of the
//   tile's last chunk, loaded a tile ahead. Rows TMA cannot take (D % 8
//   != 0, or a base not 16-byte aligned: vec == 0) are staged by plain
//   loads of the whole producer warpgroup into the same swizzled layout,
//   then fence.proxy.async.
//
//   Queries as A, rows as B. A consumer warpgroup owns 64 queries. For D <=
//   256 their [64 x D] bf16 tile is resident in shared memory (one TMA per
//   64-depth chunk at the start); above, it streams in the ring beside x.
//   Each 16-depth step is wgmma.mma_async.m64n128k16.f32.bf16.bf16 with
//   both operands K-major in shared memory (descriptors in the 128-byte
//   swizzle mode, the step advancing the start address by 32 bytes): no
//   transpose. The 64 x 128 fp32 scores of a tile are 64 registers a
//   thread. A chunk's stage is released as soon as its wgmmas complete;
//   the last chunk's, which holds the row table, after the epilogue.
//
//   The epilogue keeps fused_scan.cu's invariant: a warp owns its
//   queries. In the m64n128 accumulator layout warp w of a warpgroup holds
//   queries 16 w + lane / 4 and 16 w + 8 + lane / 4, at rows 8 j + 2 (lane %
//   4) + {0, 1} of the tile (register 4 j + 2 h + e), so every score of a
//   query lies in the 4 lanes of one quad of one warp, and the query's list
//   belongs to that warp alone. A lane turns its 32 dots of a query into
//   scores and the warp takes one vote on whether any lane's best reaches
//   its query's threshold; most tiles end there. Else, for each quad whose
//   query passed, the quad writes its 128 scores to the warp's staging row
//   in shared memory and the warp offers them to that query's list 32 at a
//   time (offer / wide_offer, each behind a vote on beats): the calls of
//   fused_scan.cu's epilogue, with 32 candidates each. The threshold, the
//   publication of a split's c-th score and the floor read after tiles 0,
//   1, 3, 7, ... (flat_epilogue.cuh) are the fp32 scan's; the wide mode
//   publishes only after a flush changed its list (which lies in global
//   memory: a read of it at every passing query cost an L2 round trip).
//
//   Overlap. With NC 2 the two consumer warpgroups share each stage and
//   race: the one whose products finish first runs its epilogue beside the
//   other's. Turns forced by named barriers (FA3's ping-pong) measured 2%
//   faster in one A/B and 6% slower in another (1M x 128, b1024, H100 at
//   700 W, bench/scan_ab.py, one call each), and deadlock where a tile has
//   more chunks than the ring has stages; a second set of accumulators
//   does not fit (168 registers a thread at three warpgroups). With
//   NC 1 two blocks share an SM where shared memory allows it
//   (ops/fused_scan.flat_tile).
//
//   Wide mode (k > MAXK): the same main loop under wide_offer and
//   wide_flush, a FLAT_CAP-entry candidate buffer a query (topk_wide.cuh),
//   one block an SM; the ring shrinks (4 -> 3 -> 2 stages) before the buffer
//   does, where shared memory runs short (tc_stages). A list changes only
//   when its buffer flushes, and a split publishes only then: flushed only
//   when full, the lists published late and the floor stayed loose, and the
//   offers and flushes took 70% of a warp's cycles at b256 k512 (clock64
//   counters in a copy). So at the floor's tiles buffers of TC_FLUSH_MIN or
//   more flush and publish: 2.4x fewer offers in the CPU emulation
//   (tests/_torch_parity.flat_scan_emulated, flush_min), 6.9 -> 3.7 ms of
//   device time (bench/scan_ab.py, one call, H100, 700 W).

#include <cuda.h>   // CUtensorMap and the tensor map enums; no libcuda link
#include <string.h>

#include "flat_epilogue.cuh"

namespace {

constexpr int TC_RT = 128;        // corpus rows a tile: the wgmma's N
constexpr int TC_DC = 64;         // depths a chunk: a 128-byte bf16 row, the swizzle's span
constexpr int TC_WG = 128;        // threads of a warpgroup
constexpr int TC_QRES_MAX_D = 256;   // q resident up to this depth, streamed above
constexpr int TC_MAX_STAGES = 4;
constexpr int TC_FLUSH_MIN = 32;   // wide mode: buffers flushed at the floor's tiles
constexpr int TC_XTILE = TC_RT * 128;   // bytes of a stage's rows
constexpr int TC_SMEM_LIMIT = 232448;   // a block's shared memory on sm_90
constexpr int TC_SMEM_TWO_BLOCKS = 115712;   // the most for two blocks an SM
constexpr unsigned TC_SPIN_LIMIT = 1u << 28;   // mbarrier polls before a trap

// Byte offsets of a block's shared memory from its 1024-aligned base.
struct TcLayout {
  int qstream;       // q streams in the ring (D > TC_QRES_MAX_D)
  size_t stage;      // bytes a stage: rows, then the q chunk when streamed
  size_t qres;       // resident q: nchunk x [bt x 128 B]
  size_t rsq;        // [nst][TC_RT] row table, +inf: row is out
  size_t bars;       // full[nst], empty[nst], qfull
  size_t perq;       // |q|^2, threshold score, threshold row, published: [bt] each
  size_t stg;        // [bt / 16 warps][TC_RT] staged scores
  size_t lists;      // [bt][k] values, rows; wide: buffers [bt][FLAT_CAP], states
  size_t total;      // with the alignment slack
};

__host__ __device__ inline TcLayout tc_layout(int k, int bt, int d, int nst) {
  TcLayout L;
  const int nchunk = (d + TC_DC - 1) / TC_DC;
  L.qstream = d > TC_QRES_MAX_D;
  L.stage = TC_XTILE + (L.qstream ? (size_t)bt * 128 : 0);
  size_t off = (size_t)nst * L.stage;
  L.qres = off;
  off += L.qstream ? 0 : (size_t)nchunk * bt * 128;
  L.rsq = off;
  off += (size_t)nst * TC_RT * sizeof(float);
  L.bars = off;
  off += (2 * (size_t)nst + 1) * sizeof(unsigned long long);
  L.perq = off;
  off += 4 * (size_t)bt * sizeof(float);
  L.stg = off;
  off += (size_t)(bt / 16) * TC_RT * sizeof(float);
  L.lists = off;
  off += k > MAXK ? (size_t)bt * (2 * FLAT_CAP * sizeof(float) + sizeof(WideState))
                  : 2 * (size_t)bt * k * sizeof(float);
  L.total = off + 1024;
  return L;
}

// Stages of the ring: the most (4 down to 2) with which the block fits its
// target, two blocks an SM for the narrow 64-query tile, else one; failing
// that, the most that fit one block an SM.
inline int tc_stages(int k, int bt, int d) {
  const size_t target = (bt == 64 && k <= MAXK) ? TC_SMEM_TWO_BLOCKS : TC_SMEM_LIMIT;
  for (int nst = TC_MAX_STAGES; nst >= 2; --nst)
    if (tc_layout(k, bt, d, nst).total <= target) return nst;
  for (int nst = TC_MAX_STAGES; nst >= 2; --nst)
    if (tc_layout(k, bt, d, nst).total <= TC_SMEM_LIMIT) return nst;
  return 2;
}

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

// Plain-load staging (vec == 0): rows [row0, row0 + nrows) x depths [d0,
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

// q [B, D] bf16 (bf16(q), exact), x [N, D] bf16, qsq [B] |q|^2 of the fp32
// q, sqnorm [N] of the fp32 rows. part_v, part_i: [B, S, kw], S =
// gridDim.y; kw = k, or in the wide mode min(k, rows_per_split). vec: the
// tensor maps are valid (TMA staging), else plain loads stage both.
template <int NC, bool IP, bool WIDE>
__global__ void __launch_bounds__(TC_WG * (NC + 1), (NC == 1 && !WIDE) ? 2 : 1)
flat_scan_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap qmap,
                    const uint16_t* __restrict__ q, const uint16_t* __restrict__ x,
                    const float* __restrict__ qsq, const float* __restrict__ sqnorm,
                    const uint8_t* __restrict__ alive, int B, int N, int D, int k,
                    int kw, int max_scans, int rows_per_split, int vec, int nst,
                    float* __restrict__ part_v, int32_t* __restrict__ part_i,
                    float* __restrict__ pub, int pub_c, int pub_g) {
  constexpr int BT = 64 * NC;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const TcLayout L = tc_layout(k, BT, D, nst);
  float* rsq = reinterpret_cast<float*>(base + L.rsq);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(base + L.bars);
  unsigned long long* empty = full + nst;
  unsigned long long* qfull = empty + nst;
  float* qq = reinterpret_cast<float*>(base + L.perq);
  float* thv = qq + BT;
  int* thi = reinterpret_cast<int*>(thv + BT);
  float* pubv = reinterpret_cast<float*>(thi + BT);
  float* stg = reinterpret_cast<float*>(base + L.stg);
  float* lv = reinterpret_cast<float*>(base + L.lists);
  int* li = reinterpret_cast<int*>(lv + (size_t)BT * (WIDE ? FLAT_CAP : k));
  WideState* wst = reinterpret_cast<WideState*>(li + (size_t)BT * FLAT_CAP);   // WIDE

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BT;
  const int r_begin = blockIdx.y * rows_per_split;
  const int limit = min(min(r_begin + rows_per_split, N), max_scans);
  const int nchunk = (D + TC_DC - 1) / TC_DC;
  const int ntile = limit > r_begin ? (limit - r_begin + TC_RT - 1) / TC_RT : 0;
  const int nstage = ntile * nchunk;
  const int S = gridDim.y;

  if (tid == 0) {
    // TMA: the issuing thread's expect_tx and 64 row-table writers; plain
    // loads: the whole producer warpgroup
    for (int s = 0; s < nst; ++s) {
      mbar_init(full + s, vec ? 65 : TC_WG);
      mbar_init(empty + s, 4 * NC);   // lane 0 of each consumer warp
    }
    mbar_init(qfull, vec ? 1 : TC_WG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!WIDE) {
    for (int e = tid; e < BT * k; e += blockDim.x) {
      lv[e] = -INFINITY;
      li[e] = -1;
    }
  }
  for (int i = tid; i < BT; i += blockDim.x) {
    if (WIDE) wst[i] = {0, 0};
    // a query past B never takes a candidate: nothing beats (+inf, -1)
    thv[i] = q0 + i < B ? -INFINITY : INFINITY;
    thi[i] = -1;
    pubv[i] = -INFINITY;
    qq[i] = q0 + i < B ? qsq[q0 + i] : 0.f;
  }
  __syncthreads();

  if (tid < TC_WG) {
    // ---- the producer warpgroup ----
    if (nstage == 0) return;
    uint8_t* qres = base + L.qres;
    if (vec) {
      const int warp = tid >> 5;
      if (warp == 0) {
        if (lane != 0) return;
        if (!L.qstream) {   // the block's queries, every chunk, once
          mbar_arrive_tx(qfull, (uint32_t)(nchunk * BT * 128));
          for (int ch = 0; ch < nchunk; ++ch)
            tma_load_2d(smem_u32(qres + (size_t)ch * BT * 128), &qmap, qfull,
                        ch * TC_DC, q0);
        }
        for (int it = 0; it < nstage; ++it) {
          const int tile = it / nchunk, ch = it - tile * nchunk;
          const int s = it % nst;
          mbar_wait(empty + s, ((it / nst) & 1) ^ 1);
          uint8_t* st = base + (size_t)s * L.stage;
          mbar_arrive_tx(full + s, (uint32_t)(TC_XTILE + (L.qstream ? BT * 128 : 0)));
          tma_load_2d(smem_u32(st), &xmap, full + s, ch * TC_DC,
                      r_begin + tile * TC_RT);
          if (L.qstream)
            tma_load_2d(smem_u32(st + TC_XTILE), &qmap, full + s, ch * TC_DC, q0);
        }
        return;
      }
      if (warp == 3) return;
      // warps 1 and 2: the row table, rows t and t + 64 of each tile, loaded
      // a tile ahead, written into the stage of the tile's last chunk
      const int t = tid - 32;
      float n0 = row_sq(sqnorm, alive, r_begin + t, limit);
      float n1 = row_sq(sqnorm, alive, r_begin + t + 64, limit);
      int it = 0;
      for (int tile = 0; tile < ntile; ++tile) {
        const float v0 = n0, v1 = n1;
        if (tile + 1 < ntile) {
          const int row = r_begin + (tile + 1) * TC_RT + t;
          n0 = row_sq(sqnorm, alive, row, limit);
          n1 = row_sq(sqnorm, alive, row + 64, limit);
        }
        for (int ch = 0; ch < nchunk; ++ch, ++it) {
          const int s = it % nst;
          mbar_wait(empty + s, ((it / nst) & 1) ^ 1);
          if (ch == nchunk - 1) {
            rsq[s * TC_RT + t] = v0;
            rsq[s * TC_RT + t + 64] = v1;
          }
          mbar_arrive(full + s);
        }
      }
      return;
    }
    // plain loads: the whole warpgroup stages each chunk, then hands it to
    // the tensor cores' (async) proxy
    if (!L.qstream) {
      for (int ch = 0; ch < nchunk; ++ch)
        stage_rows(qres + (size_t)ch * BT * 128, q, q0, BT, B, D, ch * TC_DC, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(qfull);
    }
    for (int it = 0; it < nstage; ++it) {
      const int tile = it / nchunk, ch = it - tile * nchunk;
      const int s = it % nst;
      const int row0 = r_begin + tile * TC_RT;
      mbar_wait(empty + s, ((it / nst) & 1) ^ 1);
      uint8_t* st = base + (size_t)s * L.stage;
      stage_rows(st, x, row0, TC_RT, limit, D, ch * TC_DC, tid);
      if (L.qstream) stage_rows(st + TC_XTILE, q, q0, BT, B, D, ch * TC_DC, tid);
      if (ch == nchunk - 1) rsq[s * TC_RT + tid] = row_sq(sqnorm, alive, row0 + tid, limit);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + s);
    }
    return;
  }

  // ---- the consumer warpgroups ----
  const int ctid = tid - TC_WG;
  const int wgi = ctid >> 7;             // consumer warpgroup
  const int w = (ctid >> 5) & 3;         // warp in it
  const int g = lane >> 2, t4 = lane & 3;
  const int wq0 = 64 * wgi + 16 * w;     // the warp's 16 queries: wq0 + g + 8 h
  float* wstg = stg + (size_t)(4 * wgi + w) * TC_RT;
  const uint32_t ring = smem_u32(base);
  const uint32_t qres_a = smem_u32(base + L.qres) + wgi * 64 * 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (!L.qstream && nstage > 0) mbar_wait(qfull, 0);
  int it = 0;
  for (int tile = 0; tile < ntile; ++tile) {
    for (int ch = 0; ch < nchunk; ++ch, ++it) {
      const int s = it % nst;
      mbar_wait(full + s, (it / nst) & 1);
      const uint32_t xa = ring + s * (uint32_t)L.stage;
      const uint32_t qa = L.qstream ? xa + TC_XTILE + wgi * 64 * 128
                                    : qres_a + ch * BT * 128;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16(acc, sw128_desc(qa + 32 * kk), sw128_desc(xa + 32 * kk),
                         (ch | kk) != 0);
      wgmma_commit();
      if (ch > 0) {   // the previous chunk's products are done: free its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + (it - 1) % nst);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    const int sl = (it - 1) % nst;   // the last chunk's stage: the row table
    const int row0 = r_begin + tile * TC_RT;
    float2 sq[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      sq[j] = *reinterpret_cast<const float2*>(rsq + sl * TC_RT + 8 * j + 2 * t4);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float tv = thv[wq0 + g + 8 * h];
      const float qqi = qq[wq0 + g + 8 * h];
      // the lane's best score of its query: for L2 -max(t, 0) of the least
      // t = |q|^2 - 2 dot + sqnorm (the scores' own bits: -max(., 0) is
      // monotone), for IP the largest dot of a live row (+ 0 or -inf)
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
      const float mx = IP ? best : -fmaxf(best, 0.f);
      // one vote for the 8 queries' 32 rows a lane; a tie may still rank by row
      unsigned pass = __ballot_sync(FULL, mx >= tv);
      while (pass) {   // a quad whose query passed: its 128 scores, 32 a call
        const int gq = (__ffs(pass) - 1) >> 2;
        pass &= ~(0xFu << (4 * gq));
        if (g == gq) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<float2*>(wstg + 8 * j + 2 * t4) =
                make_float2(tc_score<IP>(acc[4 * j + 2 * h], sq[j].x, qqi),
                            tc_score<IP>(acc[4 * j + 2 * h + 1], sq[j].y, qqi));
        }
        __syncwarp();
        const int qh = wq0 + gq + 8 * h;
        float htv = thv[qh];
        int hti = thi[qh];
        const size_t po = ((size_t)(q0 + qh) * S + blockIdx.y) * kw;   // WIDE
        // a flush, the one change of a wide list, leaves the buffer with
        // fewer entries than before: it needs more than CAP - 32 of them,
        // so more than CAP - 128 before this query's 128 rows came, and at
        // most 128 of those rows follow it
        const int cnt0 = WIDE ? wst[qh].cnt : 0;
#pragma unroll 1
        for (int u = 0; u < TC_RT / 32; ++u) {
          const float v = wstg[32 * u + lane];
          const int row = row0 + 32 * u + lane;
          if (!__any_sync(FULL, beats(v, row, htv, hti))) continue;
          Entry t;
          if constexpr (WIDE)
            t = wide_offer<FLAT_CAP>(part_v + po, part_i + po, kw,
                                     lv + (size_t)qh * FLAT_CAP,
                                     li + (size_t)qh * FLAT_CAP, wst + qh, v, row,
                                     htv, hti, lane);
          else
            t = offer(lv + (size_t)qh * k, li + (size_t)qh * k, k, v, row, htv, hti,
                      lane);
          // a full list of own rows raises the threshold
          if (beats(t.v, t.r, htv, hti)) {
            htv = t.v;
            hti = t.r;
          }
        }
        if (lane == 0) {   // the threshold, and what to publish
          thv[qh] = htv;
          thi[qh] = hti;
          float* dst = pub + (size_t)(q0 + qh) * S + blockIdx.y;
          if (!WIDE)
            publish(lv + (size_t)qh * k, pubv + qh, dst, pub_c);
          else if (wst[qh].cnt < cnt0 && wst[qh].fill >= pub_c)
            // a flush changed the list (in global memory); its first pub_c
            // entries are real
            publish(part_v + po, pubv + qh, dst, pub_c);
        }
        __syncwarp();
      }
    }
    if (lane == 0) mbar_arrive(empty + sl);
    // after tiles 0, 1, 3, 7, 15, ... what the other splits have published
    // raises the thresholds
    if ((tile & (tile + 1)) == 0) {
      if constexpr (WIDE) {
        // a wide list changes only at a flush: buffers of TC_FLUSH_MIN or
        // more flush here, so each split publishes a fresh c-th entry
        for (int qi = wq0; qi < wq0 + 16 && q0 + qi < B; ++qi) {
          if (wst[qi].cnt < TC_FLUSH_MIN) continue;   // warp-uniform
          const size_t o = ((size_t)(q0 + qi) * S + blockIdx.y) * kw;
          wide_flush<FLAT_CAP>(part_v + o, part_i + o, kw, lv + (size_t)qi * FLAT_CAP,
                               li + (size_t)qi * FLAT_CAP, &wst[qi].cnt, &wst[qi].fill,
                               lane);
          float htv = thv[qi];
          int hti = thi[qi];
          wide_threshold(part_v + o, part_i + o, kw, wst[qi].fill, htv, hti);
          if (lane == 0) {
            thv[qi] = htv;
            thi[qi] = hti;
            if (wst[qi].fill >= pub_c)
              publish(part_v + o, pubv + qi, pub + (size_t)(q0 + qi) * S + blockIdx.y,
                      pub_c);
          }
          __syncwarp();
        }
      }
      take_floor(pub, S, floor_window(blockIdx.y, S), q0 + wq0, B, 16, pub_g,
                 thv + wq0, thi + wq0, lane);
    }
  }

  if constexpr (WIDE) {   // the warp's queries: their last buffers, then the pads
    for (int qi = wq0; qi < wq0 + 16 && q0 + qi < B; ++qi) {
      const size_t o = ((size_t)(q0 + qi) * S + blockIdx.y) * kw;
      wide_flush<FLAT_CAP>(part_v + o, part_i + o, kw, lv + (size_t)qi * FLAT_CAP,
                           li + (size_t)qi * FLAT_CAP, &wst[qi].cnt, &wst[qi].fill,
                           lane);
      wide_pad(part_v + o, part_i + o, kw, wst[qi].fill, lane);
    }
    return;
  }
  for (int e = lane; e < 16 * k; e += 32) {
    const int qi = wq0 + e / k;
    const int b = q0 + qi;
    if (b < B) {
      const size_t o = ((size_t)b * S + blockIdx.y) * k + e % k;
      part_v[o] = lv[(size_t)qi * k + e % k];
      part_i[o] = li[(size_t)qi * k + e % k];
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime: the library
// need not link libcuda.
EncodeTiled encode_tiled() {
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
int encode_rows(CUtensorMap* map, const void* ptr, int rows, int d, int box_rows) {
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

template <int NC, bool IP, bool WIDE>
int launch_tc(const void* q, const void* x, const void* qsq, const void* sqnorm,
              const void* alive, int B, int N, int D, int k, int kw, int max_scans,
              int rows_per_split, int n_splits, int vec, void* part_v, void* part_i,
              void* pub, int pub_c, int pub_g, cudaStream_t stream) {
  constexpr int BT = 64 * NC, THREADS_TC = TC_WG * (NC + 1);
  const auto kernel = flat_scan_tc_kernel<NC, IP, WIDE>;
  const int nst = tc_stages(k, BT, D);
  const size_t smem = tc_layout(k, BT, D, nst).total;
  if (smem > (size_t)TC_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, qmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&qmap, 0, sizeof(qmap));
  if (vec) {
    int e = encode_rows(&xmap, x, N, D, TC_RT);
    if (!e) e = encode_rows(&qmap, q, B, D, BT);
    if (e) return e;
  }
  const dim3 grid((B + BT - 1) / BT, n_splits);
  kernel<<<grid, THREADS_TC, smem, stream>>>(
      xmap, qmap, (const uint16_t*)q, (const uint16_t*)x, (const float*)qsq,
      (const float*)sqnorm, (const uint8_t*)alive, B, N, D, k, kw, max_scans,
      rows_per_split, vec, nst, (float*)part_v, (int32_t*)part_i, (float*)pub, pub_c,
      pub_g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of a bf16 flat-scan block with a bt-query tile (64 or 128)
// at depth d, its ring's stages chosen by tc_stages; the wrapper's
// flat_scan_smem_bytes(k, bt, 2, d) computes the same number.
long long pyrope_flat_tc_smem_bytes(int k, int bt, int d) {
  return (long long)tc_layout(k, bt, d, tc_stages(k, bt, d)).total;
}

// The bf16 flat scan: q [B, D] bf16 (the caller's bf16(q)), x [N, D] bf16,
// qsq [B] |q|^2 of the fp32 q, sqnorm [N] of the fp32 rows, alive [N]; rows
// >= max_scans never hit. k <= MAXK: bt 64 or 128, kw = k; k > MAXK: the
// wide mode, bt 64, lists kw <= k entries wide. vec: D % 8 == 0 and q's and
// x's bases 16-byte aligned (TMA staging), else plain loads. partials [B,
// n_splits, kw], pub [B, n_splits], pub_c and pub_g as pyrope_fused_scan's.
int pyrope_flat_scan_tc(const void* q, const void* x, const void* qsq,
                        const void* sqnorm, const void* alive, int B, int N, int D,
                        int k, int kw, int metric_ip, int max_scans,
                        int rows_per_split, int n_splits, int bt, int vec,
                        void* part_v, void* part_i, void* pub, int pub_c, int pub_g,
                        void* stream) {
  const bool wide = k > MAXK;
  if (k < 1 || D < 1 || (wide ? kw < 1 || kw > k : kw != k) || (bt != 64 && bt != 128) ||
      (wide && bt != WIDE_BT) || pub_c < 1 || pub_c > kw || pub_g < 1 ||
      (long long)pub_g * pub_c < k)
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const void*, const void*, const void*, const void*, const void*,
                         int, int, int, int, int, int, int, int, int, void*, void*,
                         void*, int, int, cudaStream_t);
  static const Launch table[3][2] = {   // [narrow 64, narrow 128, wide 64][ip]
      {launch_tc<1, false, false>, launch_tc<1, true, false>},
      {launch_tc<2, false, false>, launch_tc<2, true, false>},
      {launch_tc<1, false, true>, launch_tc<1, true, true>}};
  return table[wide ? 2 : bt == 128][metric_ip != 0](
      q, x, qsq, sqnorm, alive, B, N, D, k, kw, max_scans, rows_per_split, n_splits,
      vec, part_v, part_i, pub, pub_c, pub_g, (cudaStream_t)stream);
}

}  // extern "C"
