// The bf16 list scan with promote_fp32 for Hopper (sm_90a), CUDA C++: fp32
// queries against widened bf16 rows on the CUDA cores, the rows streamed
// through a ring of shared memory by 1-D bulk copies (TMA without a tensor
// map), at k <= 128 and D <= 256.
//
// Replaces, of pyrope_tpu/ops/pallas_scan.py, the bf16 slab mode with
// promote_fp32 of K3 pallas_ivf_topk_windowed (:992) and K2 pallas_ivf_topk
// (:1035): the branch x.dtype == bfloat16 of _tile_scores (:232-264) that
// multiplies the fp32 q by the widened rows. Until it, ivf_list_scan.cu's
// <BF16, false> ran this mode (and still runs it above D 256, and its wide
// mode at k > 128).
//
// What it computes, per query b and each alive row t of a cluster in b's
// probe set (cluster c's rows offsets[c] .. offsets[c] + lens[c] of the
// cluster-major slab):
//   score = -max(|q|^2 - 2 q.x + sqnorm[t], 0)   (L2)   or   q.x   (IP),
// q the fp32 query, x the bf16 row widened to fp32, the products IEEE fp32
// FMAs on the CUDA cores (no TF32, no bf16 split: the tensor cores cannot
// take an fp32 q exactly), |q|^2 of the fp32 q, sqnorm[t] of the fp32 row
// before its cast; the top k in the total order (score desc, row asc). The
// work tables (invert_probes), the partial slots, the slot counts and the
// floor protocol are ivf_list_scan.cu's (its header; list_floor.cuh), so
// merge_partials_kernel reads its output unchanged.
//
// What bounds it on an H100. IVF-PQ's bf16 rerank slab at 1M x 128, nlist
// 1000, nprobe 3: at b64 about 192 (query, list) pairs of ~1,000 rows, 1-3
// queries a list, 44.6 MB of rows (0.0133 ms at 3.35 TB/s) against 0.05
// GFLOP (under a microsecond at 67 TFLOP/s): it is bound by its bytes, and
// what it needs is bytes in flight and little else in the way. The CUDA-core
// kernel it replaces ran 0.0893 ms there (15% of the bound): items of
// 256-512 rows (2-4 tiles), a two-stage 16 KB ring of 8-byte cp.async
// copies, and each item's prologue and epilogue paid for those few tiles.
//
// Shape of the work.
//
//   Walking blocks. The grid is one wave (two blocks an SM where shared
//   memory allows); block i walks items i, i + grid, ... of invert_probes'
//   table until the first that is no item. Its producer keeps streaming
//   across an item's end, so the next item's rows are in flight while the
//   consumers write out the last one's lists.
//
//   The row feed. A segment's rows are one contiguous byte range of the
//   slab. One producer warp streams them into a ring of NST stages (3 to 6,
//   the most that fit; 16 KB a stage): lane 0 issues one
//   cp.async.bulk ... mbarrier::complete_tx::bytes a stage as soon as the
//   stage is free (its bytes expected before any arrival), and every lane
//   writes the stage's row table (sqnorm, +inf for a row that is dead or
//   past the segment; loaded while the stage was still in use) and
//   arrives. Where D % 8 != 0 or the slab's base is not 16-byte aligned
//   (vec == 0) the warp copies the rows by plain loads into the same layout
//   (rows XS = D rounded up to 8 elements, zeros past D).
//
//   The queries. At each item's start the consumer warps gather its chunk's
//   fp32 query rows (<= 64, pairs -> query ids) whole into shared memory and
//   sum |q|^2; D <= 256 keeps them beside the ring (ops/fused_scan
//   PROMOTE_MAX_D; the host's list_plan sends a wider D to the CUDA-core
//   kernel).
//
//   The products. A warp takes 4 of the item's queries (a group) and a tile
//   of rows: LPR lanes a row (16 up to D 128, 32 up to 256), each lane one
//   16-byte piece (8 depths) of it, so a warp's reads of the stage are
//   contiguous and conflict-free, and each lane holds its 8 depths of the 4
//   queries in registers. Four steps a tile (8 rows at LPR 16), then the
//   lanes' partial sums are reduced across the LPR lanes of a row and
//   transposed at once (two exchange levels, then a butterfly), so that each
//   row's dot ends in LPR / 4 lanes. The item's queries form G groups of 4:
//   the 8 warps form 8 / G' teams (G' the power of two >= G), a team takes
//   every (8 / G')-th tile of a stage, and each warp keeps its own list a
//   query; at 1-4 queries (the b64 traffic) every warp scans its own tile of
//   each stage. Above 32 queries a warp takes two groups; a group of 1 or 2
//   queries runs a tile of its own width. Each tile's scores meet the
//   query's threshold in one warp vote a query: a 64-bit key in shared
//   memory (floor_key's order), the query's floor raised (atomicMax) by the
//   k-th entry of every team's list once full, since that list's k rows lie
//   at or above it; so the teams' lists fill no faster than one list. The
//   teams' lists of a query are merged at the item's end in log2(teams)
//   rounds of pairs spread over the warps. The offer is out of line (as
//   ivf_list_scan.cu's).
//
//   The floor. As ivf_list_scan.cu's narrow mode: an item starts from its
//   queries' floor keys and reads them again at its stages 1, 2, 4, ...;
//   at its end the teams' lists are merged, each slot written, its c-th
//   entry published (raised into the query's floor key where g = 1), and
//   with g > 1 the window's floor shared. Rows must beat a floor key: the
//   key's row lies in another slot.
//
// Shared memory (pm_layout): the ring, its row tables, the mbarriers, the
// per-query tables, the queries (64 x XS floats), the lists (64 x k
// entries).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "list_floor.cuh"
#include "tc_common.cuh"
#include "topk_warp.cuh"

namespace {

constexpr int PM_WARPS = 8;                    // consumer warps
constexpr int PM_CT = PM_WARPS * 32;           // consumer threads
constexpr int PM_THREADS = PM_CT + 32;         // and the producer warp
constexpr int PM_BT = 64;                      // queries an item (chunk)
constexpr int PM_NQ = 4;                       // queries a warp's group
constexpr int PM_STEPS = 4;                    // steps of a warp's tile
constexpr int PM_MAX_D = 256;                  // 32 lanes x 8 depths
constexpr int PM_MAX_STAGES = 6;
constexpr int PM_MIN_STAGES = 3;

__host__ __device__ inline int pm_lpr(int d) { return d <= 128 ? 16 : 32; }
__host__ __device__ inline int pm_xs(int d) { return (d + 7) & ~7; }
// rows a stage: a tile (PM_STEPS steps of 32 / LPR rows) for each warp
__host__ __device__ inline int pm_stage_rows(int d) {
  return PM_WARPS * PM_STEPS * (32 / pm_lpr(d));
}

// Byte offsets of a block's shared memory.
struct PmLayout {
  size_t stage;   // bytes a stage: pm_stage_rows x XS bf16
  size_t rsq;     // [nst][rows] row table
  size_t bars;    // full[nst], empty[nst]
  size_t fkey;    // [64] 64-bit keys (the window's floor)
  size_t perq;    // qkey [64] 64-bit (the threshold); qb, qslot, fw0, fw1
                  // [64] int, qq [64] float
  size_t qs;      // [64][XS] fp32 queries
  size_t lists;   // [64][k] values, rows
  size_t total;
};

__host__ __device__ inline PmLayout pm_layout(int k, int d, int nst) {
  PmLayout L;
  L.stage = (size_t)pm_stage_rows(d) * pm_xs(d) * 2;
  size_t off = (size_t)nst * L.stage;
  L.rsq = off;
  off += (size_t)nst * pm_stage_rows(d) * sizeof(float);
  L.bars = off;
  off += 2 * (size_t)nst * sizeof(unsigned long long);
  L.fkey = off;
  off += (size_t)PM_BT * sizeof(unsigned long long);
  L.perq = off;
  off += 7 * (size_t)PM_BT * 4;
  L.qs = off;
  off += (size_t)PM_BT * pm_xs(d) * sizeof(float);
  L.lists = off;
  off += 8 * (size_t)PM_BT * k;
  L.total = off;
  return L;
}

// Stages of the ring: the most (PM_MAX_STAGES down to PM_MIN_STAGES) with
// which two blocks share an SM, else the most that fit one block.
inline int pm_stages(int k, int d) {
  for (int nst = PM_MAX_STAGES; nst >= PM_MIN_STAGES; --nst)
    if (pm_layout(k, d, nst).total <= (size_t)TC_SMEM_TWO_BLOCKS) return nst;
  for (int nst = PM_MAX_STAGES; nst >= PM_MIN_STAGES; --nst)
    if (pm_layout(k, d, nst).total <= (size_t)TC_SMEM_LIMIT) return nst;
  return 0;
}

// `bytes` contiguous bytes of global memory at src into shared memory at
// dst (both 16-byte aligned, bytes a multiple of 16), completing `bar`'s
// transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Expect `bytes` more transaction bytes on the barrier's current phase,
// without arriving.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PM_CT) : "memory");
}

// A work item of invert_probes' tables: cluster c, chunk of <= 64 of its
// queries (pairs qlo .. qlo + qn), segment s of its ns, rows r_lo .. r_hi.
struct PmItem {
  int c, qlo, qn, ns, s, r_lo, r_hi;
};

__device__ __forceinline__ PmItem pm_item(int x, int c, const int32_t* cstart,
                                          const int32_t* ccnt, const int32_t* item_end,
                                          const int32_t* offsets, const int32_t* lens, int seg,
                                          int sample) {
  PmItem it;
  it.c = c;
  const int cnt = ccnt[c], len = lens[c];
  it.ns = (len + seg - 1) / seg;
  const int nch = (cnt + PM_BT - 1) / PM_BT;
  const int local = x - (item_end[c] - nch * it.ns);
  const int chunk = local / it.ns;
  it.s = local - chunk * it.ns;
  it.qlo = cstart[c] + chunk * PM_BT;
  it.qn = min(PM_BT, cnt - chunk * PM_BT);
  it.r_lo = offsets[c] + it.s * seg;
  it.r_hi = offsets[c] + min(len, min((it.s + 1) * seg, it.s * seg + sample));
  return it;
}

// The insertion, out of line (one call site a query of the tile, not the
// insertion's code; inlined at the tile's sites, the b1024 cell ran 0.35
// against 0.28 ms, PERF.md): every lane's candidate that beats (tv, ti)
// into the warp's list.
__device__ __noinline__ void pm_offer(float* lv, int* li, int k, float v, int r, float tv,
                                      int ti, int lane) {
  warp_offer_batch(lv, li, k, v, r, tv, ti, lane);
}

// The row dot of LPR lanes' partial sums a[s] (steps s = 0..3: rows s * (32
// / LPR) + lane / LPR of the tile), reduced and transposed: the lane ends
// with the full sum of step 2 * up + up2, up = pc & LPR / 2, up2 = pc & LPR
// / 4, the same bits in each of its LPR / 4 replicas.
template <int LPR>
__device__ __forceinline__ float pm_reduce(const float (&a)[PM_STEPS], int pc) {
  const bool up = pc & (LPR / 2);
  const float k0 = (up ? a[2] : a[0]) + __shfl_xor_sync(FULL, up ? a[0] : a[2], LPR / 2);
  const float k1 = (up ? a[3] : a[1]) + __shfl_xor_sync(FULL, up ? a[1] : a[3], LPR / 2);
  const bool up2 = pc & (LPR / 4);
  float v = (up2 ? k1 : k0) + __shfl_xor_sync(FULL, up2 ? k0 : k1, LPR / 4);
#pragma unroll
  for (int off = LPR / 8; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// One stage's tiles of a warp's team for its group of NQ queries (q0i ..,
// nqg of them real): for each tile the lane's 8 depths of each query from
// shared memory, four steps, the rows' dots reduced; then each query's
// scores offered behind one vote on its threshold, the query's key in
// shared memory (qkey: the floor, raised by every team's full list). A
// warp's list l0 + i takes query i's rows. The queries' pieces are read
// again a tile, so none is live across the offer's call (kept live across
// it, they spilled around each call).
template <int NQ, int LPR, bool IP>
__device__ __forceinline__ void pm_group(const uint16_t* xs, const float* rq, const float* qs,
                                         const float* qq, int XS, int q0i, int nqg, int s0,
                                         int nrows, int team, int T,
                                         unsigned long long* qkey, float* lv, int* li, int k,
                                         int l0, int lane) {
  constexpr int RPS = 32 / LPR;            // rows a step
  constexpr int TR = PM_STEPS * RPS;       // rows a tile
  const int pc = lane % LPR;               // the lane's 16-byte piece of a row
  const int hrow = lane / LPR;             // its row of a step
  const bool piece = pc < XS / 8;          // a piece of the row (else zeros)
  // the tile row whose dot the lane ends with, and one replica of it offers
  const int rr = (2 * ((pc & (LPR / 2)) != 0) + ((pc & (LPR / 4)) != 0)) * RPS + hrow;
  const bool canon = (pc & (LPR / 4 - 1)) == 0;
  for (int t = team; t < PM_WARPS && t * TR < nrows; t += T) {
    float dot[NQ];
    {
      float qv[NQ][8];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const bool in = i < nqg && piece;
        const float4 a = in ? *reinterpret_cast<const float4*>(qs + (q0i + i) * XS + 8 * pc)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 b = in ? *reinterpret_cast<const float4*>(qs + (q0i + i) * XS + 8 * pc + 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        qv[i][0] = a.x; qv[i][1] = a.y; qv[i][2] = a.z; qv[i][3] = a.w;
        qv[i][4] = b.x; qv[i][5] = b.y; qv[i][6] = b.z; qv[i][7] = b.w;
      }
      float acc[NQ][PM_STEPS];
#pragma unroll
      for (int s = 0; s < PM_STEPS; ++s) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (piece)
          u = *reinterpret_cast<const uint4*>(xs + (t * TR + s * RPS + hrow) * XS + 8 * pc);
        const float xv[8] = {__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                             __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u),
                             __uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                             __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u)};
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) a = fmaf(qv[i][e], xv[e], a);
          acc[i][s] = a;
        }
      }
#pragma unroll
      for (int i = 0; i < NQ; ++i) dot[i] = pm_reduce<LPR>(acc[i], pc);
    }
    const int row = s0 + t * TR + rr;
    const float sqv = rq[t * TR + rr];
    const bool ok = canon && sqv < INFINITY;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i >= nqg) break;   // warp-uniform
      const float sc = IP ? dot[i] : -fmaxf(qq[q0i + i] - 2.f * dot[i] + sqv, 0.f);
      const float v = ok ? sc : -INFINITY;
      float tv;
      int ti;
      floor_entry(*reinterpret_cast<volatile unsigned long long*>(qkey + q0i + i), tv, ti);
      if (!__any_sync(FULL, beats(v, row, tv, ti))) continue;
      float* l_v = lv + (size_t)(l0 + i) * k;
      int* l_i = li + (size_t)(l0 + i) * k;
      pm_offer(l_v, l_i, k, v, row, tv, ti, lane);
      // a full list's k-th entry has k rows at or above it: the query's
      // threshold in every team
      if (lane == 0 && l_i[k - 1] >= 0)
        atomicMax(qkey + q0i + i, floor_key(l_v[k - 1], l_i[k - 1]));
      __syncwarp();
    }
  }
}

// x [N, D] bf16 cluster-major, q [B, D] fp32, sqnorm [N] of the fp32 rows,
// alive [N]; the work tables, pub, pub_c, pub_g, seg, sample and the
// partials as ivf_list_scan_kernel's (partials k wide, always written);
// items: item_c's length (invert_probes' grid bound); nst: the ring's
// stages (pm_stages). LPR: pm_lpr(D).
template <bool IP, int LPR>
__global__ void __launch_bounds__(PM_THREADS, 2)
ivf_list_scan_promote_kernel(const float* __restrict__ q, const uint16_t* __restrict__ x,
                             const float* __restrict__ sqnorm,
                             const uint8_t* __restrict__ alive,
                             const int32_t* __restrict__ pairs, int P,
                             const int32_t* __restrict__ cstart,
                             const int32_t* __restrict__ ccnt,
                             const int32_t* __restrict__ item_end,
                             const int32_t* __restrict__ item_c,
                             const int32_t* __restrict__ slot_end,
                             const int32_t* __restrict__ offsets,
                             const int32_t* __restrict__ lens, int nclus, int items, int D,
                             int k, int seg, int sample, int nslots, int vec, int nst,
                             float* __restrict__ part_v, int32_t* __restrict__ part_i,
                             unsigned long long* __restrict__ pub, int pub_c, int pub_g) {
  constexpr int RS = PM_WARPS * PM_STEPS * (32 / LPR);   // rows a stage
  unsigned long long* qfloor = pub + nslots;   // [B] the queries' floor keys
  const int XS = pm_xs(D);
  const PmLayout L = pm_layout(k, D, nst);

  extern __shared__ __align__(128) uint8_t smem[];
  float* rsq = reinterpret_cast<float*>(smem + L.rsq);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + L.bars);
  unsigned long long* empty = full + nst;
  unsigned long long* fkey = reinterpret_cast<unsigned long long*>(smem + L.fkey);
  unsigned long long* qkey = reinterpret_cast<unsigned long long*>(smem + L.perq);
  int* qb = reinterpret_cast<int*>(qkey + PM_BT);     // query id
  int* qslot = qb + PM_BT;                            // partial slot
  int* fw0 = qslot + PM_BT;                           // the floor's slot window
  int* fw1 = fw0 + PM_BT;
  float* qq = reinterpret_cast<float*>(fw1 + PM_BT);  // |q|^2
  float* qs = reinterpret_cast<float*>(smem + L.qs);  // [64][XS]
  float* lv = reinterpret_cast<float*>(smem + L.lists);
  int* li = reinterpret_cast<int*>(lv + (size_t)PM_BT * k);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    for (int st = 0; st < nst; ++st) {
      mbar_init(full + st, 32);            // the producer warp's lanes
      mbar_init(empty + st, PM_WARPS);     // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PM_WARPS) {
    // ---- the producer warp: every stage of the block's items ----
    // the stages in order across the block's items, one looked ahead: its
    // row table's loads (and its item's decode) are in flight while this
    // stage waits for its slot
    int xi = blockIdx.x - gridDim.x, s0 = 0, hi = 0;
    auto advance = [&]() -> bool {   // s0, hi of the next stage; false past the last
      s0 += RS;
      while (s0 >= hi) {
        xi += gridDim.x;
        if (xi >= items) return false;
        const int c = item_c[xi];
        if (c >= nclus) return false;   // past the last item
        const PmItem m = pm_item(xi, c, cstart, ccnt, item_end, offsets, lens, seg, sample);
        s0 = m.r_lo;
        hi = m.r_hi;
      }
      return true;
    };
    auto rows_of = [&](int r0, int r1, float (&rv)[RS / 32]) {
#pragma unroll
      for (int u = 0; u < RS / 32; ++u) rv[u] = row_sq(sqnorm, alive, r0 + lane + 32 * u, r1);
    };
    bool have = advance();
    int c0 = s0, c1 = min(s0 + RS, hi);   // the current stage's rows
    float rv[RS / 32];
    if (have) rows_of(c0, c1, rv);
    for (int it = 0; have; ++it) {
      have = advance();
      const int n0 = s0, n1 = min(s0 + RS, hi);
      float rn[RS / 32];
      if (have) rows_of(n0, n1, rn);
      const int st = it % nst;
      mbar_wait(empty + st, ((it / nst) & 1) ^ 1);
      uint16_t* dst = reinterpret_cast<uint16_t*>(smem + (size_t)st * L.stage);
      if (vec) {
        if (lane == 0) {   // the copy first: its bytes owed before any arrival
          const uint32_t bytes = (uint32_t)(c1 - c0) * D * 2;
          mbar_expect_tx(full + st, bytes);
          bulk_load(dst, x + (size_t)c0 * D, bytes, full + st);
        }
      } else {
#pragma unroll 4
        for (int e = lane; e < (c1 - c0) * XS; e += 32) {
          const int r = e / XS, d = e - r * XS;
          dst[e] = d < D ? x[(size_t)(c0 + r) * D + d] : (uint16_t)0;
        }
      }
#pragma unroll
      for (int u = 0; u < RS / 32; ++u) rsq[st * RS + lane + 32 * u] = rv[u];
      mbar_arrive(full + st);
#pragma unroll
      for (int u = 0; u < RS / 32; ++u) rv[u] = rn[u];
      c0 = n0;
      c1 = n1;
    }
    return;
  }

  // ---- the consumer warps ----
  int it = 0;
  for (int xi = blockIdx.x; xi < items; xi += gridDim.x) {
    const int c = item_c[xi];
    if (c >= nclus) break;
    const PmItem m = pm_item(xi, c, cstart, ccnt, item_end, offsets, lens, seg, sample);
    const int qn = m.qn;
    // the item's tables (the last item's are free: consumers_sync below)
    for (int i = tid; i < qn; i += PM_CT) {
      const int j = pairs[m.qlo + i];   // pair j = b * P + p
      const int b = j / P;
      qb[i] = b;
      const int slot = slot_end[j] - m.ns + m.s;
      qslot[i] = slot;
      fkey[i] = 0ull;
      fw0[i] = fw1[i] = 0;
      if (pub_g > 1) slot_window(slot_end, b, P, slot, nslots, fw0[i], fw1[i]);
      // the floor it starts from; a query without a slot (a short max_len)
      // takes nothing: the largest key is a NaN threshold no score beats
      qkey[i] = slot < nslots ? __ldcg(qfloor + b) : ~0ull;
    }
    for (int e = tid; e < PM_BT * k; e += PM_CT) {
      lv[e] = -INFINITY;
      li[e] = -1;
    }
    consumers_sync();
    // the queries, whole, and |q|^2 of the fp32 values: a warp a query
    for (int i = warp; i < qn; i += PM_WARPS) {
      const float* qr = q + (size_t)qb[i] * D;
      float s2 = 0.f;
      for (int d = lane; d < XS; d += 32) {
        const float v = d < D ? qr[d] : 0.f;
        s2 = fmaf(v, v, s2);
        qs[i * XS + d] = v;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) s2 += __shfl_xor_sync(FULL, s2, off);
      if (lane == 0) qq[i] = s2;
    }
    consumers_sync();

    // the warp's groups of PM_NQ queries and its team's tiles
    const int G = (qn + PM_NQ - 1) / PM_NQ;
    int Gp = 1;
    while (Gp < G && Gp < PM_WARPS) Gp <<= 1;
    const int T = PM_WARPS / Gp;          // teams, each with its own lists
    const int team = warp / Gp, g0 = warp % Gp;
    const int ngrp = (g0 < G) + (Gp == PM_WARPS && g0 + PM_WARPS < G);

    for (int j = 0, s0 = m.r_lo; s0 < m.r_hi; ++j, s0 += RS, ++it) {
      const int st = it % nst;
      const int nrows = min(RS, m.r_hi - s0);
      // the floor keys again at the item's stages 1, 2, 4, ...: lane l the
      // key of query l of the warp's groups, loaded before the wait
      unsigned long long fk = 0ull;
      int fq = 0;
      if (j && !(j & (j - 1)) && lane < ngrp * PM_NQ) {
        fq = (g0 + (lane / PM_NQ) * Gp) * PM_NQ + lane % PM_NQ;
        if (fq < qn) fk = __ldcg(qfloor + qb[fq]);
      }
      mbar_wait(full + st, (it / nst) & 1);
      const uint16_t* xs = reinterpret_cast<const uint16_t*>(smem + (size_t)st * L.stage);
      const float* rq = rsq + st * RS;
#pragma unroll 1
      for (int h = 0; h < ngrp; ++h) {
        const int q0i = (g0 + h * Gp) * PM_NQ;
        const int nqg = min(PM_NQ, qn - q0i);
        const int l0 = (warp * 2 + h) * PM_NQ;
        if (nqg == 1)
          pm_group<1, LPR, IP>(xs, rq, qs, qq, XS, q0i, nqg, s0, nrows, team, T, qkey, lv, li,
                               k, l0, lane);
        else if (nqg == 2)
          pm_group<2, LPR, IP>(xs, rq, qs, qq, XS, q0i, nqg, s0, nrows, team, T, qkey, lv, li,
                               k, l0, lane);
        else
          pm_group<4, LPR, IP>(xs, rq, qs, qq, XS, q0i, nqg, s0, nrows, team, T, qkey, lv, li,
                               k, l0, lane);
      }
      if (fk) atomicMax(qkey + fq, fk);   // read before the stage, raised after it
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }

    // the item's end: the teams' lists of a query into team 0's, in
    // log2(T) rounds of pairs (team t + r into team t), the merges of a round
    // over all warps
    consumers_sync();
    for (int r = 1; r < T; r <<= 1) {
      const int pairs = T / (2 * r);
      for (int e = warp; e < qn * pairs; e += PM_WARPS) {
        const int qi = e / pairs, t = 2 * r * (e % pairs);
        const int grp = qi / PM_NQ, i = qi % PM_NQ;
        float* l_v = lv + (size_t)((t * Gp + grp) * 2 * PM_NQ + i) * k;
        int* l_i = li + (size_t)((t * Gp + grp) * 2 * PM_NQ + i) * k;
        const size_t o = (size_t)(((t + r) * Gp + grp) * 2 * PM_NQ + i) * k;
        float mv = l_v[k - 1];
        int mi = l_i[k - 1];
        if (!beats(lv[o], li[o], mv, mi)) continue;   // sorted: none will
        for (int c0 = 0; c0 < k; c0 += 32) {
          const int p = c0 + lane;
          warp_offer_batch(l_v, l_i, k, p < k ? lv[o + p] : -INFINITY,
                           p < k ? li[o + p] : -1, mv, mi, lane);
        }
      }
      consumers_sync();
    }
    // query qi's list: group qi / 4's first warp, its list h = group / 8
    auto final_list = [&](int qi) {
      const int grp = qi / PM_NQ;
      return (size_t)(((grp & 7) * 2 + (grp >> 3)) * PM_NQ + qi % PM_NQ) * k;
    };
    for (int e = tid; e < qn * k; e += PM_CT) {
      const int i = e / k, jj = e - (e / k) * k;
      if (qslot[i] >= nslots) continue;   // only if the caller's max_len was short
      const size_t o = (size_t)qslot[i] * k + jj;
      part_v[o] = lv[final_list(i) + jj];
      part_i[o] = li[final_list(i) + jj];
    }
    if (tid < qn && qslot[tid] < nslots) {   // the final list's c-th entry
      const size_t o = final_list(tid) + pub_c - 1;
      unsigned long long last = 0ull;
      publish_key_inline(lv[o], li[o], -1, &last, pub + qslot[tid],
                         pub_g == 1 ? qfloor + qb[tid] : nullptr);
    }
    if (pub_g > 1 && pub_g <= FWIN) {   // the queries' floors off their windows
      consumers_sync();
      for (int i0 = warp * 8; i0 < qn; i0 += PM_CT / 4)
        warp_share_floors(pub, qfloor, qb, fw0, fw1, i0, min(8, qn - i0), pub_g, fkey, lane);
    }
    consumers_sync();
  }
}

template <bool IP, int LPR>
int launch_promote(const void* q, const void* x, const void* sqnorm, const void* alive,
                   int blocks, const void* pairs, int P, const void* cstart, const void* ccnt,
                   const void* item_end, const void* item_c, const void* slot_end,
                   const void* offsets, const void* lens, int nclus, int items, int D, int k,
                   int seg, int sample, int nslots, int vec, void* part_v, void* part_i,
                   void* pub, int pub_c, int pub_g, cudaStream_t stream) {
  const auto kernel = ivf_list_scan_promote_kernel<IP, LPR>;
  const int nst = pm_stages(k, D);
  if (!nst) return (int)cudaErrorInvalidValue;
  const size_t smem = pm_layout(k, D, nst).total;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (items == 0) return 0;
  kernel<<<min(blocks, items), PM_THREADS, smem, stream>>>(
      (const float*)q, (const uint16_t*)x, (const float*)sqnorm, (const uint8_t*)alive,
      (const int32_t*)pairs, P, (const int32_t*)cstart, (const int32_t*)ccnt,
      (const int32_t*)item_end, (const int32_t*)item_c, (const int32_t*)slot_end,
      (const int32_t*)offsets, (const int32_t*)lens, nclus, items, D, k, seg, sample, nslots,
      vec, nst, (float*)part_v, (int32_t*)part_i, (unsigned long long*)pub, pub_c, pub_g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of a promote list-scan block at k and depth d, its ring's
// stages chosen by pm_stages; the wrapper's list_promote_smem_bytes computes
// the same number. 0 where the kernel does not take d.
long long pyrope_list_promote_smem_bytes(int k, int d) {
  if (d < 1 || d > PM_MAX_D || k < 1 || k > MAXK) return 0;
  const int nst = pm_stages(k, d);
  return nst ? (long long)pm_layout(k, d, nst).total : 0;
}

// The bf16 list scan with promote_fp32 at k <= 128, D <= 256: q [B, D]
// fp32 as it is, x [N, D] bf16 cluster-major, sqnorm [N] of the fp32 rows,
// alive [N]; blocks: the walking grid (one wave); then the work tables and
// outputs as pyrope_ivf_list_scan's (partials k wide, always written: no
// first pass runs it). vec: D % 8 == 0 and x's base 16-byte
// aligned (bulk copies), else plain loads.
int pyrope_ivf_list_scan_promote(const void* q, const void* x, const void* sqnorm,
                                 const void* alive, int blocks, const void* pairs, int P,
                                 const void* cstart, const void* ccnt, const void* item_end,
                                 const void* item_c, const void* slot_end,
                                 const void* offsets, const void* lens, int nclus, int grid,
                                 int B, int D, int k, int kw, int metric_ip, int seg,
                                 int sample, int nslots, int vec, void* part_v, void* part_i,
                                 void* pub, int pub_c, int pub_g, void* stream) {
  (void)B;
  if (k < 1 || k > MAXK || kw != k || D < 1 || D > PM_MAX_D || seg < 1 || P < 1 ||
      blocks < 1 || pub_c < 1 || pub_c > k || pub_g < 1 || (long long)pub_g * pub_c < k ||
      sample < 1 || sample > seg || !part_v || !part_i)
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const void*, const void*, const void*, const void*, int,
                         const void*, int, const void*, const void*, const void*,
                         const void*, const void*, const void*, const void*, int, int, int,
                         int, int, int, int, int, void*, void*, void*, int, int,
                         cudaStream_t);
  static const Launch table[2][2] = {   // [lpr == 32][ip]
      {launch_promote<false, 16>, launch_promote<true, 16>},
      {launch_promote<false, 32>, launch_promote<true, 32>}};
  return table[pm_lpr(D) == 32][metric_ip != 0](
      q, x, sqnorm, alive, blocks, pairs, P, cstart, ccnt, item_end, item_c, slot_end,
      offsets, lens, nclus, grid, D, k, seg, sample, nslots, vec, part_v, part_i, pub, pub_c,
      pub_g, (cudaStream_t)stream);
}

}  // extern "C"
