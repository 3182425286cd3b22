// The bf16 list scan on Hopper's tensor cores (sm_90a), CUDA C++: the IVF
// hybrid's shortlist scan at k <= 128, a TMA-fed wgmma loop under the list
// scan's top-k epilogue and floor.
//
// Replaces, of pyrope_tpu/ops/pallas_scan.py, the bf16 slab mode without
// promote_fp32 of K2 pallas_ivf_topk (:1035) and K3 pallas_ivf_topk_windowed
// (:992) at k <= 128: the branch x.dtype == bfloat16 of _tile_scores
// (:232-264), where the MXU multiplies bf16(q) by the bf16 rows into fp32.
// Until it, ivf_list_scan.cu's <BF16, false> ran that mode on the CUDA
// cores. The wide mode (k > 128: _wide_params :372, _bitonic_merge_wide
// :192, _merge_tile_wide :200, _extract_top :496) stays there: built here
// (lists in the partial slots behind 128-entry buffers, one block an SM at
// 250 registers, so 4 warps an SM inserting), it ran 0.83 + 0.29 ms (scan,
// first pass) at the hybrid's k 512 cell against that kernel's 0.70 + 0.25
// (16 warps an SM inserting), and 0.95 with two blocks an SM (an H100 at
// 700 W, bench/scan_ab.py, ABBA in one call).
//
// What it computes: ivf_list_scan_kernel<BF16, false> without promote, to
// the bit of its inputs' products. Per query b and each alive row t of a
// cluster in b's probe set (cluster c's rows are offsets[c] .. offsets[c] +
// lens[c] of the cluster-major slab):
//   score = -max(|q|^2 - 2 bf16(q).x + sqnorm[t], 0)   (L2)   or
//           bf16(q).x                                   (IP),
// products exact in fp32 (a product of two bf16 values is), sums in fp32
// (in the tensor cores' order), |q|^2 of the fp32 q (summed here, from the
// fp32 rows), sqnorm[t] of the fp32 row before its cast; the top k in the
// total order (score desc, row asc). The work items, partial slots, slot
// counts and floor protocol are the CUDA-core list scan's (ivf_list_scan.cu
// header; list_floor.cuh), so merge_partials_kernel and
// floor_select_list_kernel read its output unchanged.
//
// What bounds it on an H100. At the IVF hybrid's cell (100k x 128, nlist
// 100, nprobe 96, b256) the products are 6.3 GFLOP (0.0064 ms at 989
// TFLOP/s) against 25.6 MB of slab (0.0079 ms at 3.35 TB/s): bytes bound
// it, by a hair, and neither is near what the CUDA-core kernel took (0.92
// ms of device time at k 64): its FMAs and, above all, its insertions set
// its pace. So this design does two things: the products go to wgmma, and
// the epilogue rejects a whole tile of a warp's 16 queries with one vote
// and makes each insertion cheaper and rarer.
//
// Shape of the work. One block an item (cluster, chunk of <= 64 of the
// queries probing it, segment of <= seg of its rows; invert_probes' tables,
// ops/fused_scan.py): a producer warpgroup and one consumer warpgroup, two
// blocks an SM (128 registers a thread) up to D 128.
//
//   Queries as A, gathered once an item. TMA cannot gather rows by id, so
//   before the roles split the block's 8 warps load the chunk's fp32 query
//   rows (pairs -> query ids), a warp a query, round them to bf16 into the
//   128-byte-swizzled A tile ([64 x 64 depths] a chunk) and sum |q|^2 of the
//   fp32 values in the same pass (one order for a query in every item and
//   every launch). Rows of A past the chunk's queries are zeros. Up to D 256
//   A is resident (16 KB a 64-depth chunk); above, warps 1-2 of the producer
//   stage its chunk into each stage of the ring beside the rows, as
//   TC_QRES_MAX_D does in the flat kernel. Any D.
//
//   Rows as B, on TMA. A segment's rows are contiguous in the cluster-major
//   slab, so a 2-D tensor map over x [N, D] with a [128 rows x 64 depths]
//   box in the 128-byte swizzle feeds a ring of stages from any start row.
//   Rows of a box past the segment's end (the next cluster's, or past the
//   sample) are masked by the row table (sqnorm, +inf for a row that is out
//   or dead), which warps 1-2 of the producer write into the stage of a
//   tile's last chunk; TMA zero-fills past N. A slab whose base is not
//   16-byte aligned, or D % 8 != 0 (vec == 0), is staged by plain loads of
//   the whole producer warpgroup into the same swizzled layout, then
//   fence.proxy.async, as the flat kernel does: the same operands in the
//   same places, so the same bits.
//
//   wgmma.mma_async.m64n128k16.f32.bf16.bf16, both operands K-major in
//   shared memory: one consumer warpgroup owns the item's 64 queries. In
//   the accumulator layout every score of a query lies in one quad of one
//   warp, so that warp owns the query's list (as flat_scan_tc.cu does).
//
//   The epilogue. A lane turns its 32 dots of a query into scores, and the
//   warp takes one vote on whether any lane's best reaches its query's
//   threshold (the floor, or the list's k-th): most tiles end there. Else
//   each quad whose query passed stages its 128 scores and the warp offers
//   them 32 at a time. The lists start empty and the threshold apart from
//   them (the flat kernel's form): a list holds only the item's own rows, so
//   every entry may be published and written out as it is. Where its time
//   went, from clock64 counters in a copy (H100, k 64): 57% of a warp's
//   cycles in offers, ~3.7k cycles a passing (query, tile). So the offer and
//   the publication are inlined (out of line, each call saved and restored
//   the live accumulators at 128 registers: 0.601 against 0.487 ms of
//   device time; one block an SM with 255 registers, 0.757), and a register
//   list (k <= 32) takes more than two candidates by a sort and one merge
//   (offer_merged). Compacting a quad's candidates before the offer, and a
//   per-query buffer of candidates (the wide lists' form), both measured
//   slower (0.856 and 0.757 ms).
//
//   The floor. Each query starts from its floor key and reads it again at
//   tiles 1, 2, 4, 8, ... (loaded before the tile's wgmmas, applied after
//   them); a list publishes its c-th entry after each offer that changed
//   it; at its item's end each warp raises its queries' floor keys off
//   their slots' windows (list_floor.cuh). Rows are kept AT OR ABOVE a
//   floor key (the key's row + 1 is the threshold): a key published in this
//   launch names a row that lies in its own slot and in no other, so keeping
//   it elsewhere adds nothing, and a key from the first pass names a row that
//   lies in no list yet, which must stay a candidate.
//
//   The first pass (ops/fused_scan.list_prefloor_plan(..., tc=True), from
//   shapes alone: nprobe >= LIST_TC_PREFLOOR_MIN_PROBES): this kernel's
//   launch at k = c over the first `sample` rows of each segment, no
//   partials, its slots' c-th keys into a pub of its own;
//   floor_select_list_kernel takes each query's g-th largest into the scan's
//   floor keys. Its keys
//   equal the scan's own scores of the same rows, bit for bit: both launches
//   run one instruction sequence on the same tiles (the same chunk in A,
//   rows tiled from the segment's start). Without it, in the wave that
//   starts first every item of a query runs before any of its items ends,
//   with no floor: at k 64 a query's slots kept 4,423 rows, with it 391, and
//   the scan took 1.164 ms against 0.463 (both passes; H100, 700 W).
//
// Shared memory (lt_layout): the ring (NST stages of a 16 KB row tile, and
// the 8 KB q chunk where q streams), resident A, the row tables, the
// mbarriers, per-query tables, four warps' staged scores, and the lists (64
// x k entries); stages from 4 down to 2, the most with which two blocks
// share an SM (else one).

#include <cuda_bf16.h>
#include <limits.h>

#include "flat_epilogue.cuh"
#include "list_floor.cuh"
#include "tc_common.cuh"

namespace {

constexpr int LT_BT = 64;                 // queries an item: the wgmma's M
constexpr int LT_THREADS = 2 * TC_WG;     // producer + consumer warpgroups
constexpr int LT_WARPS = LT_THREADS / 32;
constexpr int LT_SPLIT_D = 2 * TC_DC;     // above it, each chunk's products summed apart

// The tensor cores round an accumulation toward zero at every k16 step, so
// a long one drifts: at D 384 (24 steps) a near-duplicate's score, which
// cancels |q|^2 and |x|^2 of ~128, came out 1.8e-4 under the plain fp32
// version's on an H100. Above LT_SPLIT_D each 64-depth chunk is
// accumulated fresh (4 steps) and the chunks are added in fp32 registers,
// round to nearest; that instantiation holds 64 more registers a thread
// and runs one block an SM. At D <= 128 (8 steps) one accumulation stays
// within the fp32 tolerance.
__host__ __device__ inline bool lt_split(int d) { return d > LT_SPLIT_D; }

// Byte offsets of a block's shared memory from its 1024-aligned base.
struct LtLayout {
  int qstream;       // q streams in the ring (D > TC_QRES_MAX_D)
  size_t stage;      // bytes a stage: rows, then the q chunk when streamed
  size_t qres;       // resident A: nchunk x [64 x 128 B]
  size_t rsq;        // [nst][TC_RT] row table, +inf: row is out
  size_t bars;       // full[nst], empty[nst]
  size_t keys;       // pubk, fkey: [64] 64-bit keys each
  size_t perq;       // qq, thv, thi, qb, qslot, fw0, fw1: [64] each
  size_t stg;        // [4 warps][TC_RT] staged scores
  size_t lists;      // [64][k] values, rows
  size_t total;      // with the alignment slack
};

__host__ __device__ inline LtLayout lt_layout(int k, int d, int nst) {
  LtLayout L;
  const int nchunk = (d + TC_DC - 1) / TC_DC;
  L.qstream = d > TC_QRES_MAX_D;
  L.stage = TC_XTILE + (L.qstream ? (size_t)LT_BT * 128 : 0);
  size_t off = (size_t)nst * L.stage;
  L.qres = off;
  off += L.qstream ? 0 : (size_t)nchunk * LT_BT * 128;
  L.rsq = off;
  off += (size_t)nst * TC_RT * sizeof(float);
  L.bars = off;
  off += 2 * (size_t)nst * sizeof(unsigned long long);
  L.keys = off;
  off += 2 * (size_t)LT_BT * sizeof(unsigned long long);
  L.perq = off;
  off += 7 * (size_t)LT_BT * 4;
  L.stg = off;
  off += 4 * (size_t)TC_RT * sizeof(float);
  L.lists = off;
  off += 8 * (size_t)LT_BT * k;
  L.total = off + 1024;
  return L;
}

// Stages of the ring: the most (4 down to 2) with which the block fits its
// target, two blocks an SM up to LT_SPLIT_D, else one; failing that, the
// most that fit one block an SM.
inline int lt_stages(int k, int d) {
  const size_t target = !lt_split(d) ? TC_SMEM_TWO_BLOCKS : TC_SMEM_LIMIT;
  for (int nst = TC_MAX_STAGES; nst >= 2; --nst)
    if (lt_layout(k, d, nst).total <= target) return nst;
  for (int nst = TC_MAX_STAGES; nst >= 2; --nst)
    if (lt_layout(k, d, nst).total <= TC_SMEM_LIMIT) return nst;
  return 2;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Eight depths d0 .. d0 + 7 of a query row as bf16, one 16-byte piece (zeros
// past D, and for a row that is no query); s2 += each fp32 value squared, in
// depth order.
__device__ __forceinline__ uint4 query_piece(const float* qr, bool in, int d0, int D,
                                             float& s2) {
  uint32_t w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float a = in && d0 + 2 * u < D ? qr[d0 + 2 * u] : 0.f;
    const float b = in && d0 + 2 * u + 1 < D ? qr[d0 + 2 * u + 1] : 0.f;
    s2 = fmaf(a, a, s2);
    s2 = fmaf(b, b, s2);
    w[u] = bf16_bits(a) | (bf16_bits(b) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The streamed q chunk (D > TC_QRES_MAX_D): depths d0 .. d0 + 63 of the
// item's queries, as bf16 in the swizzled [64 x 128 B] layout.
__device__ __forceinline__ void stage_queries(uint8_t* dst, const float* q, const int* qb,
                                              int qn, int D, int d0, int t, int nthreads) {
  for (int e = t; e < LT_BT * 8; e += nthreads) {
    const int i = e >> 3, c = e & 7;
    float s2 = 0.f;
    *reinterpret_cast<uint4*>(dst + i * 128 + ((c ^ (i & 7)) << 4)) =
        query_piece(q + (size_t)qb[i] * D, i < qn, d0 + 8 * c, D, s2);
  }
}

// (v, r) of the lane `other` away, and whether it goes in this lane's place:
// a compare-exchange of a bitonic network over the warp, the better entry to
// the lower lane where the run is descending.
__device__ __forceinline__ void bitonic_step(float& v, int& r, int stride, bool desc,
                                             int lane) {
  const float ov = __shfl_xor_sync(FULL, v, stride);
  const int orr = __shfl_xor_sync(FULL, r, stride);
  const bool lower = (lane & stride) == 0;
  if (lower == desc ? beats(ov, orr, v, r) : beats(v, r, ov, orr)) {
    v = ov;
    r = orr;
  }
}

// A register list of k <= 32 entries (lane i holds entry i; lv/li in shared
// memory keep it between calls) takes every lane's candidate that beats (tv,
// ti) at once: the candidates sorted by a bitonic network over the warp,
// then merged with the list (the better of entry i and the i-th worst
// candidate is the union's top 32, a bitonic run sorted in five steps).
// offer_inline inserts one candidate at a time, a few shuffles and votes
// each; filling a list from empty took most of the first pass's time
// (k 512's c = 8 lists: 206k of 244k cycles a warp, clock64 counters in a
// copy on an H100), and this costs the same for any number of candidates.
// Returns the list's last entry, as offer_inline does.
__device__ __forceinline__ Entry offer_merged(float* lv, int* li, int k, float v, int r,
                                              float tv, int ti, int lane) {
  if (!beats(v, r, tv, ti)) {   // no candidate: sorts last
    v = -INFINITY;
    r = INT_MAX;
  }
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride; stride >>= 1)
      bitonic_step(v, r, stride, (lane & size) == 0 || size == 32, lane);
  float ev = lane < k ? lv[lane] : -INFINITY;
  int ei = lane < k ? li[lane] : INT_MAX;
  if (ei < 0) ei = INT_MAX;   // an empty slot sorts last too
  const float cv = __shfl_sync(FULL, v, 31 - lane);
  const int cr = __shfl_sync(FULL, r, 31 - lane);
  if (beats(cv, cr, ev, ei)) {
    ev = cv;
    ei = cr;
  }
#pragma unroll
  for (int stride = 16; stride; stride >>= 1) bitonic_step(ev, ei, stride, true, lane);
  if (!(ev > -INFINITY)) ei = -1;
  if (lane < k) {
    lv[lane] = ev;
    li[lane] = ei;
  }
  __syncwarp();
  return {__shfl_sync(FULL, ev, k - 1), __shfl_sync(FULL, ei, k - 1)};
}

// x [N, D] bf16 (xmap over it where vec), q [B, D] fp32, sqnorm [N] of the
// fp32 rows, alive [N]. The work tables, pub, pub_c, pub_g, seg, sample and
// part_v null (the first pass) as ivf_list_scan_kernel's; k <= MAXK, the
// slots k wide; nst: the ring's stages (lt_stages). SPLIT: lt_split(D).
template <bool IP, bool SPLIT>
__global__ void __launch_bounds__(LT_THREADS, SPLIT ? 1 : 2)
ivf_list_scan_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                        const float* __restrict__ q, const uint16_t* __restrict__ x,
                        const float* __restrict__ sqnorm,
                        const uint8_t* __restrict__ alive,
                        const int32_t* __restrict__ pairs, int P,
                        const int32_t* __restrict__ cstart,
                        const int32_t* __restrict__ ccnt,
                        const int32_t* __restrict__ item_end,
                        const int32_t* __restrict__ item_c,
                        const int32_t* __restrict__ slot_end,
                        const int32_t* __restrict__ offsets,
                        const int32_t* __restrict__ lens, int nclus, int D, int k,
                        int seg, int sample, int nslots, int vec, int nst,
                        float* __restrict__ part_v, int32_t* __restrict__ part_i,
                        unsigned long long* __restrict__ pub, int pub_c, int pub_g) {
  unsigned long long* qfloor = pub + nslots;   // [B] the queries' floor keys
  const int c = item_c[blockIdx.x];
  if (c >= nclus) return;  // past the last item
  const int cnt = ccnt[c];
  const int len = lens[c];
  const int ns = (len + seg - 1) / seg;
  const int nch = (cnt + LT_BT - 1) / LT_BT;
  const int local = blockIdx.x - (item_end[c] - nch * ns);
  const int chunk = local / ns, s = local % ns;
  const int qlo = cstart[c] + chunk * LT_BT;
  const int qn = min(LT_BT, cnt - chunk * LT_BT);
  const int r_lo = offsets[c] + s * seg;
  const int r_hi = offsets[c] + min(len, min((s + 1) * seg, s * seg + sample));

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const LtLayout L = lt_layout(k, D, nst);
  float* rsq = reinterpret_cast<float*>(base + L.rsq);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(base + L.bars);
  unsigned long long* empty = full + nst;
  unsigned long long* pubk = reinterpret_cast<unsigned long long*>(base + L.keys);
  unsigned long long* fkey = pubk + LT_BT;     // the window's floor (share)
  float* qq = reinterpret_cast<float*>(base + L.perq);
  float* thv = qq + LT_BT;                     // threshold: score
  int* thi = reinterpret_cast<int*>(thv + LT_BT);   // and row
  int* qb = thi + LT_BT;                       // query id
  int* qslot = qb + LT_BT;                     // partial slot
  int* fw0 = qslot + LT_BT;                    // the floor's slot window
  int* fw1 = fw0 + LT_BT;
  float* stg = reinterpret_cast<float*>(base + L.stg);
  float* lv = reinterpret_cast<float*>(base + L.lists);
  int* li = reinterpret_cast<int*>(lv + (size_t)LT_BT * k);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nchunk = (D + TC_DC - 1) / TC_DC;
  const int ntile = (r_hi - r_lo + TC_RT - 1) / TC_RT;
  const int nstage = ntile * nchunk;

  if (tid == 0) {
    // TMA: the issuing thread's expect_tx and 64 row-table writers; plain
    // loads: the whole producer warpgroup
    for (int st = 0; st < nst; ++st) {
      mbar_init(full + st, vec ? 65 : TC_WG);
      mbar_init(empty + st, 4);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < LT_BT * k; e += LT_THREADS) {
    lv[e] = -INFINITY;
    li[e] = -1;
  }
  for (int i = tid; i < LT_BT; i += LT_THREADS) {
    pubk[i] = 0ull;
    fkey[i] = 0ull;
    fw0[i] = fw1[i] = 0;
    qb[i] = 0;
    qslot[i] = nslots;
    // a row past the chunk's queries, or a query without a slot (a short
    // max_len), takes nothing: nothing beats (+inf, -1)
    float tv = INFINITY;
    int ti = -1;
    if (i < qn) {
      const int j = pairs[qlo + i];  // pair j = b * P + p
      const int b = j / P;
      qb[i] = b;
      const int slot = slot_end[j] - ns + s;
      qslot[i] = slot;
      if (slot < nslots) floor_threshold<true>(__ldcg(qfloor + b), tv, ti);
      if (pub_g > 1) slot_window(slot_end, b, P, slot, nslots, fw0[i], fw1[i]);
    }
    thv[i] = tv;
    thi[i] = ti;
  }
  __syncthreads();
  // A: a warp a query, its fp32 row to bf16 pieces (resident up to
  // TC_QRES_MAX_D) and |q|^2 of the fp32 values
  uint8_t* qres = base + L.qres;
  for (int i = warp; i < LT_BT; i += LT_WARPS) {
    const float* qr = q + (size_t)qb[i] * D;
    float s2 = 0.f;
    for (int p = lane; p < nchunk * 8; p += 32) {
      const uint4 piece = query_piece(qr, i < qn, 8 * p, D, s2);
      if (!L.qstream)
        *reinterpret_cast<uint4*>(qres + (size_t)(p >> 3) * LT_BT * 128 + i * 128 +
                                  (((p & 7) ^ (i & 7)) << 4)) = piece;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) s2 += __shfl_xor_sync(FULL, s2, off);
    if (lane == 0) qq[i] = s2;
  }
  fence_proxy_async();
  __syncthreads();

  if (tid < TC_WG) {
    // ---- the producer warpgroup ----
    if (vec) {
      if (warp == 0) {
        if (lane != 0) return;
        for (int it = 0; it < nstage; ++it) {
          const int tile = it / nchunk, ch = it - tile * nchunk;
          const int st = it % nst;
          mbar_wait(empty + st, ((it / nst) & 1) ^ 1);
          mbar_arrive_tx(full + st, (uint32_t)TC_XTILE);
          tma_load_2d(smem_u32(base + (size_t)st * L.stage), &xmap, full + st,
                      ch * TC_DC, r_lo + tile * TC_RT);
        }
        return;
      }
      if (warp == 3) return;
      // warps 1 and 2: the row table, rows t and t + 64 of each tile, loaded
      // a tile ahead, written into the stage of the tile's last chunk; and
      // where q streams, each stage's q chunk
      const int t = tid - 32;
      float n0 = row_sq(sqnorm, alive, r_lo + t, r_hi);
      float n1 = row_sq(sqnorm, alive, r_lo + t + 64, r_hi);
      int it = 0;
      for (int tile = 0; tile < ntile; ++tile) {
        const float v0 = n0, v1 = n1;
        if (tile + 1 < ntile) {
          const int row = r_lo + (tile + 1) * TC_RT + t;
          n0 = row_sq(sqnorm, alive, row, r_hi);
          n1 = row_sq(sqnorm, alive, row + 64, r_hi);
        }
        for (int ch = 0; ch < nchunk; ++ch, ++it) {
          const int st = it % nst;
          mbar_wait(empty + st, ((it / nst) & 1) ^ 1);
          if (L.qstream) {
            stage_queries(base + (size_t)st * L.stage + TC_XTILE, q, qb, qn, D, ch * TC_DC,
                          t, 64);
            fence_proxy_async();
          }
          if (ch == nchunk - 1) {
            rsq[st * TC_RT + t] = v0;
            rsq[st * TC_RT + t + 64] = v1;
          }
          mbar_arrive(full + st);
        }
      }
      return;
    }
    // plain loads: the whole warpgroup stages each chunk, then hands it to
    // the tensor cores' (async) proxy
    for (int it = 0; it < nstage; ++it) {
      const int tile = it / nchunk, ch = it - tile * nchunk;
      const int st = it % nst;
      const int row0 = r_lo + tile * TC_RT;
      mbar_wait(empty + st, ((it / nst) & 1) ^ 1);
      uint8_t* stp = base + (size_t)st * L.stage;
      stage_rows(stp, x, row0, TC_RT, r_hi, D, ch * TC_DC, tid);
      if (L.qstream) stage_queries(stp + TC_XTILE, q, qb, qn, D, ch * TC_DC, tid, TC_WG);
      if (ch == nchunk - 1) rsq[st * TC_RT + tid] = row_sq(sqnorm, alive, row0 + tid, r_hi);
      fence_proxy_async();
      mbar_arrive(full + st);
    }
    return;
  }

  // ---- the consumer warpgroup ----
  const int w = (tid - TC_WG) >> 5;      // warp in it
  const int g = lane >> 2, t4 = lane & 3;
  const int wq0 = 16 * w;                // the warp's 16 queries: wq0 + g + 8 h
  float* wstg = stg + (size_t)w * TC_RT;
  const uint32_t ring = smem_u32(base);
  const uint32_t qres_a = smem_u32(qres);
  // lane l < 16 reads query wq0 + l's floor key at tiles 1, 2, 4, 8, ...
  const int fq = wq0 + (lane & 15);
  const bool freader = lane < 16 && fq < qn && qslot[fq] < nslots;
  float acc[64], run[64];   // run: SPLIT's sum of the chunks
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  int it = 0;
  for (int tile = 0; tile < ntile; ++tile) {
    const bool fresh = tile && ((tile - 1) & tile) == 0;
    // loaded before the tile's products, applied after them
    const unsigned long long fk = fresh && freader ? __ldcg(qfloor + qb[fq]) : 0ull;
    for (int ch = 0; ch < nchunk; ++ch, ++it) {
      const int st = it % nst;
      mbar_wait(full + st, (it / nst) & 1);
      const uint32_t xa = ring + st * (uint32_t)L.stage;
      const uint32_t qa = L.qstream ? xa + TC_XTILE : qres_a + ch * LT_BT * 128;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16(acc, sw128_desc(qa + 32 * kk), sw128_desc(xa + 32 * kk),
                         SPLIT ? kk != 0 : (ch | kk) != 0);
      wgmma_commit();
      if constexpr (SPLIT) {   // this chunk's sums into the running ones
        wgmma_wait<0>();
        fence_acc(acc);
        if (ch + 1 < nchunk && lane == 0) mbar_arrive(empty + st);
#pragma unroll
        for (int i = 0; i < 64; ++i) run[i] = ch ? run[i] + acc[i] : acc[i];
      } else if (ch > 0) {   // the previous chunk's products are done: free its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + (it - 1) % nst);
      }
    }
    if constexpr (SPLIT) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = run[i];
    } else {
      wgmma_wait<0>();
      fence_acc(acc);
    }
    const int sl = (it - 1) % nst;   // the last chunk's stage: the row table
    const int row0 = r_lo + tile * TC_RT;
    float2 sq[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      sq[j] = *reinterpret_cast<const float2*>(rsq + sl * TC_RT + 8 * j + 2 * t4);
    if (fk) raise_to<true>(fk, thv[fq], thi[fq]);
    __syncwarp();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float tv = thv[wq0 + g + 8 * h];
      const float qqi = qq[wq0 + g + 8 * h];
      const float mx = lane_best<IP>(acc, sq, h, qqi);
      // one vote for the 8 queries' 32 rows a lane; a tie may still rank by row
      unsigned pass = __ballot_sync(FULL, mx >= tv);
      while (pass) {   // a quad whose query passed: its 128 scores, 32 a call
        const int gq = (__ffs(pass) - 1) >> 2;
        pass &= ~(0xFu << (4 * gq));
        if (g == gq) stage_scores<IP>(wstg, acc, sq, h, t4, qqi);
        __syncwarp();
        const int qh = wq0 + gq + 8 * h;
        float htv = thv[qh];
        int hti = thi[qh];
        bool took = false;
#pragma unroll 1
        for (int u = 0; u < TC_RT / 32; ++u) {
          const float v = wstg[32 * u + lane];
          const int row = row0 + 32 * u + lane;
          if (!__any_sync(FULL, beats(v, row, htv, hti))) continue;
          took = true;
          const Entry t =
              k <= 32 && __popc(__ballot_sync(FULL, beats(v, row, htv, hti))) > 2
                  ? offer_merged(lv + (size_t)qh * k, li + (size_t)qh * k, k, v, row, htv,
                                 hti, lane)
                  : offer_inline(lv + (size_t)qh * k, li + (size_t)qh * k, k, v, row, htv,
                                 hti, lane);
          // a full list of own rows raises the threshold
          if (beats(t.v, t.r, htv, hti)) {
            htv = t.v;
            hti = t.r;
          }
        }
        if (lane == 0) {   // the threshold, and the slot's c-th entry if it rose
          thv[qh] = htv;
          thi[qh] = hti;
          if (took) {
            const size_t o = (size_t)qh * k + pub_c - 1;
            publish_key_inline(lv[o], li[o], -1, pubk + qh, pub + qslot[qh],
                               pub_g == 1 ? qfloor + qb[qh] : nullptr);
          }
        }
        __syncwarp();
      }
    }
    if (lane == 0) mbar_arrive(empty + sl);
  }

  const int nq = min(16, qn - wq0);   // the warp's queries
  if (part_v) {   // none in the first pass
    for (int e = lane; e < 16 * k; e += 32) {
      const int qi = wq0 + e / k, j = e - (e / k) * k;
      if (qi >= qn || qslot[qi] >= nslots) continue;
      const size_t o = (size_t)qslot[qi] * k + j;
      part_v[o] = lv[(size_t)qi * k + j];
      part_i[o] = li[(size_t)qi * k + j];
    }
  }
  __syncwarp();
  // the warp's queries' slots have published: their floors off the windows
  warp_share_floors(pub, qfloor, qb, fw0, fw1, wq0, nq, pub_g, fkey, lane);
}

template <bool IP, bool SPLIT>
int launch_lt(const void* q, const void* x, const void* sqnorm, const void* alive, int N,
              const void* pairs, int P, const void* cstart, const void* ccnt,
              const void* item_end, const void* item_c, const void* slot_end,
              const void* offsets, const void* lens, int nclus, int grid, int D, int k,
              int seg, int sample, int nslots, int vec, void* part_v, void* part_i,
              void* pub, int pub_c, int pub_g, cudaStream_t stream) {
  const auto kernel = ivf_list_scan_tc_kernel<IP, SPLIT>;
  const int nst = lt_stages(k, D);
  const size_t smem = lt_layout(k, D, nst).total;
  if (smem > (size_t)TC_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0) return 0;
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof(xmap));
  if (vec) {
    const int e = encode_rows(&xmap, x, N, D, TC_RT);
    if (e) return e;
  }
  kernel<<<grid, LT_THREADS, smem, stream>>>(
      xmap, (const float*)q, (const uint16_t*)x, (const float*)sqnorm,
      (const uint8_t*)alive, (const int32_t*)pairs, P, (const int32_t*)cstart,
      (const int32_t*)ccnt, (const int32_t*)item_end, (const int32_t*)item_c,
      (const int32_t*)slot_end, (const int32_t*)offsets, (const int32_t*)lens, nclus, D, k,
      seg, sample, nslots, vec, nst, (float*)part_v, (int32_t*)part_i,
      (unsigned long long*)pub, pub_c, pub_g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of a tensor-core list-scan block at k and depth d, its ring's
// stages chosen by lt_stages; the wrapper's list_tc_smem_bytes computes the
// same number.
long long pyrope_list_tc_smem_bytes(int k, int d) {
  return (long long)lt_layout(k, d, lt_stages(k, d)).total;
}

// The bf16 list scan without promote at k <= 128: q [B, D] fp32 (rounded to
// bf16 here), x [N, D] bf16 cluster-major, sqnorm [N] of the fp32 rows,
// alive [N]; the work tables and outputs as pyrope_ivf_list_scan's, the
// slots kw = k wide. vec: D % 8 == 0 and x's base 16-byte aligned (TMA
// staging), else plain loads.
int pyrope_ivf_list_scan_tc(const void* q, const void* x, const void* sqnorm,
                            const void* alive, int N, const void* pairs, int P,
                            const void* cstart, const void* ccnt, const void* item_end,
                            const void* item_c, const void* slot_end, const void* offsets,
                            const void* lens, int nclus, int grid, int B, int D, int k,
                            int kw, int metric_ip, int seg, int sample, int nslots, int vec,
                            void* part_v, void* part_i, void* pub, int pub_c, int pub_g,
                            void* stream) {
  (void)B;
  if (k < 1 || k > MAXK || kw != k || D < 1 || N < 1 || seg < 1 || P < 1 || pub_c < 1 ||
      pub_c > k || pub_g < 1 || (long long)pub_g * pub_c < k || sample < 1 ||
      sample > seg || (!part_v != !part_i))
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const void*, const void*, const void*, const void*, int,
                         const void*, int, const void*, const void*, const void*,
                         const void*, const void*, const void*, const void*, int, int, int,
                         int, int, int, int, int, void*, void*, void*, int, int,
                         cudaStream_t);
  static const Launch table[2][2] = {   // [split][ip]
      {launch_lt<false, false>, launch_lt<true, false>},
      {launch_lt<false, true>, launch_lt<true, true>}};
  return table[lt_split(D)][metric_ip != 0](
      q, x, sqnorm, alive, N, pairs, P, cstart, ccnt, item_end, item_c, slot_end, offsets,
      lens, nclus, grid, D, k, seg, sample, nslots, vec, part_v, part_i, pub, pub_c, pub_g,
      (cudaStream_t)stream);
}

}  // extern "C"
