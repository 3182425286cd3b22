// Cluster-major IVF list scan + running top-k for Hopper (sm_90a), CUDA C++.
//
// Replaces, of pyrope_tpu/ops/pallas_scan.py:
//   K2 pallas_ivf_topk              (:1035, body _ivf_scan_kernel :718) and
//   K3 pallas_ivf_topk_windowed     (:992)                -> ivf_list_scan<IVF>
//   K4 pallas_ivf_sq8_topk          (:1204, body _ivf_sq8_scan_kernel :1112,
//      _tile_scores_sq8 :1093) and
//   K5 pallas_ivf_sq8_topk_windowed (:1341)               -> ivf_list_scan<SQ8>
// The per-list sorted outputs go through merge_partials_kernel
// (fused_scan.cu), the work of the Pallas bodies' _merge_tile (:401).
//
// What it computes, per query b and each alive row t of a cluster in b's
// probe set (the slab is cluster-major: cluster c's rows are
// offsets[c] .. offsets[c] + lens[c]):
//   score = -max(|q|^2 - 2 q.x + sqnorm[t], 0)   (L2)   or   q.x   (IP)
//   IVF: x is the fp32 row.
//   SQ8: x is the reconstruction x^ = cent[c] + mins[t] + scales[t] * code[t]
//        (uint8 codes), so q.x^ = qc[b, c] + scales[t] * (q.code) + mins[t]
//        * sum(q), with qc = q . cents^T computed outside (a plain fp32
//        product); sqnorm[t] = |x^|^2.
//   BF16: x is a bf16 row widened to fp32 (the branch x.dtype == bfloat16 of
//        the TPU kernels' _tile_scores, :232-264), sqnorm[t] that of the
//        fp32 row before the cast. With promote_fp32 the TPU multiplies the
//        fp32 q by the widened row (here: q as it is, no qsq; at k <= 128
//        and D <= 256 ivf_list_scan_promote.cu runs that mode, on a ring of
//        bulk copies), which the
//        tensor cores cannot compute exactly (TF32 would round q); without
//        it bf16(q) by the row, fp32 sums (here: q rounded to bf16 by the
//        wrapper, an fp32 tensor, and |q|^2 of the unrounded q beside it,
//        qsq), in the wide mode and its first pass only: the narrow mode
//        without promote runs on the tensor cores (ivf_list_scan_tc.cu),
//        whose wide mode lost to this one (PERF.md, Findings).
// and returns the top k in the total order (score desc, row asc), (-inf, -1)
// in empty slots. Products and sums are IEEE fp32 FMAs on the CUDA cores: no
// TF32, no bf16 split.
//
// Why cluster-major. The TPU kernels scan every row of the slab for every
// query tile and drop unprobed rows with a mask: the MXU makes the dense
// product cheap and a gather is not. On the H100 the exact fp32 product
// runs on the CUDA cores (67 TFLOP/s at 700 W), and at nprobe 3 of 1000 the
// dense form throws away 99.7% of 268 GFLOP a b1024 batch. Here the probe
// lists are inverted (on the device, by the wrapper: ops/fused_scan.py
// invert_probes): each probed cluster is scanned once, for the queries that
// probe it, so the work is what the probes need.
//
// Work items. Item = (cluster c, chunk of <= BT of the queries probing c,
// segment of <= seg rows of c). item_c[blockIdx.x] names the cluster (or
// nclus past the last item: the block exits); the chunk and segment follow
// from the cluster's first item. The grid is a bound the host computes from
// shapes alone, so no count crosses to the host. Each (query, probe) pair j
// has one partial slot per segment of its list: slot_end[j] (the running
// count of the pairs' segments, pair-major) less its ns segments, plus s. A
// query's slots are contiguous, so the merge reads only the lists the
// query's probes have, however long the longest list is. An item writes all
// k entries of each of its queries' slots; each slot has one writer, and
// every slot a query has is written.
//
// The floor, published across a query's slots. An item's lists start
// empty, and a list that covers only one segment (~1000 rows at the main
// shapes) spends much of its life filling: at nprobe 96 each query's list
// would be refilled 96 times, k insertions or more each time, and one
// cluster's k-th row lies far below the query's k-th of ~96,000. So each
// partial slot has one 64-bit key in global memory (pub[slot], the lists'
// order as floor_key gives it; 0: nothing published), written only by the
// item that owns the slot: once the slot's list holds c of the item's own
// rows, the item stores the list's c-th entry there, after each tile's
// epilogue where the list changed (layout A and the wide layout B; the
// narrow layout B, whose eight per-warp lists meet only at the end, at the
// end), and again as the entry rises. When an item ends, a warp reads a
// window of FWIN of each of its queries' slots (they are contiguous:
// slot_end), one a lane, takes the g-th largest key published there (the
// host's list_floor picks c and g, g * c >= k) and raises the query's
// floor key (qfloor[b], after the slots' keys, atomicMax) to it; with g = 1
// (c = k) a slot's own key is such a floor, raised into the floor key as it
// is published, and no window is read. An item
// starts from its queries' floor keys and, in layout A and the wide layout
// B, copies them in again (cp.async, beside the row stage) at tiles 1, 2,
// 4, 8, ...; the narrow layout B (a few queries, a few tiles) reads them
// at its start only. Computing the window inside the scan loop stalled the
// block at its barriers (the IVF cell at nprobe 96, b4096 ran 6.3 against
// 4.6 ms of device time; list_floor's g = 32 then also never formed a
// floor at k 1000, whose 32 window slots all had to end). Why no hit is
// dropped: slots hold disjoint rows, and a slot's c-th entry only rises,
// so if g slots each published a key at or above F, at least g * c >= k
// distinct rows lie at or above F, and no row that F beats is a hit. Rows
// must beat the floor to be offered; the merged top k is the same whatever
// order the items ran in, and only the partials differ. The narrow lists
// start as k copies of the floor the item read first (fv/fi); a rising
// floor raises the threshold and leaves the copies as they are, so a copy
// is still marked by that first floor's row (which lies in another slot)
// when the lists are written out or published. Without a floor (fewer than
// g keys, or g above FWIN) nothing is dropped.
//
// One block per item. It reads its chunk's |q|^2, and in SQ8 mode sum(q)
// and qc[b, c] (one scalar per query: the block's cluster is fixed), from
// global memory first. It walks the segment's row tiles (RT rows) in depth
// chunks (DCH elements): each stage holds the chunk of the tile's rows and
// the same depths of the chunk's queries ([BT][DCH + 4], a query's 16-byte
// pieces as they lie, gathered by query id), a double buffer filled with
// cp.async, so the next chunk's copy overlaps this chunk's FMAs. So shared
// memory does not grow with D (the TPU kernels take any D: pick_row_tile
// :49 shrinks their tile; here a query is never held whole, as in the flat
// scan since q is streamed there). Every row it sees lies in a probed
// cluster: the row mask is alive alone.
//   Layout A (chunks of more than 8 queries): warp w owns queries 8w..8w+7
//   and every lane 4 rows of the tile, an 8x4 register tile of FMAs; a warp
//   offers its scores straight to its queries' lists (topk_warp.cuh,
//   warp_offer_batch: the entries that beat the threshold go in together,
//   by rank). The offer is a call (offer, __noinline__) behind a warp vote,
//   so the scan loop's body holds one call site per offer, not the
//   insertion's code: inlined at its 32 sites, with the same insertions,
//   the narrow cell below ran 7.7 ms instead of 5.3 ms.
//   Layout B (at most 8 queries, the common case at nprobe 3 of 1000 and
//   b1024, where a cluster is probed by about 3 queries): the warps split
//   the rows instead, 16 rows a warp, each half-warp 4 of the queries; each
//   warp keeps its own 8 lists, merged per query at the end of the block.
//
// The wide mode (k > MAXK, any k; ivf_list_scan_kernel<MODE, true>)
// replaces the TPU kernels' wide merges (_wide_params :372,
// _bitonic_merge_wide :192, _merge_tile_wide :200, _extract_top :496): a
// query's list is its partial slot in global memory, kw = min(k, seg, the
// longest list) entries wide, since a segment cannot give more, and
// candidates go through a buffer of LCAP entries in shared memory
// (topk_wide.cuh). Layout A: the warp owning a query appends and flushes
// its buffer on its own. Layout B: each warp appends to its own buffer of
// each query behind the query's threshold in shared memory; after each
// tile's epilogue a block barrier, then warp i flushes the buffers of query
// i that could not take another tile into the list and raises the
// threshold. The floor holds as in the narrow mode: it starts as the
// threshold and raises it on the same schedule, and a slot publishes its
// list's c-th entry once the list holds c entries (a wide list holds only
// the item's rows).
//
// The wide mode's first pass (ops/fused_scan.list_prefloor_plan decides
// from shapes whether it runs: at nprobe 96 a query has about 96 slots,
// at nprobe 3 three). The items of a query that run before its floor key
// forms keep every row of their segment: at 100k, nlist 100, nprobe 96,
// k 512 a query's slots held 20,237 real entries for the 512 it needs. So
// a narrow launch of this kernel (ivf_list_scan_kernel<MODE, false>, k = c
// <= 128, the same items, slots and layouts) first scans the first `sample`
// rows of each segment and publishes each slot's c-th key into a pub of
// its own (no partials: part_v null); floor_select_list_kernel (prefloor.cu)
// takes each query's g-th largest slot key, g = ceil(k / c), into the wide
// launch's floor keys, which its items read at their start. Slots hold
// disjoint real rows, so g * c >= k rows lie at or above that key; they
// lie in no list of the wide launch, so the wide mode keeps rows at or
// above a floor key (the floor's row itself stays a candidate), where the
// narrow mode keeps rows that beat it. Both launches compute a score with
// the same FMAs in the same order: layouts A and B order a score's depth
// FMAs alike, and an item has the same queries in both launches.
//
// What bounds it on an H100. With the masked work gone the scan reads each
// probed cluster's rows once per query chunk: at 1M x 128, nlist 1000,
// nprobe 3, b1024 about 95% of the slab (~0.5 GB fp32, ~0.15 ms at 3.35
// TB/s; the SQ8 slab a quarter of that) against 0.79 GFLOP. It is
// memory-bound there, so the design is about bytes in flight: two stages of
// RT x DCH in shared memory per block and two blocks per SM at k 10. At
// 100k, nlist 100, nprobe 96, b4096 each cluster has ~62 full chunks, the
// FMAs are those of the dense scan less 4% (101 GFLOP, 1.5 ms at 67
// TFLOP/s), and the 8x4 register tile (float4 depth reads off a
// conflict-free row-major stage) and the top-k insertions set the pace: a
// query's list is offered ~8 rows per cluster above its floor there.
// The BF16 mode stages half the bytes a row (8-byte cp.async copies: a
// 136-byte stage row is 8-byte aligned) and widens on load; a half-warp's
// 8-byte reads of 16 rows at XLD 68 cover the 32 banks once. Its FMAs are
// the fp32 mode's: faster only where the slab's bytes bound the scan.

#include <type_traits>

#include "list_floor.cuh"
#include "topk_warp.cuh"
#include "topk_wide.cuh"

namespace {

constexpr int BT = 64;           // queries per item (chunk)
constexpr int RT = 128;          // rows per tile
constexpr int DCH = 64;          // depth elements staged per stage
constexpr int THREADS = 256;     // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int QPW = BT / WARPS;  // layout A: queries per warp = 8
constexpr int RPL = RT / 32;     // layout A: rows per lane = 4
constexpr int SMALL = 8;         // layout B takes chunks of <= 8 queries
constexpr int QLD = DCH + 4;     // query stage row stride (floats): 16-byte rows
constexpr int XLD = DCH + 4;     // stage row stride (elements): conflict-free
                                 // float4 (fp32) and 32-bit (uint8) row reads
constexpr int LCAP = 128;        // the wide mode's candidate buffer, a list
constexpr int B_FLUSH = LCAP - 16;  // layout B: a buffer above this is flushed
                                    // (a warp adds at most 16 a query a tile)

enum Mode { MODE_IVF = 1, MODE_SQ8 = 2, MODE_BF16 = 3 };

__host__ __device__ __forceinline__ int round4(int d) { return (d + 3) & ~3; }

__host__ __device__ constexpr int elem_bytes(int mode) {
  return mode == MODE_SQ8 ? 1 : mode == MODE_BF16 ? 2 : 4;
}

// Independent of D: q is streamed by depth chunk beside the rows. k > MAXK
// (the wide mode): the lists lie in the partial slots, and shared memory
// holds a candidate buffer, a WideState and a threshold a list.
size_t list_scan_smem_bytes(int k, int mode) {
  const bool sq8 = mode == MODE_SQ8;
  return sizeof(float) * (size_t)2 * BT * QLD                  // qs, two stages
         + (size_t)2 * RT * XLD * elem_bytes(mode)         // xs, two stages
         + (size_t)2 * RT * 4 * (sq8 ? 4 : 2)              // row tables, two tiles
         + (size_t)13 * BT * 4                        // per-query tables
         + (k > MAXK ? (size_t)BT * (8 * LCAP + 16)   // buffers, states, thresholds
                     : (size_t)8 * BT * k);           // lists: values, rows
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four depths of one staged row as floats.
template <int MODE>
__device__ __forceinline__ float4 row4(const void* xs, int r, int qd) {
  if constexpr (MODE == MODE_SQ8) {
    const uchar4 u =
        *reinterpret_cast<const uchar4*>((const uint8_t*)xs + r * XLD + 4 * qd);
    return make_float4(u.x, u.y, u.z, u.w);
  } else if constexpr (MODE == MODE_BF16) {
    const uint2 u =
        *reinterpret_cast<const uint2*>((const uint16_t*)xs + r * XLD + 4 * qd);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  } else {
    return *reinterpret_cast<const float4*>((const float*)xs + r * XLD + 4 * qd);
  }
}

// The insertion path, out of line. The epilogue offers from 32 sites (8
// queries x 4 rows a lane in layout A); inlined there, the list insertion
// would be copied 32 times into the scan loop's body. Called only when some
// lane's score beats the list's threshold, it returns the new threshold:
// the list's last entry, or the threshold it was given (a floor) where that
// is higher.
__device__ __noinline__ Entry offer(float* lv, int* li, int k, float v, int r,
                                    float tv, int ti, int lane) {
  const float fv0 = tv;
  const int fi0 = ti;
  warp_offer_batch(lv, li, k, v, r, tv, ti, lane);
  return beats(fv0, fi0, tv, ti) ? Entry{fv0, fi0} : Entry{tv, ti};
}

// At an item's end, once its slots have published: each query's floor
// from its window (list_floor.cuh), the block's warps together, QPW queries
// a warp at a time.
__device__ __forceinline__ void share_floors(const unsigned long long* pub,
                                             unsigned long long* qfloor, const int* qb,
                                             const int* fw0, const int* fw1, int qn,
                                             int g, unsigned long long* fkey, int warp,
                                             int lane) {
  if (g == 1 || g > FWIN) return;   // no window to read
  __syncthreads();      // every slot of the block has published
  for (int i0 = warp * QPW; i0 < qn; i0 += WARPS * QPW)
    warp_share_floors(pub, qfloor, qb, fw0, fw1, i0, min(QPW, qn - i0), g, fkey, lane);
}

// slab: float [N, D] (IVF), uint8 [N, D] (SQ8) or bf16 bits [N, D] (BF16).
// mins, scales, qc [B, kp] are read in SQ8 mode only. qsq: null, or |q|^2
// [B] to take in place of the gathered q's own. vec: D % 4 == 0 and the
// slab's and q's bases are aligned, so slab rows and query rows are staged
// with cp.async; else plain loads do both. kw: the width of a partial slot
// (k; in the wide mode min(k, seg, the longest list)). pub [nslots + B],
// 0 from the caller: the slots' published keys, then the queries' floor
// keys (the wide mode: possibly the first pass's); pub_c, pub_g: the
// floor's c and g (list_floor), pub_c <= kw. An item scans the first
// `sample` rows of its segment (seg: all). part_v null (k <= MAXK only): no
// partials are written, the first pass's case.
template <int MODE, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
ivf_list_scan_kernel(const float* __restrict__ q, const void* __restrict__ slab,
                     const float* __restrict__ qsq,
                     const float* __restrict__ sqnorm,
                     const uint8_t* __restrict__ alive,
                     const float* __restrict__ mins,
                     const float* __restrict__ scales,
                     const float* __restrict__ qc, int kp,
                     const int32_t* __restrict__ pairs, int P,
                     const int32_t* __restrict__ cstart,
                     const int32_t* __restrict__ ccnt,
                     const int32_t* __restrict__ item_end,
                     const int32_t* __restrict__ item_c,
                     const int32_t* __restrict__ slot_end,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ lens, int nclus, int B, int D,
                     int k, int kw, int metric_ip, int seg, int sample, int nslots,
                     int vec, float* __restrict__ part_v, int32_t* __restrict__ part_i,
                     unsigned long long* __restrict__ pub, int pub_c, int pub_g) {
  constexpr bool SQ8 = MODE == MODE_SQ8;
  unsigned long long* qfloor = pub + nslots;   // [B] the queries' floor keys
  using Elem = typename std::conditional<
      SQ8, uint8_t,
      typename std::conditional<MODE == MODE_BF16, uint16_t, float>::type>::type;
  const int c = item_c[blockIdx.x];
  if (c >= nclus) return;  // past the last item
  const int cnt = ccnt[c];
  const int len = lens[c];
  const int ns = (len + seg - 1) / seg;
  const int nch = (cnt + BT - 1) / BT;
  const int local = blockIdx.x - (item_end[c] - nch * ns);
  const int chunk = local / ns, s = local % ns;
  const int qlo = cstart[c] + chunk * BT;
  const int qn = min(BT, cnt - chunk * BT);
  const int r_lo = offsets[c] + s * seg;
  const int r_hi = offsets[c] + min(len, min((s + 1) * seg, s * seg + sample));
  const bool small = qn <= SMALL;
  const int D4 = round4(D);

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // [2][BT][QLD]
  Elem* xs = (Elem*)(qs + 2 * BT * QLD);              // [2][RT][XLD]
  float* rsq = (float*)(xs + 2 * RT * XLD);           // [2][RT]
  int* rok = (int*)(rsq + 2 * RT);                    // [2][RT]
  float* rmn = (float*)(rok + 2 * RT);                // [2][RT] (SQ8)
  float* rsc = rmn + (SQ8 ? 2 * RT : 0);              // [2][RT] (SQ8)
  // 8-byte aligned: every table above is a multiple of 8 bytes
  unsigned long long* pubk = (unsigned long long*)(rsc + (SQ8 ? 2 * RT : 0));  // [BT]
                                                      // key the slot published last
  unsigned long long* fkey = pubk + BT;               // [BT] floor key copied in
  float* qq = (float*)(fkey + BT);                    // [BT]
  float* qsum = qq + BT;                              // [BT] (SQ8)
  float* qcv = qsum + BT;                             // [BT] (SQ8)
  int* qb = (int*)(qcv + BT);                         // [BT] query id
  int* qslot = qb + BT;                               // [BT] partial slot
  float* fv = (float*)(qslot + BT);                   // [BT] floor score at the start
  int* fi = (int*)(fv + BT);                          // [BT] floor row at the start
  int* fw0 = fi + BT;                                 // [BT] the floor's slot window
  int* fw1 = fw0 + BT;                                // [BT]
  float* lv = (float*)(fw1 + BT);                     // [BT][k]; WIDE: buffers [BT][LCAP]
  int* li = (int*)(lv + (size_t)BT * (WIDE ? LCAP : k));
  WideState* wst = (WideState*)(li + (size_t)BT * LCAP);  // WIDE: [BT]
  float* wtv = (float*)(wst + BT);                    // WIDE: [BT] threshold (layout B)
  int* wti = (int*)(wtv + BT);                        // WIDE: [BT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // where a publication of query i's slot goes straight to its floor key (g = 1)
  auto qdst = [&](int i) { return pub_g == 1 ? qfloor + qb[i] : nullptr; };

  const int nchunk = (D4 + DCH - 1) / DCH;
  const int ntile = (r_hi - r_lo + RT - 1) / RT;
  const int nstage = ntile * nchunk;

  // Row tables of a tile are loaded into registers when the tile's first
  // chunk is staged and stored to shared memory after the current chunk's
  // FMAs, so their latency hides behind the compute as cp.async's does.
  bool pend = false;
  int p_ok = 0;
  float p_sq = 0.f, p_mn = 0.f, p_sc = 0.f;

  // a stage: the depth chunk of the tile's rows and of the chunk's queries
  auto stage = [&](int st) {
    const int tile = st / nchunk, ch = st - tile * nchunk;
    const int row0 = r_lo + tile * RT, d0 = ch * DCH;
    const int nq = min(DCH, D4 - d0) / 4;
    Elem* dst0 = xs + (st & 1) * RT * XLD;
    for (int e = tid; e < RT * (DCH / 4); e += THREADS) {
      const int r = e / (DCH / 4), qd = e - r * (DCH / 4);
      if (qd >= nq) continue;
      const int row = row0 + r;
      const bool ok = row < r_hi;
      Elem* dst = dst0 + r * XLD + 4 * qd;
      const Elem* src = (const Elem*)slab + (size_t)row * D + d0 + 4 * qd;
      if (vec) {
        if constexpr (SQ8) cp_async4(dst, ok ? src : slab, ok ? 4 : 0);
        else if constexpr (MODE == MODE_BF16) cp_async8(dst, ok ? src : slab, ok ? 8 : 0);
        else cp_async16(dst, ok ? src : slab, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dst[u] = (ok && d0 + 4 * qd + u < D) ? src[u] : (Elem)0;
      }
    }
    // the chunk's queries only: no score of a query past qn is ever read
    float* qdst0 = qs + (st & 1) * BT * QLD;
    for (int e = tid; e < qn * (DCH / 4); e += THREADS) {
      const int i = e / (DCH / 4), qd = e - i * (DCH / 4);
      if (qd >= nq) continue;
      float* dst = qdst0 + i * QLD + 4 * qd;
      const float* src = q + (size_t)qb[i] * D + d0 + 4 * qd;
      if (vec) {
        cp_async16(dst, src, 16);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[u] = d0 + 4 * qd + u < D ? src[u] : 0.f;
      }
    }
    // after tiles 0, 1, 3, 7, ...: the queries' floor keys, read at the
    // epilogue of the tile this stage starts (tiles 1, 2, 4, 8, ...)
    if (ch == 0 && tile && ((tile - 1) & tile) == 0 && tid < qn && (WIDE || !small))
      cp_async8(fkey + tid, qfloor + qb[tid], 8);
    pend = ch == 0 && tid < RT;
    if (pend) {  // independent loads: nothing waits on them until stored
      const int row = row0 + tid;
      const bool in = row < r_hi;
      p_ok = in ? alive[row] : 0;
      p_sq = in ? sqnorm[row] : 0.f;
      if (SQ8) {
        p_mn = in ? mins[row] : 0.f;
        p_sc = in ? scales[row] : 0.f;
      }
    }
  };
  auto store_rows = [&](int st) {
    if (!pend) return;
    const int o = ((st / nchunk) & 1) * RT + tid;
    rok[o] = p_ok;
    rsq[o] = p_sq;
    if (SQ8) {
      rmn[o] = p_mn;
      rsc[o] = p_sc;
    }
  };

  for (int i = tid; i < BT; i += THREADS) {
    fv[i] = -INFINITY;
    fi[i] = -1;
    pubk[i] = 0ull;
    fkey[i] = 0ull;
    fw0[i] = fw1[i] = 0;
    if (WIDE) {
      wst[i] = {0, 0};
      wtv[i] = -INFINITY;
      wti[i] = -1;
    }
    if (i >= qn) continue;
    const int j = pairs[qlo + i];  // pair j = b * P + p
    const int b = j / P;
    qb[i] = b;
    const int slot = slot_end[j] - ns + s;
    qslot[i] = slot;
    if (SQ8) qcv[i] = qc[(size_t)b * kp + c];
    floor_threshold<WIDE>(__ldcg(qfloor + b), fv[i], fi[i]);   // the floor it starts from
    if (WIDE) {
      if (slot >= nslots) {   // no slot (a short max_len): takes nothing
        fv[i] = INFINITY;
        fi[i] = -1;
      }
      wtv[i] = fv[i];
      wti[i] = fi[i];
    }
    if (pub_g > 1) {   // the window of the query's slots lo .. hi that holds its own
      slot_window(slot_end, b, P, slot, nslots, fw0[i], fw1[i]);
    }
  }
  __syncthreads();
  // the first stage's copies and row tables are in flight while the lists
  // start and the queries' norms are summed
  stage(0);
  cp_async_commit();
  if (!WIDE) {
    // every list starts as k copies of its query's floor (layout B: warp w's
    // list of query i is list w * QPW + i)
    for (int e = tid; e < BT * k; e += THREADS) {
      const int i = small ? (e / k) % QPW : e / k;
      lv[e] = fv[i];
      li[e] = fi[i];
    }
  }
  // |q|^2 and sum(q), read whole from global memory: a query is never held
  // whole in shared memory
  for (int i = warp; i < qn; i += WARPS) {
    float s2 = 0.f, s1 = 0.f;
    const float* qr = q + (size_t)qb[i] * D;
    for (int d = lane; d < D; d += 32) {
      const float v = qr[d];
      s2 = fmaf(v, v, s2);
      s1 += v;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      s2 += __shfl_xor_sync(FULL, s2, off);
      s1 += __shfl_xor_sync(FULL, s1, off);
    }
    if (lane == 0) {
      qq[i] = qsq ? qsq[qb[i]] : s2;
      qsum[i] = s1;
    }
  }
  store_rows(0);
  __syncthreads();

  float tv[QPW];
  int ti[QPW];
  const int fq = small ? 0 : warp * QPW;  // the query of the warp's list 0
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    tv[i] = fv[fq + i];
    ti[i] = fi[fq + i];
  }
  float acc[QPW][RPL];

  // layout A: warps whose 8 queries all lie past qn have nothing to do
  const bool busy = small || warp * QPW < qn;
  const int rb = warp * 16 + (lane & 15);  // layout B: this lane's row
  const int g = lane >> 4;                 // layout B: queries 4g..4g+3

  for (int st = 0; st < nstage; ++st) {
    const int tile = st / nchunk, ch = st - tile * nchunk;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < QPW; ++i)
#pragma unroll
        for (int j = 0; j < RPL; ++j) acc[i][j] = 0.f;
    }
    if (st + 1 < nstage) {
      stage(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      pend = false;
      cp_async_wait<0>();
    }
    __syncthreads();

    const Elem* xb = xs + (st & 1) * RT * XLD;
    const float* qsb = qs + (st & 1) * BT * QLD;
    const int d0 = ch * DCH;
    const int nq = min(DCH, D4 - d0) / 4;
    if (!small && busy) {
      const float* qrow = qsb + warp * QPW * QLD;
      for (int qd = 0; qd < nq; ++qd) {
        float4 xv[RPL];
#pragma unroll
        for (int j = 0; j < RPL; ++j) xv[j] = row4<MODE>(xb, lane + 32 * j, qd);
#pragma unroll
        for (int i = 0; i < QPW; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(qrow + i * QLD + 4 * qd);
#pragma unroll
          for (int j = 0; j < RPL; ++j) {
            acc[i][j] = fmaf(a.x, xv[j].x, acc[i][j]);
            acc[i][j] = fmaf(a.y, xv[j].y, acc[i][j]);
            acc[i][j] = fmaf(a.z, xv[j].z, acc[i][j]);
            acc[i][j] = fmaf(a.w, xv[j].w, acc[i][j]);
          }
        }
      }
    } else if (small) {
      const float* qrow = qsb + 4 * g * QLD;
      for (int qd = 0; qd < nq; ++qd) {
        const float4 xv = row4<MODE>(xb, rb, qd);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(qrow + i * QLD + 4 * qd);
          acc[i][0] = fmaf(a.x, xv.x, acc[i][0]);
          acc[i][0] = fmaf(a.y, xv.y, acc[i][0]);
          acc[i][0] = fmaf(a.z, xv.z, acc[i][0]);
          acc[i][0] = fmaf(a.w, xv.w, acc[i][0]);
        }
      }
    }

    if (ch == nchunk - 1) {  // epilogue: metric, row mask, the warp's lists
      const int row0 = r_lo + tile * RT;
      const int tb = (tile & 1) * RT;
      const bool fresh = tile && ((tile - 1) & tile) == 0;   // floor keys copied in
      if (!small && busy) {
        if (fresh) {
#pragma unroll
          for (int i = 0; i < QPW; ++i) raise_to<WIDE>(fkey[warp * QPW + i], tv[i], ti[i]);
        }
        unsigned changed = 0;   // queries whose lists took an offer this tile
#pragma unroll
        for (int i = 0; i < QPW; ++i) {
          const int b = warp * QPW + i;
          float sc[RPL];
          bool any = false;
#pragma unroll
          for (int j = 0; j < RPL; ++j) {
            const int r = lane + 32 * j;
            float dot = acc[i][j];
            if constexpr (SQ8)
              dot = qcv[b] + acc[i][j] * rsc[tb + r] + qsum[b] * rmn[tb + r];
            const float v = metric_ip
                                ? dot
                                : -fmaxf(qq[b] - 2.f * dot + rsq[tb + r], 0.f);
            sc[j] = (rok[tb + r] && b < qn) ? v : -INFINITY;
            any |= beats(sc[j], row0 + r, tv[i], ti[i]);
          }
          if (!__any_sync(FULL, any)) continue;  // one vote for the 4 rows
#pragma unroll
          for (int j = 0; j < RPL; ++j) {
            const int r = row0 + lane + 32 * j;
            if (!__any_sync(FULL, beats(sc[j], r, tv[i], ti[i]))) continue;
            if constexpr (WIDE) {   // the list is query b's partial slot
              const size_t o = (size_t)qslot[b] * kw;
              const Entry t = wide_offer<LCAP>(part_v + o, part_i + o, kw,
                                             lv + (size_t)b * LCAP, li + (size_t)b * LCAP,
                                             wst + b, sc[j], r, tv[i], ti[i], lane);
              tv[i] = t.v;
              ti[i] = t.r;
            } else {
              const Entry t = offer(lv + (size_t)b * k, li + (size_t)b * k, k,
                                    sc[j], r, tv[i], ti[i], lane);
              tv[i] = t.v;
              ti[i] = t.r;
            }
          }
          changed |= 1u << i;
        }
        // lane i: the c-th entry of query i's list, if the list changed and
        // the entry rose, for the query's other items (one call site)
        const int b = warp * QPW + lane;
        if (lane < QPW && (changed >> lane & 1u) && qslot[b] < nslots) {
          if constexpr (WIDE) {
            const size_t o = (size_t)qslot[b] * kw + pub_c - 1;
            if (wst[b].fill >= pub_c)
              publish_key(part_v[o], part_i[o], -1, pubk + b, pub + qslot[b], qdst(b));
          } else {
            const size_t o = (size_t)b * k + pub_c - 1;
            publish_key(lv[o], li[o], fi[b], pubk + b, pub + qslot[b], qdst(b));
          }
        }
      } else if (small) {
        const bool rowok = rok[tb + rb];
#pragma unroll
        for (int i = 0; i < QPW; ++i) {
          if (i >= qn) break;  // warp-uniform
          float dot = acc[i & 3][0];
          if constexpr (SQ8)
            dot = qcv[i] + dot * rsc[tb + rb] + qsum[i] * rmn[tb + rb];
          const float sc = metric_ip
                               ? dot
                               : -fmaxf(qq[i] - 2.f * dot + rsq[tb + rb], 0.f);
          const bool ok = rowok && g == (i >> 2);
          const float v = ok ? sc : -INFINITY;
          if constexpr (WIDE) {   // into this warp's buffer of query i
            const int w = warp * QPW + i;
            wide_append(lv + (size_t)w * LCAP, li + (size_t)w * LCAP, &wst[w].cnt,
                        beats(v, row0 + rb, wtv[i], wti[i]), v, row0 + rb, lane);
          } else {
            const int w = (warp * QPW + i) * k;  // this warp's list of query i
            if (!__any_sync(FULL, beats(v, row0 + rb, tv[i], ti[i]))) continue;
            const Entry t = offer(lv + w, li + w, k, v, row0 + rb, tv[i], ti[i], lane);
            tv[i] = t.v;
            ti[i] = t.r;
          }
        }
        if constexpr (WIDE) {
          // warp i flushes the buffers of query i that could not take
          // another tile into the query's list, publishes the list's c-th
          // entry, and raises its threshold (the list's last, the floor)
          __syncthreads();
          if (warp < qn && qslot[warp] < nslots) {
            const int i = warp;
            const size_t o = (size_t)qslot[i] * kw;
            for (int w = 0; w < WARPS; ++w) {
              const int bw = w * QPW + i;
              if (wst[bw].cnt <= B_FLUSH) continue;
              wide_flush<LCAP>(part_v + o, part_i + o, kw, lv + (size_t)bw * LCAP,
                               li + (size_t)bw * LCAP, &wst[bw].cnt, &wst[i].fill, lane);
            }
            float t_v = wtv[i];
            int t_i = wti[i];
            wide_threshold(part_v + o, part_i + o, kw, wst[i].fill, t_v, t_i);
            if (lane == 0 && wst[i].fill >= pub_c)
              publish_key(part_v[o + pub_c - 1], part_i[o + pub_c - 1], -1, pubk + i,
                      pub + qslot[i], qdst(i));
            if (fresh) raise_to<WIDE>(fkey[i], t_v, t_i);
            __syncwarp();
            if (lane == 0) {
              wtv[i] = t_v;
              wti[i] = t_i;
            }
          }
        }
      }
    }
    store_rows(st + 1);
    __syncthreads();
  }

  if constexpr (WIDE) {
    // the buffers left, then the slots' pads; list i's fill is wst[i].fill
    // (layout B: every warp's buffer of query i feeds it)
    for (int i = small ? warp : warp * QPW; i < (small ? qn : min(qn, (warp + 1) * QPW));
         i += small ? WARPS : 1) {
      if (qslot[i] >= nslots) continue;
      const size_t o = (size_t)qslot[i] * kw;
      for (int w = 0; w < (small ? WARPS : 1); ++w) {
        const int bw = small ? w * QPW + i : i;
        wide_flush<LCAP>(part_v + o, part_i + o, kw, lv + (size_t)bw * LCAP,
                         li + (size_t)bw * LCAP, &wst[bw].cnt, &wst[i].fill, lane);
      }
      wide_pad(part_v + o, part_i + o, kw, wst[i].fill, lane);
    }
    __syncthreads();
    if (tid < qn && qslot[tid] < nslots && wst[tid].fill >= pub_c) {
      // the final list's c-th entry, for the query's items still running
      const size_t o = (size_t)qslot[tid] * kw + pub_c - 1;
      publish_key(part_v[o], part_i[o], -1, pubk + tid, pub + qslot[tid], qdst(tid));
    }
    share_floors(pub, qfloor, qb, fw0, fw1, qn, pub_g, fkey, warp, lane);
    return;
  }

  if (small && warp < qn) {
    // warp i merges the other warps' lists of query i into warp 0's (list i)
    const int i = warp;
    float* l_v = lv + (size_t)i * k;
    int* l_i = li + (size_t)i * k;
    float mv = l_v[k - 1];
    int mi = l_i[k - 1];
    for (int w = 1; w < WARPS; ++w) {
      const size_t base = (size_t)(w * QPW + i) * k;
      if (!beats(lv[base], li[base], mv, mi)) continue;  // sorted: none will
      for (int c0 = 0; c0 < k; c0 += 32) {
        const int p = c0 + lane;
        warp_offer_batch(l_v, l_i, k, p < k ? lv[base + p] : -INFINITY,
                   p < k ? li[base + p] : -1, mv, mi, lane);
      }
    }
  }
  __syncthreads();
  for (int e = tid; part_v && e < qn * k; e += THREADS) {   // none in the first pass
    const int i = e / k, j = e - i * k;
    if (qslot[i] >= nslots) continue;  // only if the caller's max_len was short
    const size_t o = (size_t)qslot[i] * k + j;
    const int r = li[(size_t)i * k + j];
    const bool mine = r != fi[i];  // not a copy of the floor
    part_v[o] = mine ? lv[(size_t)i * k + j] : -INFINITY;
    part_i[o] = mine ? r : -1;
  }
  if (tid < qn && qslot[tid] < nslots) {  // the final list's c-th entry
    const size_t o = (size_t)tid * k + pub_c - 1;
    publish_key(lv[o], li[o], fi[tid], pubk + tid, pub + qslot[tid], qdst(tid));
  }
  share_floors(pub, qfloor, qb, fw0, fw1, qn, pub_g, fkey, warp, lane);
}

template <int MODE>
int launch_list_scan(const void* q, const void* slab, const void* qsq,
                     const void* sqnorm,
                     const void* alive, const void* mins, const void* scales,
                     const void* qc, int kp, const void* pairs, int P,
                     const void* cstart, const void* ccnt,
                     const void* item_end, const void* item_c,
                     const void* slot_end, const void* offsets,
                     const void* lens, int nclus, int grid, int B, int D, int k,
                     int kw, int metric_ip, int seg, int sample, int nslots, int vec,
                     void* part_v, void* part_i, void* pub, int pub_c, int pub_g,
                     void* stream) {
  const bool wide = k > MAXK;
  // a slot holds k entries, or in the wide mode at most what a segment has;
  // a slot publishes its c-th entry, and g * c rows lie at or above a floor;
  // only the narrow mode (the first pass) may go without partials
  if (k < 1 || seg < 1 || P < 1 || kw < 1 || (wide ? kw > min(k, seg) : kw != k) ||
      pub_c < 1 || pub_c > kw || pub_g < 1 || (long long)pub_g * pub_c < k ||
      sample < 1 || sample > seg || (!part_v != !part_i) || (wide && !part_v))
    return (int)cudaErrorInvalidValue;
  const size_t smem = list_scan_smem_bytes(k, MODE);
  auto kernel = wide ? ivf_list_scan_kernel<MODE, true> : ivf_list_scan_kernel<MODE, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0) return 0;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, slab, (const float*)qsq, (const float*)sqnorm,
      (const uint8_t*)alive,
      (const float*)mins, (const float*)scales, (const float*)qc, kp,
      (const int32_t*)pairs, P, (const int32_t*)cstart, (const int32_t*)ccnt,
      (const int32_t*)item_end, (const int32_t*)item_c,
      (const int32_t*)slot_end, (const int32_t*)offsets, (const int32_t*)lens,
      nclus, B, D, k, kw,
      metric_ip, seg, sample, nslots, vec, (float*)part_v, (int32_t*)part_i,
      (unsigned long long*)pub, pub_c, pub_g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 1 IVF (fp32 rows), 2 SQ8, 3 BF16; the wrapper's
// list_scan_smem_bytes computes the same number. It does not depend on D.
long long pyrope_list_scan_smem_bytes(int k, int mode) {
  return (long long)list_scan_smem_bytes(k, mode);
}

// IVF mode: x [N, D] f32. The work tables come from invert_probes
// (ops/fused_scan.py); partials [nslots, kw]: kw = k for k <= MAXK, else
// (the wide mode) at most min(k, seg); pub [nslots] 64-bit keys, 0 from the
// caller, and the floor's pub_c <= kw and pub_g (list_floor); an item scans
// the first sample (1 .. seg) rows of its segment; part_v and part_i null
// (k <= MAXK only): no partials, pub alone is written (the first pass).
int pyrope_ivf_list_scan(const void* q, const void* x, const void* sqnorm,
                         const void* alive, const void* pairs, int P,
                         const void* cstart, const void* ccnt,
                         const void* item_end, const void* item_c,
                         const void* slot_end, const void* offsets,
                         const void* lens, int nclus, int grid, int B, int D,
                         int k, int kw, int metric_ip, int seg, int sample, int nslots,
                         int vec, void* part_v, void* part_i, void* pub, int pub_c,
                         int pub_g, void* stream) {
  return launch_list_scan<MODE_IVF>(
      q, x, nullptr, sqnorm, alive, nullptr, nullptr, nullptr, 0, pairs, P, cstart,
      ccnt, item_end, item_c, slot_end, offsets, lens, nclus, grid, B, D, k, kw,
      metric_ip, seg, sample, nslots, vec, part_v, part_i, pub, pub_c, pub_g, stream);
}

// SQ8 mode: codes [N, D] uint8; mins, scales, sqnorm [N] f32; qc [B, kp] f32.
int pyrope_ivf_list_scan_sq8(const void* q, const void* codes,
                             const void* mins, const void* scales,
                             const void* sqnorm, const void* alive,
                             const void* qc, int kp, const void* pairs, int P,
                             const void* cstart, const void* ccnt,
                             const void* item_end, const void* item_c,
                             const void* slot_end, const void* offsets,
                             const void* lens, int nclus, int grid, int B,
                             int D, int k, int kw, int metric_ip, int seg, int sample,
                             int nslots, int vec, void* part_v, void* part_i, void* pub,
                             int pub_c, int pub_g, void* stream) {
  return launch_list_scan<MODE_SQ8>(
      q, codes, nullptr, sqnorm, alive, mins, scales, qc, kp, pairs, P, cstart, ccnt,
      item_end, item_c, slot_end, offsets, lens, nclus, grid, B, D, k, kw, metric_ip,
      seg, sample, nslots, vec, part_v, part_i, pub, pub_c, pub_g, stream);
}

// BF16 mode: x [N, D] bf16; qsq null (promote_fp32: q as it is) or |q|^2
// [B] of the unrounded q (q rounded to bf16 by the caller: the wide mode
// and its first pass; the narrow mode is pyrope_ivf_list_scan_tc's).
int pyrope_ivf_list_scan_bf16(const void* q, const void* x, const void* qsq,
                              const void* sqnorm, const void* alive,
                              const void* pairs, int P, const void* cstart,
                              const void* ccnt, const void* item_end,
                              const void* item_c, const void* slot_end,
                              const void* offsets, const void* lens, int nclus,
                              int grid, int B, int D, int k, int kw, int metric_ip,
                              int seg, int sample, int nslots, int vec, void* part_v,
                              void* part_i, void* pub, int pub_c, int pub_g,
                              void* stream) {
  return launch_list_scan<MODE_BF16>(
      q, x, qsq, sqnorm, alive, nullptr, nullptr, nullptr, 0, pairs, P, cstart,
      ccnt, item_end, item_c, slot_end, offsets, lens, nclus, grid, B, D, k, kw,
      metric_ip, seg, sample, nslots, vec, part_v, part_i, pub, pub_c, pub_g, stream);
}

}  // extern "C"
