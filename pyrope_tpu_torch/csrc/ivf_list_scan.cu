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
//        fp32 q by the widened row; without it bf16(q) by the row, fp32
//        sums. A product of two bf16 values is exact in fp32, so both are
//        fp32 FMAs here: the wrapper passes q rounded to bf16 (an fp32
//        tensor) where promote is off, and |q|^2 of the unrounded q beside
//        it (qsq); with promote it passes q as it is and no qsq.
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
// The floor. An item's lists start empty, and a list that covers only one
// segment (~1000 rows at the main shapes) spends much of its life filling:
// at nprobe 96 each query's list would be refilled 96 times, k insertions
// or more each time. So each query keeps a floor in global memory
// (qfloor[b], one 64-bit key in the lists' order, raised with atomicMax):
// an item whose list of query b holds k of its own rows raises b's floor to
// the k-th of them, and an item starts its lists as k copies of the floor
// it reads, so only rows that beat it are offered. The rows an item drops
// this way are beaten by k rows another item writes, so the merged top k
// is the same whatever order the items ran in; only the partials differ.
//
// One block per item. It gathers its chunk's queries into shared memory
// ([D][QS_LD], query-major columns) with |q|^2, and in SQ8 mode sum(q) and
// qc[b, c] (one scalar per query: the block's cluster is fixed). It walks
// the segment's row tiles (RT rows) in depth chunks (DCH elements), staged
// into a double buffer with cp.async, so the next chunk's copy overlaps this
// chunk's FMAs. Every row it sees lies in a probed cluster: the row mask is
// alive alone.
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

#include "topk_warp.cuh"

namespace {

constexpr int BT = 64;           // queries per item (chunk)
constexpr int RT = 128;          // rows per tile
constexpr int DCH = 64;          // depth elements staged per stage
constexpr int THREADS = 256;     // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int QPW = BT / WARPS;  // layout A: queries per warp = 8
constexpr int RPL = RT / 32;     // layout A: rows per lane = 4
constexpr int SMALL = 8;         // layout B takes chunks of <= 8 queries
constexpr int GATHER = 8;        // float4 query loads in flight per thread
constexpr int QS_LD = BT + 4;    // float4-aligned query columns
constexpr int XLD = DCH + 4;     // stage row stride (elements): conflict-free
                                 // float4 (fp32) and 32-bit (uint8) row reads

enum Mode { MODE_IVF = 1, MODE_SQ8 = 2, MODE_BF16 = 3 };

__host__ __device__ __forceinline__ int round4(int d) { return (d + 3) & ~3; }

__host__ __device__ constexpr int elem_bytes(int mode) {
  return mode == MODE_SQ8 ? 1 : mode == MODE_BF16 ? 2 : 4;
}

size_t list_scan_smem_bytes(int d, int k, int mode) {
  const bool sq8 = mode == MODE_SQ8;
  return sizeof(float) * (size_t)round4(d) * QS_LD        // qs
         + (size_t)2 * RT * XLD * elem_bytes(mode)        // xs, two stages
         + (size_t)2 * RT * 4 * (sq8 ? 4 : 2)             // row tables, two tiles
         + (size_t)7 * BT * 4                        // per-query tables
         + (size_t)8 * BT * k;                       // lists: values, rows
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

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A query's floor as one 64-bit key whose unsigned order is the lists'
// (score desc, row asc) order, so atomicMax keeps the best; 0 is no floor.
__device__ __forceinline__ unsigned long long floor_key(float v, int r) {
  const unsigned u = __float_as_uint(v + 0.f);  // -0 -> +0, as beats() sees it
  const unsigned hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)hi << 32) | (0xffffffffu - (unsigned)r);
}

__device__ __forceinline__ void floor_entry(unsigned long long key, float& v,
                                            int& r) {
  const unsigned hi = (unsigned)(key >> 32);
  v = key ? __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi)
          : -INFINITY;
  r = key ? (int)(0xffffffffu - (unsigned)key) : -1;
}

// The insertion path, out of line. The epilogue offers from 32 sites (8
// queries x 4 rows a lane in layout A); inlined there, the list insertion
// would be copied 32 times into the scan loop's body. Called only when some
// lane's score beats the list's threshold, it returns the new threshold.
struct Entry {
  float v;
  int r;
};

__device__ __noinline__ Entry offer(float* lv, int* li, int k, float v, int r,
                                    float tv, int ti, int lane) {
  warp_offer_batch(lv, li, k, v, r, tv, ti, lane);
  return {tv, ti};
}

// slab: float [N, D] (IVF), uint8 [N, D] (SQ8) or bf16 bits [N, D] (BF16).
// mins, scales, qc [B, kp] are read in SQ8 mode only. qsq: null, or |q|^2
// [B] to take in place of the gathered q's own. vec: D % 4 == 0 and the
// slab's and q's bases are aligned, so slab rows are staged with cp.async
// and queries gathered as float4; else plain loads do both.
template <int MODE>
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
                     int k, int metric_ip, int seg, int nslots, int vec,
                     float* __restrict__ part_v, int32_t* __restrict__ part_i,
                     unsigned long long* __restrict__ qfloor) {
  constexpr bool SQ8 = MODE == MODE_SQ8;
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
  const int r_hi = offsets[c] + min(len, (s + 1) * seg);
  const bool small = qn <= SMALL;
  const int D4 = round4(D);

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // [D4][QS_LD]
  Elem* xs = (Elem*)(qs + (size_t)D4 * QS_LD);        // [2][RT][XLD]
  float* rsq = (float*)(xs + 2 * RT * XLD);           // [2][RT]
  int* rok = (int*)(rsq + 2 * RT);                    // [2][RT]
  float* rmn = (float*)(rok + 2 * RT);                // [2][RT] (SQ8)
  float* rsc = rmn + (SQ8 ? 2 * RT : 0);              // [2][RT] (SQ8)
  float* qq = rsc + (SQ8 ? 2 * RT : 0);               // [BT]
  float* qsum = qq + BT;                              // [BT] (SQ8)
  float* qcv = qsum + BT;                             // [BT] (SQ8)
  int* qb = (int*)(qcv + BT);                         // [BT] query id
  int* qslot = qb + BT;                               // [BT] partial slot
  float* fv = (float*)(qslot + BT);                   // [BT] floor score
  int* fi = (int*)(fv + BT);                          // [BT] floor row
  float* lv = (float*)(fi + BT);                      // [BT][k]
  int* li = (int*)(lv + (size_t)BT * k);              // [BT][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int nchunk = (D4 + DCH - 1) / DCH;
  const int ntile = (r_hi - r_lo + RT - 1) / RT;
  const int nstage = ntile * nchunk;

  // Row tables of a tile are loaded into registers when the tile's first
  // chunk is staged and stored to shared memory after the current chunk's
  // FMAs, so their latency hides behind the compute as cp.async's does.
  bool pend = false;
  int p_ok = 0;
  float p_sq = 0.f, p_mn = 0.f, p_sc = 0.f;

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

  // the first stage's copy and row tables are in flight while the queries
  // are gathered
  stage(0);
  cp_async_commit();

  for (int i = tid; i < BT; i += THREADS) {
    fv[i] = -INFINITY;
    fi[i] = -1;
    if (i >= qn) continue;
    const int j = pairs[qlo + i];  // pair j = b * P + p
    const int b = j / P;
    qb[i] = b;
    qslot[i] = slot_end[j] - ns + s;
    if (SQ8) qcv[i] = qc[(size_t)b * kp + c];
    floor_entry(__ldcg(qfloor + b), fv[i], fi[i]);
  }
  __syncthreads();
  // every list starts as k copies of its query's floor (layout B: warp w's
  // list of query i is list w * QPW + i)
  for (int e = tid; e < BT * k; e += THREADS) {
    const int i = small ? (e / k) % QPW : e / k;
    lv[e] = fv[i];
    li[e] = fi[i];
  }
  if (vec) {  // D % 4 == 0: float4 loads, GATHER in flight per thread;
              // lanes take consecutive queries, so the column stores do not
              // conflict
    const int D4q = D >> 2;
    for (int e0 = 0; e0 < BT * D4q; e0 += THREADS * GATHER) {
      float4 v[GATHER];
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int e = e0 + u * THREADS + tid, i = e % BT, j = e / BT;
        v[u] = (i < qn && j < D4q)
                   ? __ldg(reinterpret_cast<const float4*>(q + (size_t)qb[i] * D) + j)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int e = e0 + u * THREADS + tid, i = e % BT, j = e / BT;
        if (j >= D4q) continue;
        float* col = qs + (size_t)4 * j * QS_LD + i;
        col[0] = v[u].x;
        col[QS_LD] = v[u].y;
        col[2 * QS_LD] = v[u].z;
        col[3 * QS_LD] = v[u].w;
      }
    }
  } else {
    for (int e = tid; e < BT * D4; e += THREADS) {
      const int i = e / D4, d = e - i * D4;
      qs[(size_t)d * QS_LD + i] =
          (i < qn && d < D) ? q[(size_t)qb[i] * D + d] : 0.f;
    }
  }
  store_rows(0);
  __syncthreads();
  for (int i = warp; i < qn; i += WARPS) {
    float s2 = 0.f, s1 = 0.f;
    for (int d = lane; d < D4; d += 32) {
      const float v = qs[(size_t)d * QS_LD + i];
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
    const int d0 = ch * DCH;
    const int nq = min(DCH, D4 - d0) / 4;
    if (!small && busy) {
      const float* qcol = qs + (size_t)d0 * QS_LD + warp * QPW;
      for (int qd = 0; qd < nq; ++qd) {
        float4 xv[RPL];
#pragma unroll
        for (int j = 0; j < RPL; ++j) xv[j] = row4<MODE>(xb, lane + 32 * j, qd);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* qr = qcol + (4 * qd + u) * QS_LD;
          const float4 a0 = *reinterpret_cast<const float4*>(qr);
          const float4 a1 = *reinterpret_cast<const float4*>(qr + 4);
          const float a[QPW] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int i = 0; i < QPW; ++i)
#pragma unroll
            for (int j = 0; j < RPL; ++j)
              acc[i][j] = fmaf(a[i], comp(xv[j], u), acc[i][j]);
        }
      }
    } else if (small) {
      const float* qcol = qs + (size_t)d0 * QS_LD + 4 * g;
      for (int qd = 0; qd < nq; ++qd) {
        const float4 xv = row4<MODE>(xb, rb, qd);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 a =
              *reinterpret_cast<const float4*>(qcol + (4 * qd + u) * QS_LD);
          const float xu = comp(xv, u);
          acc[0][0] = fmaf(a.x, xu, acc[0][0]);
          acc[1][0] = fmaf(a.y, xu, acc[1][0]);
          acc[2][0] = fmaf(a.z, xu, acc[2][0]);
          acc[3][0] = fmaf(a.w, xu, acc[3][0]);
        }
      }
    }

    if (ch == nchunk - 1) {  // epilogue: metric, row mask, the warp's lists
      const int row0 = r_lo + tile * RT;
      const int tb = (tile & 1) * RT;
      if (!small && busy) {
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
            const Entry t = offer(lv + (size_t)b * k, li + (size_t)b * k, k,
                                  sc[j], r, tv[i], ti[i], lane);
            tv[i] = t.v;
            ti[i] = t.r;
          }
        }
      } else if (small) {
        const bool rowok = rok[tb + rb];
#pragma unroll
        for (int i = 0; i < QPW; ++i) {
          if (i >= qn) break;  // warp-uniform
          const int w = (warp * QPW + i) * k;  // this warp's list of query i
          float dot = acc[i & 3][0];
          if constexpr (SQ8)
            dot = qcv[i] + dot * rsc[tb + rb] + qsum[i] * rmn[tb + rb];
          const float sc = metric_ip
                               ? dot
                               : -fmaxf(qq[i] - 2.f * dot + rsq[tb + rb], 0.f);
          const bool ok = rowok && g == (i >> 2);
          const float v = ok ? sc : -INFINITY;
          if (!__any_sync(FULL, beats(v, row0 + rb, tv[i], ti[i]))) continue;
          const Entry t = offer(lv + w, li + w, k, v, row0 + rb, tv[i], ti[i], lane);
          tv[i] = t.v;
          ti[i] = t.r;
        }
      }
    }
    store_rows(st + 1);
    __syncthreads();
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
  for (int e = tid; e < qn * k; e += THREADS) {
    const int i = e / k, j = e - i * k;
    if (qslot[i] >= nslots) continue;  // only if the caller's max_len was short
    const size_t o = (size_t)qslot[i] * k + j;
    const int r = li[(size_t)i * k + j];
    const bool mine = r != fi[i];  // not a copy of the floor
    part_v[o] = mine ? lv[(size_t)i * k + j] : -INFINITY;
    part_i[o] = mine ? r : -1;
  }
  if (tid < qn) {  // a full list of this item's rows raises the floor
    const float v = lv[(size_t)tid * k + k - 1];
    const int r = li[(size_t)tid * k + k - 1];
    if (r >= 0 && r != fi[tid] && v > -INFINITY)
      atomicMax(qfloor + qb[tid], floor_key(v, r));
  }
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
                     int metric_ip, int seg, int nslots, int vec, void* part_v,
                     void* part_i, void* qfloor, void* stream) {
  if (k < 1 || k > MAXK || seg < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = list_scan_smem_bytes(D, k, MODE);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_list_scan_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0) return 0;
  ivf_list_scan_kernel<MODE><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, slab, (const float*)qsq, (const float*)sqnorm,
      (const uint8_t*)alive,
      (const float*)mins, (const float*)scales, (const float*)qc, kp,
      (const int32_t*)pairs, P, (const int32_t*)cstart, (const int32_t*)ccnt,
      (const int32_t*)item_end, (const int32_t*)item_c,
      (const int32_t*)slot_end, (const int32_t*)offsets, (const int32_t*)lens,
      nclus, B, D, k,
      metric_ip, seg, nslots, vec, (float*)part_v, (int32_t*)part_i,
      (unsigned long long*)qfloor);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 1 IVF (fp32 rows), 2 SQ8, 3 BF16; the wrapper's
// list_scan_smem_bytes computes the same number.
long long pyrope_list_scan_smem_bytes(int d, int k, int mode) {
  return (long long)list_scan_smem_bytes(d, k, mode);
}

// IVF mode: x [N, D] f32. The work tables come from invert_probes
// (ops/fused_scan.py); partials [nslots, k].
int pyrope_ivf_list_scan(const void* q, const void* x, const void* sqnorm,
                         const void* alive, const void* pairs, int P,
                         const void* cstart, const void* ccnt,
                         const void* item_end, const void* item_c,
                         const void* slot_end, const void* offsets,
                         const void* lens, int nclus, int grid, int B, int D,
                         int k, int metric_ip, int seg, int nslots, int vec,
                         void* part_v, void* part_i, void* qfloor,
                         void* stream) {
  return launch_list_scan<MODE_IVF>(
      q, x, nullptr, sqnorm, alive, nullptr, nullptr, nullptr, 0, pairs, P, cstart,
      ccnt, item_end, item_c, slot_end, offsets, lens, nclus, grid, B, D, k,
      metric_ip, seg, nslots, vec, part_v, part_i, qfloor, stream);
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
                             int D, int k, int metric_ip, int seg, int nslots,
                             int vec, void* part_v, void* part_i,
                             void* qfloor, void* stream) {
  return launch_list_scan<MODE_SQ8>(
      q, codes, nullptr, sqnorm, alive, mins, scales, qc, kp, pairs, P, cstart, ccnt,
      item_end, item_c, slot_end, offsets, lens, nclus, grid, B, D, k, metric_ip,
      seg, nslots, vec, part_v, part_i, qfloor, stream);
}

// BF16 mode: x [N, D] bf16; qsq null (promote_fp32: q as it is) or |q|^2
// [B] of the unrounded q (q rounded to bf16 by the caller).
int pyrope_ivf_list_scan_bf16(const void* q, const void* x, const void* qsq,
                              const void* sqnorm, const void* alive,
                              const void* pairs, int P, const void* cstart,
                              const void* ccnt, const void* item_end,
                              const void* item_c, const void* slot_end,
                              const void* offsets, const void* lens, int nclus,
                              int grid, int B, int D, int k, int metric_ip,
                              int seg, int nslots, int vec, void* part_v,
                              void* part_i, void* qfloor, void* stream) {
  return launch_list_scan<MODE_BF16>(
      q, x, qsq, sqnorm, alive, nullptr, nullptr, nullptr, 0, pairs, P, cstart,
      ccnt, item_end, item_c, slot_end, offsets, lens, nclus, grid, B, D, k,
      metric_ip, seg, nslots, vec, part_v, part_i, qfloor, stream);
}

}  // extern "C"
