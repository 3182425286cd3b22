// Fused exact scan + running top-k for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas kernels of pyrope_tpu/ops/pallas_scan.py:
//   K1 pallas_flat_topk          (:672, body _scan_kernel :572)  -> FLAT mode
//   K2 pallas_ivf_topk           (:1035, body _ivf_scan_kernel :718) -> IVF mode
//   K3 pallas_ivf_topk_windowed  (:992)  folded into IVF mode: probe membership
//      is a bitmap lookup in shared memory, which covers any cluster-table
//      width, so the TPU's per-tile cluster window is not needed.
//   K4 pallas_ivf_sq8_topk       (:1204, body _ivf_sq8_scan_kernel :1112,
//      _tile_scores_sq8 :1093) -> SQ8 mode
//   K5 pallas_ivf_sq8_topk_windowed (:1341) folded into SQ8 mode, as K3 into
//      IVF mode.
// and the merge in their bodies (_merge_tile :401, _finish_topk :642) with
// merge_partials_kernel below.
//
// What it computes, per query b and corpus row t:
//   score = -max(|q|^2 - 2 q.x + sqnorm[t], 0)   (L2)   or   q.x   (IP)
//   FLAT: row survives iff alive[t] && t < max_scans
//   IVF:  row survives iff alive[t] && bit crow[t] of the query's probe bitmap
//   SQ8:  as IVF, over a residual-SQ8 slab: x is the reconstruction
//         x^ = cent[crow[t]] + mins[t] + scales[t] * code[t] (uint8 codes), so
//         q.x^ = qc[b, crow[t]] + scales[t] * (q.code) + mins[t] * sum(q),
//         with qc = q . cents^T computed outside (a plain fp32 product) and
//         read only for rows that pass the bitmap; sqnorm[t] = |x^|^2.
// and returns the top k survivors in the total order (score desc, row asc),
// with (-inf, -1) in slots no survivor filled. Products and sums are IEEE
// fp32 FMAs on the CUDA cores: no TF32, no bf16 demotion. SQ8 codes become
// fp32 (exact for 0..255) as they are staged in shared memory.
//
// The TPU's SQ8 kernel stages a [queries, clusters] table of qc with a -1e30
// sentinel where a cluster is not probed, and selects qc[b, crow] by a
// one-hot matmul. Here that table would not fit a block's shared memory (64
// queries x 1000 clusters x 4 B = 256 KB); the bitmap carries membership and
// the few surviving rows (nprobe 3 of 1000: ~0.3%) read qc from global
// memory, where it stays in L2. No sentinel enters a sum.
//
// Shape of the work. Grid = (query tiles of BT queries) x (corpus splits).
// A block stages its BT queries in shared memory once, then walks the row
// tiles of its split: each tile's x rows are staged in DC-wide depth chunks
// and every thread accumulates an 8-query x 4-row register tile. A warp owns
// 8 queries and the 4*32 = 128 rows of the tile, so it offers its own
// register scores straight to those queries' sorted top-k lists (shared
// memory), behind a threshold test against each list's k-th entry; only
// scores that beat it are inserted, one at a time, by the whole warp. The
// block writes its lists to a [splits, B, k] partial; merge_partials_kernel
// reduces splits*k candidates per query to k with the same order.
//
// What bounds it on an H100. The score is a [B, N] x D fp32 product on the
// CUDA cores (67 TFLOP/s fp32 peak at 700 W, no tensor cores for exact
// fp32); at B = 1024, N = 1M, D = 128 that is 268 GFLOP a batch, so the
// kernel is compute-bound (SQ8 mode reads a quarter of the bytes and runs
// the same FMAs), and the slab is re-read once per query tile
// (B/BT = 16 times; the query tiles of one split are adjacent in the grid,
// so they run side by side and can share those reads through L2). The
// threshold-gated top-k update is the per-row cost on
// top: one compare per score, and an insertion only for the rare score that
// enters the list (about k ln(N/k) per query and split).
//
// Where the work should go next (not done here):
//   - IVF/SQ8 tile skipping: a row tile whose clusters no query of the block
//     probes can be skipped whole (at nlist 1000, nprobe 3, b1024 most
//     tiles); today the product runs for every row and the mask drops it.
//   - wgmma/TMA: exact fp32 has no tensor-core path, but a bf16 slab with
//     promote_fp32 (IVF-PQ's rerank slab), SQ8 codes against a split bf16
//     query, and a 3xbf16 split product could use them; cp.async/TMA double
//     buffering of the x tiles.
//   - batched insertion while the lists fill (the first tiles of a split
//     insert nearly every score).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;           // queries per block
constexpr int RT = 128;          // corpus rows per tile (4 per lane)
constexpr int DC = 32;           // depth chunk staged per step
constexpr int THREADS = 256;     // 8 warps; warp w owns queries 8w..8w+7
constexpr int QPW = BT / (THREADS / 32);   // queries per warp = 8
constexpr int RPL = RT / 32;     // rows per lane = 4
constexpr int MAXK = 128;
constexpr int SLOTS = MAXK / 32; // list slots per lane
constexpr int QS_LD = BT + 4;    // keeps float4 alignment, 4-way store conflicts once per block
constexpr int XS_LD = RT + 1;    // conflict-free transpose store and row reads
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  // (va, ia) strictly precedes (vb, ib) in (score desc, row asc) order
  return va > vb || (va == vb && ia < ib);
}

// Insert (cv, cr) into the sorted list (lv, li) of k entries; the whole warp
// calls it with the same arguments, and (cv, cr) beats the list's last entry.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k,
                                            float cv, int cr, int lane) {
  int cnt = 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int p = lane + 32 * s;
    if (p < k && beats(lv[p], li[p], cv, cr)) ++cnt;
  }
  const int pos = __reduce_add_sync(FULL, cnt);  // entries ahead of it
  float nv[SLOTS];
  int ni[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int p = lane + 32 * s;
    if (p < k && p > pos) {
      nv[s] = lv[p - 1];
      ni[s] = li[p - 1];
    } else {
      nv[s] = cv;
      ni[s] = cr;
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int p = lane + 32 * s;
    if (p < k && p >= pos) {
      lv[p] = nv[s];
      li[p] = ni[s];
    }
  }
  __syncwarp();
}

// Offer every lane's candidate (v, r) to one list. (tv, ti) is the list's
// last entry, warp-uniform, updated as entries go in.
__device__ __forceinline__ void warp_offer(float* lv, int* li, int k, float v,
                                           int r, float& tv, int& ti,
                                           int lane) {
  unsigned m = __ballot_sync(FULL, beats(v, r, tv, ti));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(FULL, v, src);
    const int cr = __shfl_sync(FULL, r, src);
    if (beats(cv, cr, tv, ti)) {
      warp_insert(lv, li, k, cv, cr, lane);
      tv = lv[k - 1];
      ti = li[k - 1];
    }
  }
}

enum Mode { MODE_FLAT = 0, MODE_IVF = 1, MODE_SQ8 = 2 };

size_t scan_smem_bytes(int d, int k, int words, bool sq8) {
  return sizeof(float) * ((size_t)d * QS_LD   // qs [D][QS_LD]
                          + (size_t)DC * XS_LD  // xs [DC][XS_LD]
                          + 3 * RT              // row sqnorm, ok, cluster
                          + BT                  // |q|^2
                          + (sq8 ? 2 * RT + BT : 0)  // row min, scale; sum(q)
                          + 2 * (size_t)BT * k  // lists: values, rows
                          + (size_t)BT * words);  // probe bitmap (IVF, SQ8)
}

// The slab is x, float [N, D] (FLAT, IVF), or codes, uint8 [N, D] (SQ8);
// mins, scales and qc [B, kp] are read in SQ8 mode only, crow and bitmap in
// IVF and SQ8 mode.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
fused_scan_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ sqnorm,
                  const uint8_t* __restrict__ alive,
                  const int32_t* __restrict__ crow,
                  const uint32_t* __restrict__ bitmap, int words,
                  const float* __restrict__ mins,
                  const float* __restrict__ scales,
                  const float* __restrict__ qc, int kp, int B, int N, int D,
                  int k, int metric_ip, int max_scans, int rows_per_split,
                  float* __restrict__ part_v, int32_t* __restrict__ part_i) {
  constexpr bool SQ8 = MODE == MODE_SQ8;
  constexpr bool PROBED = MODE != MODE_FLAT;  // bitmap membership
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [D][QS_LD], query-major columns
  float* xs = qs + (size_t)D * QS_LD;        // [DC][XS_LD]
  float* rsq = xs + DC * XS_LD;              // [RT]
  int* rok = (int*)(rsq + RT);               // [RT] row survives the row mask
  int* rc = rok + RT;                        // [RT] cluster of row (IVF, SQ8)
  float* qq = (float*)(rc + RT);             // [BT]
  float* rmn = qq + BT;                      // [RT] row min (SQ8)
  float* rsc = rmn + (SQ8 ? RT : 0);         // [RT] row scale (SQ8)
  float* qsum = rsc + (SQ8 ? RT : 0);        // [BT] sum(q) (SQ8)
  float* lv = qsum + (SQ8 ? BT : 0);         // [BT][k]
  int* li = (int*)(lv + (size_t)BT * k);     // [BT][k]
  uint32_t* bm = (uint32_t*)(li + (size_t)BT * k);  // [BT][words]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BT;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, N);
  const int limit = PROBED ? r_end : min(r_end, max_scans);

  for (int e = tid; e < BT * k; e += THREADS) {
    lv[e] = -INFINITY;
    li[e] = -1;
  }
  if (PROBED) {
    for (int e = tid; e < BT * words; e += THREADS) {
      const int b = e / words;
      bm[e] = (q0 + b < B) ? bitmap[(size_t)(q0 + b) * words + e % words] : 0u;
    }
  }
  for (int e = tid; e < BT * D; e += THREADS) {
    const int b = e / D, d = e % D;
    qs[(size_t)d * QS_LD + b] = (q0 + b < B) ? q[(size_t)(q0 + b) * D + d] : 0.f;
  }
  __syncthreads();
  for (int b = warp; b < BT; b += THREADS / 32) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = qs[(size_t)d * QS_LD + b];
      s = fmaf(v, v, s);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) qq[b] = s;
  }
  if constexpr (SQ8) {
    for (int b = warp; b < BT; b += THREADS / 32) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[(size_t)d * QS_LD + b];
#pragma unroll
      for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) qsum[b] = s;
    }
  }

  // per-query threshold = last list entry, warp-uniform, kept in registers
  float tv[QPW];
  int ti[QPW];
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    tv[i] = -INFINITY;
    ti[i] = -1;
  }

  for (int row0 = r_begin; row0 < limit; row0 += RT) {
    float acc[QPW][RPL];
#pragma unroll
    for (int i = 0; i < QPW; ++i)
#pragma unroll
      for (int j = 0; j < RPL; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // xs and the row tables are free to overwrite
      if (d0 == 0) {
        for (int r = tid; r < RT; r += THREADS) {
          const int row = row0 + r;
          const bool ok = row < limit && alive[row];
          rok[r] = ok;
          rsq[r] = ok ? sqnorm[row] : 0.f;
          if (PROBED) rc[r] = ok ? crow[row] : 0;
          if (SQ8) {
            rmn[r] = ok ? mins[row] : 0.f;
            rsc[r] = ok ? scales[row] : 0.f;
          }
        }
      }
      // rows are D elements: byte loads in SQ8 mode take any D
      for (int e = tid; e < RT * DC; e += THREADS) {
        const int r = e / DC, d = e % DC;
        const int row = row0 + r;
        if constexpr (SQ8) {
          xs[d * XS_LD + r] = (row < limit && d0 + d < D)
                                  ? (float)codes[(size_t)row * D + d0 + d] : 0.f;
        } else {
          xs[d * XS_LD + r] = (row < limit && d0 + d < D)
                                  ? x[(size_t)row * D + d0 + d] : 0.f;
        }
      }
      __syncthreads();
      const int dn = min(DC, D - d0);
      const float* qcol = qs + (size_t)d0 * QS_LD + warp * QPW;
#pragma unroll 4
      for (int d = 0; d < dn; ++d) {
        const float4 a0 = *reinterpret_cast<const float4*>(qcol + d * QS_LD);
        const float4 a1 = *reinterpret_cast<const float4*>(qcol + d * QS_LD + 4);
        const float a[QPW] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[RPL];
#pragma unroll
        for (int j = 0; j < RPL; ++j) bv[j] = xs[d * XS_LD + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < QPW; ++i)
#pragma unroll
          for (int j = 0; j < RPL; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }

    // epilogue: metric, row mask, then the warp's own lists
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      const int b = warp * QPW + i;
      float* l_v = lv + (size_t)b * k;
      int* l_i = li + (size_t)b * k;
#pragma unroll
      for (int j = 0; j < RPL; ++j) {
        const int r = lane + 32 * j;
        bool ok = rok[r] && (q0 + b < B);
        if (PROBED && ok) {
          const int c = rc[r];
          ok = (bm[(size_t)b * words + (c >> 5)] >> (c & 31)) & 1u;
        }
        float dot = acc[i][j];
        if constexpr (SQ8) {  // q.x^ from q.code; qc only where the row lives
          const float qcv = ok ? qc[(size_t)(q0 + b) * kp + rc[r]] : 0.f;
          dot = qcv + acc[i][j] * rsc[r] + qsum[b] * rmn[r];
        }
        const float s = metric_ip ? dot
                                  : -fmaxf(qq[b] - 2.f * dot + rsq[r], 0.f);
        warp_offer(l_v, l_i, k, ok ? s : -INFINITY, row0 + r, tv[i], ti[i],
                   lane);
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < BT * k; e += THREADS) {
    const int b = e / k;
    if (q0 + b < B) {
      const size_t o = ((size_t)blockIdx.y * B + q0 + b) * k + e % k;
      part_v[o] = lv[e];
      part_i[o] = li[e];
    }
  }
}

template <int MODE>
int launch_scan(const void* q, const void* x, const void* sqnorm,
                const void* alive, const void* crow, const void* bitmap,
                int words, const void* mins, const void* scales,
                const void* qc, int kp, int B, int N, int D, int k,
                int metric_ip, int max_scans, int rows_per_split,
                int n_splits, void* part_v, void* part_i, void* stream) {
  if (k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem_bytes(D, k, words, MODE == MODE_SQ8);
  cudaError_t err = cudaFuncSetAttribute(
      fused_scan_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BT - 1) / BT, n_splits);
  const bool sq8 = MODE == MODE_SQ8;
  fused_scan_kernel<MODE><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, sq8 ? nullptr : (const float*)x,
      sq8 ? (const uint8_t*)x : nullptr, (const float*)sqnorm,
      (const uint8_t*)alive,
      (const int32_t*)crow, (const uint32_t*)bitmap, words,
      (const float*)mins, (const float*)scales, (const float*)qc, kp, B, N,
      D, k, metric_ip, max_scans, rows_per_split, (float*)part_v,
      (int32_t*)part_i);
  return (int)cudaGetLastError();
}

// One warp per query: reduce the [splits, B, k] partial lists to [B, k].
__global__ void __launch_bounds__(THREADS)
merge_partials_kernel(const float* __restrict__ part_v,
                      const int32_t* __restrict__ part_i, int S, int B, int k,
                      float* __restrict__ out_v, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (THREADS / 32) + warp;
  float* lv = smem + (size_t)warp * 2 * k;
  int* li = (int*)(lv + k);
  for (int p = lane; p < k; p += 32) {
    lv[p] = -INFINITY;
    li[p] = -1;
  }
  __syncwarp();
  if (b >= B) return;  // warp-uniform
  float tv = -INFINITY;
  int ti = -1;
  for (int s = 0; s < S; ++s) {
    const size_t base = ((size_t)s * B + b) * k;
    for (int c = 0; c < k; c += 32) {
      const int p = c + lane;
      const float v = p < k ? part_v[base + p] : -INFINITY;
      const int r = p < k ? part_i[base + p] : -1;
      warp_offer(lv, li, k, v, r, tv, ti, lane);
    }
  }
  for (int p = lane; p < k; p += 32) {
    out_v[(size_t)b * k + p] = lv[p];
    out_i[(size_t)b * k + p] = li[p];
  }
}

}  // namespace

extern "C" {

long long pyrope_scan_smem_bytes(int d, int k, int words, int sq8) {
  return (long long)scan_smem_bytes(d, k, words, sq8 != 0);
}

const char* pyrope_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// crow == nullptr selects FLAT mode (max_scans applies); otherwise IVF mode
// (bitmap [B, words] uint32 probe sets, max_scans ignored).
int pyrope_fused_scan(const void* q, const void* x, const void* sqnorm,
                      const void* alive, const void* crow, const void* bitmap,
                      int words, int B, int N, int D, int k, int metric_ip,
                      int max_scans, int rows_per_split, int n_splits,
                      void* part_v, void* part_i, void* stream) {
  if (crow == nullptr)
    return launch_scan<MODE_FLAT>(q, x, sqnorm, alive, nullptr, nullptr, 0,
                                  nullptr, nullptr, nullptr, 0, B, N, D, k,
                                  metric_ip, max_scans, rows_per_split,
                                  n_splits, part_v, part_i, stream);
  return launch_scan<MODE_IVF>(q, x, sqnorm, alive, crow, bitmap, words,
                               nullptr, nullptr, nullptr, 0, B, N, D, k,
                               metric_ip, N, rows_per_split, n_splits, part_v,
                               part_i, stream);
}

// SQ8 mode: codes [N, D] uint8; mins, scales, sqnorm [N] f32; qc [B, kp] f32.
int pyrope_fused_scan_sq8(const void* q, const void* codes, const void* mins,
                          const void* scales, const void* sqnorm,
                          const void* alive, const void* crow,
                          const void* bitmap, int words, const void* qc,
                          int kp, int B, int N, int D, int k, int metric_ip,
                          int rows_per_split, int n_splits, void* part_v,
                          void* part_i, void* stream) {
  return launch_scan<MODE_SQ8>(q, codes, sqnorm, alive, crow, bitmap, words,
                               mins, scales, qc, kp, B, N, D, k, metric_ip, N,
                               rows_per_split, n_splits, part_v, part_i,
                               stream);
}

int pyrope_merge_partials(const void* part_v, const void* part_i, int S,
                          int B, int k, void* out_v, void* out_i,
                          void* stream) {
  if (k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)k * (THREADS / 32);
  const int blocks = (B + THREADS / 32 - 1) / (THREADS / 32);
  merge_partials_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)part_v, (const int32_t*)part_i, S, B, k, (float*)out_v,
      (int32_t*)out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
