// Fused exact flat scan + running top-k for Hopper (sm_90a), CUDA C++, and
// the merge kernel every scan feeds.
//
// Replaces, of pyrope_tpu/ops/pallas_scan.py:
//   K1 pallas_flat_topk  (:672, body _scan_kernel :572)  -> fused_scan_kernel
// and the merge in the Pallas bodies (_merge_tile :401, _finish_topk :642)
// with merge_partials_kernel below. The IVF and SQ8 scans (K2-K5) are
// cluster-major list scans in ivf_list_scan.cu; they share the merge.
//
// What it computes, per query b and corpus row t:
//   score = -max(|q|^2 - 2 q.x + sqnorm[t], 0)   (L2)   or   q.x   (IP)
//   a row survives iff alive[t] && t < max_scans
// and returns the top k survivors in the total order (score desc, row asc),
// with (-inf, -1) in slots no survivor filled. Products and sums are IEEE
// fp32 FMAs on the CUDA cores: no TF32, no bf16 demotion.
//
// Shape of the work. Grid = (query tiles of BT queries) x (corpus splits).
// A block stages its BT queries in shared memory once, then walks the row
// tiles of its split: each tile's x rows are staged in DC-wide depth chunks
// and every thread accumulates an 8-query x 4-row register tile. A warp owns
// 8 queries and the 4*32 = 128 rows of the tile, so it offers its own
// register scores straight to those queries' sorted top-k lists (shared
// memory, topk_warp.cuh). The block writes its lists to a [splits, B, k]
// partial; merge_partials_kernel reduces splits*k candidates per query to k
// with the same order.
//
// What bounds it on an H100. The score is a [B, N] x D fp32 product on the
// CUDA cores (67 TFLOP/s fp32 peak at 700 W, no tensor cores for exact
// fp32); at B = 1024, N = 1M, D = 128 that is 268 GFLOP a batch, so the
// kernel is compute-bound, and the slab is re-read once per query tile
// (B/BT = 16 times; the query tiles of one split are adjacent in the grid,
// so they run side by side and can share those reads through L2). The
// threshold-gated top-k update is the per-row cost on top: one compare per
// score, and an insertion only for the rare score that enters the list.
//
// Where the work should go next (not done here): cp.async/TMA double
// buffering of the x tiles (as ivf_list_scan.cu does), a tensor-core path
// where exactness allows (a 3xbf16 split product), and batched insertion
// while the lists fill.

#include "topk_warp.cuh"

namespace {

constexpr int BT = 64;           // queries per block
constexpr int RT = 128;          // corpus rows per tile (4 per lane)
constexpr int DC = 32;           // depth chunk staged per step
constexpr int THREADS = 256;     // 8 warps; warp w owns queries 8w..8w+7
constexpr int QPW = BT / (THREADS / 32);   // queries per warp = 8
constexpr int RPL = RT / 32;     // rows per lane = 4
constexpr int QS_LD = BT + 4;    // keeps float4 alignment, 4-way store conflicts once per block
constexpr int XS_LD = RT + 1;    // conflict-free transpose store and row reads

size_t scan_smem_bytes(int d, int k) {
  return sizeof(float) * ((size_t)d * QS_LD   // qs [D][QS_LD]
                          + (size_t)DC * XS_LD  // xs [DC][XS_LD]
                          + 2 * RT              // row sqnorm, ok
                          + BT                  // |q|^2
                          + 2 * (size_t)BT * k);  // lists: values, rows
}

__global__ void __launch_bounds__(THREADS)
fused_scan_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const float* __restrict__ sqnorm,
                  const uint8_t* __restrict__ alive, int B, int N, int D,
                  int k, int metric_ip, int max_scans, int rows_per_split,
                  float* __restrict__ part_v, int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [D][QS_LD], query-major columns
  float* xs = qs + (size_t)D * QS_LD;        // [DC][XS_LD]
  float* rsq = xs + DC * XS_LD;              // [RT]
  int* rok = (int*)(rsq + RT);               // [RT] row survives the row mask
  float* qq = (float*)(rok + RT);            // [BT]
  float* lv = qq + BT;                       // [BT][k]
  int* li = (int*)(lv + (size_t)BT * k);     // [BT][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BT;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, N);
  const int limit = min(r_end, max_scans);

  for (int e = tid; e < BT * k; e += THREADS) {
    lv[e] = -INFINITY;
    li[e] = -1;
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
        }
      }
      for (int e = tid; e < RT * DC; e += THREADS) {
        const int r = e / DC, d = e % DC;
        const int row = row0 + r;
        xs[d * XS_LD + r] = (row < limit && d0 + d < D)
                                ? x[(size_t)row * D + d0 + d] : 0.f;
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
        const bool ok = rok[r] && (q0 + b < B);
        const float dot = acc[i][j];
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

// One warp per query: reduce its sorted partial lists to [B, k]. Without
// qend the lists are [S, B, k] (the flat scan's corpus splits); with qend
// [B, P] (the list scan's running slot counts) they are [S, k] rows, query
// b's rows qend[b - 1][P - 1] (0 for b = 0) .. qend[b][P - 1]; rows past S
// are never read.
__global__ void __launch_bounds__(THREADS)
merge_partials_kernel(const float* __restrict__ part_v,
                      const int32_t* __restrict__ part_i, int S, int B, int k,
                      const int32_t* __restrict__ qend, int P,
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
  const int s0 = qend && b ? min(qend[(size_t)b * P - 1], S) : 0;
  const int s1 = qend ? min(qend[(size_t)b * P + P - 1], S) : S;
  for (int s = s0; s < s1; ++s) {
    const size_t base = qend ? (size_t)s * k : ((size_t)s * B + b) * k;
    // a list is sorted: if its head does not enter, nothing of it will
    if (!beats(part_v[base], part_i[base], tv, ti)) continue;
    for (int c = 0; c < k; c += 32) {
      const int p = c + lane;
      const float v = p < k ? part_v[base + p] : -INFINITY;
      const int r = p < k ? part_i[base + p] : -1;
      warp_offer_batch(lv, li, k, v, r, tv, ti, lane);
    }
  }
  for (int p = lane; p < k; p += 32) {
    out_v[(size_t)b * k + p] = lv[p];
    out_i[(size_t)b * k + p] = li[p];
  }
}

}  // namespace

extern "C" {

long long pyrope_scan_smem_bytes(int d, int k) {
  return (long long)scan_smem_bytes(d, k);
}

const char* pyrope_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// FLAT mode: rows >= max_scans never hit.
int pyrope_fused_scan(const void* q, const void* x, const void* sqnorm,
                      const void* alive, int B, int N, int D, int k,
                      int metric_ip, int max_scans, int rows_per_split,
                      int n_splits, void* part_v, void* part_i, void* stream) {
  if (k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem_bytes(D, k);
  cudaError_t err = cudaFuncSetAttribute(
      fused_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BT - 1) / BT, n_splits);
  fused_scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)x, (const float*)sqnorm,
      (const uint8_t*)alive, B, N, D, k, metric_ip, max_scans,
      rows_per_split, (float*)part_v, (int32_t*)part_i);
  return (int)cudaGetLastError();
}

// qend: null for [S, B, k] lists, else int32 [B, P] over [S, k] lists.
int pyrope_merge_partials(const void* part_v, const void* part_i, int S,
                          int B, int k, const void* qend, int P, void* out_v,
                          void* out_i, void* stream) {
  if (k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)k * (THREADS / 32);
  const int blocks = (B + THREADS / 32 - 1) / (THREADS / 32);
  merge_partials_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)part_v, (const int32_t*)part_i, S, B, k,
      (const int32_t*)qend, P, (float*)out_v, (int32_t*)out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
