// Warp-cooperative sorted top-k lists in shared memory, shared by the scan
// kernels (fused_scan.cu, ivf_list_scan.cu) and the merge kernel.
//
// A list holds k (score, row) entries sorted in the total order (score desc,
// row asc), (-inf, -1) in empty slots. A warp owns a list: every lane keeps
// the list's last entry (the threshold) in registers, offers its candidates
// behind one compare, and the few that beat the threshold go in one at a
// time, by the whole warp. This is the TPU kernels' _merge_tile
// (pyrope_tpu/ops/pallas_scan.py:401) rebuilt for a warp: the TPU merges
// whole sorted tiles with lane rolls; here a warp inserts the rare candidate
// that enters the list.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXK = 128;
constexpr int SLOTS = MAXK / 32;  // list slots per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  // (va, ia) strictly precedes (vb, ib) in (score desc, row asc) order
  return va > vb || (va == vb && ia < ib);
}

// A list entry as one 64-bit key whose unsigned order is the lists'
// (score desc, row asc) order; 0 is no key.
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

// As warp_offer, but every candidate that beats the threshold goes in at
// once, by rank: a candidate lands after the list entries and the other
// candidates that beat it, and a list entry moves down by the number of
// candidates that beat it; what lands past k drops out. A list that is
// still filling takes most of a warp's candidates at every offer, and then
// this costs one pass over them instead of one insertion each.
__device__ __forceinline__ void warp_offer_batch(float* lv, int* li, int k,
                                                 float v, int r, float& tv,
                                                 int& ti, int lane) {
  const bool pass = beats(v, r, tv, ti);
  const unsigned m = __ballot_sync(FULL, pass);
  if (!m) return;
  if (!(m & (m - 1))) {  // one candidate: the plain insertion
    const int src = __ffs(m) - 1;
    warp_insert(lv, li, k, __shfl_sync(FULL, v, src),
                __shfl_sync(FULL, r, src), lane);
  } else {
    int pos = 0;  // list entries ahead of this lane's candidate: a prefix
    if (pass) {
      int hi = k;
      while (pos < hi) {
        const int mid = (pos + hi) >> 1;
        if (beats(lv[mid], li[mid], v, r)) pos = mid + 1;
        else hi = mid;
      }
    }
    float ov[SLOTS];
    int oi[SLOTS], shift[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int p = lane + 32 * s;
      ov[s] = p < k ? lv[p] : -INFINITY;
      oi[s] = p < k ? li[p] : -1;
      shift[s] = 0;
    }
    for (unsigned mm = m; mm; mm &= mm - 1) {  // warp-uniform
      const int src = __ffs(mm) - 1;
      const float cv = __shfl_sync(FULL, v, src);
      const int cr = __shfl_sync(FULL, r, src);
      if (pass && beats(cv, cr, v, r)) ++pos;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (beats(cv, cr, ov[s], oi[s])) ++shift[s];
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int p = lane + 32 * s + shift[s];
      if (lane + 32 * s < k && p < k) {
        lv[p] = ov[s];
        li[p] = oi[s];
      }
    }
    if (pass && pos < k) {
      lv[pos] = v;
      li[pos] = r;
    }
    __syncwarp();
  }
  tv = lv[k - 1];
  ti = li[k - 1];
}

}  // namespace
