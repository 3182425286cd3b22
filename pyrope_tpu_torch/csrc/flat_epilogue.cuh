// The flat scans' epilogue pieces, shared by the fp32 scan (fused_scan.cu,
// fused_scan_kernel) and the bf16 tensor-core scan (flat_scan_tc.cu,
// flat_scan_tc_kernel): the list insertion, the publication of a split's
// c-th score and the floor read off what a query's splits have published.
// The block layouts differ; in both a warp owns its queries' lists, so these
// run on one warp with no block barrier. See fused_scan.cu's header for the
// shared floor and the filtered epilogue.
#pragma once

#include <limits.h>

#include "topk_warp.cuh"
#include "topk_wide.cuh"

namespace {

constexpr int FLOOR_BATCH = 4;   // queries whose published scores load together
constexpr int WIN = 32;          // splits whose published entries a warp reads
constexpr int WIDE_BT = 64;      // the wide mode's query tile
constexpr int FLAT_CAP = 256;    // the wide mode's candidate buffer, a query
constexpr int FLAT_SMALL_CAP = 64;  // the fp32 wide mode's, behind a first pass's
                                    // floor: two blocks an SM

// The insertion path, out of line: the epilogue's offer sites hold a call
// each, not the insertion's code. Offers every lane's (v, r) to one list
// whose threshold is (tv, ti), and returns the list's last entry.
__device__ __noinline__ Entry offer(float* lv, int* li, int k, float v, int r,
                                    float tv, int ti, int lane) {
  if (k <= 32) {
    // one list entry a lane, the list in registers while candidates go in;
    // after each insertion one vote drops every candidate the new last
    // entry has passed
    float ev = lane < k ? lv[lane] : -INFINITY;
    int ei = lane < k ? li[lane] : -1;
    unsigned m = __ballot_sync(FULL, beats(v, r, tv, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      const float cv = __shfl_sync(FULL, v, src);
      const int cr = __shfl_sync(FULL, r, src);
      const int pos = __popc(__ballot_sync(FULL, lane < k && beats(ev, ei, cv, cr)));
      const float pv = __shfl_up_sync(FULL, ev, 1);
      const int pi = __shfl_up_sync(FULL, ei, 1);
      if (lane == pos) {
        ev = cv;
        ei = cr;
      } else if (lane > pos) {
        ev = pv;
        ei = pi;
      }
      const float kv = __shfl_sync(FULL, ev, k - 1);
      const int kr = __shfl_sync(FULL, ei, k - 1);
      m &= ~(1u << src) & __ballot_sync(FULL, beats(v, r, kv, kr));
    }
    if (lane < k) {
      lv[lane] = ev;
      li[lane] = ei;
    }
    __syncwarp();
    return {__shfl_sync(FULL, ev, k - 1), __shfl_sync(FULL, ei, k - 1)};
  }
  warp_offer_batch(lv, li, k, v, r, tv, ti, lane);
  return {tv, ti};
}

// A list's pub_c-th score, when it has risen, goes to the query's row of pub
// for the other splits to read. One lane calls it.
__device__ __noinline__ void publish(const float* lv, float* pubv, float* dst,
                                     int pub_c) {
  const float pv = lv[pub_c - 1];
  if (pv > *pubv) {
    *pubv = pv;
    __stcg(dst, pv);
  }
}

// The floor, from what a query's splits have published: each list publishes
// its pub_c-th score, and the pub_g-th largest of those has pub_g * pub_c >= k
// rows at or above it, so no row under it is a hit. The warp reads a window
// of WIN lists around its own (win0 ..), one a lane, for each of its nq
// queries (rows of pub from b0 on, below B), a few queries' loads in flight,
// and raises the thresholds thv/thi that lie under it.
__device__ __noinline__ void take_floor(const float* pub, int S, int win0,
                                        int b0, int B, int nq, int pub_g,
                                        float* thv, int* thi, int lane) {
  for (int o0 = 0; o0 < nq && b0 + o0 < B; o0 += FLOOR_BATCH) {
    float fk[FLOOR_BATCH];
#pragma unroll
    for (int u = 0; u < FLOOR_BATCH; ++u)
      fk[u] = (b0 + o0 + u < B && win0 + lane < S)
                  ? __ldcg(pub + (size_t)(b0 + o0 + u) * S + win0 + lane)
                  : -INFINITY;
#pragma unroll
    for (int u = 0; u < FLOOR_BATCH; ++u) {
      int ge = 0;   // window entries at or above this lane's
      for (int m = 0; m < WIN; ++m)
        ge += __shfl_sync(FULL, fk[u], m) >= fk[u];
      float t = ge >= pub_g ? fk[u] : -INFINITY;   // the pub_g-th largest
#pragma unroll
      for (int off = 16; off; off >>= 1)
        t = fmaxf(t, __shfl_xor_sync(FULL, t, off));
      // rows scoring t or more stay: (t, INT_MAX) ranks after them all
      if (lane == 0 && t > thv[o0 + u]) {
        thv[o0 + u] = t;
        thi[o0 + u] = INT_MAX;
      }
    }
  }
  __syncwarp();
}

// The window of WIN splits a split reads its floor from.
__device__ __forceinline__ int floor_window(int split, int S) {
  return max(0, min(split & ~(WIN - 1), S - WIN));
}

}  // namespace
