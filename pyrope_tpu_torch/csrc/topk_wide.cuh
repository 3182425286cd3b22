// Wide sorted top-k lists (k above MAXK = 128 of topk_warp.cuh, any k),
// shared by the scan kernels' wide instantiations and the wide merge
// kernel's in-place path.
//
// Replaces, of pyrope_tpu/ops/pallas_scan.py, the running top-k of every
// scan kernel above RANK_MERGE_MAX_K: _wide_params (:372), the bitonic tile
// top-kpad merged into the run (_bitonic_merge_wide :192,
// _bitonic_list_merge :173), the extract-max fallback (_merge_tile_wide
// :200) and the dynamic-rounds branch of _merge_tile (:437-475, on
// _extract_top :496). The TPU sorts a whole score tile and merges it into a
// k-slot run held in VMEM at every grid step; a block here cannot hold
// k 10,000 entries a query in shared memory, and most tiles give a list
// nothing once it is full.
//
// Design. A warp owns a list of kw (score, row) entries sorted in the total
// order (score desc, row asc), of which the first `fill` are real; it lives
// in global memory (the kernel's own partial, or its output), so its width
// costs no shared memory. Candidates that beat the list's threshold go into
// a buffer of CAP entries in shared memory, appended in lane order behind
// one vote. When the buffer cannot take the next offer, and at the end, the
// warp sorts it bitonically and merges it into the list in place:
//   1. each buffer entry's place is its index plus the list entries ahead of
//      it (a binary search in the list);
//   2. the list entries from the first of those places on move down by the
//      buffer entries ahead of them (a binary search in the buffer), read and
//      written 32 at a time from the list's end backwards, so that no entry is
//      overwritten before it is read;
//   3. the buffer entries go into their places; what lands past kw drops.
// Entries are distinct (a row enters a list once), so the places are a
// permutation and the merge keeps the total order, ties by row included.
// Once the list holds kw real entries its last one is the threshold (or a
// higher floor the caller keeps). Empty slots are written (-inf, -1) at the
// end, past `fill`.
#pragma once

#include <limits.h>

#include "topk_warp.cuh"

namespace {

// Sort buf[0..m) in the lists' order, the warp together; m <= CAP. Slots m ..
// the next power of two (at least 32) are padded with (-inf, -1).
template <int CAP>
__device__ void warp_sort_buf(float* bv, int* bi, int m, int lane) {
  int p = 32;
  while (p < m) p <<= 1;
  for (int t = m + lane; t < p; t += 32) {
    bv[t] = -INFINITY;
    bi[t] = -1;
  }
  __syncwarp();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride; stride >>= 1) {
      for (int t = lane; t < (p >> 1); t += 32) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int j = i + stride;
        const bool down = (i & size) == 0;   // this run ends best first
        const float vi = bv[i], vj = bv[j];
        const int ri = bi[i], rj = bi[j];
        if (beats(vj, rj, vi, ri) == down) {
          bv[i] = vj;
          bi[i] = rj;
          bv[j] = vi;
          bi[j] = ri;
        }
      }
      __syncwarp();
    }
  }
}

// Merge the sorted run (bv, bi)[0..m), 1 <= m <= CAP, into the sorted list
// (lv, li) of width kw holding `fill` real entries, in place; the warp
// together. Returns the list's new fill.
template <int CAP>
__device__ int warp_merge_run(float* lv, int* li, int kw, int fill,
                              const float* bv, const int* bi, int m, int lane) {
  constexpr int S = CAP / 32;
  int dst[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int t = lane + 32 * s;
    dst[s] = INT_MAX;
    if (t < m) {
      const float v = bv[t];
      const int r = bi[t];
      int lo = 0, hi = fill;   // list entries ahead of (v, r)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (beats(lv[mid], li[mid], v, r)) lo = mid + 1;
        else hi = mid;
      }
      dst[s] = t + lo;
    }
  }
  const int r0 = __shfl_sync(FULL, dst[0], 0);   // the run's best entry's place
  __syncwarp();
  for (int top = min(fill, kw); top > r0; top -= 32) {
    const int j = top - 32 + lane;
    int dest = -1;
    float v = 0.f;
    int r = 0;
    if (j >= r0) {
      v = lv[j];
      r = li[j];
      int lo = 0, hi = m;   // run entries ahead of (v, r)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (beats(bv[mid], bi[mid], v, r)) lo = mid + 1;
        else hi = mid;
      }
      dest = j + lo;
    }
    __syncwarp();
    if (dest >= 0 && dest < kw) {
      lv[dest] = v;
      li[dest] = r;
    }
    __syncwarp();
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int t = lane + 32 * s;
    if (t < m && dst[s] < kw) {
      lv[dst[s]] = bv[t];
      li[dst[s]] = bi[t];
    }
  }
  __syncwarp();
  return min(fill + m, kw);
}

// A list entry; as a threshold, the entry a candidate must beat.
struct Entry {
  float v;
  int r;
};

// A wide list's state in shared memory beside its buffer.
struct WideState {
  int cnt;    // entries in the buffer
  int fill;   // real entries in the list
};

// Sort the buffer of *cnt entries and merge it into the list of *fill real
// entries; the buffer is left empty. (Several buffers may feed one list, one
// flush at a time: cnt and fill need not be one WideState's.)
template <int CAP>
__device__ __noinline__ void wide_flush(float* lv, int* li, int kw, float* bv,
                                        int* bi, int* cnt, int* fill, int lane) {
  const int m = *cnt;
  if (m > 0) {
    warp_sort_buf<CAP>(bv, bi, m, lane);
    const int f = warp_merge_run<CAP>(lv, li, kw, *fill, bv, bi, m, lane);
    __syncwarp();
    if (lane == 0) {
      *fill = f;
      *cnt = 0;
    }
  }
  __syncwarp();
}

// The threshold a full list gives, if it beats (tv, ti).
__device__ __forceinline__ void wide_threshold(const float* lv, const int* li,
                                               int kw, int fill, float& tv,
                                               int& ti) {
  if (fill >= kw) {
    const float v = lv[kw - 1];
    const int r = li[kw - 1];
    if (beats(v, r, tv, ti)) {
      tv = v;
      ti = r;
    }
  }
}

// Offer every lane's candidate (v, r) to one wide list whose threshold is
// (tv, ti); the whole warp calls it. Returns the threshold, raised when a
// flush filled the list. At most 32 candidates go in a call, so the buffer
// is flushed first when it has fewer free slots than pass.
template <int CAP>
__device__ __noinline__ Entry wide_offer(float* lv, int* li, int kw, float* bv,
                                         int* bi, WideState* st, float v, int r,
                                         float tv, int ti, int lane) {
  bool pass = beats(v, r, tv, ti);
  unsigned m = __ballot_sync(FULL, pass);
  if (!m) return {tv, ti};
  if (st->cnt + __popc(m) > CAP) {
    wide_flush<CAP>(lv, li, kw, bv, bi, &st->cnt, &st->fill, lane);
    wide_threshold(lv, li, kw, st->fill, tv, ti);
    pass = beats(v, r, tv, ti);
    m = __ballot_sync(FULL, pass);
  }
  const int cnt = st->cnt;
  if (pass) {
    const int p = cnt + __popc(m & ((1u << lane) - 1));
    bv[p] = v;
    bi[p] = r;
  }
  __syncwarp();
  if (lane == 0) st->cnt = cnt + __popc(m);
  __syncwarp();
  return {tv, ti};
}

// Append without a flush: the caller keeps at least popc(pass) slots free.
__device__ __forceinline__ void wide_append(float* bv, int* bi, int* st_cnt,
                                            bool pass, float v, int r,
                                            int lane) {
  const unsigned m = __ballot_sync(FULL, pass);
  if (!m) return;
  const int cnt = *st_cnt;
  if (pass) {
    const int p = cnt + __popc(m & ((1u << lane) - 1));
    bv[p] = v;
    bi[p] = r;
  }
  __syncwarp();
  if (lane == 0) *st_cnt = cnt + __popc(m);
  __syncwarp();
}

// The list's slots past its fill become (-inf, -1).
__device__ __forceinline__ void wide_pad(float* lv, int* li, int kw, int fill,
                                         int lane) {
  for (int p = fill + lane; p < kw; p += 32) {
    lv[p] = -INFINITY;
    li[p] = -1;
  }
}

}  // namespace
