// The wide scans' first-pass floor select: a query's g-th largest published
// entry, by one warp. Shared by the flat scans' first passes
// (fused_scan_kernel<BT, IP, false>, flat_scan_tc_kernel<NC, IP, false>),
// which take their floors in their own launch (flat_pass_floors below), and
// the list scans' floor select kernel (prefloor.cu), which runs after their
// first passes.
//
// What it computes is the plain version's, ops/fused_scan.floor_select_plain:
// over the first FS_CAP entries a query has published, the g-th largest real
// entry (equal entries count with their multiplicity, as the rows behind them
// do), none where fewer than g are real.
//
// The selection. Entries become 64-bit keys whose unsigned order is the
// entries' (the list scan's floor keys as they are, floor_key's; flat scores
// as order-preserving bits), 0 for none. The warp counts the real keys,
// takes their max and min (a warp reduction each), and finds the largest t
// with at least g keys >= t bit by bit from the highest bit where max and
// min differ (the bits above are common to all); each round counts the keys
// >= the candidate (one compare a key a lane, one __reduce_add_sync). When
// exactly g keys lie at or above the prefix found, the answer is their least
// (one min reduction), and the rounds stop: for distinct keys (the list
// scan's rows) that happens within the score's bits.
//
// The flat pass's floors in its own launch. A split block publishes its
// queries' c-th scores, meets at a barrier, and adds one to its query tile's
// count with an acquire-release atomic (a split block covers the tile's
// queries together); the split that completes the count takes each of the
// tile's floors, one warp a query: every score is then final and visible,
// whatever order the splits ran in, so the floors are the plain version's to
// the bit. The counts lie after the published scores in the same -inf fill,
// so they start at -inf's bits and need no launch of their own, and nothing
// outlives the call. The list scans keep a launch of their own (prefloor.cu):
// there the item that completes a query is, for most of them, one of the
// highest cluster's, so one block took most of its chunk's 64 floors in turn
// and held the first pass's end up (PERF.md, Findings).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FS_CAP = 2048;   // a query's entries read at most (FLOOR_SELECT_CAP)
constexpr unsigned FT_FULL = 0xffffffffu;

// flat scores as keys: the unsigned order of the bits is the float order
// (-0 as +0); 0 for none (-inf)
__device__ __forceinline__ unsigned long long score_key(float v) {
  if (!(v > -INFINITY)) return 0ull;
  const unsigned u = __float_as_uint(v + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  if (!key) return -INFINITY;
  const unsigned u = (unsigned)key;
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned long long warp_max64(unsigned long long x) {
  const unsigned hi = __reduce_max_sync(FT_FULL, (unsigned)(x >> 32));
  const unsigned lo = __reduce_max_sync(FT_FULL, (unsigned)(x >> 32) == hi ? (unsigned)x : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ unsigned long long warp_min64(unsigned long long x) {
  const unsigned hi = __reduce_min_sync(FT_FULL, (unsigned)(x >> 32));
  const unsigned lo =
      __reduce_min_sync(FT_FULL, (unsigned)(x >> 32) == hi ? (unsigned)x : 0xffffffffu);
  return ((unsigned long long)hi << 32) | lo;
}

// The g-th largest of a warp's keys (0: none), by the whole warp; 0 where
// fewer than g are real. each(f) calls f on every key the lane holds.
template <class Each>
__device__ __forceinline__ unsigned long long warp_gth_key(Each each, int g) {
  int n = 0;
  unsigned long long mx = 0ull, mn = ~0ull;
  each([&](unsigned long long x) {
    if (x) {
      ++n;
      mx = x > mx ? x : mx;
      mn = x < mn ? x : mn;
    }
  });
  n = __reduce_add_sync(FT_FULL, n);
  if (n < g) return 0ull;
  mx = warp_max64(mx);
  mn = warp_min64(mn);
  if (mx == mn) return mx;
  const int top = 63 - __clzll((long long)(mx ^ mn));
  // every real key shares the bits above `top` with mx, and lies at or above them
  unsigned long long r = top == 63 ? 0ull : mx & ~((2ull << top) - 1);
  int at = n;   // keys >= r
  for (int bit = top; bit >= 0 && at != g; --bit) {
    const unsigned long long cand = r | (1ull << bit);
    int c = 0;
    each([&](unsigned long long x) { c += x >= cand; });
    c = __reduce_add_sync(FT_FULL, c);
    if (c >= g) {
      r = cand;
      at = c;
    }
  }
  if (at != g) return r;   // every bit decided: r is the g-th largest key
  // the g keys at or above r are the g largest: the least of them
  unsigned long long least = ~0ull;
  each([&](unsigned long long x) {
    if (x && x >= r && x < least) least = x;
  });
  return warp_min64(least);
}

// warp_gth_key over m keys load(j), j < m, a lane's j = lane, lane + 32, ...
template <class Load>
__device__ __forceinline__ unsigned long long warp_gth_loaded(Load load, int m, int g,
                                                              int lane) {
  return warp_gth_key(
      [&](auto f) {
        for (int j = lane; j < m; j += 32) f(load(j));
      },
      g);
}

// The flat scans' first pass (nthreads a block; pub [B, S], the block's
// query tile q0 .. q0 + nq): one arrival on the tile's count, whose bits
// start as -inf's (the fill of pub); the split that completes it takes
// each query's g-th largest score into fout, a warp a query, the scores
// staged in buf (cap keys a warp) where they fit, else read from L2 every
// round. Out of line: its code stays out of the scan loop's registers.
__device__ __noinline__ void flat_pass_floors(const float* pub, int S, int q0, int nq,
                                              unsigned* cnt, float* fout, int g,
                                              unsigned long long* buf, int cap, int nthreads) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();   // every publication of the split, before its arrival
  bool last = false;
  if (tid == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(cnt) : "memory");
    last = old - __float_as_uint(-INFINITY) + 1 == (unsigned)S;
  }
  // thread 0's answer to the block by the barrier itself: no static shared
  // memory beside the kernels' dynamic layouts
  if (!__syncthreads_or(last)) return;
  const int m = min(S, FS_CAP);
  unsigned long long* wbuf = buf + (size_t)warp * cap;
  for (int i = warp; i < nq; i += nthreads / 32) {
    const float* src = pub + (size_t)(q0 + i) * S;
    unsigned long long key;
    if (m <= cap) {
      for (int j = lane; j < m; j += 32) wbuf[j] = score_key(__ldcg(src + j));
      __syncwarp();
      key = warp_gth_loaded([&](int j) { return wbuf[j]; }, m, g, lane);
      __syncwarp();   // wbuf is free for the warp's next query
    } else {
      key = warp_gth_loaded([&](int j) { return score_key(__ldcg(src + j)); }, m, g, lane);
    }
    if (lane == 0) fout[q0 + i] = key_score(key);
  }
}

}  // namespace
