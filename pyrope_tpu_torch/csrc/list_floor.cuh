// The list scans' floor, shared by the CUDA-core list scan
// (ivf_list_scan.cu) and the bf16 one on the tensor cores
// (ivf_list_scan_tc.cu): a partial slot's published key, a query's floor
// taken off a window of its slots' keys, and the threshold a floor key
// gives. See ivf_list_scan.cu's header for the protocol: each slot
// publishes its list's c-th entry (one writer a slot); an item that ends
// raises each of its queries' floor keys (atomicMax) to the g-th largest
// key of a window of FWIN of the query's slots; items read the floor keys
// at their start and at tiles 1, 2, 4, 8, ...
#pragma once

#include "topk_warp.cuh"

namespace {

constexpr int FWIN = 128;        // slots whose published keys a warp reads
constexpr int FPL = FWIN / 32;   // of them a lane
constexpr int FBATCH = 4;        // queries whose keys load together

// A slot's list entry (v, r) is published when it is one of the item's
// own rows (not a copy of the floor, whose row is fr; not empty) and above
// what the slot published last (*last): stored to the slot's key (dst; the
// slot has one writer) or, where g = 1 (c = k: the entry is a floor by
// itself), raised into the query's floor key (qdst) at once. One lane calls
// it: inlined (publish_key_inline) where a call would save registers around
// it, else out of line.
__device__ __forceinline__ void publish_key_inline(float v, int r, int fr,
                                                   unsigned long long* last,
                                                   unsigned long long* dst,
                                                   unsigned long long* qdst) {
  if (r < 0 || r == fr || !(v > -INFINITY)) return;
  const unsigned long long key = floor_key(v, r);
  if (key > *last) {
    *last = key;
    if (qdst) atomicMax(qdst, key);
    else __stcg(dst, key);
  }
}

__device__ __noinline__ void publish_key(float v, int r, int fr, unsigned long long* last,
                                         unsigned long long* dst, unsigned long long* qdst) {
  publish_key_inline(v, r, fr, last, dst, qdst);
}

// The floors of n queries from i0 on: for each, the g-th largest key its
// slots fw0[i] .. fw1[i] (at most FWIN, FPL a lane) have published, into
// fkey[i] (0: fewer than g keys). The warp together, the loads of FBATCH
// queries in flight at once; the g largest keys are taken out one at a time
// (a warp max, then the lane holding it drops it): keys are distinct, since
// slots hold distinct rows.
__device__ __noinline__ void take_floors(const unsigned long long* pub, const int* fw0,
                                         const int* fw1, int i0, int n, int g,
                                         unsigned long long* fkey, int lane) {
  for (int u0 = 0; u0 < n; u0 += FBATCH) {
    unsigned long long key[FBATCH][FPL];
#pragma unroll
    for (int u = 0; u < FBATCH; ++u) {
      const bool in = u0 + u < n;
#pragma unroll
      for (int e = 0; e < FPL; ++e) {
        const int s = in ? fw0[i0 + u0 + u] + lane + 32 * e : 0;
        key[u][e] = (in && s < fw1[i0 + u0 + u]) ? __ldcg(pub + s) : 0ull;
      }
    }
#pragma unroll
    for (int u = 0; u < FBATCH; ++u) {
      if (u0 + u >= n) break;
      unsigned long long t = 0ull;
      int taken = 0;
      for (; taken < g; ++taken) {
        unsigned long long m = 0ull;
#pragma unroll
        for (int e = 0; e < FPL; ++e) m = key[u][e] > m ? key[u][e] : m;
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          const unsigned long long o = __shfl_xor_sync(FULL, m, off);
          m = o > m ? o : m;
        }
        if (!m) break;   // warp-uniform: fewer than g keys
        t = m;
#pragma unroll
        for (int e = 0; e < FPL; ++e)
          if (key[u][e] == m) key[u][e] = 0ull;
      }
      if (lane == 0) fkey[i0 + u0 + u] = taken == g ? t : 0ull;
    }
  }
  __syncwarp();
}

// The floors of queries i0 .. i0 + n - 1 (n <= 32) off their windows, each
// kept as the query's floor key (qfloor[qb[i]], raised with atomicMax) for
// the items that start or read it later. One warp, once the queries' own
// slots have published; nothing where a window never holds g keys or where
// each publication raised the floor key already (g = 1).
__device__ __forceinline__ void warp_share_floors(const unsigned long long* pub,
                                                  unsigned long long* qfloor,
                                                  const int* qb, const int* fw0,
                                                  const int* fw1, int i0, int n, int g,
                                                  unsigned long long* fkey, int lane) {
  if (g == 1 || g > FWIN || n <= 0) return;
  take_floors(pub, fw0, fw1, i0, n, g, fkey, lane);
  if (lane < n && fkey[i0 + lane]) atomicMax(qfloor + qb[i0 + lane], fkey[i0 + lane]);
}

// The window of FWIN of query b's slots lo .. hi (its running slot counts)
// that holds its slot `slot`.
__device__ __forceinline__ void slot_window(const int32_t* slot_end, int b, int P,
                                             int slot, int nslots, int& w0, int& w1) {
  const int lo = b ? slot_end[(size_t)b * P - 1] : 0;
  const int hi = min(slot_end[(size_t)b * P + P - 1], nslots);
  w0 = max(lo, min(lo + ((slot - lo) & ~(FWIN - 1)), hi - FWIN));
  w1 = min(w0 + FWIN, hi);
}

// The entry a row must beat to lie at or above the floor key: the key's own
// entry, or (AT) the entry just after it (row + 1), so that the floor's row
// stays a candidate. (-inf, -1) for no key.
template <bool AT>
__device__ __forceinline__ void floor_threshold(unsigned long long key, float& v, int& r) {
  floor_entry(key, v, r);
  if (AT && key) ++r;
}

// Raise the threshold (tv, ti) to the floor key where that is higher.
template <bool AT>
__device__ __forceinline__ void raise_to(unsigned long long key, float& tv, int& ti) {
  if (!key) return;
  float v;
  int r;
  floor_threshold<AT>(key, v, r);
  if (beats(v, r, tv, ti)) {
    tv = v;
    ti = r;
  }
}

}  // namespace
