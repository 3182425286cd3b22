// The list scan's work tables on the device, for Hopper (sm_90a), CUDA C++:
// the probe lists inverted (pairs grouped by cluster), the item table and
// the pairs' partial slots, in two launches of one kernel and no host sync.
//
// Replaces, of the JAX package, the set-up of the one jitted dispatch that
// runs K2/K3 (and K4/K5): pyrope_tpu/index/ivf_flat.py probed_table_t (:224,
// the [B, Kp] probed-cluster table) and pyrope_tpu/ops/pallas_scan.py
// tile_cluster_windows (:841, each row tile's cluster window). The port's
// list scan (ivf_list_scan.cu, ivf_list_scan_tc.cu) reads the probes
// inverted instead: each probed cluster's rows are scanned once, for the
// queries that probe it. Its plain version is ops/fused_scan.py
// invert_probes_plain (a sort, two searchsorted, cumsums, a take: some
// twenty small torch launches, whose enqueue cost more host time than the
// list scan's device time at serving batches).
//
// What it writes, from probe [B, P] (int64 or int32; each row names distinct
// clusters < kp) and lens [kp] int32, bit-equal to the plain version:
//   pairs    [B*P]  pair ids j = b*P + p grouped by cluster, in query order
//                   within a cluster;
//   cstart   [kp]   each cluster's first pair;  ccnt [kp] its pairs;
//   item_end [kp]   the inclusive prefix sum of items, ceil(ccnt / chunk) *
//                   nseg, nseg = ceil(lens / seg);
//   item_c   [grid] the cluster of each list-scan block (kp past the last);
//   slot_end [B*P]  the row-major inclusive sum of nseg[probe];
// and zeroes the call's published keys (keys [n_keys] 64-bit), which the
// list scan's blocks raise from 0.
//
// Design. Queries go in tiles of 64 (IT_TILE), one block a tile. Since a
// query probes a cluster at most once, a pair's place in its cluster is the
// number of pairs of lower clusters plus the number of earlier queries that
// probe the same cluster. Pass 1: each tile block sets, for each cluster,
// one bit a query of the tile that probes it (mask[t][c], a 64-bit word;
// atomicOr, whose order leaves no trace: the word is the same whatever
// order the bits arrive in) and sums its pairs' segments (tsum[t]); extra
// blocks zero the keys. Pass 2: each tile block reads every tile's masks
// (T x kp words, L2-resident at the shapes the list scan sees: T <= 64,
// kp <= a few thousand) and scans them by cluster in chunks of the block:
// cstart, ccnt and item_end (written by block 0), its own tile's base a
// cluster (cstart plus the earlier tiles' bits), item_c for the clusters
// c = t (mod T); then places its tile's pairs (base plus the bits of
// earlier queries of its tile in the mask: a popcount) and scans their
// segments for slot_end from the earlier tiles' tsum. No atomic decides a
// place, so every table is the same on every run. 32-bit counts suffice:
// B*P < 2^31 (the wrapper checks), where the plain version needs 64-bit
// sort keys from (kp + 1) * B >= 2^31 on.
//
// Bound. It moves probe (B*P ids), writes pairs and slot_end (B*P each),
// three kp tables, item_c and the keys; at B*P = 393,216 (b4096 np96) about
// 6 MB, ~2 us at 3.35 TB/s. Its time is its two launches and each pass-2
// block's T x kp reads of the masks (25-130 KB from L2 at the main shapes).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int IT_THREADS = 512;
constexpr int IT_TILE = 64;          // queries a tile: one 64-bit mask word a cluster
constexpr int IT_WARPS = IT_THREADS / 32;
constexpr int IT_ZERO_BLOCKS = 264;  // at most this many blocks zero the keys
constexpr unsigned IT_FULL = 0xffffffffu;

__host__ __device__ __forceinline__ long long it_round16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// scratch: mask [T][kp] u64, base [T][kp] i32, tsum [T] i64, each 16-byte aligned
__host__ __device__ __forceinline__ long long it_scratch_bytes(int B, int kp) {
  const long long t = (B + IT_TILE - 1) / IT_TILE;
  return it_round16(t * kp * 8) + it_round16(t * kp * 4) + it_round16(t * 8);
}

// inclusive block scan of v over the block's threads; every thread gets its
// prefix and the block's total. Ends with the block synced.
__device__ __forceinline__ long long block_scan(long long v, long long* warp_sums,
                                                long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(IT_FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < IT_WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(IT_FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < IT_WARPS) warp_sums[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  const long long before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[IT_WARPS - 1];
  __syncthreads();   // warp_sums is reused by the next scan
  return before + x;
}

template <typename P_T>
__global__ void __launch_bounds__(IT_THREADS)
invert_probes_kernel(int pass, const P_T* __restrict__ probe, const int32_t* __restrict__ lens,
                     int B, int P, int kp, int seg, int chunk, int grid,
                     int32_t* __restrict__ pairs, int32_t* __restrict__ cstart,
                     int32_t* __restrict__ ccnt, int32_t* __restrict__ item_end,
                     int32_t* __restrict__ item_c, int32_t* __restrict__ slot_end,
                     unsigned long long* __restrict__ mask, int32_t* __restrict__ tbase,
                     long long* __restrict__ tsum, unsigned long long* __restrict__ keys,
                     long long n_keys) {
  __shared__ long long warp_sums[IT_WARPS];
  const int T = (B + IT_TILE - 1) / IT_TILE;
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  if (pass == 1 && t >= T) {   // the keys' blocks
    const long long stride = (long long)(gridDim.x - T) * IT_THREADS;
    for (long long i = (long long)(t - T) * IT_THREADS + tid; i < n_keys; i += stride)
      keys[i] = 0ull;
    return;
  }
  const int q0 = t * IT_TILE;
  const int np = (min(B, q0 + IT_TILE) - q0) * P;      // the tile's pairs
  const long long j0 = (long long)q0 * P;
  unsigned long long* my_mask = mask + (size_t)t * kp;
  int32_t* my_base = tbase + (size_t)t * kp;

  if (pass == 1) {
    for (int c = tid; c < kp; c += IT_THREADS) my_mask[c] = 0ull;
    __syncthreads();
    long long segs = 0;
    for (int e = tid; e < np; e += IT_THREADS) {
      const long long j = j0 + e;
      const long long c = (long long)probe[j];
      if (c < 0 || c >= kp) continue;   // outside the table: no pair, no slot
      const int bit = (int)(j / P) - q0;
      atomicOr(my_mask + c, 1ull << bit);
      segs += (lens[c] + seg - 1) / seg;
    }
    long long total;
    block_scan(segs, warp_sums, &total);
    if (tid == 0) tsum[t] = total;
    return;
  }

  // pass 2: the cluster tables, by chunks of the block's threads
  long long carry_pairs = 0, carry_items = 0;
  for (int c0 = 0; c0 < kp; c0 += IT_THREADS) {
    const int c = c0 + tid;
    const bool ok = c < kp;
    long long tot = 0, pre = 0, items = 0;
    if (ok) {
      for (int u = 0; u < T; ++u) {
        const int n = __popcll(mask[(size_t)u * kp + c]);
        tot += n;
        pre += u < t ? n : 0;
      }
      const long long ns = (lens[c] + seg - 1) / seg;
      items = (tot + chunk - 1) / chunk * ns;
    }
    long long sum_pairs, sum_items;
    const long long first = carry_pairs + block_scan(tot, warp_sums, &sum_pairs) - tot;
    const long long iend = carry_items + block_scan(items, warp_sums, &sum_items);
    if (ok) {
      my_base[c] = (int32_t)(first + pre);
      if (t == 0) {
        cstart[c] = (int32_t)first;
        ccnt[c] = (int32_t)tot;
        item_end[c] = (int32_t)iend;
      }
      if (c % T == t)
        for (long long i = iend - items; i < iend && i < grid; ++i) item_c[i] = c;
    }
    carry_pairs += sum_pairs;
    carry_items += sum_items;
  }
  for (long long i = carry_items + (long long)t * IT_THREADS + tid; i < grid;
       i += (long long)T * IT_THREADS)
    item_c[i] = kp;   // past the last item: the block exits
  // the tile's slot base: every earlier tile's segments
  long long before = 0;
  for (int u = tid; u < t; u += IT_THREADS) before += tsum[u];
  long long base_slots;
  block_scan(before, warp_sums, &base_slots);
  __syncthreads();   // my_base, written above by other threads of the block
  long long carry_slots = base_slots;
  for (int e0 = 0; e0 < np; e0 += IT_THREADS) {
    const int e = e0 + tid;
    const long long j = j0 + e;
    long long c = -1, ns = 0;
    if (e < np) {
      c = (long long)probe[j];
      if (c >= 0 && c < kp) ns = (lens[c] + seg - 1) / seg;
      else c = -1;
    }
    long long sum;
    const long long incl = block_scan(ns, warp_sums, &sum);
    if (e < np) {
      slot_end[j] = (int32_t)(carry_slots + incl);
      if (c >= 0) {
        const int bit = (int)(j / P) - q0;
        const unsigned long long earlier = my_mask[c] & ((1ull << bit) - 1ull);
        pairs[my_base[c] + __popcll(earlier)] = (int32_t)j;
      }
    }
    carry_slots += sum;
  }
}

}  // namespace

extern "C" {

// Bytes of the scratch the two passes share (the tile masks, bases and
// segment sums); the wrapper's invert_scratch_bytes computes the same.
long long pyrope_invert_scratch_bytes(int B, int kp) {
  return it_scratch_bytes(B, kp);
}

// probe [B, P] (probe64: int64, else int32), lens [kp] int32, segments of
// seg rows, chunks of chunk queries, grid list-scan blocks; the tables as
// ops/fused_scan.py ListWork names them, scratch of
// pyrope_invert_scratch_bytes(B, kp) bytes, and keys [n_keys] 64-bit zeroed
// (null when n_keys is 0). Two launches on the stream, no sync.
int pyrope_invert_probes(const void* probe, int probe64, const void* lens, int B, int P,
                         int kp, int seg, int chunk, int grid, void* pairs, void* cstart,
                         void* ccnt, void* item_end, void* item_c, void* slot_end,
                         void* scratch, void* keys, long long n_keys, void* stream) {
  if (B < 1 || P < 1 || kp < 1 || seg < 1 || chunk < 1 || grid < 0 || n_keys < 0 ||
      (long long)B * P > INT_MAX || (n_keys > 0 && keys == nullptr))
    return (int)cudaErrorInvalidValue;
  const int T = (B + IT_TILE - 1) / IT_TILE;
  const long long mask_bytes = it_round16((long long)T * kp * 8);
  const long long base_bytes = it_round16((long long)T * kp * 4);
  auto* mask = (unsigned long long*)scratch;
  auto* tbase = (int32_t*)((char*)scratch + mask_bytes);
  auto* tsum = (long long*)((char*)scratch + mask_bytes + base_bytes);
  const long long want = (n_keys + IT_THREADS * 4 - 1) / (IT_THREADS * 4);
  const int zero_blocks = (int)(want < IT_ZERO_BLOCKS ? want : IT_ZERO_BLOCKS);
  cudaStream_t s = (cudaStream_t)stream;
  for (int pass = 1; pass <= 2; ++pass) {
    const int blocks = pass == 1 ? T + zero_blocks : T;
    if (probe64)
      invert_probes_kernel<long long><<<blocks, IT_THREADS, 0, s>>>(
          pass, (const long long*)probe, (const int32_t*)lens, B, P, kp, seg, chunk, grid,
          (int32_t*)pairs, (int32_t*)cstart, (int32_t*)ccnt, (int32_t*)item_end,
          (int32_t*)item_c, (int32_t*)slot_end, mask, tbase, tsum,
          (unsigned long long*)keys, n_keys);
    else
      invert_probes_kernel<int32_t><<<blocks, IT_THREADS, 0, s>>>(
          pass, (const int32_t*)probe, (const int32_t*)lens, B, P, kp, seg, chunk, grid,
          (int32_t*)pairs, (int32_t*)cstart, (int32_t*)ccnt, (int32_t*)item_end,
          (int32_t*)item_c, (int32_t*)slot_end, mask, tbase, tsum,
          (unsigned long long*)keys, n_keys);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
