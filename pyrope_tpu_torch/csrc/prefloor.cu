// The floor select of the wide list scans' first pass, for Hopper (sm_90a),
// CUDA C++: each query's g-th largest published slot key, on the device,
// with no host sync.
//
// Replaces no TPU kernel of its own: it is a step of the wide modes'
// redesign (the TPU kernels' wide merges, pyrope_tpu/ops/pallas_scan.py
// _wide_params :372, _bitonic_merge_wide :192, _merge_tile_wide :200,
// _extract_top :496, run at k > 128 in pallas_ivf_topk :1035 /
// pallas_ivf_sq8_topk :1204), and of the tensor-core list scan's floor.
//
// What it computes. A list scan's first pass (ivf_list_scan_kernel<MODE,
// false> or ivf_list_scan_tc_kernel at k = c <= 128) publishes the c-th key
// of each of a query's partial slots (floor_key order, 0: nothing
// published), a query's slots qend[b - 1][P - 1] .. qend[b][P - 1]. Slots
// hold disjoint real rows, so the g-th largest key, g = ceil(k / c), has
// g * c >= k rows at or above it: no row under it is a hit. out[b] =
// max(base[b], that key), base the first pass's own query floor keys (0:
// none). It reads the first FS_CAP of a query's keys: the g-th largest of a
// subset is at most that of all, so still a floor. The flat scan's first
// pass takes its floors in its own launch (floor_tail.cuh); the list scans'
// in theirs measured slower (PERF.md: the item that completes a query is
// mostly one of the highest cluster's, so a few blocks took most floors in
// turn at the pass's end).
//
// Design (the first form took a block of 128 threads a query and counted,
// for each key, the keys at or above it, O(m * g): 0.0266 ms at 1024
// queries x 96 keys, g 72, on an H100). One warp a query, eight a
// block: up to 256 keys a query lie in registers, 8 a lane, and the warp
// finds the g-th largest bit by bit (floor_tail.cuh warp_gth_key: a compare
// a key and a __reduce_add_sync a round, stopping where exactly g keys lie
// at or above the prefix); a query with more keys reads them from L2 every
// round. It is bound by its launch at the shapes it sees.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "floor_tail.cuh"

namespace {

constexpr int FS_WARPS = 8;   // queries a block
constexpr int FS_REG = 8;     // keys a lane holds: 256 a query in registers

__global__ void __launch_bounds__(FS_WARPS * 32)
floor_select_list_kernel(const unsigned long long* __restrict__ keys, int nslots,
                         const int32_t* __restrict__ qend, int B, int P, int g,
                         const unsigned long long* __restrict__ base,
                         unsigned long long* __restrict__ out) {
  const int b = blockIdx.x * FS_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;   // a whole warp
  const int lane = threadIdx.x & 31;
  const int lo = b ? min(qend[(size_t)b * P - 1], nslots) : 0;
  const int hi = min(qend[(size_t)b * P + P - 1], nslots);
  const int m = min(max(hi - lo, 0), FS_CAP);
  const unsigned long long* src = keys + lo;
  unsigned long long got;
  if (m <= 32 * FS_REG) {
    unsigned long long r[FS_REG];
#pragma unroll
    for (int e = 0; e < FS_REG; ++e) r[e] = lane + 32 * e < m ? src[lane + 32 * e] : 0ull;
    got = warp_gth_key(
        [&](auto f) {
#pragma unroll
          for (int e = 0; e < FS_REG; ++e) f(r[e]);
        },
        g);
  } else {
    got = warp_gth_loaded([&](int j) { return src[j]; }, m, g, lane);
  }
  if (lane == 0) {
    const unsigned long long f = base ? base[b] : 0ull;
    out[b] = f > got ? f : got;
  }
}

}  // namespace

extern "C" {

// keys [nslots] (the slots' published keys), qend [B, P] int32 (the running
// slot counts), base [B] the first pass's query floor keys or null -> out
// [B] = max(base, the g-th largest of the query's slot keys). out may not
// alias keys or base.
int pyrope_floor_select_list(const void* keys, int nslots, const void* qend, int B, int P,
                             int g, const void* base, void* out, void* stream) {
  if (B < 0 || nslots < 0 || P < 1 || g < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  floor_select_list_kernel<<<(B + FS_WARPS - 1) / FS_WARPS, FS_WARPS * 32, 0,
                             (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, nslots, (const int32_t*)qend, B, P, g,
      (const unsigned long long*)base, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
