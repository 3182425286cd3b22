// The floor select of the wide scans' first pass, for Hopper (sm_90a), CUDA
// C++: each query's g-th largest published entry, on the device, with no
// host sync.
//
// Replaces no TPU kernel of its own: it is a step of the wide modes'
// redesign (the TPU kernels' wide merges, pyrope_tpu/ops/pallas_scan.py
// _wide_params :372, _bitonic_merge_wide :192, _merge_tile_wide :200,
// _extract_top :496, run at k > 128 in pallas_flat_topk :672 and
// pallas_ivf_topk :1035 / pallas_ivf_sq8_topk :1204).
//
// What it computes. A wide scan's first pass is a narrow launch of the same
// scan kernel at k = c <= 128 (fused_scan_kernel<BT, IP, false>,
// ivf_list_scan_kernel<MODE, false>) that publishes the c-th entry of each
// of a query's splits or partial slots. Splits and slots hold disjoint real
// rows, so the g-th largest of those entries, g = ceil(k / c), has g * c >=
// k rows at or above it: no row under it is a hit. This kernel takes that
// g-th largest for each query:
//   flat scan:  vals [B, S] float scores (-inf: nothing published), out [B]
//               float (-inf: fewer than g published);
//   list scan:  vals the [nslots] 64-bit keys of the slots (floor_key order,
//               0: nothing published), a query's slots qend[b - 1][P - 1] ..
//               qend[b][P - 1]; out[b] = max(base[b], the g-th largest key),
//               base the first pass's own query floor keys (0: none).
// It reads the first FS_CAP of a query's entries: the g-th largest of a
// subset is at most that of all, so still a floor. One block a query: the
// entries into shared memory, then each thread counts, for each of its
// entries, the entries at or above it (stopping at g); an entry with g at or
// above it is a candidate, and the largest candidate is the g-th largest
// (equal scores count with their multiplicity, as the rows behind them do).
// At the shapes it sees (at most a few hundred entries a query) it is bound
// by its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FS_THREADS = 128;
constexpr int FS_CAP = 2048;   // entries a query read at most

constexpr unsigned FS_FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T none_value();
template <>
__device__ __forceinline__ float none_value<float>() { return -INFINITY; }
template <>
__device__ __forceinline__ unsigned long long none_value<unsigned long long>() {
  return 0ull;
}

template <typename T>
__global__ void __launch_bounds__(FS_THREADS)
floor_select_kernel(const T* __restrict__ vals, int B, int S,
                    const int32_t* __restrict__ qend, int P, int g,
                    const T* __restrict__ base, T* __restrict__ out) {
  __shared__ T v[FS_CAP];
  __shared__ T best[FS_THREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = qend ? (b ? min(qend[(size_t)b * P - 1], S) : 0) : b * S;
  const int hi = qend ? min(qend[(size_t)b * P + P - 1], S) : lo + S;
  const int m = min(max(hi - lo, 0), FS_CAP);
  for (int i = tid; i < m; i += FS_THREADS) v[i] = vals[lo + i];
  __syncthreads();
  T mine = none_value<T>();
  if (g <= m) {
    for (int i = tid; i < m; i += FS_THREADS) {
      const T x = v[i];
      if (!(x > mine)) continue;   // only a larger entry can raise the result
      int ge = 0;
      for (int j = 0; j < m && ge < g; ++j) ge += v[j] >= x;
      if (ge >= g) mine = x;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const T o = __shfl_xor_sync(FS_FULL, mine, off);
    mine = o > mine ? o : mine;
  }
  if (lane == 0) best[warp] = mine;
  __syncthreads();
  if (tid == 0) {
    T r = best[0];
    for (int w = 1; w < FS_THREADS / 32; ++w) r = best[w] > r ? best[w] : r;
    if (base && base[b] > r) r = base[b];
    out[b] = r;
  }
}

}  // namespace

extern "C" {

// The flat scan's first pass: pub [B, S] float scores -> out [B], each row's
// g-th largest (-inf where fewer than g splits published). g >= 1.
int pyrope_floor_select_flat(const void* pub, int B, int S, int g, void* out,
                             void* stream) {
  if (B < 0 || S < 1 || g < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  floor_select_kernel<float><<<B, FS_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pub, B, S, nullptr, 0, g, nullptr, (float*)out);
  return (int)cudaGetLastError();
}

// The list scan's first pass: keys [nslots] (the slots' published keys),
// qend [B, P] int32 (the running slot counts), base [B] the first pass's
// query floor keys -> out [B] = max(base, g-th largest of the query's slot
// keys). out may not alias keys or base.
int pyrope_floor_select_list(const void* keys, int nslots, const void* qend, int B,
                             int P, int g, const void* base, void* out, void* stream) {
  if (B < 0 || nslots < 0 || P < 1 || g < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  floor_select_kernel<unsigned long long><<<B, FS_THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, B, nslots, (const int32_t*)qend, P, g,
      (const unsigned long long*)base, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
