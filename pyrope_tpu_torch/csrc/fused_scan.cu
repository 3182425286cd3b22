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
// What bounds it on an H100. The score is a [B, N] x D fp32 product on the
// CUDA cores (67 TFLOP/s fp32 peak at 700 W; exact fp32 rules out the tensor
// cores): at B = 1024, N = 1M, D = 128 that is 268 GFLOP a batch against 0.5
// GB of slab, so the kernel is bound by operations, and its design is that
// of a register-blocked SGEMM whose epilogue is a top-k instead of a store.
// What an SM loses beside the FMAs, in the order measured: shared-memory
// bandwidth (one 128-byte wavefront a clock for all four schedulers), the
// top-k update, and the wait at the block's barriers.
//
// Shape of the work. Grid = (query tiles of BT queries) x (corpus splits);
// the query tiles of a split are adjacent in the grid, so they run side by
// side and their slab reads meet in L2. A block of 256 threads walks the
// row tiles (RT = 128 rows) of its split. BT is 128 (thread tile 8 queries
// x 8 rows) or 64 (4 x 8): ops/fused_scan.py flat_tile picks the widest
// tile of which two blocks fit an SM (a batch of <= 64 queries takes 64).
//
//   A warp owns its queries. A warp covers BT / 8 queries x all 128 rows
//   of the tile: lanes are 2 query groups x 16 row groups, a lane's
//   queries are lq + 2i and its rows lr + 16j. So every score of a query
//   in this block lies in one warp, the query's list belongs to that warp
//   alone, and the epilogue needs no block barrier, queue or atomic: the
//   warp votes and inserts on its own while the block's other warps run
//   on. Measured against the alternative (lanes 4 x 8, a warp 32 queries x
//   64 rows, the two warps of a query meeting in a shared-memory queue
//   behind two block barriers a tile): that FMA loop is faster (16 against
//   24 shared-memory wavefronts per 256 FMAs: 7.6 against 8.7 ms at the
//   main shape without any epilogue), but its epilogue cost 1.7 ms before
//   a single insertion where this one costs 0.35 ms.
//
//   Register tile. A float4 of depth is read once per row and per query
//   and used for 8 x 8 x 4 FMAs: 16 shared-memory loads per 256 FMAs.
//
//   No transposing store. q [B, D] and x [N, D] are both contiguous along
//   depth, so 16-byte cp.async copies rows as they lie into [row][32 depth]
//   stages, and the FMAs read float4s along depth. A row is 128 bytes, all
//   32 banks, so the 16-byte piece c of row r lives at piece c ^ (r & 7):
//   the 8 rows a quarter-warp reads in one load then cover all 32 banks (a
//   load of 16 rows is two wavefronts, the least 256 bytes take), and the 2
//   queries a warp reads lie in distinct bank groups; lanes that share a
//   row or a query read one address.
//
//   A ring of two stages, each a 32-depth chunk of the 128 rows and of the
//   BT queries. The copy of chunk i + 1 is issued before the FMAs of chunk
//   i, one __syncthreads a chunk, and the ring runs across row tiles, so
//   the next tile's first chunk loads under this tile's epilogue. The rows'
//   sqnorm and alive ride along (one table: +inf for a row that is dead or
//   cut): loaded into registers when a tile's first chunk is issued,
//   stored to shared memory after the current FMAs. A
//   third stage bought nothing (the FMAs of a chunk outlast its copy many
//   times) and its 32 KB are what lets two blocks share an SM up to k 45.
//
//   q is streamed with x, not resident. 128 resident queries x D 128 are
//   64 KB and a limit on D. Streamed, a stage is 32 KB (24 KB at BT 64)
//   whatever D is: 79,360 bytes a block at k 10, two blocks (16 warps) an
//   SM, any D. The price is L2 traffic, 16 FMAs per byte copied; q's 0.5
//   MB stay in L2.
//
//   A filtered epilogue. A lane turns its 8 dots of a query into scores,
//   and the warp takes one vote on whether any reaches the query's
//   threshold; most tiles end there. Else each group of 16 rows is offered
//   to the list behind a vote on `beats` (the lists' own order, so equal
//   scores still rank by row); the insertion is a call (offer), and for k
//   <= 32 it keeps the list in registers, one entry a lane. The threshold
//   is the k-th entry of the query's own list once that is full, or the
//   shared floor where that is higher.
//
//   The shared floor. Each split's list starts empty, and 33 splits a
//   query would each take k (1 + ln(rows / k)) insertions: counted, 1.07M
//   offers a batch at the main shape even with each split's k-th entry
//   shared. So every split publishes the c-th score of its list in global
//   memory (pub [B, splits]), and after tiles 0, 1, 3, 7, 15, ... a
//   warp reads up to 32 splits' published scores of each of its queries,
//   one a lane, and takes the g-th largest as the floor: g * c >=
//   k rows lie at or above it (c = 1, g = k at k <= 32: the k-th best of
//   the splits' best rows), so no row under it is a hit. Rows a split
//   drops this way are beaten by k rows other splits hold: the merged top
//   k is the same whatever order the blocks ran in; only the partials
//   differ.
//
// The block writes its lists to a [B, splits, k] partial: a query's
// candidates are one contiguous run for the merge.
//
// merge_partials_kernel: one warp a query. It first offers all list heads
// (lane s reads list s's head, every load in flight), which leaves the
// k-th best head as the list's threshold whenever the query has k lists or
// more: a floor no result lies under. Then it reads all other candidates,
// several batches of 32 in flight, and only those above the threshold go
// in. Nothing depends on a previous list's data, so there is no chain of
// global-memory latencies; at the shapes it sees it is bound by its launch.
//
// The bf16 slab mode (fused_scan_kernel<BT, IP, uint16_t>) replaces the
// branch x.dtype == bfloat16 of the TPU kernels' _tile_scores (:232-264):
// the MXU multiplies bf16(q) by the bf16 rows and sums in fp32. A product
// of two bf16 values is exact in fp32, so fp32 FMAs on values widened from
// bf16 give the MXU's products exactly; only the order of the sum differs.
// The wrapper rounds q to bf16 (an fp32 tensor of bf16 values) and passes
// |q|^2 of the unrounded q beside it (qsq), as _tile_scores takes it; the
// rows' sqnorm are those of the fp32 rows. A bf16 stage is 64 depths deep:
// a row is 128 bytes again, so the fp32 swizzle holds (the 16 rows a warp
// reads 8 bytes of at once fall in 8 bank pairs, two wavefronts, as a
// float4 load of fp32 rows takes), and the q stage is 64 floats deep. Half
// the chunks of 32-depth stages (64-byte rows, swizzle c ^ ((r >> 1) & 3)):
// measured on an H100 at 700 W, 8.08-8.27 against 8.58-8.65 ms device time
// at 1M x 128, b1024, k10 (bench/scan_ab.py, one call, ABBA). The FMA loop
// widens on load (a 16-bit shift); q stays fp32. The slab's bytes halve,
// the FMAs are the same: about as fast as fp32 here.
//
// Not done here: a tensor-core path where exactness allows (a 3xbf16 split
// product); a narrow query tile for batches of a few queries (a 64-query
// tile at B = 1 is mostly padding: the scan is then bound by the FMAs of
// the padding, not by the slab's bytes); a cheaper first tile at wide k
// (at k 100 the lists' filling and the dense offers of a split's first
// dozen tiles cost as much as its FMAs).

#include <limits.h>

#include "topk_warp.cuh"

namespace {

constexpr int RT = 128;          // corpus rows per tile
constexpr int NST = 2;           // stages in the ring
constexpr int FLOOR_BATCH = 4;   // queries whose published scores load together
constexpr int WIN = 32;          // splits whose published entries a warp reads
constexpr int THREADS = 256;     // 8 warps, each owning BT / 8 of the queries
constexpr int WARPS = THREADS / 32;
constexpr int TR = 8;            // rows per thread
constexpr int MERGE_IN_FLIGHT = 4;  // merge: batches of 32 loads in flight

// Depth elements a stage holds: one 128-byte row of the slab.
__host__ __device__ constexpr int depth_chunk(int elem) { return 128 / elem; }

// A stage: the rows' depth chunk (RT rows of 128 bytes) and the queries'
// (bt x depth_chunk floats), in floats.
__host__ __device__ constexpr int stage_floats(int bt, int elem) {
  return RT * 32 + bt * depth_chunk(elem);
}

size_t scan_smem_bytes(int k, int bt, int elem) {
  return sizeof(float) * ((size_t)NST * stage_floats(bt, elem)  // the ring
                          + NST * RT          // row sqnorm (+inf: dead), a tile a stage
                          + 4 * (size_t)bt    // |q|^2, threshold, score published
                          + 2 * (size_t)bt * k);  // lists: values, rows
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A staged row of the slab: XT float (fp32 rows) or uint16_t (bf16 rows, as
// their bits). A row of a stage is 128 bytes, eight 16-byte pieces, piece c
// of row r at c ^ (r & 7); load4 returns depths 4 d4 .. 4 d4 + 3 as floats.
template <typename XT>
struct Rows;

template <>
struct Rows<float> {
  __device__ static float4 load4(const char* xs, int r, int d4) {
    return *reinterpret_cast<const float4*>(xs + r * 128 + ((d4 ^ (r & 7)) << 4));
  }
};

template <>
struct Rows<uint16_t> {
  __device__ static float4 load4(const char* xs, int r, int d4) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        xs + r * 128 + (((d4 >> 1) ^ (r & 7)) << 4) + ((d4 & 1) << 3));
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
};

// The insertion path, out of line: the epilogue's offer sites hold a call
// each, not the insertion's code. Offers every lane's (v, r) to one list
// whose threshold is (tv, ti), and returns the list's last entry.
struct Entry {
  float v;
  int r;
};

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

// vec: a row of x and of q is a whole number of 16-byte pieces (D % 4 == 0
// for fp32 rows, D % 8 == 0 for bf16) and q's and x's bases are 16-byte
// aligned, so rows are staged with cp.async; else plain loads and stores
// stage them (no overlap). qsq: null, or |q|^2 [B] to take in place of the
// streamed q's own (the bf16 mode's q is rounded, its |q|^2 is not).
// part_v, part_i: [B, S, k], S = gridDim.y.
template <int BT, bool IP, typename XT>
__global__ void __launch_bounds__(THREADS, 2)
fused_scan_kernel(const float* __restrict__ q, const XT* __restrict__ x,
                  const float* __restrict__ qsq,
                  const float* __restrict__ sqnorm,
                  const uint8_t* __restrict__ alive, int B, int N, int D,
                  int k, int max_scans, int rows_per_split, int vec,
                  float* __restrict__ part_v,
                  int32_t* __restrict__ part_i, float* __restrict__ pub,
                  int pub_c, int pub_g) {
  constexpr int QG = 2;             // query groups of a warp's lanes
  constexpr int RG = 32 / QG;       // row groups: rows lr + RG j, j < TR
  constexpr int TQ = BT / 16;       // queries per thread
  constexpr int WQ = QG * TQ;       // queries a warp owns
  constexpr int STAGE = stage_floats(BT, sizeof(XT));
  constexpr int DC = depth_chunk(sizeof(XT));  // depth elements a stage
  constexpr int QP = DC / 4;                   // float4 pieces of a query row
  constexpr int QSH = QP == 16 ? 4 : 3;        // log2(QP)
  constexpr int XBYTES = RT * 128;             // a stage's rows
  constexpr int XE = 16 / sizeof(XT);          // elements a 16-byte piece
  using R = Rows<XT>;
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                        // [NST]: rows [RT][128 bytes],
                                               // then queries [BT][DC], swizzled
  float* rsq = stages + NST * STAGE;           // [NST][RT], +inf: row is out
  float* qq = rsq + NST * RT;                 // [BT]
  float* thv = qq + BT;                        // [BT] threshold score
  int* thi = (int*)(thv + BT);                 // [BT] threshold row
  float* pubv = (float*)(thi + BT);            // [BT] score last published
  float* lv = pubv + BT;                       // [BT][k]
  int* li = (int*)(lv + (size_t)BT * k);       // [BT][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lr = lane % RG, lq = lane / RG;
  const int qbase = warp * WQ + lq;             // queries qbase + QG i
  const int q0 = blockIdx.x * BT;
  const int r_begin = blockIdx.y * rows_per_split;
  const int limit = min(min(r_begin + rows_per_split, N), max_scans);
  const int D4 = (D + 3) & ~3;
  const int nchunk = (D4 + DC - 1) / DC;
  const int ntile = limit > r_begin ? (limit - r_begin + RT - 1) / RT : 0;
  const int nstage = ntile * nchunk;
  const int S = gridDim.y;                    // lists a query has in all

  int p_slot = -1;   // where the row-table entry in flight goes, or -1
  float p_sq = 0.f;

  auto load_stage = [&](int st) {
    p_slot = -1;
    if (st >= nstage) return;
    const int tile = st / nchunk, ch = st - tile * nchunk;
    const int row0 = r_begin + tile * RT, d0 = ch * DC;
    const int nd = min(DC, D4 - d0);   // depth elements this chunk
    char* sb = reinterpret_cast<char*>(stages + (st % NST) * STAGE);
#pragma unroll
    for (int e = tid; e < RT * 8; e += THREADS) {
      const int rr = e >> 3, c = e & 7;
      if (c * XE >= nd) continue;
      XT* dst = reinterpret_cast<XT*>(sb + rr * 128 + ((c ^ (rr & 7)) << 4));
      const bool ok = row0 + rr < limit;
      const XT* src = x + (size_t)(row0 + rr) * D + d0 + XE * c;
      if (vec) {
        cp_async16(dst, ok ? src : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < XE; ++u)
          dst[u] = (ok && d0 + XE * c + u < D) ? src[u] : XT(0);
      }
    }
    float* qsb = reinterpret_cast<float*>(sb + XBYTES);
#pragma unroll
    for (int e = tid; e < BT * QP; e += THREADS) {
      const int rr = e >> QSH, c = e & (QP - 1);
      if (4 * c >= nd) continue;
      float* dst = qsb + rr * DC + ((c ^ (rr & 7)) << 2);
      const bool ok = q0 + rr < B;
      const float* src = q + (size_t)(q0 + rr) * D + d0 + 4 * c;
      if (vec) {
        cp_async16(dst, ok ? src : q, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dst[u] = (ok && d0 + 4 * c + u < D) ? src[u] : 0.f;
      }
    }
    if (ch == 0 && tid < RT) {  // independent loads: nothing waits on them
                                // until they are stored
      const int row = row0 + tid;
      p_sq = (row < limit && alive[row]) ? sqnorm[row] : INFINITY;
      p_slot = (tile % NST) * RT + tid;
    }
  };
  auto store_rows = [&]() {
    if (p_slot >= 0) rsq[p_slot] = p_sq;
  };

  // the first stages are in flight while the block sets up
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    load_stage(st);
    cp_async_commit();
    store_rows();
  }

  for (int e = tid; e < BT * k; e += THREADS) {
    lv[e] = -INFINITY;
    li[e] = -1;
  }
  for (int i = tid; i < BT; i += THREADS) {
    // a query past B never takes a candidate: nothing beats (+inf, -1)
    thv[i] = q0 + i < B ? -INFINITY : INFINITY;
    thi[i] = -1;
    pubv[i] = -INFINITY;
  }
  for (int i = warp; i < BT; i += WARPS) {
    if (qsq) {   // warp-uniform
      if (lane == 0) qq[i] = q0 + i < B ? qsq[q0 + i] : 0.f;
      continue;
    }
    float s = 0.f;
    if (q0 + i < B) {
      for (int d = lane; d < D; d += 32) {
        const float v = q[(size_t)(q0 + i) * D + d];
        s = fmaf(v, v, s);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) qq[i] = s;
  }

  float acc[TQ][TR];

  for (int st = 0; st < nstage; ++st) {
    const int tile = st / nchunk, ch = st - tile * nchunk;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;
    }
    cp_async_wait<NST - 2>();   // chunk st has landed (this thread's copies)
    __syncthreads();            // everyone's copies; stage st - 1 is free
    load_stage(st + NST - 1);
    cp_async_commit();

    const char* xs = reinterpret_cast<const char*>(stages + (st % NST) * STAGE);
    const float* qs = reinterpret_cast<const float*>(xs + XBYTES);
    const int nq4 = min(DC, D4 - ch * DC) >> 2;
    for (int d4 = 0; d4 < nq4; ++d4) {
      float4 xv[TR];
#pragma unroll
      for (int j = 0; j < TR; ++j) xv[j] = R::load4(xs, lr + RG * j, d4);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(
            qs + (qbase + QG * i) * DC + ((d4 ^ ((lq + QG * i) & 7)) << 2));
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          acc[i][j] = fmaf(a.x, xv[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, xv[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, xv[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, xv[j].w, acc[i][j]);
        }
      }
    }

    if (ch == nchunk - 1) {
      // epilogue, the warp on its own: scores, filter, its queries' lists
      const int row0 = r_begin + tile * RT;
      const int tb = (tile % NST) * RT;
      float sqj[TR];   // +inf for a row that does not survive
#pragma unroll
      for (int j = 0; j < TR; ++j) sqj[j] = rsq[tb + lr + RG * j];
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int qi = qbase + QG * i;
        float tv = thv[qi];
        int ti = thi[qi];
        const float qqi = qq[qi];
        float sc[TR];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          const float dot = acc[i][j];
          if (IP) sc[j] = sqj[j] < INFINITY ? dot : -INFINITY;
          else sc[j] = -fmaxf(qqi - 2.f * dot + sqj[j], 0.f);
          mx = fmaxf(mx, sc[j]);
        }
        // one vote for the lane's 8 rows; a tie may still rank by row
        if (!__any_sync(FULL, mx >= tv)) continue;
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          const int row = row0 + lr + RG * j;
          const unsigned m = __ballot_sync(FULL, beats(sc[j], row, tv, ti));
          if (!m) continue;
#pragma unroll
          for (int h = 0; h < QG; ++h) {   // lane group h holds query h + QG i
            if (!(m & (((1ull << RG) - 1) << (RG * h)))) continue;
            const int qh = warp * WQ + h + QG * i;
            const float htv = __shfl_sync(FULL, tv, RG * h);
            const int hti = __shfl_sync(FULL, ti, RG * h);
            const Entry t = offer(lv + (size_t)qh * k, li + (size_t)qh * k, k,
                                  lq == h ? sc[j] : -INFINITY, row, htv, hti,
                                  lane);
            // a full list of own rows raises the threshold
            if (beats(t.v, t.r, htv, hti) && lq == h) {
              tv = t.v;
              ti = t.r;
            }
          }
        }
        if (lr == 0) {   // one lane a query: the threshold, and what to publish
          thv[qi] = tv;
          thi[qi] = ti;
          publish(lv + (size_t)qi * k, pubv + qi,
                  pub + (size_t)(q0 + qi) * S + blockIdx.y, pub_c);
        }
      }
      __syncwarp();
      // after tiles 0, 1, 3, 7, 15, ... what the other splits have
      // published raises the thresholds: the published scores rise as the
      // logarithm of the rows seen
      if ((tile & (tile + 1)) == 0)
        take_floor(pub, S, max(0, min((int)blockIdx.y & ~(WIN - 1), S - WIN)),
                   q0 + warp * WQ, B, WQ, pub_g, thv + warp * WQ,
                   thi + warp * WQ, lane);
    }
    store_rows();
  }

  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < BT * k; e += THREADS) {
    const int b = q0 + e / k;
    if (b < B) {
      const size_t o = ((size_t)b * S + blockIdx.y) * k + e % k;
      part_v[o] = lv[e];
      part_i[o] = li[e];
    }
  }
}

// One warp per query: reduce its sorted partial lists to [B, k]. List s of
// query b starts at entry base(b) + s * lstride. Without qend every query
// has S lists and base(b) = b * qstride ([B, S, k]: qstride S k, lstride k;
// [S, B, k]: qstride k, lstride B k). With qend [B, P] (the list scan's
// running slot counts) the lists are [S, k] rows, query b's rows
// qend[b - 1][P - 1] (0 for b = 0) .. qend[b][P - 1]; rows past S are never
// read.
__global__ void __launch_bounds__(THREADS)
merge_partials_kernel(const float* __restrict__ part_v,
                      const int32_t* __restrict__ part_i, int S, int B, int k,
                      const int32_t* __restrict__ qend, int P,
                      long long qstride, long long lstride,
                      float* __restrict__ out_v, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
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
  const int nl = s1 - s0;
  const size_t base = qend ? (size_t)s0 * k : (size_t)b * qstride;
  if (qend) lstride = k;
  constexpr int U = MERGE_IN_FLIGHT;
  // the heads: with k lists or more, the k-th best head becomes the
  // threshold, a floor under every result
  for (int h0 = 0; h0 < nl; h0 += 32 * U) {
    float v[U];
    int r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = h0 + 32 * u + lane;
      v[u] = s < nl ? part_v[base + s * lstride] : -INFINITY;
      r[u] = s < nl ? part_i[base + s * lstride] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (h0 + 32 * u < nl) warp_offer_batch(lv, li, k, v[u], r[u], tv, ti, lane);
  }
  // every other candidate, all loads of U batches in flight
  const int total = k > 1 ? nl * k : 0;
  for (int c0 = 0; c0 < total; c0 += 32 * U) {
    float v[U];
    int r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + 32 * u + lane;
      const int s = c / k, e = c - s * k;
      const bool ok = c < total && e;   // heads went in above
      v[u] = ok ? part_v[base + s * lstride + e] : -INFINITY;
      r[u] = ok ? part_i[base + s * lstride + e] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + 32 * u < total) warp_offer_batch(lv, li, k, v[u], r[u], tv, ti, lane);
  }
  for (int p = lane; p < k; p += 32) {
    out_v[(size_t)b * k + p] = lv[p];
    out_i[(size_t)b * k + p] = li[p];
  }
}

template <int BT, bool IP, typename XT>
int launch_scan(const void* q, const void* x, const void* qsq,
                const void* sqnorm, const void* alive, int B, int N, int D,
                int k, int max_scans, int rows_per_split, int n_splits,
                int vec, void* part_v, void* part_i, void* pub, int pub_c,
                int pub_g, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(k, BT, sizeof(XT));
  cudaError_t err = cudaFuncSetAttribute(
      fused_scan_kernel<BT, IP, XT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BT - 1) / BT, n_splits);
  fused_scan_kernel<BT, IP, XT><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const XT*)x, (const float*)qsq, (const float*)sqnorm,
      (const uint8_t*)alive, B, N, D, k, max_scans, rows_per_split, vec,
      (float*)part_v, (int32_t*)part_i, (float*)pub, pub_c, pub_g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of a flat-scan block with a bt-query tile (64 or 128) over
// rows of elem bytes an element (4: fp32, 2: bf16); the wrapper's
// flat_scan_smem_bytes computes the same number.
long long pyrope_scan_smem_bytes(int k, int bt, int elem) {
  return (long long)scan_smem_bytes(k, bt, elem);
}

const char* pyrope_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// FLAT mode: rows >= max_scans never hit. x: fp32 rows (elem 4) or bf16
// rows (elem 2); qsq: null, or |q|^2 [B] (the bf16 mode: q rounded to bf16
// by the caller, |q|^2 of the unrounded q). bt: the query tile, 64 or 128;
// partials [B, n_splits, k]; pub [B, n_splits] floats, -inf from the caller:
// each split publishes its list's pub_c-th score there, and pub_g * pub_c >=
// k with pub_g <= min(n_splits, 32).
int pyrope_fused_scan(const void* q, const void* x, const void* qsq,
                      const void* sqnorm, const void* alive, int B, int N,
                      int D, int k, int metric_ip, int max_scans,
                      int rows_per_split, int n_splits, int bt, int elem,
                      int vec, void* part_v, void* part_i, void* pub,
                      int pub_c, int pub_g, void* stream) {
  if (k < 1 || k > MAXK || (bt != 64 && bt != 128) || (elem != 4 && elem != 2) ||
      pub_c < 1 || pub_c > k || pub_g < 1 || pub_g > WIN || pub_g > n_splits ||
      pub_g * pub_c < k)
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, int, int, int, int, int, int, int, int,
                         void*, void*, void*, int, int, cudaStream_t);
  static const Launch table[2][2][2] = {   // [bf16][bt == 128][ip]
      {{launch_scan<64, false, float>, launch_scan<64, true, float>},
       {launch_scan<128, false, float>, launch_scan<128, true, float>}},
      {{launch_scan<64, false, uint16_t>, launch_scan<64, true, uint16_t>},
       {launch_scan<128, false, uint16_t>, launch_scan<128, true, uint16_t>}}};
  return table[elem == 2][bt == 128][metric_ip != 0](
      q, x, qsq, sqnorm, alive, B, N, D, k, max_scans, rows_per_split,
      n_splits, vec, part_v, part_i, pub, pub_c, pub_g, (cudaStream_t)stream);
}

// qend: null for S lists a query at strides (qstride, lstride), else int32
// [B, P] over [S, k] lists.
int pyrope_merge_partials(const void* part_v, const void* part_i, int S,
                          int B, int k, const void* qend, int P,
                          long long qstride, long long lstride, void* out_v,
                          void* out_i, void* stream) {
  if (k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)k * WARPS;
  const int blocks = (B + WARPS - 1) / WARPS;
  merge_partials_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)part_v, (const int32_t*)part_i, S, B, k,
      (const int32_t*)qend, P, qstride, lstride, (float*)out_v,
      (int32_t*)out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
