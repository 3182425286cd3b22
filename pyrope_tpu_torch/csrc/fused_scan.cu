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
// The bf16 slab mode is a kernel of its own, on the tensor cores:
// flat_scan_tc.cu. It shares this kernel's epilogue (flat_epilogue.cuh).
//
// The wide mode (k > MAXK = 128, any k;
// fused_scan_kernel<64, IP, true>, merge_wide_kernel) replaces the TPU
// kernels' wide merges (_wide_params :372, _bitonic_merge_wide :192,
// _merge_tile_wide :200, the dynamic rounds of _merge_tile :437-475 on
// _extract_top :496). The k <= MAXK instantiations are compiled from the
// same source with the wide code behind `if constexpr`, so theirs is the
// code they had. A query's list is its [B, splits, kw] partial row in
// global memory, kw = min(k, rows a split): a split cannot give more, so
// any k runs; shared memory holds a FLAT_CAP-entry candidate buffer a
// query (topk_wide.cuh: the buffer is sorted and merged into the list when
// full), 182,784 B a block of 64 queries, one
// block an SM, so the wrapper's grid is one wave (ops/fused_scan._splits).
// The epilogue, its vote, the threshold and the shared floor are the
// narrow mode's: a split publishes its list's c-th entry once the list
// holds c entries. A list ends with a fill count ([B, splits] int32, the
// wrapper's `fills`) where it had pads of (-inf, -1): at b64 k 10,000 the
// pads were 519 MB written for ~60 entries a list. The wide merge
// (merge_wide_kernel, below) reads the counts, and a
// floor off the lists' c-th entries, gathers the prefixes above it and
// sorts them once, a block a query.
//
// The wide mode's first pass (ops/fused_scan.flat_prefloor_plan decides
// from shapes whether it runs). A split's list starts empty, so before the
// shared floor forms every row goes through the buffer into the list in
// global memory: at b64 k 10,000 a split's list could hold all its 7,680
// rows, and the floor needs 32 splits' flushed c-th entries. So a narrow
// launch of this same kernel (fused_scan_kernel<BT, IP, false>, k = c <=
// 128) first scans the first rows_scan rows of each of its own splits and
// publishes each split's c-th score (no partials: part_v null);
// floor_select_kernel (prefloor.cu) takes each query's g-th largest, g =
// ceil(k / c), and the wide launch starts every threshold there (floor0,
// kept as (F, INT_MAX): rows scoring F or more stay, the floor's own row
// among them). The splits hold disjoint real rows, so g * c >= k rows lie
// at or above F. Both launches compute a score with the same FMAs in the
// same order (the FMA loop and the score do not depend on BT or WIDE), so a
// row's score in the second pass is bit-equal to the first's.
//
// Not done here: a tensor-core path where exactness allows (a 3xbf16 split
// product, beside flat_scan_tc.cu's bf16 one); a narrow query tile for batches of a few queries (a 64-query
// tile at B = 1 is mostly padding: the scan is then bound by the FMAs of
// the padding, not by the slab's bytes); a cheaper first tile at wide k
// (at k 100 the lists' filling and the dense offers of a split's first
// dozen tiles cost as much as its FMAs).

#include "flat_epilogue.cuh"

namespace {

constexpr int RT = 128;          // corpus rows per tile
constexpr int NST = 2;           // stages in the ring
constexpr int THREADS = 256;     // 8 warps, each owning BT / 8 of the queries
constexpr int WARPS = THREADS / 32;
constexpr int TR = 8;            // rows per thread
constexpr int MERGE_IN_FLIGHT = 4;  // merge: batches of 32 loads in flight
constexpr int MERGE_CAP = 256;   // the wide merge's in-place path: a run, a query
constexpr int MW_THREADS = 256;  // the wide merge's block, one a query
constexpr int MW_KEYS = MW_THREADS;  // lists whose c-th entries make its floor
constexpr int MW_LEVELS = 9;         // its floor's levels: g = 1, 2, 4, ..., MW_KEYS
constexpr int MW_MIN_CAP = 1024;     // its run buffer, entries: at least
constexpr int MW_MAX_CAP = 16384;    // and at most (128 KB)

constexpr int DC = 32;           // depth elements a stage holds: a 128-byte row

// A stage: the rows' depth chunk (RT rows of 128 bytes) and the queries'
// (bt x DC floats), in floats.
__host__ __device__ constexpr int stage_floats(int bt) { return RT * 32 + bt * DC; }

// k > MAXK (the wide mode): the lists lie in the partials, and shared memory
// holds each query's candidate buffer of cap entries and its WideState
// instead.
size_t scan_smem_bytes(int k, int bt, int cap = FLAT_CAP) {
  return sizeof(float) * ((size_t)NST * stage_floats(bt)  // the ring
                          + NST * RT          // row sqnorm (+inf: dead), a tile a stage
                          + 4 * (size_t)bt    // |q|^2, threshold, score published
                          + (k > MAXK ? (size_t)bt * (2 * cap + 2)  // buffers, state
                                      : 2 * (size_t)bt * k));  // lists: values, rows
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

// Depths 4 d4 .. 4 d4 + 3 of staged row r: a row of a stage is 128 bytes,
// eight 16-byte pieces, piece c of row r at c ^ (r & 7).
__device__ __forceinline__ float4 load_row4(const char* xs, int r, int d4) {
  return *reinterpret_cast<const float4*>(xs + r * 128 + ((d4 ^ (r & 7)) << 4));
}

// vec: a row of x and of q is a whole number of 16-byte pieces (D % 4 ==
// 0) and q's and x's bases are 16-byte aligned, so rows are staged with
// cp.async; else plain loads and stores stage them (no overlap).
// part_v, part_i: [B, S, kw], S = gridDim.y; kw = k, or in the wide mode
// min(k, rows_per_split): a split cannot give more. part_v null (k <= MAXK
// only): nothing is written but pub, the first pass's case. A split scans
// its first rows_scan (<= rows_per_split) rows. floor0 (the wide mode; null:
// none): [B] scores each query's rows must reach, -inf where none. fills
// (the wide mode; null: the lists are padded with (-inf, -1) instead):
// [B, S], the real entries of each list.
template <int BT, bool IP, bool WIDE = false, int CAP = FLAT_CAP>
__global__ void __launch_bounds__(THREADS, 2)
fused_scan_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const float* __restrict__ sqnorm,
                  const uint8_t* __restrict__ alive, int B, int N, int D,
                  int k, int kw, int max_scans, int rows_per_split, int rows_scan,
                  int vec, float* __restrict__ part_v,
                  int32_t* __restrict__ part_i, float* __restrict__ pub,
                  int pub_c, int pub_g, const float* __restrict__ floor0,
                  int32_t* __restrict__ fills) {
  constexpr int QG = 2;             // query groups of a warp's lanes
  constexpr int RG = 32 / QG;       // row groups: rows lr + RG j, j < TR
  constexpr int TQ = BT / 16;       // queries per thread
  constexpr int WQ = QG * TQ;       // queries a warp owns
  constexpr int STAGE = stage_floats(BT);
  constexpr int QP = DC / 4;                   // float4 pieces of a query row
  constexpr int QSH = 3;                       // log2(QP)
  constexpr int XBYTES = RT * 128;             // a stage's rows
  constexpr int XE = 4;                        // elements a 16-byte piece
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                        // [NST]: rows [RT][128 bytes],
                                               // then queries [BT][DC], swizzled
  float* rsq = stages + NST * STAGE;           // [NST][RT], +inf: row is out
  float* qq = rsq + NST * RT;                 // [BT]
  float* thv = qq + BT;                        // [BT] threshold score
  int* thi = (int*)(thv + BT);                 // [BT] threshold row
  float* pubv = (float*)(thi + BT);            // [BT] score last published
  float* lv = pubv + BT;                       // [BT][k]; WIDE: buffers [BT][CAP]
  int* li = (int*)(lv + (size_t)BT * (WIDE ? CAP : k));
  WideState* wst = (WideState*)(li + (size_t)BT * CAP);   // WIDE: [BT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lr = lane % RG, lq = lane / RG;
  const int qbase = warp * WQ + lq;             // queries qbase + QG i
  const int q0 = blockIdx.x * BT;
  const int r_begin = blockIdx.y * rows_per_split;
  const int limit = min(min(r_begin + rows_scan, N), max_scans);
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
      float* dst = reinterpret_cast<float*>(sb + rr * 128 + ((c ^ (rr & 7)) << 4));
      const bool ok = row0 + rr < limit;
      const float* src = x + (size_t)(row0 + rr) * D + d0 + XE * c;
      if (vec) {
        cp_async16(dst, ok ? src : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < XE; ++u)
          dst[u] = (ok && d0 + XE * c + u < D) ? src[u] : 0.f;
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

  if (!WIDE) {
    for (int e = tid; e < BT * k; e += THREADS) {
      lv[e] = -INFINITY;
      li[e] = -1;
    }
  }
  for (int i = tid; i < BT; i += THREADS) {
    if (WIDE) wst[i] = {0, 0};
    // a query past B never takes a candidate: nothing beats (+inf, -1)
    thv[i] = q0 + i < B ? -INFINITY : INFINITY;
    thi[i] = -1;
    pubv[i] = -INFINITY;
    if (WIDE && floor0 && q0 + i < B) {   // the first pass's floor: rows
      const float f = floor0[q0 + i];     // scoring f or more stay
      if (f > -INFINITY) {
        thv[i] = f;
        thi[i] = INT_MAX;
      }
    }
  }
  for (int i = warp; i < BT; i += WARPS) {
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
      for (int j = 0; j < TR; ++j) xv[j] = load_row4(xs, lr + RG * j, d4);
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
            const float cv = lq == h ? sc[j] : -INFINITY;
            Entry t;
            if constexpr (WIDE) {   // the list is query qh's partial
              const size_t o = ((size_t)(q0 + qh) * S + blockIdx.y) * kw;
              t = wide_offer<CAP>(part_v + o, part_i + o, kw,
                                       lv + (size_t)qh * CAP,
                                       li + (size_t)qh * CAP, wst + qh, cv, row,
                                       htv, hti, lane);
            } else {
              t = offer(lv + (size_t)qh * k, li + (size_t)qh * k, k, cv, row, htv,
                        hti, lane);
            }
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
          if (!WIDE)
            publish(lv + (size_t)qi * k, pubv + qi,
                    pub + (size_t)(q0 + qi) * S + blockIdx.y, pub_c);
          else if (wst[qi].fill >= pub_c)   // the list's first pub_c are real
            publish(part_v + ((size_t)(q0 + qi) * S + blockIdx.y) * kw, pubv + qi,
                    pub + (size_t)(q0 + qi) * S + blockIdx.y, pub_c);
        }
      }
      __syncwarp();
      // after tiles 0, 1, 3, 7, 15, ... what the other splits have
      // published raises the thresholds: the published scores rise as the
      // logarithm of the rows seen
      if ((tile & (tile + 1)) == 0)
        take_floor(pub, S, floor_window(blockIdx.y, S),
                   q0 + warp * WQ, B, WQ, pub_g, thv + warp * WQ,
                   thi + warp * WQ, lane);
    }
    store_rows();
  }

  cp_async_wait<0>();
  __syncthreads();
  if constexpr (WIDE) {   // each warp: its queries' last buffers, then the pads
    for (int qi = warp * WQ; qi < (warp + 1) * WQ && q0 + qi < B; ++qi) {
      const size_t o = ((size_t)(q0 + qi) * S + blockIdx.y) * kw;
      wide_flush<CAP>(part_v + o, part_i + o, kw, lv + (size_t)qi * CAP,
                      li + (size_t)qi * CAP, &wst[qi].cnt, &wst[qi].fill, lane);
      if (!fills) wide_pad(part_v + o, part_i + o, kw, wst[qi].fill, lane);
      else if (lane == 0) fills[(size_t)(q0 + qi) * S + blockIdx.y] = wst[qi].fill;
    }
    return;
  }
  if (!part_v) return;   // the first pass: pub is its output
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

// The wide merge (k > MAXK, or lists narrower than k): lists of width L <=
// k (a list-scan slot holds min(k, seg, max_len) entries, a wide flat
// split min(k, rows_per_split)) into [B, k], laid out as
// merge_partials_kernel's; one block a query.
//   1. The floor. A list is sorted, so its entry c-1 is a c-th entry the
//      merge can read at once: thread t reads those of list t (the first
//      MW_KEYS lists, m of them, every load in flight). For g = 1, 2, 4, ...
//      up to m and c = ceil(k / g) (at most L), the g-th largest of the
//      lists' c-th entries has g * c >= k entries at or above it, so no
//      entry it beats is a hit; the floor F is the largest of those. A list
//      shorter than c, or padded there with (-inf, -1), gives no key at
//      that level; with no level found there is no floor. Several levels,
//      because a list scan's slots come cut short by its own floor: a
//      single c (ceil(k / m)) found too few slots that long at nprobe 96,
//      k 512, and its merge fell to the in-place path (0.64 ms).
//   2. The gather. Thread t finds the prefix of list t at or above F (a
//      binary search; every entry without a floor), a block scan places the
//      prefixes, and the block copies them into shared memory, MW_THREADS
//      lists a round.
//   3. One bitonic sort of the gathered entries in the lists' order (score
//      desc, row asc); the first k go out, (-inf, -1) past the entries
//      there are.
// Where the entries at or above F outgrow the run buffer (cap entries, from
// k) and k fits it, the floor is raised first: a bisection of the key range
// above F, each step counting the lists' prefixes at or above its middle (a
// binary search a list), until k <= that count <= cap (keys are distinct,
// so the count falls by at most one from a key to the next, and such a key
// exists). Every hit still lies at or above it, and the gather fits: the
// wide flat scan behind its first pass's floor hands over ~1.35 k / f
// entries a query, more than 16,384 at b64 k 10,000 with a small sample.
// Where k itself outgrows the buffer (k > MW_MAX_CAP), warp 0 merges each
// list's prefix above the floor into the output row in place instead
// (topk_wide.cuh warp_merge_run, MERGE_CAP at a time): the same function,
// one list after another. cap = clamp(next power of two of 4k, MW_MIN_CAP,
// MW_MAX_CAP): 4096 entries (32 KB) at k 1000.
// an entry at or above the floor key f (every real entry where f is 0)
__device__ __forceinline__ bool at_or_above(float v, int r, unsigned long long f) {
  return f ? floor_key(v, r) >= f : (r >= 0 && v > -INFINITY);
}

// Entries of list l (L wide, sorted) at or above the floor key f: a prefix.
__device__ __forceinline__ int prefix_at_or_above(const float* pv, const int32_t* pi,
                                                  int L, unsigned long long f) {
  int n = 0, hi = L;
  while (n < hi) {
    const int mid = (n + hi) >> 1;
    if (at_or_above(pv[mid], pi[mid], f)) n = mid + 1;
    else hi = mid;
  }
  return n;
}

// Exclusive prefix sum of one int a thread over the block; *total gets the
// sum. scratch: MW_THREADS / 32 ints.
__device__ __forceinline__ int block_scan(int x, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < MW_THREADS / 32; ++w) {
    const int t = scratch[w];
    before += w < warp ? t : 0;
    sum += t;
  }
  __syncthreads();
  *total = sum;
  return before + inc - x;
}

// 1b. Entries at or above f outgrow the run buffer (cap >= k): the least
// floor found by bisecting the keys above f that leaves k .. cap entries at
// or above it (count(lo) > cap, count(hi) < k throughout; keys are distinct,
// so the count falls by at most one from a key to the next and the search
// meets such a key before lo and hi close). The block together; top: a
// shared 64-bit word.
__device__ unsigned long long raise_floor(const float* part_v, const int32_t* part_i,
                                          size_t base, long long lstride, int nl, int L,
                                          const int32_t* lfill, int k, int cap,
                                          unsigned long long f, unsigned long long* top,
                                          int* scratch) {
  const int tid = threadIdx.x;
  auto count = [&](unsigned long long key) {
    int n = 0;
    for (int l = tid; l < nl; l += MW_THREADS)
      n += prefix_at_or_above(part_v + base + (size_t)l * lstride,
                              part_i + base + (size_t)l * lstride,
                              lfill ? lfill[l] : L, key);
    int sum;
    block_scan(n, scratch, &sum);
    return sum;
  };
  if (tid == 0) *top = 0ull;
  __syncthreads();
  for (int l = tid; l < nl; l += MW_THREADS) {   // the top key: a list's head
    if (lfill && !lfill[l]) continue;
    const float v = part_v[base + (size_t)l * lstride];
    const int r = part_i[base + (size_t)l * lstride];
    if (r >= 0 && v > -INFINITY) atomicMax(top, floor_key(v, r));
  }
  __syncthreads();
  unsigned long long lo = f, hi = *top + 1;
  for (int step = 0; step < 64 && hi - lo > 1; ++step) {
    const unsigned long long mid = lo + (hi - lo) / 2;
    const int n = count(mid);   // block-uniform
    if (n >= k && n <= cap) return mid;
    if (n > cap) lo = mid;
    else hi = mid;
  }
  return lo;   // not reached; the gather then takes the in-place path
}

__global__ void __launch_bounds__(MW_THREADS)
merge_wide_kernel(const float* __restrict__ part_v,
                  const int32_t* __restrict__ part_i, int S, int B, int k, int L,
                  const int32_t* __restrict__ qend, int P, long long qstride,
                  long long lstride, const int32_t* __restrict__ fills, int cap,
                  float* __restrict__ out_v, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  unsigned long long* keys = (unsigned long long*)smem;    // [MW_KEYS]
  unsigned long long* floor_s = keys + MW_KEYS;            // [2]: floor, top key
  int* offs = (int*)(floor_s + 2);                         // [MW_THREADS + 1]
  int* scratch = offs + MW_THREADS + 1;                    // [MW_THREADS / 32]
  float* bv = (float*)(scratch + MW_THREADS / 32 + 1);     // [cap]
  int* bi = (int*)(bv + cap);                              // [cap]
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x;
  const int s0 = qend && b ? min(qend[(size_t)b * P - 1], S) : 0;
  const int s1 = qend ? min(qend[(size_t)b * P + P - 1], S) : S;
  const int nl = max(s1 - s0, 0);
  const size_t base = qend ? (size_t)s0 * L : (size_t)b * qstride;
  if (qend) lstride = L;
  float* ov = out_v + (size_t)b * k;
  int32_t* oi = out_i + (size_t)b * k;
  // the real entries of list l: its fill count (S lists a query), or all L
  // with (-inf, -1) past them
  const int32_t* lfill = fills && !qend ? fills + (size_t)b * S : nullptr;
  auto width = [&](int l) { return lfill ? lfill[l] : L; };

  // 1. the floor: for g = 1, 2, 4, ... up to the m lists read, the g-th
  // largest of their c-th entries, c = ceil(k / g) (a level whose c is
  // above L is skipped), and the largest of those floors. Every load is in
  // flight before the first level is counted.
  const int m = min(nl, MW_KEYS);
  const int wl = tid < m ? width(tid) : 0;
  unsigned long long lvl[MW_LEVELS];
#pragma unroll
  for (int j = 0; j < MW_LEVELS; ++j) {
    const int g = 1 << j;
    const long long c = ((long long)k + g - 1) / g;
    lvl[j] = 0ull;
    if (tid < m && g <= m && c <= wl) {
      const size_t o = base + (size_t)tid * lstride + c - 1;
      const float v = part_v[o];
      const int r = part_i[o];
      lvl[j] = (r >= 0 && v > -INFINITY) ? floor_key(v, r) : 0ull;
    }
  }
  if (tid == 0) *floor_s = 0ull;
#pragma unroll
  for (int j = 0; j < MW_LEVELS; ++j) {
    const int g = 1 << j;
    if (g > m) break;   // block-uniform
    if (tid < MW_KEYS) keys[tid] = lvl[j];
    __syncthreads();
    const unsigned long long key = lvl[j];
    if (key > *floor_s) {   // only a key above the floor so far can raise it
      int ge = 0;   // keys at or above this thread's
      for (int t = 0; t < m && ge < g; ++t) ge += keys[t] >= key;
      if (ge >= g) atomicMax(floor_s, key);
    }
    __syncthreads();
  }
  unsigned long long f = *floor_s;

  // 2. each list's prefix at or above the floor, gathered into bv/bi; where
  // they outgrow the run buffer and k fits it, the floor is raised (1b) and
  // the gather starts again
  int total = 0;
  bool fits = true;
  for (int attempt = 0; attempt < 2; ++attempt) {
    total = 0;
    fits = true;
    for (int r0 = 0; r0 < nl; r0 += MW_THREADS) {
      const int l = r0 + tid;
      const int n = l < nl ? prefix_at_or_above(part_v + base + (size_t)l * lstride,
                                                part_i + base + (size_t)l * lstride,
                                                width(l), f)
                           : 0;
      int got;
      const int before = block_scan(n, scratch, &got);
      offs[tid] = before;
      if (tid == 0) offs[MW_THREADS] = got;
      __syncthreads();
      if (total + got > cap) {
        fits = false;   // block-uniform
        break;
      }
      for (int e = tid; e < got; e += MW_THREADS) {
        int lo = 0, hi2 = MW_THREADS;   // the list: the last offs[] at or below e
        while (hi2 - lo > 1) {
          const int mid = (lo + hi2) >> 1;
          if (offs[mid] <= e) lo = mid;
          else hi2 = mid;
        }
        const size_t o = base + (size_t)(r0 + lo) * lstride + (e - offs[lo]);
        bv[total + e] = part_v[o];
        bi[total + e] = part_i[o];
      }
      total += got;
      __syncthreads();
    }
    if (fits || k > cap || attempt) break;
    f = raise_floor(part_v, part_i, base, lstride, nl, L, lfill, k, cap, f, floor_s + 1,
                    scratch);
  }

  if (fits) {
    // 3. one bitonic sort, best first, then the first k
    int p = 32;
    while (p < total) p <<= 1;
    for (int t = total + tid; t < p; t += MW_THREADS) {
      bv[t] = -INFINITY;
      bi[t] = -1;
    }
    __syncthreads();
    for (int size = 2; size <= p; size <<= 1) {
      for (int stride = size >> 1; stride; stride >>= 1) {
        for (int t = tid; t < (p >> 1); t += MW_THREADS) {
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
        __syncthreads();
      }
    }
    for (int j = tid; j < k; j += MW_THREADS) {
      ov[j] = j < total ? bv[j] : -INFINITY;
      oi[j] = j < total ? bi[j] : -1;
    }
    return;
  }

  // the prefixes outgrow the run buffer: warp 0 merges them into the output
  // row in place, list by list, behind the floor
  if (tid >= 32) return;
  float tv = -INFINITY;
  int ti = -1;
  if (f) {   // rows at or above F stay: they beat (F's score, F's row + 1)
    floor_entry(f, tv, ti);
    ++ti;
  }
  int fill = 0;
  for (int s = 0; s < nl; ++s) {
    const float* pv = part_v + base + (size_t)s * lstride;
    const int32_t* pi = part_i + base + (size_t)s * lstride;
    const int ls = width(s);
    for (int c0 = 0; c0 < ls; c0 += MERGE_CAP) {
      int mm = 0;   // entries of this chunk that beat the threshold: a prefix
      for (int u = 0; u < MERGE_CAP; u += 32) {
        const int e = c0 + u + lane;
        const float v = e < ls ? pv[e] : -INFINITY;
        const int r = e < ls ? pi[e] : -1;
        const bool pass = beats(v, r, tv, ti);
        const unsigned mk = __ballot_sync(FULL, pass);
        if (pass) {
          bv[u + lane] = v;
          bi[u + lane] = r;
        }
        mm += __popc(mk);
        if (mk != FULL) break;
      }
      __syncwarp();
      if (mm) {
        fill = warp_merge_run<MERGE_CAP>(ov, oi, k, fill, bv, bi, mm, lane);
        wide_threshold(ov, oi, k, fill, tv, ti);
      }
      if (mm < MERGE_CAP) break;
    }
  }
  wide_pad(ov, oi, k, fill, lane);
}

template <int BT, bool IP, bool WIDE = false, int CAP = FLAT_CAP>
int launch_scan(const void* q, const void* x, const void* sqnorm,
                const void* alive, int B, int N, int D, int k, int kw,
                int max_scans, int rows_per_split, int rows_scan, int n_splits,
                int vec, void* part_v, void* part_i, void* pub, int pub_c,
                int pub_g, const void* floor0, void* fills, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(k, BT, CAP);
  cudaError_t err = cudaFuncSetAttribute(
      fused_scan_kernel<BT, IP, WIDE, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BT - 1) / BT, n_splits);
  fused_scan_kernel<BT, IP, WIDE, CAP><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)x, (const float*)sqnorm,
      (const uint8_t*)alive, B, N, D, k, kw, max_scans, rows_per_split, rows_scan,
      vec, (float*)part_v, (int32_t*)part_i, (float*)pub, pub_c, pub_g,
      (const float*)floor0, (int32_t*)fills);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of a flat-scan block with a bt-query tile (64 or 128) over
// fp32 rows; the wrapper's flat_scan_smem_bytes computes the same number.
long long pyrope_scan_smem_bytes(int k, int bt) {
  return (long long)scan_smem_bytes(k, bt);
}

// The same for the wide mode (k > MAXK) with a cap-entry candidate buffer a
// query (FLAT_CAP, or FLAT_SMALL_CAP behind a first pass's floor).
long long pyrope_scan_wide_smem_bytes(int k, int cap) {
  return (long long)scan_smem_bytes(k, WIDE_BT, cap);
}

const char* pyrope_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// FLAT mode over fp32 rows: rows >= max_scans never hit. k <= MAXK: the
// warp-register lists, bt 64 or 128, kw = k; k > MAXK: the wide mode, bt
// 64, lists kw <= k entries wide. partials [B, n_splits, kw] (part_v and
// part_i null, k <= MAXK only: not written, the first pass); a split scans
// its first rows_scan (1 .. rows_per_split) rows; pub [B, n_splits] floats,
// -inf from the caller: each split publishes its list's pub_c-th score there
// (pub_c <= kw), and pub_g * pub_c >= k (a pub_g above min(n_splits, 32) is
// never reached: no floor). floor0: null, or (k > MAXK) [B] scores the
// queries' rows must reach (-inf: none), the first pass's floors. cap (k >
// MAXK): the candidate buffer a query, FLAT_CAP, or FLAT_SMALL_CAP behind a
// first pass's floor (two blocks an SM). fills: null, or (k > MAXK) [B,
// n_splits] int32, each list's real entries, written in place of the pads.
int pyrope_fused_scan(const void* q, const void* x, const void* sqnorm,
                      const void* alive, int B, int N, int D, int k, int kw,
                      int metric_ip, int max_scans, int rows_per_split,
                      int rows_scan, int n_splits, int bt, int vec, void* part_v,
                      void* part_i, void* pub, int pub_c, int pub_g,
                      const void* floor0, int cap, void* fills, void* stream) {
  const bool wide = k > MAXK;
  if (k < 1 || (wide ? kw < 1 || kw > k : kw != k) || (bt != 64 && bt != 128) ||
      (wide && bt != WIDE_BT) || pub_c < 1 || pub_c > kw || pub_g < 1 ||
      (long long)pub_g * pub_c < k || rows_scan < 1 || rows_scan > rows_per_split ||
      (wide && (!part_v || !part_i)) || (!wide && floor0) || (!part_v != !part_i) ||
      (wide && cap != FLAT_CAP && cap != FLAT_SMALL_CAP) || (!wide && fills))
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const void*, const void*, const void*, const void*, int,
                         int, int, int, int, int, int, int, int, int, void*, void*,
                         void*, int, int, const void*, void*, cudaStream_t);
  static const Launch wide_table[2][2] = {   // [cap == FLAT_SMALL_CAP][ip]
      {launch_scan<WIDE_BT, false, true>, launch_scan<WIDE_BT, true, true>},
      {launch_scan<WIDE_BT, false, true, FLAT_SMALL_CAP>,
       launch_scan<WIDE_BT, true, true, FLAT_SMALL_CAP>}};
  if (wide)
    return wide_table[cap == FLAT_SMALL_CAP][metric_ip != 0](
        q, x, sqnorm, alive, B, N, D, k, kw, max_scans, rows_per_split, rows_scan,
        n_splits, vec, part_v, part_i, pub, pub_c, pub_g, floor0, fills,
        (cudaStream_t)stream);
  static const Launch table[2][2] = {   // [bt == 128][ip]
      {launch_scan<64, false>, launch_scan<64, true>},
      {launch_scan<128, false>, launch_scan<128, true>}};
  return table[bt == 128][metric_ip != 0](
      q, x, sqnorm, alive, B, N, D, k, kw, max_scans, rows_per_split, rows_scan,
      n_splits, vec, part_v, part_i, pub, pub_c, pub_g, floor0, nullptr,
      (cudaStream_t)stream);
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

// The wide merge: lists of width list_w (<= k) into [B, k], any k (the
// wrapper takes it for k > MAXK, or lists narrower than k); the layouts as
// pyrope_merge_partials. One block a query; its run buffer holds cap entries.
// fills: null (entries past a list's last are (-inf, -1)), or without qend
// [B, S] int32, each list's real entries (past them the list is not read).
int pyrope_merge_partials_wide(const void* part_v, const void* part_i, int S,
                               int B, int k, int list_w, const void* qend, int P,
                               long long qstride, long long lstride, const void* fills,
                               void* out_v, void* out_i, void* stream) {
  if (k < 1 || list_w < 1 || list_w > k || (fills && qend))
    return (int)cudaErrorInvalidValue;
  int cap = MW_MIN_CAP;
  while (cap < MW_MAX_CAP && cap < 4LL * k) cap <<= 1;
  const size_t smem = sizeof(unsigned long long) * (MW_KEYS + 2) +
                      sizeof(int) * (MW_THREADS + 1 + MW_THREADS / 32 + 1) +
                      (sizeof(float) + sizeof(int)) * (size_t)cap;
  cudaError_t err = cudaFuncSetAttribute(
      merge_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  merge_wide_kernel<<<B, MW_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)part_v, (const int32_t*)part_i, S, B, k, list_w,
      (const int32_t*)qend, P, qstride, lstride, (const int32_t*)fills, cap,
      (float*)out_v, (int32_t*)out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
