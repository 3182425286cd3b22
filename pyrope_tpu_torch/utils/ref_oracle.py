"""Reference-semantics CPU oracle for recall parity (the port's copy of
``pyrope_tpu/utils/ref_oracle.py``, numpy only).

The reference publishes NO recall numbers (SURVEY §4), so parity claims need
an oracle: a from-scratch numpy re-implementation of the reference's search
*algorithms* at the same hyperparameters, run on the same data. bench.py
runs it next to every ANN config and commits a ``recall_ref`` column so
"TPU recall >= reference recall" is measured, not asserted (VERDICT r1 #1).

Semantics mirrored (cited):
- k-means: random-sample init, <=10 Lloyd iterations, empty cluster keeps
  its previous centroid, early stop on unchanged assignment
  (ref: Vector/KMeansUtils.cs:10-68).
- IVF-Flat search: score every centroid, sort descending, scan the top
  ``nprobe`` lists with exact distances, global top-k
  (ref: Vector/IvfFlatVectorIndex.cs:183-219).
- IVF-PQ: coarse k-means seed 123, residual PQ with per-subspace k-means
  seed 42+m (ref: IvfPqVectorIndex.cs:67-107, ProductQuantizer.cs:28-58);
  search scores with ADC tables ONLY — the reference has no rerank stage
  (ref: IvfPqVectorIndex.cs:152-199).
- HNSW: sequential greedy upper descent + best-first SearchLayer(ef) at
  layer 0 (ref: HnswVectorIndex.cs:229-247, 281-325). ``ref_hnsw_search``
  runs on WHATEVER graph the passed index holds: bench.py's ``recall_ref``
  column passes the rebuild's serving graph (diversity-heuristic selection
  by default — isolating device beam vs sequential search on an identical
  graph), while the ``recall_ref_e2e`` column passes a closest-M graph
  (``neighbor_heuristic=False``, the reference's SelectNeighbors :327-331)
  so the number is the reference's own end-to-end recall.

Exact seed-level equality with the C# reference is impossible (System.Random
!= numpy PCG64); what the oracle fixes is the algorithm and hyperparameters,
which is what determines recall on seeded synthetic data.
"""

from __future__ import annotations

import numpy as np


def _l2_sq(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """[N] squared distances of q [D] against x [N, D] (blocked matmul)."""
    return np.maximum(
        (q * q).sum() - 2.0 * (x @ q) + np.einsum("nd,nd->n", x, x), 0.0
    )


_BLOCK = 131072  # rows per assignment block (caps the [B, K] matrix)


def _assign(data: np.ndarray, cents: np.ndarray) -> np.ndarray:
    cc = np.einsum("kd,kd->k", cents, cents)
    out = np.empty(data.shape[0], np.int64)
    for s in range(0, data.shape[0], _BLOCK):
        blk = data[s : s + _BLOCK]
        d2 = (
            np.einsum("nd,nd->n", blk, blk)[:, None]
            - 2.0 * (blk @ cents.T)
            + cc[None, :]
        )
        out[s : s + _BLOCK] = np.argmin(d2, axis=1)
    return out


def ref_kmeans(
    data: np.ndarray, k: int, seed: int, iters: int = 10
) -> np.ndarray:
    """ref: Vector/KMeansUtils.cs:10-68."""
    data = np.asarray(data, np.float32)
    n = data.shape[0]
    k = min(k, n)
    rng = np.random.default_rng(seed)
    cents = data[rng.choice(n, size=k, replace=False)].copy()
    prev = None
    for _ in range(iters):
        assign = _assign(data, cents)
        if prev is not None and np.array_equal(assign, prev):
            break  # ref: early stop at the Lloyd fixed point
        prev = assign
        # per-dim bincount segment-sum (np.add.at is unbuffered and ~10x
        # slower at 1M rows)
        sums = np.stack(
            [np.bincount(assign, weights=data[:, j], minlength=k)
             for j in range(data.shape[1])], axis=1,
        ).astype(np.float32)
        counts = np.bincount(assign, minlength=k).astype(np.float32)
        nz = counts > 0
        cents[nz] = sums[nz] / counts[nz, None]
        # empty cluster keeps previous centroid
    return cents


# ---- IVF-Flat ------------------------------------------------------------

def ref_ivf_build(data: np.ndarray, nlist: int, seed: int = 42):
    """ref: IvfFlatVectorIndex.cs:85-145 (k-means seed 42)."""
    cents = ref_kmeans(data, nlist, seed)
    assign = _assign(data, cents)
    lists = [np.flatnonzero(assign == ci) for ci in range(cents.shape[0])]
    return cents, lists


def ref_ivf_search(
    data: np.ndarray, cents: np.ndarray, lists: list, q: np.ndarray,
    nprobe: int, topk: int,
) -> np.ndarray:
    """ref: IvfFlatVectorIndex.cs:183-219. Returns row indices [topk]."""
    order = np.argsort(_l2_sq(q, cents), kind="stable")[:nprobe]
    rows = np.concatenate([lists[ci] for ci in order]) if len(order) else np.zeros(0, np.int64)
    if rows.size == 0:
        return np.full(topk, -1, np.int64)
    d2 = _l2_sq(q, data[rows])
    best = rows[np.argsort(d2, kind="stable")[:topk]]
    out = np.full(topk, -1, np.int64)
    out[: best.size] = best
    return out


# ---- IVF-PQ ----------------------------------------------------------------

def ref_ivfpq_build(
    data: np.ndarray, nlist: int, m: int, ksub: int,
    coarse_seed: int = 123, pq_seed: int = 42,
):
    """ref: IvfPqVectorIndex.cs:55-116 + ProductQuantizer.cs:28-80."""
    d = data.shape[1]
    sub = d // m
    cents = ref_kmeans(data, nlist, coarse_seed)
    assign = _assign(data, cents)
    residuals = data - cents[assign]
    codebooks = np.zeros((m, ksub, sub), np.float32)
    codes = np.zeros((data.shape[0], m), np.int32)
    for mi in range(m):
        sd = residuals[:, mi * sub : (mi + 1) * sub]
        cb = ref_kmeans(sd, ksub, pq_seed + mi)  # seed 42+m (ref :35)
        codebooks[mi, : cb.shape[0]] = cb
        if cb.shape[0] < ksub:
            codebooks[mi, cb.shape[0] :] = cb[-1]
        codes[:, mi] = _assign(sd, codebooks[mi])
    lists = [np.flatnonzero(assign == ci) for ci in range(cents.shape[0])]
    return cents, lists, codebooks, codes


def ref_ivfpq_search(
    cents: np.ndarray, lists: list, codebooks: np.ndarray, codes: np.ndarray,
    q: np.ndarray, nprobe: int, topk: int,
) -> np.ndarray:
    """Pure ADC, no rerank (ref: IvfPqVectorIndex.cs:152-199)."""
    m, ksub, sub = codebooks.shape
    order = np.argsort(_l2_sq(q, cents), kind="stable")[:nprobe]
    all_rows, all_d = [], []
    for ci in order:
        rows = lists[ci]
        if rows.size == 0:
            continue
        qr = (q - cents[ci]).reshape(m, sub)
        # table[m, k] = ||q_sub - cb[m, k]||^2 (ref ComputeDistanceTable)
        table = (
            np.einsum("ms,ms->m", qr, qr)[:, None]
            - 2.0 * np.einsum("ms,mks->mk", qr, codebooks)
            + np.einsum("mks,mks->mk", codebooks, codebooks)
        )
        adc = table[np.arange(m)[None, :], codes[rows]].sum(axis=1)  # [len]
        all_rows.append(rows)
        all_d.append(adc)
    if not all_rows:
        return np.full(topk, -1, np.int64)
    rows = np.concatenate(all_rows)
    d = np.concatenate(all_d)
    best = rows[np.argsort(d, kind="stable")[:topk]]
    out = np.full(topk, -1, np.int64)
    out[: best.size] = best
    return out


# ---- SQ8 brute force ---------------------------------------------------

def ref_sq8_quantize(x: np.ndarray) -> np.ndarray:
    """Per-vector min/max byte quantization (ref: ScalarQuantizer.cs:22-62;
    zero-range vectors quantize to all-zero codes). ``np.rint`` rounds
    half-to-even, matching C# ``Math.Round``'s default."""
    x = np.asarray(x, np.float32)
    mins = x.min(axis=-1, keepdims=True)
    rng = x.max(axis=-1, keepdims=True) - mins
    scale = np.divide(
        np.float32(255.0), rng, out=np.zeros_like(rng), where=rng > 0
    )
    return np.clip(np.rint((x - mins) * scale), 0, 255).astype(np.uint8)


def ref_sq8_build(data: np.ndarray):
    """Quantized slab (as f32 for the blocked matmul) + squared code norms."""
    codes = ref_sq8_quantize(data).astype(np.float32)
    return codes, np.einsum("nd,nd->n", codes, codes)


def ref_sq8_search(
    codes: np.ndarray, code_sq: np.ndarray, q: np.ndarray, topk: int,
    metric: str = "L2",
) -> np.ndarray:
    """Quantized brute-force scan. The reference quantizes the query on its
    OWN min/max and scores RAW BYTES — both affine transforms (per-vector
    min and scale) are discarded at score time, so its SQ8 recall collapses
    when vector scales vary (ref: BruteForceVectorIndex.cs:297-331 —
    L2Squared8Bit/DotProduct8Bit over the byte spans). The rebuild instead
    decomposes dot(q, x_hat) = min*sum(q) + scale*dot(q, code)
    (index/flat.py sq8_scores), which is why its recall does not."""
    qb = ref_sq8_quantize(q[None])[0].astype(np.float32)
    if metric == "L2":
        scores = -(code_sq - 2.0 * (codes @ qb) + (qb * qb).sum())
    else:  # InnerProduct and Cosine both score the raw byte dot (ref :327-329)
        scores = codes @ qb
    return np.argsort(-scores, kind="stable")[:topk]


# ---- HNSW ------------------------------------------------------------------

def ref_hnsw_search(index, q: np.ndarray, ef: int, topk: int) -> np.ndarray:
    """Sequential reference search on the rebuild's host graph: greedy
    descent through upper layers then best-first SearchLayer(ef) at layer 0
    (ref: HnswVectorIndex.cs:229-325). ``index`` is an HnswIndex of either package
    (it reads ``_entry``, ``_top_level``, ``_greedy_descent_host``,
    ``_search_layer_host``, ``_alive`` and ``metric``).
    Returns row indices [topk] (tombstones excluded)."""
    q = np.asarray(q, np.float32)
    if index.metric.value == "COSINE":
        n = np.linalg.norm(q)
        if n > 1e-12:
            q = q / n
    cur = index._entry
    if cur < 0:
        return np.full(topk, -1, np.int64)
    for lev in range(index._top_level, 0, -1):
        cur = index._greedy_descent_host(q, cur, lev)
    w = index._search_layer_host(q, [cur], max(ef, topk), 0)
    rows = [node for _, node in w if index._alive[node]][:topk]
    out = np.full(topk, -1, np.int64)
    out[: len(rows)] = rows
    return out
