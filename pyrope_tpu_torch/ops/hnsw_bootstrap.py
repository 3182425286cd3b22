"""Device-bootstrapped HNSW construction (port of
``pyrope_tpu/ops/hnsw_bootstrap.py``).

The incremental builder (native/hnsw_builder.cc) is sequential: insert i
depends on the graph after insert i−1, so a 1M-row build walks one host
core. This module builds the same data structure in bulk, with every
distance evaluation a product on the device:

1. coarse k-means over the corpus (ops/kmeans.py) and a cluster-major slab
2. layer-0 candidates: every node's top-R neighbors within its cluster's
   ``nprobe`` nearest clusters (bf16 products summed in fp32, exact top-R)
3. the diversity heuristic (HNSW paper Alg. 4) over nodes in chunks: the
   keep/reject walk over candidate ranks is a loop of a few tensor ops a
   rank, each over a whole chunk of nodes
4. one NN-descent round, symmetrization (reverse edges unioned in on the
   host, then a second selection pass), component grafting (scipy)
5. upper layers: exact KNN among each level's subset, the same selection
   and symmetrization, plus cluster highways

Returns (adj0 [n, 2m], adj_up per level [n, m], entry, top level, levels),
searched by the same beam as the incremental graphs. Where the JAX package
draws candidates with ``lax.approx_max_k(recall_target=0.98)``, the port
selects them exactly (``ops/topk.stable_topk``); on the CPU the two agree.
Rows are independent in every selection, so the chunk size changes no
result; it is large so the per-rank launches stop mattering on the card.
Each stage's time is logged (``_mark``).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from pyrope_tpu_torch.device import resolve_device
from pyrope_tpu_torch.index.ivf_flat import slab_pad
from pyrope_tpu_torch.ops.distance import rounded
from pyrope_tpu_torch.ops.kmeans import kmeans_build
from pyrope_tpu_torch.ops.slab import pad_order, take_slab
from pyrope_tpu_torch.ops.topk import NEG_INF, stable_topk
from pyrope_tpu_torch.types import Metric
from pyrope_tpu_torch.utils.shapes import round_up

logger = logging.getLogger(__name__)

# layer-0 candidate pool per node (before selection), and clusters probed
# per node: the JAX package's values
DEFAULT_KNN_R = 64
DEFAULT_NPROBE = 8
CHUNK = 65_536        # nodes a selection step takes at once
KNN_ROWS = 4096       # corpus rows a candidate product takes at once


def _gather(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[ids] for ids of any shape (rows of x appended as the last dim)."""
    return x.index_select(0, ids.reshape(-1)).view(*ids.shape, *x.shape[1:])


def _scores_to_node(x, sqnorm, node_ids, cand_ids, metric: Metric):
    """score(cand -> node) [C, R] in fp32; -inf for invalid (-1) or self."""
    safe = cand_ids.clamp(min=0)
    nv = x.index_select(0, node_ids)                          # [C, D]
    dots = torch.bmm(_gather(x, safe), nv[:, :, None])[..., 0]
    if metric == Metric.L2:
        nn = sqnorm.index_select(0, node_ids)[:, None]
        s = -torch.clamp(nn - 2.0 * dots + _gather(sqnorm, safe), min=0.0)
    else:
        s = dots
    bad = (cand_ids < 0) | (cand_ids == node_ids[:, None])
    return torch.where(bad, NEG_INF, s)


def _select_fn(x, sqnorm, node_ids, cand_ids, metric: Metric, deg: int):
    """Sort each node's candidates best-first, run the diversity heuristic
    with keep-pruned backfill (the native builder's select_heuristic), and
    return up to ``deg`` neighbor ids a node, -1 padded: [C, deg] int32."""
    s = _scores_to_node(x, sqnorm, node_ids, cand_ids, metric)
    c, r = s.shape
    svals, sel = stable_topk(s, r)                           # best-first
    valid = torch.isfinite(svals)
    cand = torch.where(valid, cand_ids.gather(1, sel), -1)   # [C, R]

    cv = _gather(x, cand.clamp(min=0))                       # [C, R, D]
    pd = torch.bmm(cv, cv.transpose(1, 2))                   # [C, R, R]
    if metric == Metric.L2:
        cc = _gather(sqnorm, cand.clamp(min=0))
        pw = -torch.clamp(cc[:, :, None] - 2.0 * pd + cc[:, None, :], min=0.0)
    else:
        pw = pd
    del cv, pd

    # Alg. 4 walk over candidate ranks: keep e iff e is closer to the node
    # than to every already-kept neighbor
    kept = torch.zeros((c, r), dtype=torch.bool, device=x.device)
    kcount = torch.zeros(c, dtype=torch.int32, device=x.device)
    for rank in range(r):
        closer_to_kept = (kept & (pw[:, rank, :] > svals[:, rank:rank + 1])).any(1)
        take = valid[:, rank] & ~closer_to_kept & (kcount < deg)
        kept[:, rank] = take
        kcount += take
    for rank in range(r):  # keepPrunedConnections backfill, rank order
        take = valid[:, rank] & ~kept[:, rank] & (kcount < deg)
        kept[:, rank] |= take
        kcount += take

    # pack kept candidates left in best-first order, -1 padded to deg
    iota = torch.arange(r, device=x.device).expand(c, r)
    d_eff = min(deg, r)
    order = torch.argsort(torch.where(kept, iota, r + iota), dim=1)[:, :d_eff]
    out = torch.where(kept.gather(1, order), cand.gather(1, order), -1)
    if d_eff < deg:
        out = torch.nn.functional.pad(out, (0, deg - d_eff), value=-1)
    return out.int()


def _chunked_select(x, sqnorm, node_ids: np.ndarray, cand: np.ndarray,
                    deg: int, metric: Metric) -> np.ndarray:
    """``_select_fn`` over chunks of ``CHUNK`` nodes; [n, deg] int32 on the
    host (one fetch at the end)."""
    n = cand.shape[0]
    nodes = torch.from_numpy(np.ascontiguousarray(node_ids, np.int64)).to(x.device)
    cands = torch.from_numpy(np.ascontiguousarray(cand, np.int32)).to(x.device)
    out = torch.cat([
        _select_fn(x, sqnorm, nodes[s:s + CHUNK], cands[s:s + CHUNK], metric, deg)
        for s in range(0, n, CHUNK)
    ])
    return out.cpu().numpy()


def _descend_candidates(adj: np.ndarray, j: int = 2) -> np.ndarray:
    """One NN-descent expansion: each node's current neighbors plus the
    first ``j`` neighbors of each neighbor (two-hop candidates the
    incremental builder's ef_construction search would have found)."""
    n, deg = adj.shape
    nn = adj[np.maximum(adj, 0), :j]                # [n, deg, j], no [n,deg,deg]
    nn[adj < 0] = -1
    return np.concatenate([adj, nn.reshape(n, deg * j)], axis=1)


def _graft_components(adj: np.ndarray, xperm, sqnorm, n: int,
                      metric: Metric) -> np.ndarray:
    """Connect stray graph components to the main one: detect weak
    components (scipy, on the host), then bridge each stray component's
    representative bidirectionally to its nearest node in the main
    component (bf16 products summed in fp32 on the device)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    deg = adj.shape[1]
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    dst = adj.reshape(-1)
    ok = dst >= 0
    g = sp.coo_matrix(
        (np.ones(int(ok.sum()), np.int8), (src[ok], dst[ok])), shape=(n, n)
    )
    ncomp, labels = connected_components(g, directed=True, connection="weak")
    if ncomp <= 1:
        return adj
    counts = np.bincount(labels, minlength=ncomp)
    main = int(np.argmax(counts))
    comp_ids, first_idx = np.unique(labels, return_index=True)
    reps = first_idx[comp_ids != main].astype(np.int64)
    logger.info("hnsw_bootstrap grafting %d stray components", reps.size)

    in_main = np.zeros(xperm.shape[0], bool)
    in_main[:n] = labels == main
    mask = torch.from_numpy(in_main).to(xperm.device)
    xr = rounded(xperm, "bfloat16")
    nn = []
    for s in range(0, reps.size, 256):
        rep = torch.from_numpy(reps[s:s + 256]).to(xperm.device)
        dots = xr.index_select(0, rep) @ xr.T
        if metric == Metric.L2:
            sc = -(sqnorm.index_select(0, rep)[:, None] - 2.0 * dots + sqnorm[None, :])
        else:
            sc = dots
        nn.append(torch.argmax(torch.where(mask[None, :], sc, NEG_INF), dim=1))
    out = adj.copy()
    for rep, tgt in zip(reps.tolist(), torch.cat(nn).cpu().tolist()):
        for a, b in ((rep, tgt), (tgt, rep)):
            row = out[a]
            slot = np.flatnonzero(row < 0)
            row[slot[0] if slot.size else deg - 1] = b
    return out


def _symmetrize(adj: np.ndarray, n: int, rev_cap: int) -> np.ndarray:
    """Union each node's out-edges with up to ``rev_cap`` reverse edges
    (CSR grouping; duplicates and self collapsed to -1 — the selection pass
    that follows re-sorts by score, so order need not be kept)."""
    deg = adj.shape[1]
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    dst = adj.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    order = np.argsort(dst, kind="stable")
    ds, ss = dst[order], src[order]
    counts = np.bincount(ds, minlength=n)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    pos = np.arange(ds.size, dtype=np.int64) - offs[ds]
    keep = pos < rev_cap
    in_adj = np.full((n, rev_cap), -1, np.int32)
    in_adj[ds[keep], pos[keep]] = ss[keep]
    union = np.concatenate([adj, in_adj], axis=1)
    su = np.sort(union, axis=1)
    su[:, 1:][su[:, 1:] == su[:, :-1]] = -1       # dedup
    su[su == np.arange(n, dtype=np.int32)[:, None]] = -1  # drop self
    return su


def _fill_tail_slots(row: np.ndarray, take: list[int]) -> None:
    """Write ``take`` into ``row`` in place: free (-1) slots first, then the
    tail-most OCCUPIED slots not already claimed in this call (blind
    ``m-1-j`` indexing would overwrite a link written a moment before)."""
    free = np.flatnonzero(row < 0)
    slots = list(free[: len(take)])
    if len(take) > len(slots):
        used = set(slots)
        slots += [s for s in range(len(row) - 1, -1, -1)
                  if s not in used][: len(take) - len(slots)]
    for slot, t in zip(slots, take):
        row[slot] = t


def _layer0_candidates(xperm, sqnorm, cents: np.ndarray, offsets: np.ndarray,
                       lens: np.ndarray, n: int, l_pad: int, knn_r: int,
                       nprobe: int, metric: Metric) -> np.ndarray:
    """Top-(R + 1) KNN of the (permuted) corpus against itself: [n, R + 1]
    slab rows, -1 padded (self is in the list; selection masks it).

    Probes are resolved per cluster (its nearest clusters by centroid L2,
    own cluster first), so each block of up to ``KNN_ROWS`` rows of one
    cluster is one dense product against its probed lists' slices, each
    slice ``tier`` rows long: the probed lists' longest length rounded up to
    a power-of-two multiple of 128, capped at ``l_pad`` (the slab's tail
    pad keeps every slice in range)."""
    k = knn_r + 1
    kc = cents.shape[0]
    cc = np.einsum("kd,kd->k", cents, cents)
    cd2 = cc[:, None] - 2.0 * (cents @ cents.T) + cc[None, :]
    np_eff = min(nprobe, kc)
    probe_sets = np.argsort(cd2, axis=1, kind="stable")[:, :np_eff]
    probe_max = lens[probe_sets].max(axis=1)
    tiers = [min(128 * (1 << max(-(-int(pm) // 128) - 1, 0).bit_length()), l_pad)
             for pm in np.maximum(probe_max, 1)]

    dev = xperm.device
    xr = rounded(xperm, "bfloat16")
    out = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    for c in range(kc):
        if lens[c] == 0:
            continue
        tier = tiers[c]
        offs_p = offsets[probe_sets[c]].astype(np.int64)
        xs = torch.cat([xr[o:o + tier] for o in offs_p])            # [P*tier, D]
        ssq = torch.cat([sqnorm[o:o + tier] for o in offs_p])
        t_i = np.arange(tier)
        valid = torch.from_numpy(
            (t_i[None, :] < lens[probe_sets[c]][:, None]).reshape(-1)).to(dev)
        rows = torch.from_numpy((offs_p[:, None] + t_i).reshape(-1)).to(dev)
        start, end = int(offsets[c]), int(offsets[c] + lens[c])
        for s in range(start, end, KNN_ROWS):
            e = min(s + KNN_ROWS, end)
            dots = xr[s:e] @ xs.T
            if metric == Metric.L2:
                sc = -torch.clamp(sqnorm[s:e, None] - 2.0 * dots + ssq[None, :], min=0.0)
            else:
                sc = dots
            vals, ci = stable_topk(torch.where(valid[None, :], sc, NEG_INF), k)
            out[s:e] = torch.where(torch.isfinite(vals), rows[ci], -1).int()
    return out.cpu().numpy()


def _subset_knn(x, sqnorm, subset: np.ndarray, k: int, metric: Metric,
                chunk: int = 2048) -> np.ndarray:
    """Exact KNN (global ids) among a subset of rows, bf16 products summed
    in fp32: [ns, k], -1 padded past ns."""
    ns = subset.shape[0]
    sub = torch.from_numpy(subset.astype(np.int64)).to(x.device)
    sv = rounded(x.index_select(0, sub), "bfloat16")
    ssq = sqnorm.index_select(0, sub)
    keff = min(k, ns)
    out = np.full((ns, k), -1, np.int32)
    res = []
    for s in range(0, ns, chunk):
        dots = sv[s:s + chunk] @ sv.T
        if metric == Metric.L2:
            sc = -(ssq[s:s + chunk, None] - 2.0 * dots + ssq[None, :])
        else:
            sc = dots
        res.append(sub[stable_topk(sc, keff)[1]])
    out[:, :keff] = torch.cat(res).cpu().numpy()
    return out


def bootstrap_build(
    vecs: np.ndarray,
    levels: np.ndarray,
    m: int,
    metric: Metric,
    *,
    device="cuda",
    knn_r: int = DEFAULT_KNN_R,
    nprobe: int = DEFAULT_NPROBE,
    descent_rounds: int = 1,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray, int, int, np.ndarray]:
    """Build the full HNSW layer stack on ``device``.

    vecs [n, D] float32 (cosine rows pre-normalized by the caller), levels
    [n] int32 pre-drawn. Returns (adj0 [n, 2m], adj_up [max_level, n, m],
    entry, top_level, levels) in the INPUT row space — levels may differ
    from the input by cluster-representative promotions to level 1 (every
    k-means cluster is guaranteed a routing-layer node)."""
    dev = resolve_device(device)
    n, dim = vecs.shape
    sm = Metric.INNER_PRODUCT if metric == Metric.COSINE else metric
    nlist = min(int(np.clip(n // 1000, 16, 4000)), n)
    t_start = time.perf_counter()

    def _mark(stage: str) -> None:
        logger.info("hnsw_bootstrap %s at %.2fs", stage,
                    time.perf_counter() - t_start)

    # ---- coarse partition + cluster-major device slab -------------------
    # partition is always L2 (for COSINE/IP the caller's rows are already
    # normalized, so L2 proximity == angular proximity)
    cents, assign, x_dev = kmeans_build(
        vecs, nlist, Metric.L2, device=dev, seed=seed, compute_dtype="bfloat16",
    )
    kc = cents.shape[0]
    order = np.argsort(assign, kind="stable").astype(np.int64)
    lens = np.bincount(assign, minlength=kc).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    l_pad = int(round_up(max(int(lens.max()), 1), 128))
    npad = slab_pad(n, l_pad)
    xperm, sqnorm = take_slab(x_dev, pad_order(order, npad, x_dev.shape[0], dev))
    del x_dev
    _mark("kmeans+slab")

    # ---- layer 0: probe-KNN -> select -> descent -> symmetrize -> select -
    cand = _layer0_candidates(
        xperm, sqnorm, cents[:kc], offsets, lens, n, l_pad, knn_r, nprobe, sm,
    )
    _mark("knn candidates")
    node_ids = np.arange(n, dtype=np.int32)
    deg0 = 2 * m
    adj0_p = _chunked_select(xperm, sqnorm, node_ids, cand, deg0, sm)
    _mark("select pass 1")
    for _ in range(descent_rounds):
        grown = _descend_candidates(adj0_p)
        adj0_p = _chunked_select(xperm, sqnorm, node_ids, grown, deg0, sm)
        _mark("descent round")
    union = _symmetrize(adj0_p, n, rev_cap=m)
    adj0_p = _chunked_select(xperm, sqnorm, node_ids, union, deg0, sm)
    _mark("symmetrize+select")
    adj0_p = _graft_components(adj0_p, xperm, sqnorm, n, sm)
    _mark("graft")

    # ---- upper layers (subset exact KNN + cluster highways) ---------------
    # (a) every k-means cluster gets at least one level-1 node (the row
    #     nearest its centroid), so the routing layer covers the space;
    # (b) each cluster's representative node gets its nearest clusters'
    #     representatives in its tail slots: an explicit backbone for
    #     cross-cluster routing
    levels_perm = levels[order].copy()
    crow_perm = np.repeat(np.arange(kc, dtype=np.int32), lens)
    d2own_host: np.ndarray | None = None

    def _d2own() -> np.ndarray:
        """Distance of every (permuted) row to its own centroid, computed
        on the device in one pass; [n] fp32 to the host."""
        nonlocal d2own_host
        if d2own_host is None:
            crow = torch.from_numpy(crow_perm.astype(np.int64)).to(dev)
            cg = torch.from_numpy(cents).to(dev).index_select(0, crow)
            x = xperm[:n].float()
            dots = (x * cg).sum(-1)
            csq = (cg * cg).sum(-1)
            d2own_host = (sqnorm[:n] - 2.0 * dots + csq).cpu().numpy()
        return d2own_host

    def _cluster_reps(sub_mask: np.ndarray) -> np.ndarray:
        """Per cluster: the masked row nearest its centroid (-1 if none)."""
        d2 = _d2own()
        reps = np.full(kc, -1, np.int32)
        rows = np.flatnonzero(sub_mask)
        if rows.size == 0:
            return reps
        cr = crow_perm[rows]
        order_r = np.lexsort((d2[rows], cr))
        rs, cs = rows[order_r], cr[order_r]
        first = np.concatenate([[True], cs[1:] != cs[:-1]])
        reps[cs[first]] = rs[first]
        return reps

    # (a) promotion: clusters with no level>=1 node
    has_l1 = np.zeros(kc, bool)
    has_l1[np.unique(crow_perm[levels_perm >= 1])] = True
    if not has_l1.all():
        reps_all = _cluster_reps(np.ones(n, bool))
        for c in np.flatnonzero(~has_l1):
            if reps_all[c] >= 0:
                levels_perm[reps_all[c]] = 1

    cc_h = np.einsum("kd,kd->k", cents, cents)
    cd2_h = cc_h[:, None] - 2.0 * (cents @ cents.T) + cc_h[None, :]
    cluster_nn = np.argsort(cd2_h, axis=1, kind="stable")[:, 1:9]  # 8 nearest

    top = int(levels_perm.max(initial=0))
    adj_up_p = []
    for lev in range(1, top + 1):
        subset = np.flatnonzero(levels_perm >= lev).astype(np.int32)
        a = np.full((n, m), -1, np.int32)
        if subset.size > 1:
            c_up = _subset_knn(xperm, sqnorm, subset,
                               min(knn_r, subset.size) + 1, sm)
            sel = _chunked_select(xperm, sqnorm, subset, c_up, m, sm)
            # symmetrize within the layer (ids are global; group by subset)
            dense = np.full((n, m), -1, np.int32)
            dense[subset] = sel
            uni = _symmetrize(dense, n, rev_cap=m)[subset]
            sel = _chunked_select(xperm, sqnorm, subset, uni, m, sm)
            # (b) highways
            sub_mask = np.zeros(n, bool)
            sub_mask[subset] = True
            reps = _cluster_reps(sub_mask)
            live = np.flatnonzero(reps >= 0)
            pos_in_subset = {int(r): i for i, r in enumerate(subset)}
            for c in live:
                u = int(reps[c])
                i = pos_in_subset[u]
                targets = [int(t) for t in reps[cluster_nn[c]]
                           if t >= 0 and t != u and t not in sel[i]]
                row = sel[i]
                n_free = int((row < 0).sum())
                take = targets[: max(n_free, min(4, m // 4))]
                _fill_tail_slots(row, take)
            a[subset] = sel
        adj_up_p.append(a)
    _mark("upper layers")

    # ---- map back to input row space -------------------------------------
    order32 = order.astype(np.int32)

    def to_orig(a):
        mapped = np.where(a >= 0, order32[np.maximum(a, 0)], -1)
        out = np.empty_like(mapped)
        out[order] = mapped  # row p describes original row order[p]
        return out

    adj0 = to_orig(adj0_p)
    adj_up = (
        np.stack([to_orig(a) for a in adj_up_p])
        if adj_up_p else np.zeros((0, n, m), np.int32)
    )
    levels_out = np.empty(n, np.int32)
    levels_out[order] = levels_perm  # includes cluster-rep promotions
    top_rows = np.flatnonzero(levels_out == top)
    entry = int(top_rows[0]) if top_rows.size else 0
    return adj0, adj_up, entry, top, levels_out
