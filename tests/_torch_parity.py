"""Comparison helpers for the PyTorch port's parity tests (test_torch_*.py).

The same numpy inputs go through the JAX function and its port. Both sides
compute in fp32 but sum in a different order (XLA's dot or the Pallas
kernel in interpret mode against torch's matmul or the port's chunked plain
scan), so scores agree to the JAX tests' own tolerance, rtol 1e-5 and atol
1e-4 (tests/test_pallas_scan.py), not bit for bit. Hit sets must be equal;
an ordered list may differ from the other only where adjacent scores lie
within that tolerance.

The two packages have their own types (``Metric``, ``SearchOptions``,
``IndexConfig``, ``IndexStats``): a JAX-side value crosses to the port only
through the ``port_*`` helpers here, never as the JAX object itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pyrope_tpu_torch import types as port_types
from pyrope_tpu_torch.ops import fused_scan as fs
from pyrope_tpu_torch.ops.fused_scan import fused_flat_topk_plain, list_csr

RTOL = 1e-5
ATOL = 1e-4


# the JAX package's SQ8 kernel tolerance (tests/test_pallas_scan.py): the
# scale·(q·code) term's dot runs up to 255·Σ|q|, so summation order shows more
SQ8_RTOL = 1e-4


def assert_same_hits(vals_a, idx_a, vals_b, idx_b, rtol=RTOL) -> None:
    """Per-row equal hit sets, scores within tolerance, and order equal
    except inside runs of near-equal scores. Ids may be ints or strings."""
    va, vb = np.asarray(vals_a, np.float64), np.asarray(vals_b, np.float64)
    ia, ib = np.asarray(idx_a), np.asarray(idx_b)
    assert ia.shape == ib.shape, (ia.shape, ib.shape)
    for row in range(ia.shape[0]):
        assert set(ia[row].tolist()) == set(ib[row].tolist()), (row, ia[row], ib[row])
    np.testing.assert_allclose(va, vb, rtol=rtol, atol=ATOL)
    for row, j in zip(*np.nonzero(ia != ib)):
        near = [jj for jj in (j - 1, j + 1) if 0 <= jj < va.shape[1]
                and np.isclose(va[row, j], va[row, jj], rtol=rtol, atol=ATOL)]
        assert near, f"row {row} rank {j}: {ia[row]} vs {ib[row]} differ outside a tie"


def assert_hits_but_kth_ties(vals_a, idx_a, vals_b, idx_b, rtol=RTOL) -> None:
    """As assert_same_hits, except that a row's hits may differ where every
    differing hit scores within tolerance of the row's k-th score of
    ``vals_b`` (a tie at the k-th place): scores rounded to bf16 tie more
    often than fp32 ones."""
    va, vb = np.asarray(vals_a, np.float64), np.asarray(vals_b, np.float64)
    ia, ib = np.asarray(idx_a), np.asarray(idx_b)
    assert ia.shape == ib.shape, (ia.shape, ib.shape)
    np.testing.assert_allclose(va, vb, rtol=rtol, atol=ATOL)
    for row in range(ia.shape[0]):
        only = set(ia[row].tolist()) ^ set(ib[row].tolist())
        if not only:
            continue
        kth = vb[row][np.isfinite(vb[row])][-1]
        score = {**dict(zip(ib[row].tolist(), vb[row])), **dict(zip(ia[row].tolist(), va[row]))}
        assert all(np.isclose(score[r], kth, rtol=rtol, atol=ATOL) for r in only), (
            f"row {row}: {ia[row]} vs {ib[row]} differ outside a k-th place tie")


def hits_to_arrays(results):
    """search_batch output -> (scores, ids) arrays padded with -inf / ''."""
    k = max((len(r) for r in results), default=0)
    vals = np.full((len(results), k), -np.inf)
    ids = np.full((len(results), k), "", dtype=object)
    for i, row in enumerate(results):
        for j, h in enumerate(row):
            vals[i, j], ids[i, j] = h.score, h.id
    return vals, ids


def assert_same_results(res_a, res_b, rtol=RTOL) -> None:
    """Two search_batch outputs name the same hits with the same scores."""
    assert_same_hits(*hits_to_arrays(res_a), *hits_to_arrays(res_b), rtol=rtol)


# ---- the seam between the two packages' types -------------------------------


def port_metric(metric) -> str:
    """A metric (either package's enum, or a string) as the string value
    both packages parse."""
    return getattr(metric, "value", metric)


def port_options(opts) -> "port_types.SearchOptions":
    """The JAX package's SearchOptions as the port's."""
    return port_types.SearchOptions(**dataclasses.asdict(opts))


def port_config(cfg) -> "port_types.IndexConfig":
    """The JAX package's IndexConfig as the port's (through its dict form)."""
    return port_types.IndexConfig.from_dict(cfg.to_dict())


def stats_tuple(stats) -> tuple:
    """An IndexStats of either package as (count, dim, metric value)."""
    return stats.count, stats.dim, port_metric(stats.metric)


# ---- seeded inputs shared by the kernel tests ------------------------------


def as_tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def flat_case(seed, n, b, d):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d), np.float32)
    q = rng.random((b, d), np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = np.ones(n, bool)
    alive[7:50] = False
    return x, q, sq, alive


def ivf_case(seed, n, b, d, kc, nprobe):
    x, q, sq, alive = flat_case(seed, n, b, d)
    rng = np.random.default_rng(seed + 100)
    lens = rng.multinomial(n, np.ones(kc) / kc)
    crow = np.repeat(np.arange(kc, dtype=np.int32), lens)  # cluster-major
    probe = np.stack([rng.choice(kc, size=nprobe, replace=False)
                      for _ in range(b)]).astype(np.int32)
    return x, q, sq, alive, crow, probe


def csr(crow, kp):
    """(offsets, lens) int32 tensors [kp] of a cluster-major crow."""
    return list_csr(as_tensor(crow), kp)


def sq8_case(seed, n, b, d, kc, nprobe, kp):
    """ivf_case's corpus stored as residual SQ8 against per-cluster means,
    encoded as the JAX package's host encoder does. Returns (q, codes,
    mins, scales, sqnorm of the reconstruction, alive, crow, probe, cents
    [kp, D] zero-padded, qc = q·centsᵀ [B, kp])."""
    x, q, _, alive, crow, probe = ivf_case(seed, n, b, d, kc, nprobe)
    cents = np.zeros((kp, d), np.float32)
    for c in range(kc):
        if (crow == c).any():
            cents[c] = x[crow == c].mean(axis=0)
    r = x - cents[crow]
    mn = r.min(axis=1)
    sc = np.maximum(r.max(axis=1) - mn, 1e-12) / np.float32(255.0)
    codes = np.clip(np.round((r - mn[:, None]) / sc[:, None]), 0, 255).astype(np.uint8)
    xhat = cents[crow] + mn[:, None] + sc[:, None] * codes.astype(np.float32)
    sq = np.einsum("nd,nd->n", xhat, xhat).astype(np.float32)
    return q, codes, mn, sc, sq, alive, crow, probe, cents, q @ cents.T


def list_case(seed, n, b, d, kc, nprobe, *, big=0, empty=0, dead=0.0, dup=False):
    """A cluster-major IVF case for the list scan's layouts. ``big`` extra
    rows go to one cluster (skew); clusters 0..empty-1 hold no rows and
    every third query probes one of them; a ``dead`` share of rows is
    tombstoned; ``dup`` copies a row of one cluster into another and makes
    query 0 that row, probing both (exact score ties across lists).
    Returns (x, q, sq, alive, crow, probe) as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, d), np.float32)
    q = rng.random((b, d), np.float32)
    w = np.ones(kc)
    w[:empty] = 0.0
    lens = rng.multinomial(n - big, w / w.sum())
    hot = empty                               # the skewed cluster
    lens[hot] += big
    crow = np.repeat(np.arange(kc, dtype=np.int32), lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    forced = np.full((b, 2), -1)
    if big:
        forced[::2, 0] = hot
    if empty:
        forced[::3, 1] = rng.integers(0, empty, len(forced[::3]))
    if dup:
        c1, c2 = hot + 1, hot + 2
        r1, r2 = offs[c1] + lens[c1] // 2, offs[c2] + lens[c2] // 2
        x[r2] = x[r1]
        q[0] = x[r1]
        forced[0] = (c1, c2)
    probe = np.empty((b, nprobe), np.int32)
    for i in range(b):
        want = [c for c in forced[i] if c >= 0][:nprobe]
        rest = [c for c in rng.permutation(kc) if c not in want]
        probe[i] = (want + rest)[:nprobe]
    alive = rng.random(n) >= dead
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    return x, q, sq, alive, crow, probe


def sq8_of(case, kp):
    """A list_case's corpus as residual SQ8 against per-cluster means, as
    sq8_case encodes it: (codes, mins, scales, sqnorm of x̂, cents [kp, D],
    qc [B, kp])."""
    x, q, _, _, crow, _ = case
    cents = np.zeros((kp, x.shape[1]), np.float32)
    for c in np.unique(crow):
        cents[c] = x[crow == c].mean(axis=0)
    r = x - cents[crow]
    mn = r.min(axis=1)
    sc = np.maximum(r.max(axis=1) - mn, 1e-12) / np.float32(255.0)
    codes = np.clip(np.round((r - mn[:, None]) / sc[:, None]), 0, 255).astype(np.uint8)
    xhat = cents[crow] + mn[:, None] + sc[:, None] * codes.astype(np.float32)
    sq = np.einsum("nd,nd->n", xhat, xhat).astype(np.float32)
    return codes, mn, sc, sq, cents, (q @ cents.T).astype(np.float32)


def split_partials(q, x, sq, alive, k, per):
    """Per-split plain scans stacked as the scan kernel's [S, B, k] output."""
    parts = []
    for s in range(0, x.shape[0], per):
        split_alive = np.zeros_like(alive)
        split_alive[s:s + per] = alive[s:s + per]
        parts.append(fused_flat_topk_plain(as_tensor(q), as_tensor(x),
                                           as_tensor(sq), as_tensor(split_alive),
                                           x.shape[0], k))
    return (torch.stack([v for v, _ in parts]).contiguous(),
            torch.stack([i for _, i in parts]).contiguous())


# ---- the list scan's work layout, emulated on the CPU -------------------------


def list_item(work, item, lens, offsets, seg, chunk=fs.QUERY_TILE):
    """The kernel's decode of block ``item``: (cluster, pair ids, segment,
    rows lo..hi), or None past the last item."""
    c = int(work.item_c[item])
    if c >= work.ccnt.shape[0]:
        return None
    cnt, n = int(work.ccnt[c]), int(lens[c])
    ns, nch = -(-n // seg), -(-cnt // chunk)
    local = item - (int(work.item_end[c]) - nch * ns)
    ch, s = divmod(local, ns)
    q0 = int(work.cstart[c]) + ch * chunk
    pairs = work.pairs[q0:q0 + min(chunk, cnt - ch * chunk)].long()
    lo = int(offsets[c]) + s * seg
    return c, pairs, s, lo, int(offsets[c]) + min(n, (s + 1) * seg)


def list_partials_emulated(item_scores, alive, offsets, lens, probe, kp, k, max_len,
                           seg, chunk=fs.QUERY_TILE, order=None):
    """Plain emulation of the list scan kernel's work layout: invert_probes,
    then every item's sorted lists into its queries' slots (``slot_of``)
    of the [slots, k] partials, as the kernel writes them. Returns
    (part_v, part_i, work); slots no item wrote hold NaN / -2.
    ``item_scores(b_ids, c, s, e)`` -> [len(b_ids), e-s] scores of rows
    s..e of cluster c. Items run in ``order`` (default: item order), one
    after another, with the kernel's per-query floor: an item keeps only
    the rows that beat its query's floor, and a full list of k such rows
    raises the floor to its k-th entry."""
    b, nprobe = probe.shape
    work = fs.invert_probes(probe, lens, kp, max_len, seg, int(lens.sum()), chunk)
    part_v = torch.full((work.slots, k), float("nan"))
    part_i = torch.full((work.slots, k), -2, dtype=torch.int32)
    floor_v = torch.full((b,), float("-inf"))
    floor_i = torch.full((b,), -1, dtype=torch.int64)
    for item in (range(work.grid) if order is None else order):
        got = list_item(work, item, lens, offsets, seg, chunk)
        if got is None:
            continue
        c, pairs, s, lo, hi = got
        bq = pairs // nprobe
        sc = torch.where(alive[None, lo:hi], item_scores(bq, c, lo, hi), float("-inf"))
        fv, fi = floor_v[bq, None], floor_i[bq, None]
        rows = torch.arange(lo, hi)[None, :]
        above = (sc > fv) | ((sc == fv) & (rows < fi))  # beats the floor
        sc = torch.where(above, sc, float("-inf"))
        vals, pos = torch.sort(sc, dim=1, descending=True, stable=True)
        kk = min(k, hi - lo)
        vals, rows = vals[:, :kk], torch.where(torch.isfinite(vals), pos + lo, -1)[:, :kk]
        slot = slot_of(work, pairs, lens[c], seg) + s
        part_v[slot], part_i[slot] = float("-inf"), -1
        part_v[slot, :kk], part_i[slot, :kk] = vals, rows.int()
        if kk == k:  # a full list: its k-th entry beats the floor it started from
            full = torch.isfinite(vals[:, -1])
            floor_v[bq[full]] = vals[full, -1]
            floor_i[bq[full]] = rows[full, -1]
    return part_v, part_i, work


def slot_of(work, pairs, n, seg):
    """The first partial slot of pairs ``pairs`` of one list of ``n`` rows,
    as the kernel computes it: the running segment count less the list's."""
    return work.slot_end.view(-1)[pairs].long() - -(-int(n) // seg)


def query_offsets(work):
    """[B+1]: query b's partial slots are qoff[b] .. qoff[b+1]."""
    return torch.nn.functional.pad(work.slot_end[:, -1], (1, 0))


def list_scan_emulated(*args, **kw):
    """``list_partials_emulated``, then the merge over each query's slots."""
    part_v, part_i, work = list_partials_emulated(*args, **kw)
    return fs.merge_partials_plain(part_v, part_i, work.slot_end)


def _l2_or_ip(q, dots, sq, metric):
    if port_types.Metric.parse(metric) == port_types.Metric.INNER_PRODUCT:
        return dots
    return -torch.clamp((q * q).sum(1, keepdim=True) - 2.0 * dots + sq[None, :], min=0.0)


def fused_ivf_topk_emulated(q, x, sqnorm, alive, offsets, lens, probe, kp, k,
                            metric="L2", *, max_len=None, seg=fs.LIST_SEG, order=None):
    """``list_scan_emulated`` with the IVF scores (CPU tensors)."""
    return list_scan_emulated(
        lambda bq, c, s, e: _l2_or_ip(q[bq], q[bq] @ x[s:e].T, sqnorm[s:e], metric),
        alive, offsets, lens, probe, kp, k,
        int(lens.max()) if max_len is None else max_len, seg, order=order)


def fused_ivf_sq8_topk_emulated(q, codes, mins, scales, sqnorm, alive, offsets,
                                lens, probe, qc, kp, k, metric="L2", *, seg=fs.LIST_SEG):
    """``list_scan_emulated`` with the SQ8 scores (CPU tensors)."""
    ip = port_types.Metric.parse(metric) == port_types.Metric.INNER_PRODUCT

    def item_scores(bq, c, s, e):
        crow = torch.full((e - s,), c, dtype=torch.int32)
        return fs.sq8_scores(q[bq], qc[bq], codes[s:e], mins[s:e], scales[s:e],
                             sqnorm[s:e], crow, ip)

    return list_scan_emulated(item_scores, alive, offsets, lens, probe, kp, k,
                              int(lens.max()), seg)


# ---- the flat scan's block and the merge's head floor, emulated on the CPU ----


def _beats(v, r, tv, ti):
    """(v, r) strictly precedes (tv, ti) in (score desc, row asc) order, as
    the kernels' ``beats`` compares floats."""
    return v > tv or (v == tv and r < ti)


class _SortedList:
    """A kernel top-k list: at most k entries in (score desc, row asc)
    order; ``kth`` is its k-th entry, (-inf, -1) while it is not full."""

    def __init__(self, k):
        self.k, self.items = k, []

    @property
    def kth(self):
        return self.items[-1] if len(self.items) == self.k else (float("-inf"), -1)

    def offer_batch(self, cands, threshold=None):
        """``warp_offer_batch``: every candidate that beats ``threshold``
        (default: the k-th entry) goes in by rank; what lands past k drops."""
        tv, ti = self.kth if threshold is None else threshold
        take = [(v, r) for v, r in cands if _beats(v, r, tv, ti)]
        self.items = sorted(self.items + take, key=lambda e: (-e[0], e[1]))[:self.k]

    def padded(self):
        return self.items + [(float("-inf"), -1)] * (self.k - len(self.items))


def flat_scan_emulated(scores, row_ok, max_scans, k, *, query_tile, per, n_splits,
                       batch=16, seed=0, refresh_every=None):
    """Plain emulation of the flat scan kernel's blocks on a [B, N] score
    matrix: grid (query tiles) x (``n_splits`` splits of ``per`` rows). A
    warp owns a query's list in its block. Per row tile it compares the
    query's scores with the threshold ((+inf, -1) for a padding query): if
    the best score reaches the threshold's, the rows that beat it are
    offered ``batch`` rows at a time, and a full list whose k-th entry beats
    the threshold raises it. Every split publishes the c-th score of its
    list (``fs.flat_floor``); after tiles 0, 1, 3, 7, ... and every 32nd
    (``refresh_every``: after every that many) a block takes the g-th
    largest score t its window of splits has published and, where that is
    higher, (t, INT_MAX) as its threshold. The blocks of the grid advance a
    tile at a time in a seeded random order, as concurrent blocks might.
    Returns the [B, S, k] partials the kernel writes (float32 scores, int32
    rows)."""
    b, n = scores.shape
    rng = np.random.default_rng(seed)
    sc, ok = scores.numpy(), row_ok.numpy()
    part_v = np.full((b, n_splits, k), np.nan, np.float32)
    part_i = np.full((b, n_splits, k), -2, np.int32)
    c, g = fs.flat_floor(k, n_splits)
    pub = np.full((b, n_splits), -np.inf, np.float32)
    win = fs.FLAT_FLOOR_WINDOW
    blocks = []
    for q0 in range(0, b, query_tile):
        for s in range(n_splits):
            limit = min(s * per + per, n, max_scans)
            real = min(query_tile, b - q0)
            blocks.append(dict(
                q0=q0, s=s, limit=limit, t=0,
                tiles=list(range(s * per, max(limit, s * per), fs.ROW_TILE)),
                lists=[_SortedList(k) for _ in range(real)],
                thr=[(float("-inf"), -1)] * real))
    active = [blk for blk in blocks if blk["tiles"]]
    while active:
        for at in rng.permutation(len(active)):
            blk = active[at]
            row0 = blk["tiles"].pop(0)
            rows = np.arange(row0, min(row0 + fs.ROW_TILE, blk["limit"]))
            for i, lst in enumerate(blk["lists"]):
                q = blk["q0"] + i
                vals = np.where(ok[rows], sc[q, rows], -np.inf)
                if not vals.max() >= blk["thr"][i][0]:    # one vote for the tile
                    continue
                for g0 in range(0, len(rows), batch):
                    cands = [(float(v), int(r)) for v, r in
                             zip(vals[g0:g0 + batch], rows[g0:g0 + batch])
                             if _beats(v, r, *blk["thr"][i])]
                    if not cands:
                        continue
                    lst.offer_batch(cands, blk["thr"][i])
                    if _beats(*lst.kth, *blk["thr"][i]):
                        blk["thr"][i] = lst.kth
                    if len(lst.items) >= c:
                        pub[q, blk["s"]] = max(pub[q, blk["s"]], lst.items[c - 1][0])
            t = blk["t"]
            blk["t"] += 1
            due = ((t & (t + 1)) == 0 or (t & 31) == 31 if refresh_every is None
                   else (t + 1) % refresh_every == 0)
            if due:
                w0 = max(0, min(blk["s"] // win * win, n_splits - win))
                for i in range(len(blk["lists"])):
                    seen = np.sort(pub[blk["q0"] + i, w0:w0 + win])[::-1]
                    floor = float(seen[g - 1])             # the g-th largest
                    if floor > blk["thr"][i][0]:
                        blk["thr"][i] = (floor, 2**31 - 1)
        active = [blk for blk in active if blk["tiles"]]
    for blk in blocks:
        for i, lst in enumerate(blk["lists"]):
            ent = lst.padded()
            part_v[blk["q0"] + i, blk["s"]] = [v for v, _ in ent]
            part_i[blk["q0"] + i, blk["s"]] = [r for _, r in ent]
    return torch.from_numpy(part_v), torch.from_numpy(part_i)


def merge_emulated(part_v, part_i, batch=32):
    """Plain emulation of the merge kernel on [S, B, k] partials: all list
    heads are offered first (so the k-th best head is the threshold when a
    query has k lists or more), then every other entry, ``batch`` at a time,
    only those beating the threshold going in."""
    s, b, k = part_v.shape
    out_v = np.full((b, k), -np.inf, np.float32)
    out_i = np.full((b, k), -1, np.int32)
    pv, pi = part_v.numpy(), part_i.numpy()
    for q in range(b):
        lst = _SortedList(k)
        heads = [(float(pv[l, q, 0]), int(pi[l, q, 0])) for l in range(s)]
        rest = [(float(pv[l, q, e]), int(pi[l, q, e])) for l in range(s)
                for e in range(1, k)]
        for cands in (heads, rest):
            for c0 in range(0, len(cands), batch):
                lst.offer_batch(cands[c0:c0 + batch])
        ent = lst.padded()
        out_v[q] = [v for v, _ in ent]
        out_i[q] = [r for _, r in ent]
    return torch.from_numpy(out_v), torch.from_numpy(out_i)
