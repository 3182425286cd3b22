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
import pytest
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


def ivf_plain_exact(q, x16, sqnorm, alive, crow, probe, kp, k, metric="L2"):
    """``fs.fused_ivf_topk_plain`` over a bf16 slab without promote, with
    bf16(q)·x summed exactly: the exact products summed in float64 and
    rounded once to fp32 (‖q‖², the sqnorm and the L2 combination in fp32,
    as the plain version). The reference the tensor-core list scan is held
    to, so that a comparison sees the kernel's own rounding alone: two fp32
    orders of the same sum drift apart by more than ATOL where a
    near-duplicate's L2 cancels ‖q‖² and ‖x‖² of ~128 (1.7e-4 at D 384,
    tests/bf16_sum_witness.py)."""
    ip = fs._metric_ip(metric)
    qd = q.bfloat16().double()

    def tile(s, e):
        return fs._l2_or_ip(q, (qd @ x16[s:e].double().T).float(), sqnorm[s:e], ip)

    return fs._plain_scan(q, x16.shape[0], tile, fs._probed_rows(probe, kp, crow, alive), k,
                          8192)


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


@pytest.fixture(scope="module", autouse=True)
def jax_native_build_dir(tmp_path_factory):
    """For the modules that import it: the JAX package's native HNSW
    library, built anew for the module in a directory of its own. The JAX
    package builds it in place, with no temporary name, and keeps a failed
    load for the process (then its add_batch inserts row by row), so a
    build shared with another test worker could hand this one a partial
    file. The loader's state is restored after the module."""
    from pyrope_tpu.native import build as jax_native

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYROPE_NATIVE_BUILD_DIR", str(tmp_path_factory.mktemp("jax_native")))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        yield


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


def _key(e):
    """A list entry's place in the lists' order as a sortable tuple (larger
    is better): the kernels' floor_key."""
    return (e[0] + 0.0, -e[1])


def _best(a, b):
    """The better of two entries (either may be None)."""
    if a is None or b is None:
        return a if b is None else b
    return a if _key(a) >= _key(b) else b


def list_window(work, b, slot, nslots, win=fs.LIST_FLOOR_WINDOW):
    """The window of query b's slots whose keys its floor is read from, as
    the kernel computes it: ``win`` slots of qoff[b] .. qoff[b+1] that hold
    ``slot``."""
    se = work.slot_end.reshape(-1)
    nprobe = work.slot_end.shape[1]
    lo = int(se[b * nprobe - 1]) if b else 0
    hi = min(int(se[b * nprobe + nprobe - 1]), nslots)
    w0 = max(lo, min(lo + ((slot - lo) & ~(win - 1)), hi - win))
    return w0, min(w0 + win, hi)


def list_partials_emulated(item_scores, alive, offsets, lens, probe, kp, k, max_len,
                           seg, chunk=fs.QUERY_TILE, order=None, wide_cap=None,
                           floor="slots", concurrent=1, stats=None, prefloor=None,
                           floor_strict=False, tc=False):
    """Plain emulation of the list scan kernel's work layout: invert_probes,
    then every item's sorted lists into its queries' slots (``slot_of``)
    of the [slots, width] partials, as the kernel writes them. Returns
    (part_v, part_i, work); slots no item wrote hold NaN / -2.
    ``item_scores(b_ids, c, s, e)`` -> [len(b_ids), e-s] scores of rows
    s..e of cluster c. Items start in ``order`` (default: item order),
    ``concurrent`` at a time, each advancing a row tile in turn.

    ``floor`` is the kernel's floor: "slots" (published across a query's
    slots, ``fs.list_floor``'s (c, g)): after each tile an item's list
    publishes its c-th entry to the slot once it holds c entries (the
    narrow few-query layout, whose lists meet at the end, at the end); an
    item that ends takes the g-th largest key of its window of the query's
    slots (``list_window``) as the query's floor where that is higher (g =
    1: each published entry raises the floor at once); an item starts from its queries' floors and reads them again at tiles 1,
    2, 4, 8, ...; rows must beat the threshold (the floor, or a full list's
    last entry) to be offered. "query": the per-query floor it replaced (a
    full list of k of an item's rows raises its query's floor to the k-th,
    read when an item starts). None: no floor. A slot holds
    ``fs.list_slot_width(k, seg, max_len)`` entries; with ``wide_cap`` each
    list is a ``WideListEmulated`` of that many slots and that buffer, fed
    the item's rows 32 at a time; else, as in the kernel, a list starts as
    ``width`` copies of the floor the item started from, and the copies
    (that floor's row) are left out when the list is written or published.
    ``stats``, a dict, gets the rows offered to lists ("offered") and the
    thresholds a floor raised during an item's walk ("raised").

    The wide lists (``wide_cap``) keep rows at or above a floor (the floor's
    own row stays a candidate: the threshold is the entry just after it),
    ``floor_strict`` (a mutant) rows that beat it. ``prefloor`` (an
    ``fs.ListPrefloor``): the first pass runs before the items,
    ``list_prefloor_emulated``, and each query starts from its floor.

    ``tc``: the tensor-core list scan's form (csrc/ivf_list_scan_tc.cu): a
    narrow list starts empty with its threshold apart (no floor copies), it
    keeps rows at or above a floor as the wide lists do, and every item
    publishes after each tile (no few-query layout)."""
    b, nprobe = probe.shape
    work = fs.invert_probes(probe, lens, kp, max_len, seg, int(lens.sum()), chunk)
    width = fs.list_slot_width(k, seg, max_len)
    part_v = torch.full((work.slots, width), float("nan"))
    part_i = torch.full((work.slots, width), -2, dtype=torch.int32)
    c_pub, g_pub = fs.list_floor(k, nprobe, width)
    pub = [None] * work.slots            # the slots' published entries
    qfloor = [None] * b                  # the queries' floors
    offered = raised = 0
    no_thr = (float("-inf"), -1)
    if prefloor is not None:
        qfloor = list_prefloor_emulated(item_scores, alive, offsets, lens, work, seg,
                                        prefloor, chunk)

    def floor_thr(e):
        """The threshold a floor entry gives: the entry itself (rows must
        beat it), or in the wide mode the entry just after it."""
        if e is None:
            return no_thr
        return e if (wide_cap is None and not tc) or floor_strict else (e[0], e[1] + 1)

    def start(item):
        got = list_item(work, item, lens, offsets, seg, chunk)
        if got is None:
            return None
        c, pairs, s, lo, hi = got
        bq = (pairs // nprobe).tolist()
        slots = (slot_of(work, pairs, lens[c], seg) + s).tolist()
        sc = torch.where(alive[None, lo:hi], item_scores(pairs // nprobe, c, lo, hi),
                         float("-inf"))
        small = len(bq) <= 8 and wide_cap is None and not tc
        thr = [floor_thr(qfloor[q]) if floor else no_thr for q in bq]
        lists = [WideListEmulated(width, wide_cap) if wide_cap else [] if tc else [f0] * width
                 for f0 in thr]
        return dict(lo=lo, hi=hi, bq=bq, slots=slots, sc=sc, small=small, lists=lists,
                    thr=thr, f0=list(thr), tile=0)

    def entries(it, i):
        """The list's own entries: not the copies of the first floor."""
        lst = it["lists"][i]
        if wide_cap:
            return lst.items
        if tc:
            return list(lst)
        return [e for e in lst if e[1] != it["f0"][i][1]]

    def publish(it, i):
        ent = entries(it, i)
        if len(ent) >= c_pub and it["slots"][i] < work.slots:
            pub[it["slots"][i]] = _best(pub[it["slots"][i]], ent[c_pub - 1])
            if g_pub == 1:   # c = k: the entry is a floor by itself
                q = it["bq"][i]
                qfloor[q] = _best(qfloor[q], ent[c_pub - 1])

    def step(it):
        nonlocal offered, raised
        t = it["tile"]
        r0 = it["lo"] + t * fs.ROW_TILE
        r1 = min(r0 + fs.ROW_TILE, it["hi"])
        fresh = floor == "slots" and t and ((t - 1) & t) == 0
        for i, q in enumerate(it["bq"]):
            if fresh and qfloor[q] is not None and _key(floor_thr(qfloor[q])) > _key(
                    it["thr"][i]):
                it["thr"][i] = floor_thr(qfloor[q])
                raised += 1
            row = it["sc"][i, r0 - it["lo"]:r1 - it["lo"]].tolist()
            lst = it["lists"][i]
            for g0 in range(0, r1 - r0, 32):            # a warp's offer: 32 rows
                tv, ti = it["thr"][i]
                cands = [(v, r0 + g0 + j) for j, v in enumerate(row[g0:g0 + 32])
                         if _beats(v, r0 + g0 + j, tv, ti)]
                offered += len(cands)
                if wide_cap:
                    lst.offer_batch(cands, it["thr"][i])
                    it["thr"][i] = _best(it["thr"][i], lst.kth if lst.fill >= width
                                         else None)
                elif cands:
                    lst[:] = sorted(lst + cands, key=lambda e: (-e[0], e[1]))[:width]
                    if len(lst) == width:   # a full list's last entry
                        it["thr"][i] = _best(it["thr"][i], lst[-1])
            if floor == "slots" and not it["small"]:
                publish(it, i)
        it["tile"] += 1
        return r1 >= it["hi"]

    def finish(it):
        for i, q in enumerate(it["bq"]):
            lst = it["lists"][i]
            if wide_cap:
                lst.padded()
            ent = entries(it, i)
            slot = it["slots"][i]
            if slot < work.slots:
                part_v[slot], part_i[slot] = float("-inf"), -1
                if ent:
                    part_v[slot, :len(ent)] = torch.tensor([v for v, _ in ent])
                    part_i[slot, :len(ent)] = torch.tensor([r for _, r in ent],
                                                           dtype=torch.int32)
            if floor == "slots":
                publish(it, i)
            elif floor == "query" and len(ent) == k:
                qfloor[q] = _best(qfloor[q], ent[-1])
        if floor == "slots" and g_pub > 1:
            for i, q in enumerate(it["bq"]):
                w0, w1 = list_window(work, q, it["slots"][i], work.slots)
                seen = sorted((e for e in pub[w0:w1] if e is not None), key=_key,
                              reverse=True)
                if g_pub <= len(seen):
                    qfloor[q] = _best(qfloor[q], seen[g_pub - 1])

    pending = list(range(work.grid) if order is None else order)
    running = []
    while pending or running:
        while pending and len(running) < concurrent:
            it = start(pending.pop(0))
            if it is not None:
                running.append(it)
        for it in list(running):
            if step(it):
                finish(it)
                running.remove(it)
    if stats is not None:
        stats.update(offered=offered, raised=raised)
    return part_v, part_i, work


def list_prefloor_emulated(item_scores, alive, offsets, lens, work, seg, plan, chunk):
    """The wide list scan's first pass, emulated: every item scans the first
    ``plan.sample`` rows of its segment and its slots publish the c-th
    entry of their queries' rows there (none under c rows); then each
    query's floor is the g-th largest of its slots' entries (None under g),
    as floor_select_kernel takes it. Returns the queries' floors."""
    nprobe = work.slot_end.shape[1]
    first = [None] * work.slots
    for item in range(work.grid):
        got = list_item(work, item, lens, offsets, seg, chunk)
        if got is None:
            continue
        c, pairs, s, lo, hi = got
        hi = min(hi, lo + plan.sample)
        sc = torch.where(alive[None, lo:hi], item_scores(pairs // nprobe, c, lo, hi),
                         float("-inf"))
        for i, slot in enumerate((slot_of(work, pairs, lens[c], seg) + s).tolist()):
            ent = sorted(((v, lo + j) for j, v in enumerate(sc[i].tolist())
                          if v > float("-inf")), key=lambda e: (-e[0], e[1]))
            if slot < work.slots and len(ent) >= plan.c:
                first[slot] = ent[plan.c - 1]
    g = plan.g
    qoff = query_offsets(work).tolist()
    floors = []
    for q in range(work.slot_end.shape[0]):
        seen = sorted((e for e in first[qoff[q]:qoff[q + 1]] if e is not None), key=_key,
                      reverse=True)[:fs.FLOOR_SELECT_CAP]
        floors.append(seen[g - 1] if 1 <= g <= len(seen) else None)
    return floors


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
    return fs.merge_partials_plain(part_v, part_i, work.slot_end, args[6])


def _l2_or_ip(q, dots, sq, metric):
    if port_types.Metric.parse(metric) == port_types.Metric.INNER_PRODUCT:
        return dots
    return -torch.clamp((q * q).sum(1, keepdim=True) - 2.0 * dots + sq[None, :], min=0.0)


def ivf_item_scores(q, x, sqnorm, metric="L2"):
    """``item_scores`` of the IVF list scan (CPU tensors)."""
    return lambda bq, c, s, e: _l2_or_ip(q[bq], q[bq] @ x[s:e].T, sqnorm[s:e], metric)


def fused_ivf_topk_emulated(q, x, sqnorm, alive, offsets, lens, probe, kp, k,
                            metric="L2", *, max_len=None, seg=fs.LIST_SEG, **kw):
    """``list_scan_emulated`` with the IVF scores (CPU tensors); ``kw`` as
    ``list_partials_emulated`` takes them (order, wide_cap, floor, ...)."""
    return list_scan_emulated(
        ivf_item_scores(q, x, sqnorm, metric), alive, offsets, lens, probe, kp, k,
        int(lens.max()) if max_len is None else max_len, seg, **kw)


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
                       batch=16, seed=0, refresh_every=None, make_list=None,
                       flush_min=None, pub_short=0, stats=None, floor0=None,
                       floor_strict=False):
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
    ``make_list(k)`` builds a list (default ``_SortedList``; the wide mode's
    ``WideListEmulated``). ``flush_min`` (the bf16 scan's wide mode): at
    those same tiles, before the floor is read, a list whose buffer holds
    that many entries or more flushes, raises its threshold and publishes.
    ``pub_short`` (a mutant): publish the (c - pub_short)-th entry.
    ``stats`` (a dict) gets the candidates offered, summed in "offered".
    ``floor0`` ([B] scores, -inf: none; the wide mode's first pass): each
    query's threshold starts at (floor0, INT_MAX), rows scoring floor0 or
    more stay; ``floor_strict`` (a mutant) at (floor0, -1), rows scoring
    more.
    Returns the [B, S, k] partials the kernel writes (float32 scores, int32
    rows)."""
    make_list = make_list or _SortedList
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
                lists=[make_list(k) for _ in range(real)],
                thr=[_first_floor(floor0, q0 + i, floor_strict) for i in range(real)]))
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
                    if stats is not None:
                        stats["offered"] = stats.get("offered", 0) + len(cands)
                    lst.offer_batch(cands, blk["thr"][i])
                    if _beats(*lst.kth, *blk["thr"][i]):
                        blk["thr"][i] = lst.kth
                    if len(lst.items) >= c:
                        pub[q, blk["s"]] = max(pub[q, blk["s"]],
                                               lst.items[c - 1 - pub_short][0])
            t = blk["t"]
            blk["t"] += 1
            due = ((t & (t + 1)) == 0 or (t & 31) == 31 if refresh_every is None
                   else (t + 1) % refresh_every == 0)
            if due and flush_min is not None:
                for i, lst in enumerate(blk["lists"]):
                    if len(lst.buf) >= flush_min:
                        lst.flush()
                        if _beats(*lst.kth, *blk["thr"][i]):
                            blk["thr"][i] = lst.kth
                        if len(lst.items) >= c:
                            q = blk["q0"] + i
                            pub[q, blk["s"]] = max(pub[q, blk["s"]],
                                                   lst.items[c - 1 - pub_short][0])
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


def _first_floor(floor0, q, strict):
    """A flat block's first threshold for query q: none, or the first
    pass's floor score with the row that keeps its ties (INT_MAX) or drops
    them (-1, the strict mutant)."""
    if floor0 is None or not float(floor0[q]) > float("-inf"):
        return (float("-inf"), -1)
    return (float(floor0[q]), -1 if strict else 2**31 - 1)


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


# ---- the wide lists (k > 128, csrc/topk_wide.cuh), emulated on the CPU --------


def _next_pow2(n):
    p = 1
    while p < n:
        p <<= 1
    return p


class WideListEmulated:
    """The kernels' wide list step by step: kw slots (the first ``fill``
    real) that only a flush of the CAP-entry candidate buffer changes.
    ``offer_batch(cands, threshold)`` is ``wide_offer``: the candidates that
    beat the threshold go into the buffer in lane order; when they do not
    fit, the buffer is flushed first (``wide_flush``: bitonic sort, then the
    in-place merge by rank, list entries moved from the end backwards 32 at
    a time) and the candidates are filtered again by the raised threshold.
    ``padded()`` flushes what is left and pads the slots past the fill.
    ``mutant`` breaks one step: "row_desc" (ties by row desc), "drop_last"
    (no last flush), "forward" (list entries moved from the front)."""

    def __init__(self, kw, cap=fs.FLAT_WIDE_CAP, mutant=None):
        self.kw, self.cap, self.mutant = kw, cap, mutant
        self.lv = [float("nan")] * kw
        self.li = [-2] * kw
        self.fill, self.buf, self.flushes = 0, [], 0

    def _beats(self, a, b):
        if self.mutant == "row_desc":
            return a[0] > b[0] or (a[0] == b[0] and a[1] > b[1])
        return _beats(*a, *b)

    def _rank(self, seq, n, x):
        """Entries of seq[:n] that beat x: the kernels' binary search."""
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) >> 1
            if self._beats(seq[mid], x):
                lo = mid + 1
            else:
                hi = mid
        return lo

    @property
    def items(self):
        return list(zip(self.lv[:self.fill], self.li[:self.fill]))

    @property
    def kth(self):
        if self.fill < self.kw:
            return (float("-inf"), -1)
        return (self.lv[self.kw - 1], self.li[self.kw - 1])

    def offer_batch(self, cands, threshold=None):
        thr = self.kth if threshold is None else threshold
        take = [c for c in cands if self._beats(c, thr)]
        if len(self.buf) + len(take) > self.cap:
            self.flush()
            if self._beats(self.kth, thr):
                thr = self.kth
            take = [c for c in take if self._beats(c, thr)]
        self.buf += take

    def flush(self):
        m = len(self.buf)
        if not m:
            return
        self.flushes += 1
        p = max(32, _next_pow2(m))
        a = self.buf + [(float("-inf"), -1)] * (p - m)
        size = 2
        while size <= p:                       # warp_sort_buf
            stride = size >> 1
            while stride:
                for t in range(p >> 1):
                    i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1))
                    j = i + stride
                    if self._beats(a[j], a[i]) == ((i & size) == 0):
                        a[i], a[j] = a[j], a[i]
                stride >>= 1
            size <<= 1
        run = a[:m]
        lst = list(zip(self.lv, self.li))      # warp_merge_run
        dst = [t + self._rank(lst, self.fill, run[t]) for t in range(m)]
        r0, top = dst[0], min(self.fill, self.kw)
        chunks = list(range(top, r0, -32))
        if self.mutant == "forward":
            chunks = chunks[::-1]
        for hi in chunks:
            got = [(j, (self.lv[j], self.li[j])) for j in range(max(r0, hi - 32), hi)]
            for j, e in got:
                dest = j + self._rank(run, m, e)
                if dest < self.kw:
                    self.lv[dest], self.li[dest] = e
        for t, d in enumerate(dst):
            if d < self.kw:
                self.lv[d], self.li[d] = run[t]
        self.fill, self.buf = min(self.fill + m, self.kw), []

    def padded(self):
        if self.mutant != "drop_last":
            self.flush()
        return self.items + [(float("-inf"), -1)] * (self.kw - self.fill)


def wide_stream_emulated(vals, kw, *, cap=fs.LIST_WIDE_CAP, lanes=32, floor=None,
                         mutant=None, reach=False):
    """One wide list fed rows 0..n-1 with scores ``vals`` (-inf: masked),
    ``lanes`` rows an offer, behind the threshold (a full list's last entry,
    or ``floor`` where that is higher), as a list-scan warp offers them;
    with ``reach`` (the wide mode behind a first pass's floor) rows at or
    above ``floor`` stay, the floor's own row among them. Returns (values,
    rows) of the padded list and the list."""
    lst = WideListEmulated(kw, cap, mutant)
    thr = (float("-inf"), -1) if floor is None else floor
    if reach and floor is not None:
        thr = (floor[0], floor[1] + 1)
    for r0 in range(0, len(vals), lanes):
        cands = [(float(vals[r]), r) for r in range(r0, min(r0 + lanes, len(vals)))]
        lst.offer_batch(cands, thr)
        if _beats(*lst.kth, *thr):
            thr = lst.kth
    ent = lst.padded()
    return (np.array([v for v, _ in ent], np.float32),
            np.array([r for _, r in ent], np.int32), lst)


# ---- the wide merge (merge_wide_kernel of fused_scan.cu), emulated on the CPU --

MERGE_WIDE_KEYS = 256                  # MW_KEYS: lists whose c-th entries make the floor
MERGE_WIDE_CAPS = (1024, 16384)        # MW_MIN_CAP, MW_MAX_CAP: the run buffer's bounds


def merge_wide_cap(k):
    """The wide merge's run buffer, entries: the next power of two of 4k
    within MERGE_WIDE_CAPS, as pyrope_merge_partials_wide sizes it."""
    cap = MERGE_WIDE_CAPS[0]
    while cap < MERGE_WIDE_CAPS[1] and cap < 4 * k:
        cap <<= 1
    return cap


def merge_wide_emulated(part_v, part_i, qend=None, k=None, cap=None, stats=None):
    """Plain emulation of the wide merge kernel, a query at a time, on
    merge_partials' layouts ([S, B, w], or [slots, w] rows cut by ``qend``):
    the floor F is the largest, over g = 1, 2, 4, ... up to the lists read
    (the query's first MERGE_WIDE_KEYS), of the g-th largest of their c-th
    entries, c = ceil(k / g) at most w (a list without a real c-th entry
    gives none at that level; no level found: no floor);
    each list's prefix at or above F (every real entry without a floor) is
    gathered and sorted once, and the first k go out. Where the entries at
    or above F outgrow ``cap`` (default ``merge_wide_cap(k)``) and k <=
    cap, F is raised first to a key that leaves k .. cap of them (the
    kernel bisects for one; here the cap-th largest); where k > cap, the
    prefixes are merged into the output list by list instead (the in-place
    path): the same entries. ``stats``, a dict, gets per query the entries
    gathered ("gathered"), whether the floor was raised ("bisected") and
    whether the in-place path ran ("in_place")."""
    w = part_v.shape[-1]
    k = w if k is None else k
    cap = merge_wide_cap(k) if cap is None else cap
    pv, pi = part_v.numpy(), part_i.numpy()
    if qend is None:
        s, b, _ = pv.shape
        lists = [[(pv[l, q], pi[l, q]) for l in range(s)] for q in range(b)]
    else:
        qoff = [0] + qend[:, -1].tolist()
        b = qend.shape[0]
        lists = [[(pv[l], pi[l]) for l in range(qoff[q], qoff[q + 1])] for q in range(b)]
    out_v = np.full((b, k), -np.inf, np.float32)
    out_i = np.full((b, k), -1, np.int32)
    gathered, in_place, bisected = [], [], []
    for q, ls in enumerate(lists):
        m = min(len(ls), MERGE_WIDE_KEYS)
        f = None
        g = 1
        while g <= m:
            c = -(-k // g)
            if c <= w:
                keys = sorted((_key((float(v[c - 1]), int(r[c - 1]))) for v, r in ls[:m]
                               if r[c - 1] >= 0 and v[c - 1] > -np.inf), reverse=True)
                if g <= len(keys) and (f is None or keys[g - 1] > f):
                    f = keys[g - 1]
            g <<= 1
        got = []
        for v, r in ls:
            n = 0
            while n < w and r[n] >= 0 and v[n] > -np.inf and (
                    f is None or _key((float(v[n]), int(r[n]))) >= f):
                n += 1
            got += [(float(v[j]), int(r[j])) for j in range(n)]
        bisected.append(len(got) > cap and k <= cap)
        if bisected[-1]:   # a floor that leaves k .. cap entries
            got = sorted(got, key=lambda e: (-e[0], e[1]))[:cap]
        gathered.append(len(got))
        in_place.append(len(got) > cap)
        top = sorted(got, key=lambda e: (-e[0], e[1]))[:k]
        out_v[q, :len(top)] = [e[0] for e in top]
        out_i[q, :len(top)] = [e[1] for e in top]
    if stats is not None:
        stats.update(gathered=gathered, in_place=in_place, bisected=bisected)
    return torch.from_numpy(out_v), torch.from_numpy(out_i)
