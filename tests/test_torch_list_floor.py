"""The list scan's floor published across a query's slots, and the wide
merge's floor and gather, on the CPU.

The CUDA list scan (csrc/ivf_list_scan.cu) publishes each slot's c-th entry
and keeps, per query, the g-th largest key of a window of its slots as a
floor that later rows must beat (``fs.list_floor`` picks c and g). The wide
merge (``merge_wide_kernel``, csrc/fused_scan.cu) takes a floor from its
lists' c-th entries, gathers each list's prefix above it and sorts once.
Here their CPU emulations (_torch_parity: ``list_partials_emulated`` with
``floor="slots"``, ``merge_wide_emulated``) are held, bit for bit, to the
plain versions (``fused_ivf_topk_plain``, ``merge_partials_plain``), across
item orders and concurrency, and to the JAX package's Pallas kernels in
interpret mode (scores rtol 1e-5 / atol 1e-4, as test_torch_fused_scan.py).
A hypothesis property runs the emulation on small-integer data, where
every score is exact and ties are many, at k from 1 to above 10,000: no row
the floor drops is a hit. The kernels themselves are held to the plain
versions on the card in test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    as_tensor,
    assert_same_hits,
    csr,
    fused_ivf_topk_emulated,
    ivf_item_scores,
    list_case,
    list_item,
    list_partials_emulated,
    merge_wide_cap,
    merge_wide_emulated,
    query_offsets,
    slot_of,
    split_partials,
)
from hypothesis import given, settings
from hypothesis import strategies as st

from pyrope_tpu.ops.pallas_scan import pallas_ivf_topk
from pyrope_tpu.types import Metric
from pyrope_tpu_torch.ops import fused_scan as fs

KP = 128  # cluster-table width the JAX kernels take unwindowed


def _tensors(case):
    return [as_tensor(a) for a in case]


def _int_case(seed, n, b, d, kc, nprobe, **kw):
    """list_case on small integers: every L2 and IP score is exact in fp32
    whatever the summation order, and equal scores are common."""
    x, q, _, alive, crow, probe = list_case(seed, n, b, d, kc, nprobe, **kw)
    x, q = np.floor(x * 4).astype(np.float32), np.floor(q * 4).astype(np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    return x, q, sq, alive, crow, probe


def _slot_entries(part_v, work):
    """Real entries a query's slots hold after the scan, summed over queries."""
    return int(torch.isfinite(part_v[:int(query_offsets(work)[-1])]).sum())


# ---- list_floor ----------------------------------------------------------------


@pytest.mark.parametrize("nprobe", [1, 3, 4, 12, 32, 96, 1000])
@pytest.mark.parametrize("width", [1, 7, 64, 128, 1000, 2048])
def test_list_floor_counts_k_rows(nprobe, width):
    """g slots each holding c entries at or above the floor: g·c >= k rows,
    so no dropped row is a hit; c fits the slot, and g stays within the
    slots a window reads whenever the slot can hold ceil(k / g) entries."""
    for k in (*range(1, 300), 1000, 4096, 10_000, 20_000):
        c, g = fs.list_floor(k, nprobe, width)
        assert 1 <= c <= min(k, width) and g >= 1 and g * c >= k
        assert (g - 1) * c < k                        # the least g for that c
        want = (1 if k < fs.LIST_FLOOR_MIN_K
                else min(fs.LIST_FLOOR_SLOTS, max(1, nprobe // 4)))
        if -(-k // want) <= width:
            assert g <= want <= fs.LIST_FLOOR_WINDOW
        if g == 1:
            assert c == k                             # a slot's own k-th entry


# ---- the published floor, against the plain version and the JAX kernel -----

CASES = {
    "uniform": (dict(), 3, 10, 256),
    "skewed": (dict(big=1500), 3, 10, 256),
    "np36": (dict(), 36, 10, 256),
    "np36_k64": (dict(empty=2), 36, 64, 128),
    "dup_ties": (dict(dup=True), 12, 10, 256),
    "k128": (dict(big=600), 16, 128, 256),
}


@pytest.mark.parametrize("concurrent", [1, 6, 64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_published_floor_results_whatever_the_item_order(name, concurrent):
    """Items started in item order, reversed and shuffled, ``concurrent`` at
    a time: bit-equal merged results, equal to the plain version and to
    pallas_ivf_topk in interpret mode."""
    kw, nprobe, k, seg = CASES[name]
    x, q, sq, alive, crow, probe = list_case(1, 3000, 24, 16, 40, nprobe, **kw)
    t = _tensors((q, x, sq, alive, crow, probe))
    offsets, lens = csr(crow, KP)
    grid = fs.list_grid(len(q), nprobe, KP, int(lens.max()), seg)[0]
    rng = np.random.default_rng(7)
    runs = [fused_ivf_topk_emulated(t[0], t[1], t[2], t[3], offsets, lens, t[5], KP, k,
                                    seg=seg, order=order, concurrent=concurrent)
            for order in (None, range(grid - 1, -1, -1), rng.permutation(grid))]
    for v, i in runs[1:]:
        assert torch.equal(v, runs[0][0]) and torch.equal(i, runs[0][1])
    assert_same_hits(*runs[0], *fs.fused_ivf_topk_plain(*t, KP, k))
    probed = np.zeros((len(q), KP), np.float32)
    probed[np.arange(len(q))[:, None], probe] = 1.0
    jv, ji = pallas_ivf_topk(*(jnp.asarray(a) for a in (q, x, sq, alive, crow, probed)),
                             k, Metric.L2)
    assert_same_hits(*runs[0], jv, ji)


@pytest.mark.parametrize("k,wide", [(10, False), (64, False), (200, True)])
def test_published_floor_holds_fewer_entries_than_the_query_floor(k, wide):
    """At nprobe 96 of 100 lists (the shape of ivf100k_np96), the slots hold
    fewer real entries, and fewer rows are offered, with the floor published
    across slots than with the per-query floor it replaced (a full list's
    k-th entry, read when an item starts), and the merged hits are the same.
    At k 10 (g 1: the same keys, raised as they are published and read
    during the walk too) no more."""
    b, n = (24, 6000) if wide else (80, 6000)
    x, q, sq, alive, crow, probe = list_case(3, n, b, 8, 100, 96)
    t = _tensors((q, x, sq, alive, crow, probe))
    offsets, lens = csr(crow, 100)
    scores = ivf_item_scores(t[0], t[1], t[2])
    got = {}
    for floor in ("query", "slots"):
        stats = {}
        pv, pi, work = list_partials_emulated(
            scores, t[3], offsets, lens, t[5], 100, k, int(lens.max()), fs.LIST_SEG,
            floor=floor, concurrent=16, stats=stats,
            wide_cap=fs.LIST_WIDE_CAP if wide else None)
        got[floor] = (_slot_entries(pv, work), stats["offered"],
                      fs.merge_partials_plain(pv, pi, work.slot_end, k))
    strict = fs.list_floor(k, 96, k)[1] > 1
    assert got["slots"][0] < got["query"][0] or not strict
    assert got["slots"][0] <= got["query"][0] and got["slots"][1] <= got["query"][1]
    assert got["slots"][1] < got["query"][1] or not strict
    for a, b_ in zip(got["slots"][2], got["query"][2]):
        assert torch.equal(a, b_)
    assert_same_hits(*got["slots"][2], *fs.fused_ivf_topk_plain(*t, 100, k))


def test_narrow_floor_rising_during_an_item_leaves_no_copy():
    """A long item of a skewed list runs beside short items of the same
    queries, whose ends raise the queries' floors during its walk: its
    thresholds rise (the copies of the floor it started from stay in its
    lists), and no slot writes a row outside its own segment (a copy of
    the first floor is another slot's row)."""
    x, q, sq, alive, crow, probe = list_case(5, 4000, 40, 8, 30, 12, big=1500)
    t = _tensors((q, x, sq, alive, crow, probe))
    offsets, lens = csr(crow, KP)
    seg = 2048
    work = fs.invert_probes(t[5], lens, KP, int(lens.max()), seg, len(x))
    hot = int(lens.argmax())
    items = [it for it in range(work.grid) if list_item(work, it, lens, offsets, seg)]
    # the long items first, each beside many short ones that end first
    order = sorted(items, key=lambda it: list_item(work, it, lens, offsets, seg)[0] != hot)
    stats = {}
    pv, pi, work = list_partials_emulated(
        ivf_item_scores(t[0], t[1], t[2]), t[3], offsets, lens, t[5], KP, 10,
        int(lens.max()), seg, order=order, concurrent=12, stats=stats)
    assert stats["raised"] > 0
    for it in items:
        _, pairs, s, lo, hi = list_item(work, it, lens, offsets, seg)
        rows = pi[slot_of(work, pairs, lens[_], seg) + s]
        real = rows[rows >= 0]
        assert ((real >= lo) & (real < hi)).all()
    got = fs.merge_partials_plain(pv, pi, work.slot_end, 10)
    assert_same_hits(*got, *fs.fused_ivf_topk_plain(*t, KP, 10))


def test_a_copy_marked_by_the_current_floor_would_surface():
    """The mutant the marking guards against: write a list out marking the
    copies by the floor its walk last raised to, not the first floor, and
    copies of the first floor surface as hits from a slot that does not
    hold them. Emulated here on one list: k copies of F0, the floor rises
    to F1, one row of the item goes in."""
    k, f0, f1 = 4, (0.5, 900), (0.7, 901)
    lst = [f0] * k
    thr = max(f0, f1, key=lambda e: (e[0], -e[1]))      # the raised threshold
    cand = (0.8, 5)
    assert cand > thr
    lst = sorted(lst + [cand], key=lambda e: (-e[0], e[1]))[:k]
    right = [e for e in lst if e[1] != f0[1]]
    wrong = [e for e in lst if e[1] != thr[1]]
    assert right == [cand]
    assert any(r == f0[1] for _, r in wrong)            # the mutant writes copies


@settings(max_examples=40, deadline=None)
@given(k=st.one_of(st.integers(1, 40), st.sampled_from([128, 129, 300, 1000, 10_001, 12_000])),
       nprobe=st.integers(1, 14), kc=st.integers(2, 16), big=st.sampled_from([0, 150]),
       empty=st.integers(0, 2), seg=st.sampled_from([1, 7, 64, 256]),
       dup=st.booleans(), concurrent=st.sampled_from([1, 3, 16]),
       metric=st.sampled_from(["L2", "INNER_PRODUCT"]), seed=st.integers(0, 2**16))
def test_no_dropped_row_is_a_hit(k, nprobe, kc, big, empty, seg, dup, concurrent, metric,
                                 seed):
    """The published floor never drops a hit: on exact integer scores with
    ties, skewed and empty lists, one-row segments, duplicated rows and any
    item order, the merged slots equal the plain version bit for bit, in
    the narrow mode and (k > 128) the wide one; every hit of the plain
    version lies in some slot."""
    nprobe = min(nprobe, kc - empty) if kc > empty else 1
    empty = min(empty, kc - 1)
    n, b = 300, 12
    x, q, sq, alive, crow, probe = _int_case(seed, n, b, 4, kc, nprobe, big=big,
                                             empty=empty, dup=dup and kc - empty >= 3)
    t = _tensors((q, x, sq, alive, crow, probe))
    offsets, lens = csr(crow, kc)
    rng = np.random.default_rng(seed)
    grid = fs.list_grid(b, nprobe, kc, int(lens.max()), seg)[0]
    pv, pi, work = list_partials_emulated(
        ivf_item_scores(t[0], t[1], t[2], metric), t[3], offsets, lens, t[5], kc, k,
        int(lens.max()), seg, order=rng.permutation(grid), concurrent=concurrent,
        wide_cap=fs.LIST_WIDE_CAP if k > fs.NARROW_MAX_K else None)
    got = fs.merge_partials_plain(pv, pi, work.slot_end, k)
    want = fs.fused_ivf_topk_plain(*t, kc, k, metric)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    held = set(pi[pi >= 0].tolist())
    assert set(want[1][want[1] >= 0].tolist()) <= held


# ---- the wide merge: floor from the c-th entries, gather, one sort ----------


def _sorted_lists(rng, s, b, w, levels):
    """[S, B, w] sorted lists of distinct rows (per query), scores on
    ``levels`` values: ties across lists."""
    v = np.sort(rng.integers(0, levels, (s, b, w)).astype(np.float32), axis=2)[:, :, ::-1]
    rows = np.stack([rng.permutation(s * w) for _ in range(b)], 1).reshape(s, w, b)
    rows = np.ascontiguousarray(rows.transpose(0, 2, 1)).astype(np.int32)
    order = np.lexsort((rows, -v), axis=2)
    return (torch.from_numpy(np.take_along_axis(np.ascontiguousarray(v), order, 2)),
            torch.from_numpy(np.take_along_axis(rows, order, 2)))


@pytest.mark.parametrize("k,w,s,levels", [
    (200, 200, 8, 1000), (1000, 1000, 8, 50), (1000, 300, 33, 20), (500, 40, 96, 7),
    (300, 300, 300, 1000),           # more lists than the floor reads
    (5000, 100, 4, 100),             # k above the entries present
    (150, 150, 1, 10),               # one list
])
def test_merge_wide_emulation_equals_plain_on_flat_layouts(k, w, s, levels):
    """[S, B, w] lists (the flat path's splits), with lists shorter than c,
    all-padding lists and ties across lists: bit-equal to merge_partials_plain;
    the gather takes at least the k best, and no more than every entry."""
    rng = np.random.default_rng(k + w + s)
    pv, pi = _sorted_lists(rng, s, 5, w, levels)
    pv[::2, 1, w // 3:], pi[::2, 1, w // 3:] = float("-inf"), -1   # short lists
    pv[:, 2], pi[:, 2] = float("-inf"), -1                         # no entry at all
    if s > 1:
        pv[1, 3], pi[1, 3] = float("-inf"), -1                     # one all-padding list
    stats = {}
    got = merge_wide_emulated(pv, pi, k=k, stats=stats)
    want = fs.merge_partials_plain(pv, pi, k=k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    real = (pi >= 0).sum(dim=(0, 2)).tolist()
    for q in range(5):
        assert min(k, real[q]) <= stats["gathered"][q] <= real[q]


def test_merge_wide_floor_cuts_the_gather():
    """On the flat path's [1024-like, 8, 1000] and the list scan's 96-slot
    layout at k 1000, the floor leaves the gather a small multiple of k,
    inside the run buffer: the sort-once path, not the in-place one."""
    rng = np.random.default_rng(11)
    for s, w in ((8, 1000), (96, 1000)):
        pv = torch.from_numpy(-np.sort(-rng.random((s, 4, w), np.float32), axis=2))
        pi = torch.from_numpy(rng.permutation(s * 4 * w).reshape(s, 4, w).astype(np.int32))
        stats = {}
        got = merge_wide_emulated(pv, pi, k=1000, stats=stats)
        want = fs.merge_partials_plain(pv, pi, k=1000)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert max(stats["gathered"]) <= 3 * 1000 <= merge_wide_cap(1000)
        assert not any(stats["in_place"])


def test_merge_wide_emulation_takes_per_query_slots_and_the_in_place_path():
    """The list scan's slots (queries with different numbers of slots, one
    with none), through the gather and, with a small run buffer, through
    the in-place path: the same hits, equal to merge_partials_plain."""
    x, q, sq, alive, crow, probe = list_case(9, 3000, 20, 8, 12, 4, big=600, empty=1)
    t = _tensors((q, x, sq, alive, crow, probe))
    offsets, lens = csr(crow, 12)
    for k in (200, 700):
        pv, pi, work = list_partials_emulated(
            ivf_item_scores(t[0], t[1], t[2]), t[3], offsets, lens, t[5], 12, k,
            int(lens.max()), 256, wide_cap=fs.LIST_WIDE_CAP)
        used = int(query_offsets(work)[-1])
        pv, pi = pv[:used].contiguous(), pi[:used].contiguous()
        want = fs.merge_partials_plain(pv, pi, work.slot_end, k)
        for cap in (None, 64):
            stats = {}
            got = merge_wide_emulated(pv, pi, work.slot_end, k, cap=cap, stats=stats)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            assert any(stats["in_place"]) == (cap == 64)


def test_merge_wide_emulation_on_the_flat_scan_partials():
    """The flat scan's per-split partials of a real scan, merged: the plain
    scan's hits."""
    x, q, sq, alive, *_ = list_case(13, 5000, 6, 8, 4, 2)
    pv, pi = split_partials(q, x, sq, alive, 300, 640)
    got = merge_wide_emulated(pv, pi, k=300)
    want = fs.fused_flat_topk_plain(*_tensors((q, x, sq, alive)), len(x), 300)
    assert_same_hits(*got, *want)


@pytest.mark.parametrize("k", [200, 512])
def test_merge_wide_floor_on_slots_the_scan_floor_cut_short(k):
    """The list scan's slots at nprobe 96 come cut short by its own floor:
    most hold fewer than ceil(k / slots) entries. The merge's floor over
    several (c, g) levels still forms, and the gather stays inside the run
    buffer (the sort-once path), with the plain merge's hits."""
    x, q, sq, alive, crow, probe = list_case(15, 6000, 24, 8, 100, 96)
    t = _tensors((q, x, sq, alive, crow, probe))
    offsets, lens = csr(crow, 100)
    pv, pi, work = list_partials_emulated(
        ivf_item_scores(t[0], t[1], t[2]), t[3], offsets, lens, t[5], 100, k,
        int(lens.max()), fs.LIST_SEG, concurrent=16, wide_cap=fs.LIST_WIDE_CAP)
    used = int(query_offsets(work)[-1])
    pv, pi = pv[:used].contiguous(), pi[:used].contiguous()
    stats = {}
    got = merge_wide_emulated(pv, pi, work.slot_end, k, stats=stats)
    want = fs.merge_partials_plain(pv, pi, work.slot_end, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not any(stats["in_place"])
    assert max(stats["gathered"]) <= merge_wide_cap(k)


def test_a_floor_one_slot_short_drops_a_hit():
    """list_floor's g is the least that is safe: k 16 over 32 probed lists
    gives c 2, g 8. Seven lists of high scores end first and publish their
    2nd entries; the 8th list holds the last two hits, far below them. With
    g 8 the floor waits for an eighth key (a low list's) and keeps those
    hits; a floor taken at g 7 (one slot short) sits above them, and the
    list that runs last drops two hits."""
    k, nprobe = 16, 32
    assert fs.list_floor(k, nprobe, 2) == (2, 8)
    scores = np.zeros(2 * nprobe, np.float32)
    for c in range(nprobe):
        hi = 100.0 + c if c < 7 else 50.0 if c == 7 else 10.0 - c / 10
        scores[2 * c:2 * c + 2] = (hi, hi - 1)
    table = torch.from_numpy(scores)
    crow = np.repeat(np.arange(nprobe, dtype=np.int32), 2)
    offsets, lens = csr(crow, nprobe)
    probe = torch.arange(nprobe, dtype=torch.int32)[None]
    work = fs.invert_probes(probe, lens, nprobe, 2, 256, len(crow))
    cluster = {it: list_item(work, it, lens, offsets, 256)[0] for it in range(work.grid)
               if list_item(work, it, lens, offsets, 256)}
    order = sorted(cluster, key=lambda it: (cluster[it] == 7, cluster[it]))  # list 7 last

    def merged(floor_of):
        real = fs.list_floor
        fs.list_floor = floor_of
        try:
            pv, pi, w = list_partials_emulated(
                lambda bq, c, s, e: table[s:e][None].expand(len(bq), -1),
                torch.ones(len(crow), dtype=torch.bool), offsets, lens, probe, nprobe, k,
                2, 256, order=order)
        finally:
            fs.list_floor = real
        return fs.merge_partials_plain(pv, pi, w.slot_end, k)[1][0].tolist()

    want = sorted(range(len(scores)), key=lambda r: (-scores[r], r))[:k]
    assert merged(fs.list_floor) == want
    short = merged(lambda k_, p, w: (2, 7))
    assert short != want and {14, 15} - set(short) == {14, 15}
