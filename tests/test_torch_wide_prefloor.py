"""The wide modes' first pass on the CPU: a floor formed before any row is
kept.

The wide fp32 flat scan and the wide list scan (csrc/fused_scan.cu,
csrc/ivf_list_scan.cu) may first run a narrow launch of the same kernel at
k = c over a sample of each split or segment, take each query's g-th
largest published c-th entry (the flat scan's in its own launch,
csrc/floor_tail.cuh; the list scans' with csrc/prefloor.cu's kernel) and
start the wide pass there, keeping rows at or above it. A CUDA kernel has
no CPU mode, so here the two passes are emulated (_torch_parity:
``flat_scan_emulated(floor0=)``, ``list_partials_emulated(prefloor=)``) and
held, bit for bit, to the plain versions and, to the JAX tests' tolerance,
to the JAX package's Pallas kernels in interpret mode; mutants of the floor
(g - 1, or rows that must beat the floor instead of reaching it) drop a hit.
The host rules that decide whether the first pass runs, and its c, g and
sample, are checked against shapes worked by hand. The kernels themselves
are held to the plain versions on the card in test_torch_kernels_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    WideListEmulated,
    as_tensor,
    assert_same_hits,
    csr,
    flat_case,
    flat_scan_emulated,
    fused_ivf_topk_emulated,
    ivf_item_scores,
    list_case,
    list_partials_emulated,
    list_prefloor_emulated,
    list_scan_emulated,
    merge_wide_emulated,
    wide_stream_emulated,
)

from pyrope_tpu.ops.pallas_scan import pallas_flat_topk, pallas_ivf_topk
from pyrope_tpu.types import Metric
from pyrope_tpu_torch.ops import fused_scan as fs

KP = 128      # the JAX list kernels' cluster table, unwindowed
H100_SMS = 132


# ---- the host rules --------------------------------------------------------------


@pytest.mark.parametrize("k,b,n,want", [
    # b64, k 10,000 on 1M rows: the narrow grid of 64-query blocks, two waves
    # of two an SM: 521 splits of 15 tiles; c = ceil(10000 / 455) = 22 (the
    # warp-register lists), g 455; f = sqrt(20 * 10000 / 1M) = 0.447: 7 tiles
    (10_000, 64, 1_000_000, fs.FlatPrefloor(64, 1920, 521, 7 * 128, 22, 455)),
    # b1024, k 1000: 128-query blocks, 66 splits of 119 tiles; c 18, g 56;
    # f = sqrt(20 * 1000 / 1M) = 0.141: 17 tiles
    (1000, 1024, 1_000_000, fs.FlatPrefloor(128, 15_232, 66, 17 * 128, 18, 56)),
    # b1024, k 200 (phase 6's k 200): c 4, g 50, f = 0.063: 8 tiles
    (200, 1024, 1_000_000, fs.FlatPrefloor(128, 15_232, 66, 8 * 128, 4, 50)),
    # k 1000 at b1 over 20k rows: 157 one-tile splits, the whole tile
    (1000, 1, 20_000, fs.FlatPrefloor(64, 128, 157, 128, 8, 125)),
    (128, 1024, 1_000_000, None),      # narrow
    (10_000, 1024, 1_000_000, None),   # c = ceil(10000 / 57) > 128
    (300, 8, 256, None),               # two splits: c = 300
])
def test_flat_prefloor_plan_hand_worked(k, b, n, want):
    got = fs.flat_prefloor_plan(k, b, 128, n, H100_SMS)
    assert got == want
    if got is not None:
        assert got.g * got.c >= k and got.g <= got.splits and got.rows <= got.per
        assert got.tile == fs.flat_tile(128, got.c, b)[0]


@pytest.mark.parametrize("k,nprobe,width,seg,rows,want", [
    # 100k rows, nlist 100 (1000 a list), nprobe 96, k 1000: c = ceil(1000 /
    # 72) = 14, g 72; f = sqrt(5 * 1000 / 96,000) = 0.23: 2 tiles a segment
    (1000, 96, 1000, 2048, 1000.0, fs.ListPrefloor(14, 72, 256)),
    # the IVF hybrid's R 512: c 8, g 64, f 0.16: 2 tiles
    (512, 96, 512, 2048, 1000.0, fs.ListPrefloor(8, 64, 256)),
    # SQ8 k 200: c 3, g 67, f 0.10: 1 tile
    (200, 96, 200, 2048, 1000.0, fs.ListPrefloor(3, 67, 128)),
    # lists of 100 rows: one tile holds a whole segment
    (1000, 96, 256, 256, 100.0, fs.ListPrefloor(14, 72, 128)),
    # k 4000 at nprobe 128 over 300-row lists: c 42, g 96, f 0.72: 2 tiles
    (4000, 128, 2048, 2048, 300.0, fs.ListPrefloor(42, 96, 256)),
    (1000, 3, 1000, 2048, 1000.0, None),     # nprobe 3: three slots a query
    (1000, 15, 1000, 2048, 6000.0, None),    # below LIST_PREFLOOR_MIN_PROBES
    (64, 96, 64, 2048, 1000.0, None),        # narrow
    (20_000, 96, 2048, 2048, 1000.0, None),  # c = ceil(20000 / 72) > 128
])
def test_list_prefloor_plan_hand_worked(k, nprobe, width, seg, rows, want):
    got = fs.list_prefloor_plan(k, nprobe, width, seg, rows)
    assert got == want
    if got is not None:
        assert got.g * got.c >= k and got.c <= min(width, fs.NARROW_MAX_K)
        assert got.sample <= seg and got.sample >= 2 * got.c


# ---- the floor keys and the floor select -------------------------------------------


def test_floor_keys_round_trip_in_the_lists_order():
    """key_of is the kernels' floor_key: its unsigned order is (score desc,
    row asc), -0 and +0 one score, 0 no key; entry_of inverts it."""
    v = torch.tensor([3.5, 3.5, -0.0, 0.0, -2.0, -1e30, float("-inf"), 7.0])
    r = torch.tensor([4, 9, 2, 1, 0, 5, -1, 3], dtype=torch.int32)
    keys = fs.key_of(v, r)
    assert int(keys[6]) == 0
    ev, er = fs.entry_of(keys)
    np.testing.assert_array_equal(ev.numpy(), (v + 0.0).numpy())
    np.testing.assert_array_equal(er.numpy(), r.numpy())
    order = torch.argsort(fs._unsigned_order(keys), descending=True).tolist()
    want = sorted(range(8), key=lambda j: (-float(v[j]), int(r[j])) if r[j] >= 0
                  else (float("inf"), 0))
    assert order == want


@pytest.mark.parametrize("g", [1, 3, 9, 10])
def test_floor_select_plain_takes_the_g_th_largest(g):
    """Floats with ties and -inf (none); keys over uneven per-query slots,
    some queries with none, the larger of that and a base key."""
    pub = torch.tensor([[5.0, 1.0, 5.0, float("-inf"), 2.0, 7.0, 0.0, 3.0, 3.0]])
    real = sorted((x for x in pub[0].tolist() if x > float("-inf")), reverse=True)
    want = real[g - 1] if g <= len(real) else float("-inf")
    assert float(fs.floor_select_plain(pub, g)[0]) == want
    v = torch.tensor([1.0, 4.0, 2.0, 9.0, 9.0, -3.0, 5.0])
    r = torch.arange(7, dtype=torch.int32)
    keys = fs.key_of(v, r)
    qend = torch.tensor([[3], [3], [7]], dtype=torch.int32)   # 3, 0 and 4 slots
    base = fs.key_of(torch.tensor([3.0, 1.0, -9.0]), torch.tensor([20, 21, 22],
                                                                  dtype=torch.int32))
    got = fs.entry_of(fs.floor_select_plain(keys, g, qend, base))
    by_query = [[(1.0, 0), (4.0, 1), (2.0, 2)], [], [(9.0, 3), (9.0, 4), (-3.0, 5), (5.0, 6)]]
    for q, ent in enumerate(by_query):
        ent = sorted(ent, key=lambda e: (-e[0], e[1]))
        sel = ent[g - 1] if g <= len(ent) else None
        best = max([e for e in (sel, (float(fs.entry_of(base)[0][q]), 20 + q)) if e],
                   key=lambda e: (e[0], -e[1]))
        assert (float(got[0][q]), int(got[1][q])) == best


# ---- the flat scan: two passes against the plain scan and the JAX kernel ---------


def _plain_top(scores, ok, k):
    """The top k of [B, n] scores over the rows ``ok``, (score desc, row
    asc), as the kernels order them: the emulation's yardstick on the same
    scores."""
    wv, pos = torch.sort(torch.where(ok[None, :], scores, float("-inf")), dim=1,
                         descending=True, stable=True)
    return wv[:, :k], torch.where(torch.isfinite(wv[:, :k]), pos[:, :k], -1).int()


def _flat_two_pass(scores, ok, k, plan, per, n_splits, floor_strict=False, stats=None,
                   floor0=None):
    """The first pass's floors (the plain rule: it equals what the narrow
    launch and the floor select give), then the wide blocks from them,
    merged."""
    if floor0 is None:
        floor0 = fs.split_floor_plain(scores, ok, plan)
    pv, pi = flat_scan_emulated(scores, ok, scores.shape[1], k, query_tile=fs.FLAT_WIDE_TILE,
                                per=per, n_splits=n_splits, seed=k, floor0=floor0,
                                floor_strict=floor_strict, stats=stats,
                                make_list=lambda kw: WideListEmulated(kw, fs.FLAT_WIDE_CAP))
    return fs.merge_partials_plain(pv.permute(1, 0, 2), pi.permute(1, 0, 2))


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("k,b,dup", [(129, 3, False), (300, 5, True), (700, 2, False)])
def test_flat_two_pass_equals_plain_and_pallas(k, b, dup, metric):
    """On 12,288 rows (5% dead, the tail cut by max_scans), the first pass's
    floors from the plan the host rule gives, the wide blocks started there:
    the merged hits equal the plain top-k of the same scores bit for bit,
    and fused_flat_topk_plain's and pallas_flat_topk's (interpret mode) to
    the JAX tests' tolerance; fewer candidates are offered than without the
    first pass."""
    n, d, ms = 12_288, 16, 11_800   # n: a whole number of the JAX kernel's row tiles
    x, q, sq, alive = flat_case(k, n, b, d)
    alive &= np.random.default_rng(k).random(n) > 0.05
    if dup:
        x[6000:6400] = x[:400]
        sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    t = [as_tensor(a) for a in (q, x, sq, alive)]
    ip = metric == Metric.INNER_PRODUCT
    scores = fs._tile_scores(t[0], t[1], t[2], ip)(0, n)
    ok = t[3] & (torch.arange(n) < ms)
    plan = fs.flat_prefloor_plan(k, b, d, ms, 16)
    assert plan is not None
    per, n_splits = fs._splits(b, ms, 16, fs.FLAT_WIDE_TILE, k)
    with_stats, without = {}, {}
    mv, mi = _flat_two_pass(scores, ok, k, plan, per, n_splits, stats=with_stats)
    wv, wi = _plain_top(scores, ok, k)
    np.testing.assert_array_equal(mi.numpy(), wi.numpy())
    np.testing.assert_array_equal(mv.numpy(), wv.numpy())
    assert_same_hits(mv, mi, *fs.fused_flat_topk_plain(*t, ms, k, metric.value))
    jv, ji = pallas_flat_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq),
                              jnp.asarray(alive), ms, k, metric)
    assert_same_hits(mv, mi, jv, ji)
    _flat_two_pass(scores, ok, k, plan, per, n_splits, stats=without,
                   floor0=torch.full((b,), float("-inf")))
    assert with_stats["offered"] < without["offered"]


@pytest.mark.parametrize("sample", ["all", "one tile"])
def test_flat_two_pass_with_every_hit_in_one_split(sample):
    """Every hit of both queries lies in split 0 (rows near the queries,
    tied); the floor from the other splits' c-th entries lies under them,
    whatever the sample, and the hits are the plain version's."""
    n, b, d, k = 8192, 2, 8, 300
    x, q, sq, alive = flat_case(7, n, b, d)
    x[:400] = q[np.arange(400) % b] + 0.125
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    t = [as_tensor(a) for a in (q, x, sq, alive)]
    scores = fs._tile_scores(t[0], t[1], t[2], False)(0, n)
    plan = fs.flat_prefloor_plan(k, b, d, n, 16)
    if sample == "one tile":
        plan = dataclasses.replace(plan, rows=fs.ROW_TILE)
    per, n_splits = fs._splits(b, n, 16, fs.FLAT_WIDE_TILE, k)
    mv, mi = _flat_two_pass(scores, t[3], k, plan, per, n_splits)
    wv, wi = _plain_top(scores, t[3], k)
    np.testing.assert_array_equal(mi.numpy(), wi.numpy())
    np.testing.assert_array_equal(mv.numpy(), wv.numpy())


def _flat_exact_floor_case():
    """Ten pass-1 splits of 256 rows, each holding 15 of the 150 hits (k =
    g * c exactly): the floor is the 150th hit itself."""
    plan = fs.FlatPrefloor(tile=64, per=256, splits=10, rows=256, c=15, g=10)
    rng = np.random.default_rng(5)
    sc = rng.random((2, 2560)) * 100
    for s in range(10):
        sc[:, s * 256 + 100:s * 256 + 115] = 1000 + rng.random((2, 15)) * 50 + s
    scores = torch.from_numpy(sc.astype(np.float32))
    return scores, torch.ones(2560, dtype=torch.bool), 150, plan


@pytest.mark.parametrize("mutant", [None, "g_minus_1", "strict"])
def test_flat_first_pass_mutants_drop_a_hit(mutant):
    """The floor is the k-th hit's score; the (g-1)-th largest c-th entry
    lies above it, and a strict floor drops its row: each mutant drops a
    hit, the design keeps all 150."""
    scores, ok, k, plan = _flat_exact_floor_case()
    if mutant == "g_minus_1":
        plan = dataclasses.replace(plan, g=plan.g - 1)
    mv, mi = _flat_two_pass(scores, ok, k, plan, 1280, 2, floor_strict=mutant == "strict")
    wv, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    same = np.array_equal(mi.numpy(), pos[:, :k].int().numpy())
    assert same == (mutant is None)


# ---- the list scan: two passes against the plain scan and the JAX kernel ---------


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("name", ["spread", "skewed", "dups_dead_empty"])
@pytest.mark.parametrize("k", [200, 600])
def test_list_two_pass_equals_plain_and_pallas(k, name, metric):
    """The wide list scan with its first pass (the plan the host rule gives
    at nprobe 24): a skewed list holding every second query's hits, a row
    copied into two lists, dead rows, probed empty lists; the merged hits
    equal fused_ivf_topk_plain's and pallas_ivf_topk's (the emulation scores
    item by item, the plain version in row chunks: equal hits, scores to the
    JAX tests' tolerance)."""
    kw = {"spread": {}, "skewed": {"big": 2500},
          "dups_dead_empty": {"dup": True, "dead": 0.1, "empty": 3}}[name]
    seg = 256
    n = 8192   # a whole number of the JAX kernel's row tiles
    x, q, sq, alive, crow, probe = list_case(21, n, 9, 16, 40, 24, **kw)
    t = [as_tensor(a) for a in (q, x, sq, alive, crow, probe)]
    offsets, lens = csr(crow, KP)
    width = fs.list_slot_width(k, seg, int(lens.max()))
    plan = fs.list_prefloor_plan(k, 24, width, seg, n / 40)
    assert plan is not None
    got = fused_ivf_topk_emulated(t[0], t[1], t[2], t[3], offsets, lens, t[5], KP, k,
                                  metric.value, seg=seg, wide_cap=fs.LIST_WIDE_CAP,
                                  prefloor=plan)
    assert_same_hits(*got, *fs.fused_ivf_topk_plain(*t, KP, k, metric.value))
    probed = np.zeros((len(q), KP), np.float32)
    probed[np.arange(len(q))[:, None], probe] = 1.0
    jv, ji = pallas_ivf_topk(*(jnp.asarray(a) for a in (q, x, sq, alive, crow, probed)),
                             k, metric)
    assert_same_hits(*got, jv, ji)


def test_list_first_pass_keeps_fewer_entries():
    """At nprobe 24 of 40 lists, k 300: with the first pass the wide slots
    hold fewer real entries, and fewer rows are offered, than without; the
    hits are the same."""
    x, q, sq, alive, crow, probe = list_case(23, 6000, 12, 16, 40, 24)
    t = [as_tensor(a) for a in (q, x, sq, alive, crow, probe)]
    offsets, lens = csr(crow, KP)
    plan = fs.list_prefloor_plan(300, 24, 256, 256, 150.0)
    runs = []
    for pf in (plan, None):
        stats = {}
        pv, pi, work = list_partials_emulated(
            ivf_item_scores(t[0], t[1], t[2]), t[3], offsets, lens, t[5], KP, 300,
            int(lens.max()), 256, wide_cap=fs.LIST_WIDE_CAP, prefloor=pf, stats=stats)
        real = int(torch.isfinite(pv[:int(work.slot_end[-1, -1])]).sum())
        runs.append((fs.merge_partials_plain(pv, pi, work.slot_end, 300), real,
                     stats["offered"]))
    (a, real_a, off_a), (b, real_b, off_b) = runs
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    assert real_a < real_b and off_a < off_b


def _list_exact_floor_case():
    """One query probing 20 lists of 50 rows; 14 lists hold 10 of the 140
    hits each (k = g * c exactly): the floor is the 140th hit itself."""
    kc, per = 20, 50
    rng = np.random.default_rng(9)
    sc = rng.random(kc * per) * 100
    for c in range(14):
        sc[c * per + 20:c * per + 30] = 1000 + rng.random(10) * 50 + c
    table = torch.from_numpy(sc.astype(np.float32))
    crow = np.repeat(np.arange(kc, dtype=np.int32), per)
    offsets, lens = csr(crow, kc)
    probe = torch.arange(kc, dtype=torch.int32)[None, :]
    scores = lambda bq, c, s, e: table[None, s:e].expand(len(bq), -1)
    return scores, table, offsets, lens, probe, kc


@pytest.mark.parametrize("mutant", [None, "g_minus_1", "strict"])
def test_list_first_pass_mutants_drop_a_hit(mutant):
    scores, table, offsets, lens, probe, kc = _list_exact_floor_case()
    k = 140
    plan = fs.list_prefloor_plan(k, kc, 50, 256, 50.0)
    assert (plan.c, plan.g) == (10, 14)
    if mutant == "g_minus_1":
        plan = dataclasses.replace(plan, g=plan.g - 1)
    alive = torch.ones(table.shape[0], dtype=torch.bool)
    mv, mi = list_scan_emulated(scores, alive, offsets, lens, probe, kc, k, 50, 256,
                                wide_cap=fs.LIST_WIDE_CAP, prefloor=plan,
                                floor_strict=mutant == "strict")
    wv, pos = torch.sort(table, descending=True, stable=True)
    same = np.array_equal(mi[0].numpy(), pos[:k].int().numpy())
    assert same == (mutant is None)


@pytest.mark.parametrize("sample", [128, 256])
@pytest.mark.parametrize("kw", [{}, {"big": 1500, "dead": 0.1, "empty": 2}])
def test_list_prefloor_plain_equals_the_emulated_first_pass(kw, sample):
    """The plain first pass on dense scores (``list_prefloor_plain``: each
    probed list's segments, their sampled rows' c-th keys, the g-th largest
    a query) names the same floor entry as the emulated items and slots."""
    seg = 256
    x, q, sq, alive, crow, probe = list_case(31, 5000, 11, 16, 30, 20, **kw)
    t = [as_tensor(a) for a in (q, x, sq, alive, crow, probe)]
    offsets, lens = csr(crow, 30)
    plan = fs.ListPrefloor(c=6, g=14, sample=sample)
    scores = fs._tile_scores(t[0], t[1], t[2], False)(0, len(x))
    keys = fs.list_prefloor_plain(scores, t[3], t[4], offsets, lens, t[5], seg, plan)
    work = fs.invert_probes(t[5], lens, 30, int(lens.max()), seg, len(x))
    want = list_prefloor_emulated(ivf_item_scores(t[0], t[1], t[2]), t[3], offsets, lens,
                                  work, seg, plan, fs.QUERY_TILE)
    got_v, got_r = fs.entry_of(keys)
    assert any(w is not None for w in want)
    for qi, w in enumerate(want):
        if w is None:
            assert int(keys[qi]) == 0
        else:
            assert int(got_r[qi]) == w[1]
            np.testing.assert_allclose(float(got_v[qi]), w[0], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("ties", [0, 5])
def test_wide_stream_behind_a_first_pass_floor_keeps_its_row(ties):
    """A wide list behind a floor that is a row of its own stream (the
    first pass's floor lies in rows the second pass scans again): with
    ``reach`` the list holds every row at or above the floor, the floor's
    row included; rows that must beat it lose exactly that row (and its
    ties after it)."""
    rng = np.random.default_rng(41 + ties)
    vals = (rng.integers(0, 40, 3000) if ties else rng.random(3000) * 100).astype(np.float32)
    order = sorted(range(3000), key=lambda r: (-float(vals[r]), r))
    f_row = order[299]
    floor = (float(vals[f_row]), f_row)
    got_v, got_r, _ = wide_stream_emulated(vals, 512, floor=floor, reach=True)
    assert list(got_r[:300]) == order[:300] and got_r[300] == -1
    got_v, got_r, _ = wide_stream_emulated(vals, 512, floor=floor)
    assert list(got_r[:299]) == order[:299] and got_r[299] == -1


def test_merge_wide_raises_its_floor_where_the_gather_outgrows_the_buffer():
    """Lists that hold more entries at or above the merge's level floor than
    its run buffer (the wide flat scan's partials behind a first pass's
    floor at b64 k 10,000 hand it ~1.35 k / f a query): the emulated merge
    raises its floor to leave k .. cap entries and gathers them, without
    the in-place path; the plain merge's hits, bit for bit."""
    rng = np.random.default_rng(43)
    s, b, w, k, cap = 60, 3, 120, 300, 400
    v = np.sort(rng.random((s, b, w)).astype(np.float32), axis=2)[:, :, ::-1]
    rows = np.stack([rng.permutation(s * w) for _ in range(b)], 1).reshape(s, w, b)
    pv = torch.from_numpy(np.ascontiguousarray(v))
    pi = torch.from_numpy(np.ascontiguousarray(rows.transpose(0, 2, 1)).astype(np.int32))
    stats = {}
    got = merge_wide_emulated(pv, pi, k=k, cap=cap, stats=stats)
    want = fs.merge_partials_plain(pv, pi, k=k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(stats["bisected"]) and not any(stats["in_place"])
    assert max(stats["gathered"]) <= cap
