"""The IVF list scan's work layout, on the CPU, against the dense definition
and the JAX package's Pallas kernels.

The CUDA list scan (csrc/ivf_list_scan.cu) reads what ``invert_probes``
builds on the device: the (query, probe) pairs grouped by cluster and an
item table of (cluster, query chunk, row segment), launched on a grid the
host sizes from shapes alone. Here that Python is checked directly (every
pair's segments land in its own slots, each slot written exactly once;
the grid and slot bounds never fall below what the data needs; the CPU
wrapper refuses inputs that break the kernel's preconditions), and
``fused_ivf_topk_emulated`` / ``fused_ivf_sq8_topk_emulated`` (in
_torch_parity: the same items and slots, each item's lists computed in
torch, then the merge) are held against the dense plain
versions and against ``pallas_ivf_topk`` / ``pallas_ivf_sq8_topk`` in
interpret mode on the same numpy inputs: skewed and empty clusters,
tombstones, ties across lists, k up to 128. Tolerances as
test_torch_fused_scan.py: rtol 1e-5 / atol 1e-4, the SQ8 scan rtol 1e-4.
The kernel itself is held against the plain versions on the card in
test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    SQ8_RTOL,
    as_tensor,
    assert_same_hits,
    csr,
    fused_ivf_sq8_topk_emulated,
    fused_ivf_topk_emulated,
    list_case,
    list_item,
    list_partials_emulated,
    port_metric,
    query_offsets,
    slot_of,
    sq8_of,
)
from hypothesis import given, settings
from hypothesis import strategies as st

from pyrope_tpu.ops.pallas_scan import MASK_SENT, pallas_ivf_sq8_topk, pallas_ivf_topk
from pyrope_tpu.types import Metric
from pyrope_tpu_torch.ops import fused_scan as fs

KP = 128  # cluster-table width the JAX kernels take unwindowed

# name -> (list_case kwargs, nprobe, k, seg): seg 256 splits lists into
# several segments at these sizes, as LIST_SEG does at the card's sizes
CASES = {
    "uniform": (dict(), 3, 10, 256),
    "skewed": (dict(big=1500), 3, 10, 256),
    "empty_probed": (dict(empty=5), 4, 10, 256),
    "tombstones": (dict(dead=0.3), 3, 10, 256),
    "dup_ties": (dict(dup=True), 3, 10, 256),
    "k128": (dict(big=600), 3, 128, 256),
    "all_lists": (dict(empty=3), 40, 10, 512),   # nprobe >= non-empty clusters
}


def _case(name, seed=0, n=4096, b=16, d=16, kc=40):
    kw, nprobe, k, seg = CASES[name]
    return list_case(seed, n, b, d, kc, nprobe, **kw), k, seg


def _decode_all(work, probe, lens, offsets, seg):
    """Every item's (b, p, s, slot) and rows, as the kernel decodes them."""
    b, nprobe = probe.shape
    got = []
    for item in range(work.grid):
        it = list_item(work, item, lens, offsets, seg)
        if it is None:
            continue
        c, pairs, s, lo, hi = it
        for j in pairs.tolist():
            got.append((j // nprobe, j % nprobe, s, int(slot_of(work, j, lens[c], seg)) + s,
                        c, lo, hi))
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_inversion_covers_every_pair_once_in_its_slot(name):
    (x, q, sq, alive, crow, probe), k, seg = _case(name, b=150)
    offsets, lens = csr(crow, KP)
    work = fs.invert_probes(as_tensor(probe), lens, KP, int(lens.max()), seg, len(x))
    got = _decode_all(work, probe, lens, offsets, seg)
    keys = [(b, p, s) for b, p, s, *_ in got]
    assert len(keys) == len(set(keys))                  # one item per segment
    want = set()
    for b in range(probe.shape[0]):
        for p in range(probe.shape[1]):
            for s in range(-(-int(lens[probe[b, p]]) // seg)):
                want.add((b, p, s))
    assert set(keys) == want                            # and every segment scanned
    # slots: one writer each, every slot below qoff[B] written, each query's
    # in its own range, a pair's segments in probe order
    qoff = query_offsets(work)
    slots = sorted(slot for *_, slot, _, _, _ in got)
    assert slots == list(range(int(qoff[-1])))
    assert int(qoff[-1]) <= work.slots
    for b, p, s, slot, c, lo, hi in got:
        assert qoff[b] <= slot < qoff[b + 1]
        assert slot == qoff[b] + sum(-(-int(lens[c2]) // seg) for c2 in probe[b, :p]) + s
        assert c == probe[b, p]
        assert offsets[c] + s * seg == lo and lo < hi <= offsets[c] + lens[c]
        assert hi - lo <= seg and (crow[lo:hi] == c).all()
    # each item holds at most QUERY_TILE queries, in ascending order
    for item in range(work.grid):
        it = list_item(work, item, lens, offsets, seg)
        if it is not None:
            qs = (it[1] // probe.shape[1]).tolist()
            assert len(qs) <= fs.QUERY_TILE and qs == sorted(qs)


@settings(max_examples=60, deadline=None)
@given(b=st.integers(0, 300), nprobe=st.integers(1, 12), kc=st.integers(1, 64),
       skew=st.floats(0.0, 3.0), seg=st.sampled_from([1, 7, 64, 1024]),
       pad=st.integers(0, 200), seed=st.integers(0, 2**16))
def test_grid_bound_never_below_the_items(b, nprobe, kc, skew, seg, pad, seed):
    rng = np.random.default_rng(seed)
    nprobe = min(nprobe, kc)
    kp = kc + pad % 9                                  # padded cluster table
    w = rng.random(kc) ** (1.0 + 4.0 * skew)           # skewed list lengths
    lens = np.zeros(kp, np.int64)
    lens[:kc] = rng.multinomial(int(rng.integers(0, 5000)), w / w.sum())
    probe = np.stack([rng.choice(kc, nprobe, replace=False) for _ in range(b)]) \
        if b else np.zeros((0, nprobe), np.int64)
    max_len = int(lens.max()) + pad                    # an l_pad-style bound
    n_rows = int(lens.sum()) + pad                     # a padded slab
    work = fs.invert_probes(torch.from_numpy(probe), torch.from_numpy(lens).int(),
                            kp, max_len, seg, n_rows)
    items = int(work.item_end[-1])
    assert items <= work.grid
    assert work.item_c.shape == (work.grid,)
    assert (work.item_c[items:] == kp).all()
    # the exact count: chunks of the probing queries times segments
    cnt = np.bincount(probe.reshape(-1), minlength=kp)
    assert items == int((-(-cnt // fs.QUERY_TILE) * -(-lens // seg)).sum())
    assert work.segs == max(1, -(-max_len // seg))
    # the slots: each query's segments, never more than the host bound
    per_query = (-(-lens[probe] // seg)).sum(1) if b else np.zeros(0, np.int64)
    np.testing.assert_array_equal(query_offsets(work).diff().numpy(), per_query)
    assert work.slot_end.shape == (b, nprobe)
    assert int(query_offsets(work)[-1]) <= work.slots


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ivf_layout_matches_dense_and_pallas(name, metric):
    (x, q, sq, alive, crow, probe), k, seg = _case(name)
    t = [as_tensor(a) for a in (q, x, sq, alive, crow, probe)]
    offsets, lens = csr(crow, KP)
    ev, ei = fused_ivf_topk_emulated(t[0], t[1], t[2], t[3], offsets, lens, t[5],
                                     KP, k, port_metric(metric), seg=seg)
    pv, pi = fs.fused_ivf_topk_plain(*t, KP, k, port_metric(metric))
    assert_same_hits(ev, ei, pv, pi)
    probed = np.zeros((len(q), KP), np.float32)
    probed[np.arange(len(q))[:, None], probe] = 1.0
    jv, ji = pallas_ivf_topk(*(jnp.asarray(a) for a in (q, x, sq, alive, crow, probed)),
                             k, metric)
    assert_same_hits(ev, ei, jv, ji)
    if name == "dup_ties" and metric == Metric.L2:
        # query 0 is a row copied into a second list: both copies lead, and
        # at equal scores the lower row comes first
        r0, r1 = ei[0, :2].tolist()
        assert (x[r0] == x[r1]).all()
        assert ev[0, 0] > ev[0, 1] or r0 < r1
    if name == "tombstones":
        assert alive[ei[ei >= 0].numpy()].all()


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("name", ["skewed", "empty_probed", "tombstones", "k128"])
def test_sq8_layout_matches_dense_and_pallas(name, metric):
    case, k, seg = _case(name, d=24)  # d 24: no multiple of 16
    x, q, _, alive, crow, probe = case
    codes, mn, sc, sq, _, qc = sq8_of(case, KP)
    offsets, lens = csr(crow, KP)
    args = [as_tensor(a) for a in (q, codes, mn, sc, sq, alive)]
    ev, ei = fused_ivf_sq8_topk_emulated(*args, offsets, lens, as_tensor(probe),
                                         as_tensor(qc), KP, k, port_metric(metric),
                                         seg=seg)
    pv, pi = fs.fused_ivf_sq8_topk_plain(*args, as_tensor(crow), as_tensor(probe),
                                         as_tensor(qc), KP, k, port_metric(metric))
    assert_same_hits(ev, ei, pv, pi, rtol=SQ8_RTOL)
    tq = np.full((len(q), KP), MASK_SENT, np.float32)
    tq[np.arange(len(q))[:, None], probe] = np.take_along_axis(qc, probe, axis=1)
    jv, ji = pallas_ivf_sq8_topk(*(jnp.asarray(a) for a in (
        q, codes, mn, sc, sq, alive, crow, tq)), k, metric)
    assert_same_hits(ev, ei, jv, ji, rtol=SQ8_RTOL)


@pytest.mark.parametrize("name", ["uniform", "skewed", "dup_ties", "k128", "all_lists"])
def test_floor_leaves_the_result_alone_whatever_the_item_order(name):
    """The per-query floor drops rows from later items' partials, never from
    the merged top k: items run in item order, reversed and shuffled give
    bit-equal results, equal to the dense definition."""
    (x, q, sq, alive, crow, probe), k, seg = _case(name, b=70)
    t = [as_tensor(a) for a in (q, x, sq, alive, crow, probe)]
    offsets, lens = csr(crow, KP)
    grid = fs.list_grid(len(q), probe.shape[1], KP, int(lens.max()), seg)[0]
    rng = np.random.default_rng(5)
    runs = [fused_ivf_topk_emulated(t[0], t[1], t[2], t[3], offsets, lens, t[5], KP,
                                    k, seg=seg, order=order)
            for order in (None, range(grid - 1, -1, -1), rng.permutation(grid),
                          rng.permutation(grid))]
    for v, i in runs[1:]:
        assert torch.equal(v, runs[0][0]) and torch.equal(i, runs[0][1])
    assert_same_hits(*runs[0], *fs.fused_ivf_topk_plain(*t, KP, k))


def test_floor_prunes_later_items():
    """With the floor, an item that runs after a query's list is full emits
    fewer than k rows for it; without one every item would emit k."""
    (x, q, sq, alive, crow, probe), k, seg = _case("all_lists", b=8)
    offsets, lens = csr(crow, KP)
    tq, tx = as_tensor(q), as_tensor(x)
    part_v, _, work = list_partials_emulated(
        lambda bq, c, s, e: tq[bq] @ tx[s:e].T, as_tensor(alive), offsets, lens,
        as_tensor(probe), KP, k, int(lens.max()), seg)
    part_v = part_v[:int(query_offsets(work)[-1])]       # the slots the queries have
    assert not part_v.isnan().any()                      # all of them written
    filled = torch.isfinite(part_v).sum(1)               # rows an item emitted
    written = filled > 0
    assert (filled[written] <= k).all()
    assert float((filled[written] < k).float().mean()) > 0.5  # most items were cut


def test_layout_takes_a_loose_max_len_and_one_row_segments():
    (x, q, sq, alive, crow, probe), k, _ = _case("skewed", n=2048, kc=12)
    t = [as_tensor(a) for a in (q, x, sq, alive, crow, probe)]
    offsets, lens = csr(crow, 12)
    want = fs.fused_ivf_topk_plain(*t, 12, k)
    for max_len, seg in ((int(lens.max()) + 300, 1024), (int(lens.max()), 97)):
        got = fused_ivf_topk_emulated(t[0], t[1], t[2], t[3], offsets, lens, t[5],
                                      12, k, max_len=max_len, seg=seg)
        assert_same_hits(*got, *want)


def test_merge_order_does_not_depend_on_list_order():
    """The list scan's partials come in probe-rank order, not row order:
    the merge still returns (score desc, row asc)."""
    rng = np.random.default_rng(3)
    s, b, k = 6, 5, 8
    v = np.round(rng.random((s, b, k)) * 4).astype(np.float32) / 4  # many ties
    i = rng.permutation(s * b * k).reshape(s, b, k).astype(np.int32)
    order = np.lexsort((i, -v), axis=-1)
    v, i = np.take_along_axis(v, order, -1), np.take_along_axis(i, order, -1)
    mv, mi = fs.merge_partials(as_tensor(v), as_tensor(i))
    rv, ri = fs.merge_partials(as_tensor(v[::-1].copy()), as_tensor(i[::-1].copy()))
    np.testing.assert_array_equal(mi.numpy(), ri.numpy())
    for row in range(b):
        flat = sorted(zip(-v[:, row].ravel(), i[:, row].ravel()))[:k]
        assert mi[row].tolist() == [int(r) for _, r in flat]
        np.testing.assert_array_equal(mv[row].numpy(), [-s for s, _ in flat])


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    (x, q, sq, alive, crow, probe), k, _ = _case("uniform")
    t = [as_tensor(a) for a in (q, x, sq, alive, crow)]
    offsets, lens = csr(crow, KP)
    before = dict(fs.LAUNCHES)
    got = fs.fused_ivf_topk(*t, offsets, lens, as_tensor(probe), KP, k, max_len=4096)
    want = fs.fused_ivf_topk_plain(*t, as_tensor(probe), KP, k)
    assert fs.LAUNCHES == before
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_segment_length_fills_the_card_from_shapes():
    # 1M rows, nlist 1000, b1024, nprobe 3: a thousand lists already fill it
    assert fs.list_seg(1024, 3, 1000, 1152, 132) == fs.LIST_SEG
    # 100k rows, nlist 100, b1024, nprobe 3: 100 lists, so shorter segments
    seg = fs.list_seg(1024, 3, 100, 1152, 132)
    assert fs.LIST_SEG_MIN <= seg < fs.LIST_SEG
    assert fs.list_grid(1024, 3, 100, 1152, seg)[0] >= 4 * 132 or seg == fs.LIST_SEG_MIN
    assert fs.list_seg(1, 1, 1, 1, 132) == fs.LIST_SEG_MIN


def test_merge_of_per_query_slots_equals_the_padded_merge():
    """The list scan's merge form: query b's lists are rows qoff[b] ..
    qoff[b+1] of [slots, k], as many as its probes have segments (none for
    a query that probes only empty lists), given as the running counts
    qend [B, P] (qoff[b+1] = qend[b, -1]); the same lists padded to [S, B,
    k] with empty ones merge to the same result."""
    rng = np.random.default_rng(4)
    b, k = 7, 6
    per_probe = np.array([[0, 0], [1, 0], [2, 1], [0, 2], [3, 2], [0, 0], [1, 3]])
    cnt = per_probe.sum(1)
    qend = np.cumsum(per_probe.reshape(-1)).reshape(b, 2).astype(np.int32)
    qoff = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
    v = np.round(rng.random((qoff[-1] + 3, k)) * 4).astype(np.float32) / 4  # ties
    i = rng.permutation(v.size).reshape(v.shape).astype(np.int32)
    order = np.lexsort((i, -v), axis=-1)
    v, i = np.take_along_axis(v, order, -1), np.take_along_axis(i, order, -1)
    pad_v = np.full((cnt.max(), b, k), -np.inf, np.float32)
    pad_i = np.full((cnt.max(), b, k), -1, np.int32)
    for row in range(b):
        pad_v[:cnt[row], row] = v[qoff[row]:qoff[row + 1]]
        pad_i[:cnt[row], row] = i[qoff[row]:qoff[row + 1]]
    got = fs.merge_partials(as_tensor(v), as_tensor(i), as_tensor(qend))
    want = fs.merge_partials(as_tensor(pad_v), as_tensor(pad_i))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1][cnt == 0] == -1).all() and torch.isinf(got[0][cnt == 0]).all()
    none = fs.merge_partials(as_tensor(v), as_tensor(i), torch.zeros((b, 2), dtype=torch.int32))
    assert none[0].shape == (b, k) and (none[1] == -1).all()


@pytest.mark.parametrize("fault", ["repeated_probe", "short_max_len", "max_len_tensor"])
def test_cpu_wrapper_checks_the_list_preconditions(fault):
    """The kernel relies on distinct probes in a row and max_len >= every
    list, a host int; the wrapper checks them for CPU tensors."""
    (x, q, sq, alive, crow, probe), k, _ = _case("skewed")
    t = [as_tensor(a) for a in (q, x, sq, alive, crow)]
    offsets, lens = csr(crow, KP)
    probe, max_len = probe.copy(), int(lens.max())
    if fault == "repeated_probe":
        probe[3, 1] = probe[3, 0]
    elif fault == "short_max_len":
        max_len -= 1
    else:
        max_len = lens.max()
    err = TypeError if fault == "max_len_tensor" else ValueError
    with pytest.raises(err):
        fs.fused_ivf_topk(*t, offsets, lens, as_tensor(probe), KP, k, max_len=max_len)
    codes, mn, sc, sq8, _, qc = sq8_of((x, q, sq, alive, crow, probe), KP)
    with pytest.raises(err):
        fs.fused_ivf_sq8_topk(*(as_tensor(a) for a in (q, codes, mn, sc, sq8, alive, crow)),
                              offsets, lens, as_tensor(probe), as_tensor(qc), KP, k,
                              max_len=max_len)
