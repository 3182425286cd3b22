"""The Zipf corpora: the port's generators and its IVF-Flat path on a
skewed partition, against the JAX package on the CPU.

- ``zipf_cluster_sizes``, ``synthetic_zipf`` and ``synthetic_zipf_queries``
  are numpy only and must be bit-equal to the JAX package's, at bench.py's
  sizes too (1M rows over 1000 clusters).
- ``ivf100k_zipf`` (bench.py's row: 100k x 128, 100 natural clusters,
  nlist 100, nprobe 3) built in both packages: recall@10 within phase 23's
  0.005 of each other (the partitions differ at ~0.1% of the rows: see
  the test), and the JAX package's recall is chip_smoke's
  ``ZIPF_RECALL_JAX``, the gate phase 23 holds the card to.
- A 20k-row Zipf index built by the JAX package and carried into the port
  (``convert.ivf_flat_from_arrays``) answers every route with the JAX
  hits: the list scan's plain version (``dense-pallas``; JAX K2 in
  interpret mode), ``probe`` and ``dense-xla``. The probe route walks its
  gather in query blocks (``DENSE_MAX_ELEMS``), bit-equal to one block.
"""

import numpy as np
import pytest
import torch
from _torch_parity import assert_same_results, port_options

import pyrope_tpu as jpt
from pyrope_tpu.types import SearchOptions
from pyrope_tpu.utils import datasets as jds
from pyrope_tpu_torch import convert
from pyrope_tpu_torch.index import ivf_flat as tivf
from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
from pyrope_tpu_torch.types import Metric
from pyrope_tpu_torch.utils import datasets as tds


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module: the tier-1 run's
    workers share the host's cores, and there these CPU builds ran 25x
    slower at the default thread count than at one (threads spinning on
    cores the other workers hold). The pool is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,k,alpha,seed", [
    (1_000_000, 1000, 1.0, 42),
    (100_000, 100, 1.0, 42),
    (64_000, 1000, 1.0, 42),     # the queries' popularity table at 1000 clusters
    (5_000, 37, 1.3, 7),
    (997, 10, 0.5, 1),
    (10, 10, 1.0, 3),            # one row a cluster
])
def test_zipf_cluster_sizes_bit_equal(n, k, alpha, seed):
    got = tds.zipf_cluster_sizes(n, k, alpha, seed)
    want = jds.zipf_cluster_sizes(n, k, alpha, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.sum() == n and (got > 0).all()


@pytest.mark.parametrize("n,d,k,alpha,seed", [
    (100_000, 128, 100, 1.0, 42),
    (20_000, 32, 100, 1.0, 42),
    (3_000, 7, 13, 1.5, 5),
])
def test_synthetic_zipf_bit_equal(n, d, k, alpha, seed):
    got = tds.synthetic_zipf(n, d, n_clusters=k, alpha=alpha, seed=seed)
    want = jds.synthetic_zipf(n, d, n_clusters=k, alpha=alpha, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,d,k,alpha,seed,base_seed", [
    (1024, 128, 1000, 1.0, 1337, 42),
    (1024, 128, 100, 1.0, 1337, 42),
    (50, 9, 17, 0.8, 3, 11),
])
def test_synthetic_zipf_queries_bit_equal(n, d, k, alpha, seed, base_seed):
    got = tds.synthetic_zipf_queries(n, d, n_clusters=k, alpha=alpha, seed=seed,
                                     base_seed=base_seed)
    want = jds.synthetic_zipf_queries(n, d, n_clusters=k, alpha=alpha, seed=seed,
                                      base_seed=base_seed)
    assert np.array_equal(got, want)


def test_zipf_skew_is_the_benchmarks():
    """The largest of 1000 clusters at 1M rows: (1e6 - 1000) / H(1000) + 1
    rows, about 13% of the corpus."""
    sizes = tds.zipf_cluster_sizes(1_000_000, 1000)
    h = (1.0 / np.arange(1, 1001)).sum()
    assert abs(int(sizes.max()) - (1_000_000 - 1000) / h) < 3
    assert 0.13 < sizes.max() / 1e6 < 0.14


N100K, D, K = 100_000, 128, 10


def test_ivf100k_zipf_builds_agree():
    """Both packages build ivf100k_zipf from the same rows. k-means++ picks
    the same rows (``ops/jrandom``), but Lloyd's fp32 sums and the
    assignments' products run in another order in each package, and on
    this corpus k-means splits the big natural clusters, whose halves share
    a dense boundary: ~0.1% of the rows land in another list, and a query
    whose neighbours sit there can differ. So the two builds are held to
    phase 23's tolerance (recall@10 within 0.005); one partition carried
    across gives the JAX hits on every route (the 20k cases below). The
    JAX index answers through its probe route, which scans the probed lists
    exactly as its kernel route does (phase 23 holds the two routes equal
    on the card), without Pallas' interpret mode."""
    import chip_smoke

    base = tds.synthetic_zipf(N100K, D, n_clusters=100)
    queries = tds.synthetic_zipf_queries(1024, D, n_clusters=100)[:256]
    truth = tds.ground_truth(base, queries, K, "L2")
    ids = [str(i) for i in range(N100K)]
    jix = jpt.IvfFlatIndex(D, "L2", nlist=100)
    tix = IvfFlatIndex(D, "L2", nlist=100, device="cpu")
    rows = {}
    for name, ix in (("jax", jix), ("port", tix)):
        ix.add_batch(ids, base)
        ix.build()
        assert ix.describe_scan(256) == "dense-pallas"
    jix.scan_mode = "probe"
    for name, ix in (("jax", jix), ("port", tix)):
        hits = ix.search_batch(queries, K)
        rows[name] = tds.id_lists_to_rows([[h.id for h in r] for r in hits], K)
    rj, rp = (tds.recall_at_k(rows[s], truth, K) for s in ("jax", "port"))
    same = sum(set(a) == set(b) for a, b in zip(rows["jax"], rows["port"]))
    moved = int(np.abs(np.asarray(jix._lens) - tix._lens).sum()) // 2
    print(f"ivf100k_zipf recall@10 jax {rj} port {rp}; hit sets equal {same}/256; "
          f"rows in another list >= {moved}")
    assert rj == chip_smoke.ZIPF_RECALL_JAX
    assert abs(rp - rj) <= 0.005


@pytest.fixture(scope="module")
def zipf20k(tmp_path_factory):
    n, d = 20_000, 32
    base = tds.synthetic_zipf(n, d, n_clusters=100)
    q = tds.synthetic_zipf_queries(64, d, n_clusters=100)
    jix = jpt.IvfFlatIndex(d, "L2", nlist=100, nprobe=3, scan_mode="dense")
    jix.add_batch([str(i) for i in range(n)], base)
    jix.build()
    path = str(tmp_path_factory.mktemp("zipf") / "jax.npz")
    jix.snapshot(path)
    with np.load(path) as z:
        tix = convert.ivf_flat_from_arrays(z, "cpu")
    return jix, tix, q


def test_zipf20k_partition_is_skewed(zipf20k):
    _, tix, _ = zipf20k
    lens = np.sort(tix._lens)[::-1]
    assert lens[0] > 4 * np.median(lens)


@pytest.mark.parametrize("mode,route,opts", [
    ("dense", "dense-pallas", SearchOptions()),
    ("probe", "probe", SearchOptions()),
    ("dense", "dense-xla", SearchOptions(max_scans=15_000)),
])
def test_zipf20k_routes_return_the_jax_hits(zipf20k, mode, route, opts):
    jix, tix, q = zipf20k
    jix.scan_mode = tix.scan_mode = mode
    try:
        ms = opts.max_scans
        assert jix.describe_scan(64, max_scans=ms) == route
        assert tix.describe_scan(64, max_scans=ms) == route
        assert_same_results(tix.search_batch(q, K, port_options(opts)),
                            jix.search_batch(q, K, opts))
    finally:
        jix.scan_mode = tix.scan_mode = "dense"


def test_probe_route_blocks_bit_equal_to_one_block(zipf20k, monkeypatch):
    """The probe route's gather walked in blocks of queries (a cap small
    enough for blocks of 5 of 64 queries, and one of 4 + a tail of 1 that
    joins the block before it) gives the one-block route's hits, bit for
    bit."""
    jix, tix, q = zipf20k
    dev = tix._sync()
    qt = torch.from_numpy(q)
    probe = tivf.top_probes(qt, dev["cents"], dev["cvalid"], 3, Metric.L2)
    offs_p, eff = tivf.probe_extents(probe, dev["offsets"], dev["lens"], tix._main_n)
    args = (dev["xperm"], dev["sqnorm"], dev["alive"])
    kw = dict(k=K, l_pad=dev["l_pad"], metric=Metric.L2)
    whole = tivf._scan_probed_block(*args, qt, offs_p, eff, **kw)
    for per_block, b in ((5, 64), (4, 61)):
        monkeypatch.setattr(tivf, "DENSE_MAX_ELEMS", per_block * dev["l_pad"] * 32)
        got = tivf.scan_probed_lists(*args, qt[:b], offs_p[:b], eff[:b], **kw)
        assert torch.equal(got[0], whole[0][:b]) and torch.equal(got[1], whole[1][:b])
