"""Port parity: pyrope_tpu_torch/parallel against the JAX package's sharded
families.

Twins of tests/test_sharded.py. The JAX side runs on its 8 virtual CPU
devices (tests/conftest.py), the port on an 8-shard CPU mesh
(``make_mesh(device="cpu")``); the same seeded numpy inputs go to both, and
where a JAX test holds the sharded index to the single one, the port's
twin holds it to the JAX sharded index as well. The IVF and PQ twins carry
the JAX index's partition into the port (its snapshot through
``convert.sharded_*_from_arrays``), so both scan the same lists; the HNSW
twins carry the JAX graph. fp32 on both sides in another summation order:
scores within rtol 1e-5 / atol 1e-4 unless a test states its own (the JAX
test's), and an ordered list may differ only inside a run of near-equal
scores (assert_same_results).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import SQ8_RTOL, assert_same_results
from jax.sharding import NamedSharding, PartitionSpec as P

import pyrope_tpu as jpt
from pyrope_tpu import parallel as jpar
from pyrope_tpu.parallel.mesh import DATA_AXIS as JDATA
from pyrope_tpu.utils.datasets import (
    ground_truth,
    id_lists_to_rows,
    recall_at_k,
    synthetic,
    synthetic_clustered,
    synthetic_clustered_queries,
    synthetic_zipf,
)
from pyrope_tpu_torch import convert
from pyrope_tpu_torch.index.delta import DeltaIndex
from pyrope_tpu_torch.index.flat import FlatIndex
from pyrope_tpu_torch.index.hnsw import HnswIndex
from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex
from pyrope_tpu_torch.parallel import (
    ShardedFlatIndex,
    ShardedHnswCorpusIndex,
    ShardedHnswIndex,
    ShardedIvfFlatIndex,
    ShardedIvfPqIndex,
    make_mesh,
    make_mesh_2d,
    make_mesh_multislice,
    sharded_kmeans_step,
)
from pyrope_tpu_torch.parallel.dryrun import dryrun_multichip
from pyrope_tpu_torch.parallel.mesh import (
    allgather_merge_topk,
    row_axes,
    row_shard_count,
)
from pyrope_tpu_torch.types import SearchOptions


def tmesh(n=None):
    return make_mesh(n, device="cpu")


def ids_of(results):
    return [[h.id for h in r] for r in results]


def jax_options(**kw):
    return jpt.SearchOptions(**kw)


# ---- mesh ------------------------------------------------------------------


def test_mesh_has_8_devices():
    assert tmesh().devices.size == jpar.make_mesh().devices.size == 8
    assert tmesh().axis_names == jpar.make_mesh().axis_names == ("data",)


def test_mesh_devices_may_repeat():
    """A mesh of explicit devices may name one device several times (four
    shards on one card); asking for more devices than given raises, as
    make_mesh does past the machine's devices."""
    m = make_mesh(devices=["cpu"] * 4)
    assert m.size == 4 and len(set(m.devices.flat)) == 1
    assert make_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="asked for 5"):
        make_mesh(5, devices=["cpu"] * 4)
    assert make_mesh_2d(2, 2, devices=["cpu"] * 4).shape == {"batch": 2, "data": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(4)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardedFlatIndex(8)


# ---- sharded Flat -----------------------------------------------------------


def test_sharded_flat_matches_single_device():
    base = synthetic(2000, 32)
    q = synthetic(16, 32, seed=5)
    ids = [str(i) for i in range(2000)]
    ref = FlatIndex(32, device="cpu")
    sh = ShardedFlatIndex(32, mesh=tmesh())
    jsh = jpar.ShardedFlatIndex(32, mesh=jpar.make_mesh())
    for ix in (ref, sh, jsh):
        ix.add_batch(ids, base)
    assert_same_results(sh.search_batch(q, 10), ref.search_batch(q, 10))
    assert_same_results(sh.search_batch(q, 10), jsh.search_batch(q, 10))


def test_sharded_flat_delete_and_maxscans():
    base = synthetic(500, 16)
    sh = ShardedFlatIndex(16, mesh=tmesh())
    jsh = jpar.ShardedFlatIndex(16)
    for ix in (sh, jsh):
        ix.add_batch([str(i) for i in range(500)], base)
        ix.delete("123")
    hits = sh.search(base[123], 5)
    assert all(h.id != "123" for h in hits)
    assert_same_results([hits], [jsh.search(base[123], 5)])
    hits = sh.search(base[400], 3, SearchOptions(max_scans=50))
    assert all(int(h.id) < 50 for h in hits)
    assert_same_results([hits], [jsh.search(base[400], 3, jax_options(max_scans=50))])


@pytest.mark.parametrize("metric", ["IP", "COSINE"])
def test_sharded_flat_metrics(metric):
    base = synthetic(300, 16)
    q = synthetic(4, 16, seed=3)
    sh = ShardedFlatIndex(16, metric, mesh=tmesh())
    ref = FlatIndex(16, metric, device="cpu")
    jsh = jpar.ShardedFlatIndex(16, metric)
    for ix in (sh, ref, jsh):
        ix.add_batch([str(i) for i in range(300)], base)
    assert ids_of(sh.search_batch(q, 5)) == ids_of(ref.search_batch(q, 5))
    assert_same_results(sh.search_batch(q, 5), jsh.search_batch(q, 5))


@pytest.mark.parametrize("multislice", [False, True])
def test_sharded_kmeans_step_matches_host(multislice):
    x = synthetic(1024, 16)
    cents0 = x[:8].copy()
    mesh = make_mesh_multislice(2, 4, device="cpu") if multislice else tmesh()
    out = sharded_kmeans_step(x, np.ones(1024, bool), cents0, metric="L2", mesh=mesh).numpy()
    d2 = ((x[:, None, :] - cents0[None, :, :]) ** 2).sum(-1)
    assign = d2.argmin(1)
    expect = np.stack([x[assign == j].mean(0) if (assign == j).any() else cents0[j]
                       for j in range(8)])
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)
    jmesh = jpar.make_mesh()
    jout = jpar.sharded_kmeans_step(
        jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P(JDATA, None))),
        jax.device_put(jnp.ones(1024, bool), NamedSharding(jmesh, P(JDATA))),
        jnp.asarray(cents0), metric=jpt.Metric.L2, mesh=jmesh)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-5, atol=1e-5)


def test_sharded_kmeans_step_keeps_empty_clusters_and_invalid_rows():
    rng = np.random.default_rng(0)
    x = rng.random((256, 8)).astype(np.float32)
    cents0 = np.concatenate([x[:3], np.full((1, 8), 50.0, np.float32)])  # 3 never wins
    valid = np.arange(256) % 3 != 0
    out = sharded_kmeans_step(x, valid, cents0, metric="L2", mesh=tmesh()).numpy()
    np.testing.assert_array_equal(out[3], cents0[3])
    assign = ((x[:, None] - cents0[None]) ** 2).sum(-1).argmin(1)
    for j in range(3):
        np.testing.assert_allclose(out[j], x[(assign == j) & valid].mean(0), rtol=1e-5,
                                   atol=1e-6)


class TestShardedFlatSnapshot:
    def test_snapshot_load_roundtrip_preserves_mesh(self, tmp_path):
        mesh = tmesh(4)
        idx = ShardedFlatIndex(8, "L2", mesh=mesh)
        vecs = np.random.default_rng(0).random((100, 8), dtype=np.float32)
        idx.add_batch([f"v{i}" for i in range(100)], vecs)
        p = str(tmp_path / "s.npz")
        idx.snapshot(p)
        idx.load(p)
        assert idx.mesh is mesh
        assert idx.get_stats().count == 100
        assert idx.search(vecs[5], 1)[0].id == "v5"

    @pytest.mark.parametrize("storage", ["fp32", "sq8"])
    def test_jax_snapshot_carries_across(self, tmp_path, storage):
        """convert.sharded_flat_from_arrays: the JAX ShardedFlatIndex's
        snapshot on the port's mesh searches as the JAX index does."""
        rng = np.random.default_rng(1)
        vecs = rng.random((900, 16), dtype=np.float32)
        q = rng.random((8, 16), dtype=np.float32)
        jsh = jpar.ShardedFlatIndex(16, "L2", storage=storage)
        jsh.add_batch([f"v{i}" for i in range(900)], vecs)
        jsh.delete("v17")
        jsh.snapshot(str(tmp_path / "j.npz"))
        with np.load(tmp_path / "j.npz") as z:
            sh = convert.sharded_flat_from_arrays(z, tmesh())
        assert sh.storage == storage and sh.get_stats().count == 899
        assert_same_results(sh.search_batch(q, 10), jsh.search_batch(q, 10), rtol=SQ8_RTOL)


class TestBatchDataMesh:
    def test_2d_mesh_matches_1d(self):
        rng = np.random.default_rng(0)
        base = rng.random((2048, 16), dtype=np.float32)
        ids = [str(i) for i in range(2048)]
        q = rng.random((16, 16), dtype=np.float32)
        one_d = ShardedFlatIndex(16, "L2", mesh=tmesh(8))
        two_d = ShardedFlatIndex(16, "L2", mesh=make_mesh_2d(2, 4, device="cpu"))
        jtwo = jpar.ShardedFlatIndex(16, "L2", mesh=jpar.make_mesh_2d(2, 4))
        for ix in (one_d, two_d, jtwo):
            ix.add_batch(ids, base)
        assert ids_of(one_d.search_batch(q, 10)) == ids_of(two_d.search_batch(q, 10))
        assert_same_results(two_d.search_batch(q, 10), jtwo.search_batch(q, 10))

    def test_2d_mesh_takes_a_ragged_batch(self):
        """The JAX 2-D mesh needs a batch the batch axis divides; the port
        splits any batch over its groups."""
        base = synthetic(600, 16)
        q = synthetic(5, 16, seed=2)
        two_d = ShardedFlatIndex(16, "L2", mesh=make_mesh_2d(2, 4, device="cpu"))
        ref = FlatIndex(16, "L2", device="cpu")
        for ix in (two_d, ref):
            ix.add_batch([str(i) for i in range(600)], base)
        vals, rows = two_d.device_search(torch.from_numpy(q), 7)
        rvals, rrows = ref.device_search(torch.from_numpy(q), 7)
        assert torch.equal(rows, rrows)


class TestShardedSq8:
    def test_matches_single_device_sq8(self):
        rng = np.random.default_rng(3)
        base = rng.random((2000, 32), dtype=np.float32)
        ids = [str(i) for i in range(2000)]
        q = rng.random((8, 32), dtype=np.float32)
        ref = FlatIndex(32, "L2", device="cpu", storage="sq8")
        sh = ShardedFlatIndex(32, "L2", mesh=tmesh(8), storage="sq8")
        jsh = jpar.ShardedFlatIndex(32, "L2", mesh=jpar.make_mesh(8), storage="sq8")
        for ix in (ref, sh, jsh):
            ix.add_batch(ids, base)
        assert_same_results(sh.search_batch(q, 10), ref.search_batch(q, 10), rtol=SQ8_RTOL)
        assert_same_results(sh.search_batch(q, 10), jsh.search_batch(q, 10), rtol=SQ8_RTOL)
        assert sh.describe_scan(8) == "flat-sq8"

    def test_sq8_delete_visibility(self):
        base = np.random.default_rng(4).random((300, 16), dtype=np.float32)
        sh = ShardedFlatIndex(16, "L2", mesh=tmesh(4), storage="sq8")
        sh.add_batch([str(i) for i in range(300)], base)
        assert sh.search(base[7], 1)[0].id == "7"
        sh.delete("7")
        assert sh.search(base[7], 1)[0].id != "7"


def test_sharded_flat_pallas_parity_and_budget_rebase():
    """selection='pallas': the flat scan (its plain version on the CPU) on
    every shard; the global max_scans budget rebased to each shard's
    block, matching the single index's first-ms-rows semantics."""
    base = synthetic(5000, 32)
    ids = [str(i) for i in range(5000)]
    sh = ShardedFlatIndex(32, "L2", mesh=tmesh(8), selection="pallas")
    ref = FlatIndex(32, "L2", device="cpu")
    jsh = jpar.ShardedFlatIndex(32, "L2", mesh=jpar.make_mesh(8), selection="pallas")
    for ix in (sh, ref, jsh):
        ix.add_batch(ids, base)
    assert sh.describe_scan(64) == "flat-pallas"
    q = synthetic(64, 32)
    a = sh.search_batch(q, 10)
    assert_same_results(a, ref.search_batch(q, 10))
    assert_same_results(a, jsh.search_batch(q, 10))
    opts = SearchOptions(max_scans=700)
    a2 = sh.search_batch(q, 10, opts)
    assert_same_results(a2, ref.search_batch(q, 10, opts))
    assert_same_results(a2, jsh.search_batch(q, 10, jax_options(max_scans=700)))
    for h in a[0][:3]:
        assert sh.delete(h.id)
    a3 = sh.search_batch(q[:8], 10)
    assert not ({h.id for h in a3[0]} & {h.id for h in a[0][:3]})


def test_sharded_flat_bf16_pallas_runs_the_bf16_scan():
    """A bf16 slab with selection='pallas': each shard's flat scan in its
    bf16 mode, as the JAX package's per-shard kernel takes the bf16 slab."""
    base = synthetic(3000, 32)
    q = synthetic(16, 32, seed=4)
    ids = [str(i) for i in range(3000)]
    sh = ShardedFlatIndex(32, "L2", mesh=tmesh(), storage="bf16", selection="pallas")
    ref = FlatIndex(32, "L2", device="cpu", storage="bf16", selection="pallas")
    for ix in (sh, ref):
        ix.add_batch(ids, base)
    assert sh._sync()["shards"][0][0]["vecs"].dtype == torch.bfloat16
    assert_same_results(sh.search_batch(q, 10), ref.search_batch(q, 10))


# ---- sharded IVF-Flat ---------------------------------------------------------


def _jax_ivf_pair(tmp_path, dim, base, mesh_n=8, shard_by="rows", **kw):
    """A JAX ShardedIvfFlatIndex built on ``base`` and the port's twin on the
    same partition (its snapshot carried across)."""
    ids = [str(i) for i in range(len(base))]
    jsh = jpar.ShardedIvfFlatIndex(dim, "L2", mesh=jpar.make_mesh(mesh_n), shard_by=shard_by,
                                   **kw)
    jsh.add_batch(ids, base)
    jsh.build()
    jsh.snapshot(str(tmp_path / "jivf.npz"))
    with np.load(tmp_path / "jivf.npz") as z:
        sh = convert.sharded_ivf_flat_from_arrays(z, tmesh(mesh_n), shard_by=shard_by)
    return jsh, sh


class TestShardedIvf:
    def test_matches_single_device_ivf(self, tmp_path):
        rng = np.random.default_rng(0)
        n, dim = 4000, 32
        base = rng.random((n, dim), dtype=np.float32)
        q = rng.random((8, dim), dtype=np.float32)
        jsh, sh = _jax_ivf_pair(tmp_path, dim, base, nlist=16)
        with np.load(tmp_path / "jivf.npz") as z:
            ref = convert.ivf_flat_from_arrays(z, "cpu")
        opts = SearchOptions(nprobe=8)
        r_sh = sh.search_batch(q, 10, opts)
        assert_same_results(r_sh, ref.search_batch(q, 10, opts))
        assert_same_results(r_sh, jsh.search_batch(q, 10, jax_options(nprobe=8)))

    def test_buffer_delete_and_upsert_semantics(self):
        rng = np.random.default_rng(1)
        base = rng.random((500, 16), dtype=np.float32)
        sh = ShardedIvfFlatIndex(16, "L2", mesh=tmesh(4), nlist=8)
        sh.add_batch([str(i) for i in range(500)], base)
        sh.build()
        fresh = rng.random(16).astype(np.float32)
        assert sh.add("fresh", fresh)
        assert sh.search(fresh, 1)[0].id == "fresh"
        assert sh.delete("42")
        hits = sh.search(base[42], 5, SearchOptions(nprobe=8))
        assert all(h.id != "42" for h in hits)
        sh.build()
        assert sh.search(fresh, 1)[0].id == "fresh"
        assert sh.get_stats().count == 500

    def test_recall_parity(self, tmp_path):
        rng = np.random.default_rng(2)
        n, dim = 5000, 32
        base = rng.random((n, dim), dtype=np.float32)
        q = rng.random((16, dim), dtype=np.float32)
        jsh, sh = _jax_ivf_pair(tmp_path, dim, base, nlist=16)
        truth = ground_truth(base, q, 10, "L2")
        got = [recall_at_k(id_lists_to_rows(ids_of(ix.search_batch(q, 10, o)), 10), truth, 10)
               for ix, o in ((sh, SearchOptions(nprobe=16)), (jsh, jax_options(nprobe=16)))]
        assert got[0] == got[1] > 0.99  # all lists probed => exact

    def test_sharded_ivf_snapshot_load(self, tmp_path):
        mesh = tmesh(4)
        sh = ShardedIvfFlatIndex(16, "L2", mesh=mesh, nlist=4)
        base = np.random.default_rng(3).random((300, 16), dtype=np.float32)
        sh.add_batch([str(i) for i in range(300)], base)
        sh.build()
        p = str(tmp_path / "sivf.npz")
        sh.snapshot(p)
        sh.load(p)
        assert sh.mesh is mesh
        assert sh.search(base[11], 3, SearchOptions(nprobe=4))[0].id == "11"

    def test_2d_batch_data_mesh_matches_1d(self, tmp_path):
        rng = np.random.default_rng(8)
        base = rng.random((2000, 32), dtype=np.float32)
        q = rng.random((8, 32), dtype=np.float32)
        jsh, one_d = _jax_ivf_pair(tmp_path, 32, base, mesh_n=4, nlist=8)
        with np.load(tmp_path / "jivf.npz") as z:
            two_d = convert.sharded_ivf_flat_from_arrays(z, make_mesh_2d(2, 4, device="cpu"))
        opts = SearchOptions(nprobe=8)
        assert ids_of(one_d.search_batch(q, 10, opts)) == ids_of(two_d.search_batch(q, 10, opts))
        assert_same_results(two_d.search_batch(q, 10, opts),
                            jsh.search_batch(q, 10, jax_options(nprobe=8)))


class TestShardedDenseScan:
    """Both sharded IVF routes (dense and probe) against the single index
    and the JAX sharded index, per mode."""

    def _data(self, n=3000, dim=16, nq=6, seed=3):
        rng = np.random.default_rng(seed)
        return rng.random((n, dim), dtype=np.float32), rng.random((nq, dim), dtype=np.float32)

    @pytest.mark.parametrize("mode", ["dense", "probe"])
    def test_sharded_ivf_mode_matches_single(self, tmp_path, mode):
        base, q = self._data()
        jsh, sh = _jax_ivf_pair(tmp_path, 16, base, nlist=12, scan_mode=mode)
        with np.load(tmp_path / "jivf.npz") as z:
            ref = convert.ivf_flat_from_arrays(z, "cpu")
        for nprobe in (2, 12):
            opts = SearchOptions(nprobe=nprobe)
            a = sh.search_batch(q, 10, opts)
            assert_same_results(a, ref.search_batch(q, 10, opts))
            assert_same_results(a, jsh.search_batch(q, 10, jax_options(nprobe=nprobe)))

    @pytest.mark.parametrize("mode", ["dense", "probe"])
    def test_sharded_ivf_max_scans_local_budget(self, tmp_path, mode):
        """max_scans splits across shards (ceil(ms/nd) a shard): the port's
        dense and probe routes agree with each other and with the JAX
        sharded index's."""
        base, q = self._data(seed=4)
        jsh, sh = _jax_ivf_pair(tmp_path, 16, base, nlist=12, scan_mode=mode)
        assert sh.describe_scan(8, 12, max_scans=160) == (
            "dense-xla" if mode == "dense" else "probe")
        opts = SearchOptions(nprobe=12, max_scans=160)
        a = sh.search_batch(q, 10, opts)
        assert_same_results(a, jsh.search_batch(q, 10, jax_options(nprobe=12, max_scans=160)))
        other = "probe" if mode == "dense" else "dense"
        sh.scan_mode = other
        assert ids_of(sh.search_batch(q, 10, opts)) == ids_of(a)


class TestShardedPallasDense:
    """The sharded dense route runs the list scan per shard (its plain
    version on the CPU) with the single index's hits, and the plain dense
    scan under a budget."""

    def test_narrow_path_and_parity(self, tmp_path):
        base = synthetic(4096, 32)
        jsh, sh = _jax_ivf_pair(tmp_path, 32, base, nlist=16, nprobe=8)
        assert sh.describe_scan(64, 8) == jsh.describe_scan(64, 8) == "dense-pallas"
        assert sh.describe_scan(64, 8, max_scans=100) == "dense-xla"
        with np.load(tmp_path / "jivf.npz") as z:
            ref = convert.ivf_flat_from_arrays(z, "cpu")
        q = synthetic(64, 32)
        a = sh.search_batch(q, 10)
        assert_same_results(a, ref.search_batch(q, 10))
        assert_same_results(a, jsh.search_batch(q, 10))

    def test_windowed_path_and_parity(self, tmp_path):
        """nlist 640 (a cluster table past 512): the route the JAX package
        names dense-pallas-win, here the same list scan; hits equal the
        single index's on the same partition (one JAX build carried into
        both port indexes)."""
        n = 131072
        base = synthetic(n, 16)
        jref = jpt.IvfFlatIndex(16, "L2", nlist=640, nprobe=64)
        jref.add_batch([str(i) for i in range(n)], base)
        jref.build()
        jref.snapshot(str(tmp_path / "j640.npz"))
        with np.load(tmp_path / "j640.npz") as z:
            sh = convert.sharded_ivf_flat_from_arrays(z, tmesh(8))
            ref = convert.ivf_flat_from_arrays(z, "cpu")
        assert sh.describe_scan(64, 64) == ref.describe_scan(64, 64) == "dense-pallas-win"
        q = synthetic(64, 16)
        assert_same_results(sh.search_batch(q, 10), ref.search_batch(q, 10))


class TestClusterShardedIvf:
    """shard_by='cluster': whole lists a shard, probes routed to owners."""

    def _pair(self, tmp_path, n=4000, dim=32, nlist=16, zipf=False, **kw):
        rng = np.random.default_rng(3)
        base = (synthetic_zipf(n, dim, n_clusters=nlist) if zipf
                else rng.random((n, dim), dtype=np.float32))
        jsh, sh = _jax_ivf_pair(tmp_path, dim, base, shard_by="cluster", nlist=nlist, **kw)
        sh.probe_cap = jsh.probe_cap
        with np.load(tmp_path / "jivf.npz") as z:
            ref = convert.ivf_flat_from_arrays(z, "cpu")
        ref.scan_mode = kw.get("scan_mode", "auto")
        return ref, sh, jsh, rng

    def _assert_match(self, ref, sh, jsh, q, k, nprobe):
        a = sh.search_batch(q, k, SearchOptions(nprobe=nprobe))
        assert_same_results(a, ref.search_batch(q, k, SearchOptions(nprobe=nprobe)))
        assert_same_results(a, jsh.search_batch(q, k, jax_options(nprobe=nprobe)))

    def test_cluster_probe_matches_single_device(self, tmp_path):
        ref, sh, jsh, rng = self._pair(tmp_path, scan_mode="probe")
        self._assert_match(ref, sh, jsh, rng.random((8, 32), dtype=np.float32), 10, 8)

    def test_cluster_probe_no_drop_cap(self, tmp_path):
        ref, sh, jsh, rng = self._pair(tmp_path, scan_mode="probe", probe_cap=8)
        assert sh._resolve_probe_cap(8) == 8
        self._assert_match(ref, sh, jsh, rng.random((8, 32), dtype=np.float32), 10, 8)

    def test_cluster_dense_matches_single_device(self, tmp_path):
        ref, sh, jsh, rng = self._pair(tmp_path, scan_mode="dense")
        self._assert_match(ref, sh, jsh, rng.random((8, 32), dtype=np.float32), 10, 8)

    def test_cluster_lpt_balance_under_zipf(self, tmp_path):
        _, sh, jsh, _ = self._pair(tmp_path, n=8000, nlist=32, zipf=True)
        dev = sh._sync()
        per_shard = dev["local_lens"].sum(axis=1).astype(float)
        assert per_shard.max() <= 1.3 * per_shard.mean()
        assert dev["owner"].shape[0] == dev["local_lens"].shape[1]
        np.testing.assert_array_equal(dev["local_lens"], np.asarray(jsh._sync()["lens"]))
        np.testing.assert_array_equal(dev["owner"], np.asarray(jsh._sync()["owner"]))

    def test_cluster_validation(self):
        with pytest.raises(ValueError, match="shard_by"):
            ShardedIvfFlatIndex(8, "L2", mesh=tmesh(4), shard_by="bogus")


# ---- sharded IVF-PQ -------------------------------------------------------------


def _jax_pq_pair(tmp_path, dim, base, mesh_n=8, **kw):
    ids = [str(i) for i in range(len(base))]
    jsh = jpar.ShardedIvfPqIndex(dim, "L2", mesh=jpar.make_mesh(mesh_n), **kw)
    jsh.add_batch(ids, base)
    jsh.build()
    jsh.snapshot(str(tmp_path / "jpq.npz"))
    with np.load(tmp_path / "jpq.npz") as z:
        sh = convert.sharded_ivf_pq_from_arrays(z, tmesh(mesh_n))
    sh.scan_mode = jsh.scan_mode
    return jsh, sh


def _assert_near_ties(a, b, score_tol=1e-2, tie_tol=1e-3):
    """The JAX IVF-PQ test's tolerance: scores within score_tol, a position
    may hold another id only where the two scores are a near-tie."""
    for ra, rb in zip(a, b):
        for ha, hb in zip(ra, rb):
            assert abs(ha.score - hb.score) < score_tol
            if ha.id != hb.id:
                assert abs(ha.score - hb.score) < tie_tol, (ha, hb)


class TestShardedIvfPq:
    def test_matches_single_device_ivfpq(self, tmp_path):
        rng = np.random.default_rng(0)
        n, dim = 3000, 32
        base = rng.random((n, dim), dtype=np.float32)
        q = rng.random((8, dim), dtype=np.float32)
        # refine 400: R covers the whole corpus, shortlists are complete
        jsh, sh = _jax_pq_pair(tmp_path, dim, base, nlist=8, pq_m=4, ksub=64, refine=400)
        with np.load(tmp_path / "jpq.npz") as z:
            ref = convert.ivf_pq_from_arrays(z, "cpu")
        a = sh.search_batch(q, 10, SearchOptions(nprobe=8))
        _assert_near_ties(ref.search_batch(q, 10, SearchOptions(nprobe=8)), a)
        _assert_near_ties(jsh.search_batch(q, 10, jax_options(nprobe=8)), a)

    def test_buffer_and_delete(self):
        rng = np.random.default_rng(1)
        base = rng.random((400, 16), dtype=np.float32)
        sh = ShardedIvfPqIndex(16, "L2", mesh=tmesh(4), nlist=4, pq_m=4, ksub=32)
        sh.add_batch([str(i) for i in range(400)], base)
        sh.build()
        fresh = rng.random(16).astype(np.float32)
        assert sh.add("fresh", fresh)
        assert sh.search(fresh, 1)[0].id == "fresh"
        assert sh.delete("7")
        hits = sh.search(base[7], 5, SearchOptions(nprobe=4))
        assert all(h.id != "7" for h in hits)

    def test_2d_batch_data_mesh_matches_1d(self, tmp_path):
        rng = np.random.default_rng(9)
        base = rng.random((2000, 32), dtype=np.float32)
        q = rng.random((8, 32), dtype=np.float32)
        kw = dict(nlist=8, pq_m=4, ksub=16, refine=8)
        jsh, one_d = _jax_pq_pair(tmp_path, 32, base, mesh_n=4, **kw)
        with np.load(tmp_path / "jpq.npz") as z:
            two_d = convert.sharded_ivf_pq_from_arrays(z, make_mesh_2d(2, 4, device="cpu"))
        opts = SearchOptions(nprobe=8)
        assert ids_of(one_d.search_batch(q, 10, opts)) == ids_of(two_d.search_batch(q, 10, opts))
        assert_same_results(two_d.search_batch(q, 10, opts),
                            jsh.search_batch(q, 10, jax_options(nprobe=8)))

    @pytest.mark.parametrize("refine", [0, 8])
    def test_sharded_ivfpq_dense_matches_probe(self, tmp_path, refine):
        rng = np.random.default_rng(5)
        base = rng.random((2600, 16), dtype=np.float32)
        q = rng.random((6, 16), dtype=np.float32)
        res = {}
        for m in ("dense", "probe"):
            jsh, sh = _jax_pq_pair(tmp_path, 16, base, nlist=8, pq_m=4, ksub=16,
                                   refine=refine, scan_mode=m)
            res[m] = sh.search_batch(q, 10, SearchOptions(nprobe=4))
            _assert_near_ties(jsh.search_batch(q, 10, jax_options(nprobe=4)), res[m],
                              tie_tol=1e-3 if refine else 1e-2)
        for d_hits, p_hits in zip(res["dense"], res["probe"]):
            d_ids, p_ids = {h.id for h in d_hits}, {h.id for h in p_hits}
            assert len(d_ids & p_ids) / max(len(p_ids), 1) >= 0.8
            for dh, ph in zip(d_hits, p_hits):
                if refine > 0:
                    assert dh.score >= ph.score - 1e-3  # the dense exact scan dominates
                else:
                    assert dh.score == pytest.approx(ph.score, rel=1e-4, abs=1e-3)

    def test_sharded_ivfpq_dense_matches_single_chip(self, tmp_path):
        rng = np.random.default_rng(6)
        base = rng.random((2600, 16), dtype=np.float32)
        q = rng.random((6, 16), dtype=np.float32)
        jsh, sh = _jax_pq_pair(tmp_path, 16, base, nlist=8, pq_m=4, ksub=16, refine=8,
                               scan_mode="dense")
        with np.load(tmp_path / "jpq.npz") as z:
            ref = convert.ivf_pq_from_arrays(z, "cpu")
        ref.scan_mode = "dense"
        opts = SearchOptions(nprobe=8)
        for a, b in zip(ref.search_batch(q, 10, opts), sh.search_batch(q, 10, opts)):
            a_ids, b_ids = {h.id for h in a}, {h.id for h in b}
            assert len(a_ids & b_ids) / max(len(a_ids), 1) >= 0.9
        assert_same_results(sh.search_batch(q, 10, opts),
                            jsh.search_batch(q, 10, jax_options(nprobe=8)))

    @pytest.mark.parametrize("refine_storage", ["fp32", "bf16"])
    def test_sharded_ivfpq_pallas_exact_scan_parity(self, tmp_path, refine_storage):
        """refine > 0, full scans: the list scan (promote mode on a bf16
        slab) on every shard, the single index's hit sets; a max_scans
        budget keeps the plain dense scan."""
        base = synthetic(4096, 32)
        kw = dict(nlist=16, pq_m=4, ksub=64, nprobe=8, refine=16)
        sh = ShardedIvfPqIndex(32, "L2", mesh=tmesh(8), refine_storage=refine_storage, **kw)
        ref = IvfPqIndex(32, "L2", device="cpu", refine_storage=refine_storage, **kw)
        for ix in (sh, ref):
            ix.add_batch([str(i) for i in range(4096)], base)
            ix.build()
        assert sh.describe_scan(64, 8) == "dense-exact-pallas"
        assert sh.describe_scan(64, 8, max_scans=100) == "dense-exact-xla"
        if refine_storage == "bf16":
            assert sh._sync()["shards"][0][0]["xraw"].dtype == torch.bfloat16
        q = synthetic(64, 32)
        assert_same_results(sh.search_batch(q, 10), ref.search_batch(q, 10))
        if refine_storage == "fp32":
            jsh = jpar.ShardedIvfPqIndex(32, "L2", mesh=jpar.make_mesh(8), **kw)
            jsh.add_batch([str(i) for i in range(4096)], base)
            jsh.build()
            assert jsh.describe_scan(64, 8) == "dense-exact-pallas"


class TestShardedDelta:
    def test_delta_composes_sharded_halves(self):
        base = np.random.default_rng(7).random((1200, 32), dtype=np.float32)
        mesh = tmesh(8)
        delta = DeltaIndex(ShardedFlatIndex(32, "L2", mesh=mesh),
                           ShardedIvfPqIndex(32, "L2", mesh=mesh, nlist=8, pq_m=4, ksub=64))
        delta.add_batch([str(i) for i in range(1000)], base[:1000])
        delta.build()  # compaction: head -> sharded tail
        delta.add_batch([str(i) for i in range(1000, 1200)], base[1000:])
        assert delta.get_stats().count == 1200
        assert delta.search(base[1100], 1)[0].id == "1100"
        assert "50" in [h.id for h in delta.search(base[50], 3, SearchOptions(nprobe=8))]


# ---- multi-slice meshes ----------------------------------------------------------


class TestMultisliceMesh:
    def _mesh(self, n_slices=2, per_slice=4):
        return make_mesh_multislice(n_slices, per_slice, device="cpu")

    def test_mesh_axes_and_row_shards(self):
        mesh = self._mesh()
        jmesh = jpar.make_mesh_multislice(2, 4)
        assert mesh.axis_names == jmesh.axis_names == ("slice", "data")
        assert row_axes(mesh) == ("slice", "data")
        assert row_shard_count(mesh) == 8
        assert row_shard_count(tmesh()) == 8

    def test_multislice_flat_matches_single_device(self):
        base = synthetic(2000, 32)
        q = synthetic(16, 32, seed=5)
        ref = FlatIndex(32, device="cpu")
        sh = ShardedFlatIndex(32, mesh=self._mesh())
        jsh = jpar.ShardedFlatIndex(32, mesh=jpar.make_mesh_multislice(2, 4))
        for ix in (ref, sh, jsh):
            ix.add_batch([str(i) for i in range(2000)], base)
        assert_same_results(sh.search_batch(q, 10), ref.search_batch(q, 10))
        assert_same_results(sh.search_batch(q, 10), jsh.search_batch(q, 10))

    def test_multislice_maxscans_and_delete(self):
        base = synthetic(512, 16)
        sh = ShardedFlatIndex(16, mesh=self._mesh(4, 2))
        sh.add_batch([str(i) for i in range(512)], base)
        sh.delete("100")
        assert all(h.id != "100" for h in sh.search(base[100], 5))
        hits = sh.search(base[400], 3, SearchOptions(max_scans=50))
        assert all(int(h.id) < 50 for h in hits)

    def test_multislice_sq8(self):
        base = synthetic(600, 16)
        ref = FlatIndex(16, device="cpu", storage="sq8")
        sh = ShardedFlatIndex(16, storage="sq8", mesh=self._mesh())
        for ix in (ref, sh):
            ix.add_batch([str(i) for i in range(600)], base)
        q = synthetic(4, 16, seed=3)
        assert ids_of(ref.search_batch(q, 5)) == ids_of(sh.search_batch(q, 5))

    def test_multislice_pallas_matches_exact(self):
        n, d = 4096, 32
        base = synthetic(n, d)
        ref = FlatIndex(d, device="cpu", selection="exact")
        sh = ShardedFlatIndex(d, selection="pallas", mesh=self._mesh())
        for ix in (ref, sh):
            ix.add_batch([str(i) for i in range(n)], base)
        assert sh._pallas_eligible(8)
        q = synthetic(8, d, seed=9)
        assert_same_results(ref.search_batch(q, 10), sh.search_batch(q, 10))

    def test_multislice_kmeans_step_matches_1d(self):
        rng = np.random.default_rng(0)
        x = rng.random((512, 16)).astype(np.float32)
        valid = np.ones(512, bool)
        cents = x[:8].copy()
        out = [sharded_kmeans_step(x, valid, cents, metric="L2", mesh=m).numpy()
               for m in (tmesh(), self._mesh())]
        np.testing.assert_allclose(out[0], out[1], rtol=1e-5, atol=1e-6)


# ---- the shard merge ------------------------------------------------------------


def test_shard_merge_tie_order_matches_jax():
    """Equal scores across shards: lax.top_k over the gathered lists keeps
    position (shard-major) order; the port's merge keys (score desc, lower
    encoded row) give the same order."""
    rng = np.random.default_rng(0)
    nd, b, k, stride = 8, 4, 6, 1000
    vals = np.round(rng.random((nd, b, k)) * 4).astype(np.float32) / 4   # many ties
    vals = -np.sort(-vals, axis=2)
    local = np.stack([[rng.choice(stride, k, replace=False) for _ in range(b)]
                      for _ in range(nd)])        # a row once a list, as a scan gives it
    rows = (local + np.arange(nd)[:, None, None] * stride).astype(np.int32)
    # per shard, ties already in (score desc, row asc) order
    for s in range(nd):
        for i in range(b):
            order = np.lexsort((rows[s, i], -vals[s, i]))
            vals[s, i], rows[s, i] = vals[s, i, order], rows[s, i, order]
    gathered_v = np.concatenate(list(vals), axis=1)           # [B, nd*k] shard-major
    gathered_i = np.concatenate(list(rows), axis=1)
    jv, pos = jax.lax.top_k(jnp.asarray(gathered_v), k)
    ji = np.take_along_axis(gathered_i, np.asarray(pos), axis=1)
    parts = [(torch.from_numpy(vals[s]), torch.from_numpy(rows[s])) for s in range(nd)]
    tv, ti = allgather_merge_topk(parts, k, torch.device("cpu"))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), ji)


def test_sharded_flat_ties_across_shards_order_as_jax():
    """A corpus whose rows repeat across shards: both sharded indexes return
    the copies in the same order (lower row first)."""
    base = np.repeat(synthetic(40, 16), 20, axis=0)   # each row 20 times, every shard
    q = synthetic(6, 16, seed=11)
    ids = [str(i) for i in range(len(base))]
    sh = ShardedFlatIndex(16, mesh=tmesh())
    jsh = jpar.ShardedFlatIndex(16, mesh=jpar.make_mesh())
    for ix in (sh, jsh):
        ix.add_batch(ids, base)
    assert ids_of(sh.search_batch(q, 25)) == ids_of(jsh.search_batch(q, 25))


# ---- sharded HNSW -----------------------------------------------------------------


def _jax_hnsw_graph(tmp_path, base, **kw):
    """A JAX HnswIndex graph and its snapshot's arrays (the same graph for
    both packages' sharded indexes)."""
    jix = jpt.HnswIndex(base.shape[1], "L2", **kw)
    jix.add_batch([str(i) for i in range(len(base))], base)
    jix.snapshot(str(tmp_path / "g.npz"))
    with np.load(tmp_path / "g.npz") as z:
        return jix, {k: z[k] for k in z.files}


class TestShardedHnsw:
    def test_matches_single_device_hnsw(self, tmp_path):
        rng = np.random.default_rng(5)
        base = rng.random((1500, 32), dtype=np.float32)
        q = rng.random((16, 32), dtype=np.float32)
        kw = dict(m=8, ef_construction=100, ef_search=32, seed=11)
        _, arrays = _jax_hnsw_graph(tmp_path, base, **kw)
        jsh = jpar.ShardedHnswIndex(32, "L2", mesh=jpar.make_mesh(8), **kw)
        jsh.load(str(tmp_path / "g.npz"))
        sh = ShardedHnswIndex(32, "L2", mesh=tmesh(8), **kw)
        sh._restore(arrays)
        ref = HnswIndex(32, "L2", device="cpu", **kw)
        ref._restore(arrays)
        opts = SearchOptions(ef_search=32)
        a = sh.search_batch(q, 10, opts)
        # the identical graph + beam on each query slice -> identical results
        assert ids_of(a) == ids_of(ref.search_batch(q, 10, opts))
        assert_same_results(a, jsh.search_batch(q, 10, jax_options(ef_search=32)))

    def test_ragged_batch_pads(self):
        rng = np.random.default_rng(6)
        base = rng.random((500, 16), dtype=np.float32)
        sh = ShardedHnswIndex(16, "L2", mesh=tmesh(8), m=8)
        sh.add_batch([str(i) for i in range(500)], base)
        res = sh.search_batch(rng.random((5, 16), dtype=np.float32), 3)
        assert len(res) == 5 and all(len(r) <= 3 for r in res)
        with pytest.raises(ValueError, match="multiple of the mesh size"):
            sh.device_search(torch.zeros(5, 16), 3)

    def test_one_graph_copy_a_device(self):
        base = np.random.default_rng(2).random((300, 16), dtype=np.float32)
        sh = ShardedHnswIndex(16, "L2", mesh=make_mesh(devices=["cpu"] * 4), m=8)
        sh.add_batch([str(i) for i in range(300)], base)
        sh.search_batch(base[:8], 3)
        reps = sh._replicas["per_device"]
        assert len(reps) == 4 and all(r is reps[0] for r in reps)
        assert reps[0]["x"] is sh._dev["x"]


class TestShardedHnswCorpus:
    def _clustered(self, n=4000, dim=32, nc=16):
        return (synthetic_clustered(n, dim, n_clusters=nc),
                synthetic_clustered_queries(32, dim, n_clusters=nc))

    def test_recall_parity_vs_replicated(self):
        base, q = self._clustered()
        ids = [str(i) for i in range(len(base))]
        truth = ground_truth(base, q, 10, "L2")
        opts = SearchOptions(ef_search=64)
        ref = HnswIndex(32, "L2", device="cpu", m=8, ef_construction=100, seed=11)
        ref.add_batch(ids, base)
        sh = ShardedHnswCorpusIndex(32, "L2", mesh=tmesh(8), m=8, ef_construction=100,
                                    seed=11)
        sh.add_batch(ids, base)
        sh.build()

        def rec(ix):
            return recall_at_k(id_lists_to_rows(ids_of(ix.search_batch(q, 10, opts))),
                               truth, 10)

        r_ref, r_sh = rec(ref), rec(sh)
        assert r_sh >= r_ref - 0.02, (r_sh, r_ref)
        assert r_sh >= 0.9, r_sh

    def test_graph_memory_shards_over_mesh(self):
        base, q = self._clustered(n=2000)
        sh = ShardedHnswCorpusIndex(32, "L2", mesh=tmesh(8), m=8)
        sh.add_batch([str(i) for i in range(len(base))], base)
        sh.build()
        sh.search_batch(q[:4], 5)
        mem = sh.memory_bytes()
        assert sum(mem["graph_per_shard"]) == mem["graph_total"]
        assert mem["graph_per_device"] == max(mem["graph_per_shard"]) < mem["graph_total"]
        counts = [s.get_stats().count for s in sh._subs]
        assert max(counts) <= -(-2000 // 8), counts
        assert sum(counts) == 2000

    def test_partition_matches_jax(self):
        """The capacity-balanced k-means cells: the port's k-means draws the
        JAX package's k-means++ rows, so both partition alike."""
        base, _ = self._clustered(n=2000)
        sh = ShardedHnswCorpusIndex(32, "L2", mesh=tmesh(8), m=8)
        jsh = jpar.ShardedHnswCorpusIndex(32, "L2", mesh=jpar.make_mesh(8), m=8)
        cells, jcells = sh._partition(base, 8), jsh._partition(base, 8)
        assert (cells == jcells).mean() >= 0.99

    def test_delete_and_post_build_add(self):
        base, _ = self._clustered(n=1000)
        sh = ShardedHnswCorpusIndex(32, "L2", mesh=tmesh(8), m=8)
        sh.add_batch([str(i) for i in range(1000)], base)
        sh.build()
        opts = SearchOptions(ef_search=48)
        assert sh.search(base[7], 1, opts)[0].id == "7"
        assert sh.delete("7")
        assert all(h.id != "7" for h in sh.search(base[7], 10, opts))
        nv = base[7] + 0.001
        assert sh.add("new", nv)
        assert sh.search(nv, 1, opts)[0].id == "new"
        assert sh.get_stats().count == 1000

    def test_snapshot_roundtrip(self, tmp_path):
        base, q = self._clustered(n=800)
        mesh = tmesh(8)
        sh = ShardedHnswCorpusIndex(32, "L2", mesh=mesh, m=8)
        sh.add_batch([str(i) for i in range(800)], base)
        sh.build()
        p = str(tmp_path / "shnsw.json")
        sh.snapshot(p)
        fresh = ShardedHnswCorpusIndex(32, "L2", mesh=mesh, m=8)
        fresh.load(p)
        opts = SearchOptions(ef_search=48)
        assert ids_of(sh.search_batch(q[:8], 5, opts)) == ids_of(fresh.search_batch(q[:8], 5, opts))

    def test_jax_snapshot_carries_across(self, tmp_path):
        """convert.sharded_hnsw_corpus_from_arrays: the JAX index's manifest
        and sub-graphs on the port's mesh search as the JAX index does."""
        import json

        base, q = self._clustered(n=1200)
        jsh = jpar.ShardedHnswCorpusIndex(32, "L2", mesh=jpar.make_mesh(8), m=8)
        jsh.add_batch([str(i) for i in range(1200)], base)
        jsh.build()
        p = str(tmp_path / "j.json")
        jsh.snapshot(p)
        with open(p) as f:
            meta = json.load(f)
        shards = []
        for s in range(8):
            with np.load(f"{p}.shard{s}.npz") as z:
                shards.append({k: z[k] for k in z.files})
        sh = convert.sharded_hnsw_corpus_from_arrays(meta, shards, tmesh(8))
        opts = SearchOptions(ef_search=48)
        assert_same_results(sh.search_batch(q[:8], 5, opts),
                            jsh.search_batch(q[:8], 5, jax_options(ef_search=48)))


def test_dryrun_multichip():
    dryrun_multichip(8)
