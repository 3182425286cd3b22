"""The gates and routes chip_smoke phase 25 holds bench.py's rows to, from
the JAX package on the CPU.

Phase 25 runs fifteen of bench.py's rows through the bench twin on the
card. The rows of 100k or fewer vectors are built here in both packages
from the same rows the twin makes (the file-backed ones through the twin's
writer and the packages' readers):

- the JAX package's recall@10 on each IVF and Delta row is chip_smoke's
  ``BENCH_RECALL_JAX`` (phase 25 holds the card within 0.01 of it), and the
  port's on the CPU is within that 0.01 too;
- the JAX index's ``describe_scan`` on each row is chip_smoke's
  ``BENCH_ROUTES`` (the Delta rows have none in either package), and so is
  the port's;
- the 1M rows' routes are the ones ``BENCH_DETAIL.json`` records, and
  their gates that record less 0.01.

The JAX indexes answer on their plain dense scan, which is exact over the
probed lists as their kernel route is, without Pallas' interpret mode.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import pyrope_tpu as jpt
import pyrope_tpu_torch as tpt
from pyrope_tpu.types import SearchOptions as JOptions
from pyrope_tpu_torch.index.flat import FlatIndex
from pyrope_tpu_torch.scripts import bench as tb
from pyrope_tpu_torch.scripts import make_dataset_files as tmake
from pyrope_tpu_torch.types import SearchOptions
from pyrope_tpu_torch.utils import datasets as tds

REPO = Path(__file__).resolve().parent.parent
K = 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module (the tier-1 run's
    workers share the host's cores); the pool is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(ix, queries, opts) -> np.ndarray:
    hits = ix.search_batch(queries, K, opts)
    return tds.id_lists_to_rows([[h.id for h in r] for r in hits], K)


def _exact_dense(ix) -> None:
    """A JAX IVF index (or a Delta's IVF tail) on its plain dense scan."""
    for sub in (getattr(ix, "tail", None), ix):
        if isinstance(sub, jpt.IvfFlatIndex):
            sub.selection, sub.scan_mode = "exact", "dense"


# corpus -> (the rows on it and their nprobe; how the packages' indexes are made)
GROUPS = {
    "uniform100k": ({"ivf100k_np16": 16, "ivf100k_np32": 32, "ivf100k_np64": 64},
                    lambda m, d, **kw: m.IvfFlatIndex(d, "L2", nlist=100, **kw)),
    "uniform20k": ({"delta20k": None, "delta20k_np96": 96}, None),
    "fvecs": ({"ivf100k_fvecs_file": None},
              lambda m, d, **kw: m.IvfFlatIndex(d, "L2", nlist=100, **kw)),
    "glove": ({"ivf_glove_file": None},
              lambda m, d, **kw: m.IvfFlatIndex(d, "L2", nlist=100, **kw)),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tmake.write_dataset_files(tmp_path_factory.mktemp("datasets"))


def _corpus(group: str, files: dict):
    """(base, queries of the rows' eval batch) as the twin's run_config
    reads them."""
    if group == "fvecs":
        base, q, _, _ = tb.row_data("ivf100k_fvecs_file", 1024, 1024,
                                    str(files["clustered100k.fvecs"]),
                                    str(files["clustered100k_queries.fvecs"]))
        return base, q[:1024]
    if group == "glove":
        fvecs = tb.glove_to_fvecs(str(files["glove50k.txt"]),
                                  tmp_dir=str(files["glove50k.txt"].parent))
        base, q, _, _ = tb.row_data("ivf_glove_file", 1024, 1024, fvecs,
                                    str(files["glove50k_queries.fvecs"]),
                                    glove_src=str(files["glove50k.txt"]))
        return base, q[:1024]
    name = next(iter(GROUPS[group][0]))
    base, q, _, _ = tb.row_data(name, 64, 1024)
    return base, q[:256]


def _delta(m, d, device=None):
    kw = {} if device is None else {"device": device}
    return m.DeltaIndex(m.FlatIndex(d, "L2", **kw), m.IvfFlatIndex(d, "L2", nlist=100, **kw))


@pytest.mark.parametrize("group", list(GROUPS))
def test_bench_rows_recall_and_routes_are_the_jax_packages(group, files):
    rows, make = GROUPS[group]
    base, queries = _corpus(group, files)
    n, d = base.shape
    ids = [str(i) for i in range(n)]
    if make is None:
        jix, tix = _delta(jpt, d), _delta(tpt, d, "cpu")
    else:
        jix, tix = make(jpt, d), make(tpt, d, device="cpu")
    for ix in (jix, tix):
        ix.add_batch(ids, base)
        ix.build()
    batch = 64 if group.startswith("uniform") else 1024
    truth = tds.ground_truth(base, queries, K, "L2")
    for name, nprobe in rows.items():
        for ix in (jix, tix):
            route = ix.describe_scan(batch, nprobe) if hasattr(ix, "describe_scan") else None
            assert route == chip_smoke.BENCH_ROUTES[name], (name, type(ix).__module__)
    _exact_dense(jix)
    for name, nprobe in rows.items():
        rj = tds.recall_at_k(_rows(jix, queries, JOptions(nprobe=nprobe)), truth, K)
        rp = tds.recall_at_k(_rows(tix, queries, SearchOptions(nprobe=nprobe)), truth, K)
        print(f"{name}: recall@10 jax {rj} port {rp} ({len(queries)} queries)")
        assert rj == chip_smoke.BENCH_RECALL_JAX[name]
        assert abs(rp - rj) <= chip_smoke.BENCH_RECALL_TOL


@pytest.mark.parametrize("name,metric,n,d", [
    ("flat100k_cos_b1024", "COSINE", 100_000, 128),
    ("flat100k_ip_b1024", "IP", 100_000, 128),
    ("flat10k_d1024_b1024", "L2", 10_000, 1024),
    ("flat100k_d1024_b1024", "L2", 100_000, 1024),
])
def test_exact_rows_route_as_the_jax_package(name, metric, n, d):
    algo, n0, d0, _ = tb.CONFIGS[name]
    assert (n0, d0) == (n, d) and name in chip_smoke.BENCH_EXACT
    jix = jpt.FlatIndex(d, metric)
    tix = tb.build_index(algo, d, {}, "cpu")
    assert isinstance(tix, FlatIndex) and tix.metric.value == metric
    assert jix.describe_scan(1024) == tix.describe_scan(1024) == chip_smoke.BENCH_ROUTES[name]


def test_1m_rows_hold_the_recorded_routes_and_gates():
    """The 1M IVF-PQ rows cannot be built on the CPU here: their routes are
    BENCH_DETAIL.json's and their gates its recall less 0.01."""
    detail = {r["config"]: r for r in json.loads((REPO / "BENCH_DETAIL.json").read_text())}
    for name, (record, gate) in chip_smoke.BENCH_TPU_GATES.items():
        assert record == detail[name]["recall_at_k"]
        assert gate == round(record - 0.01, 4)
        assert chip_smoke.BENCH_ROUTES[name] == detail[name]["scan_path"]


def test_phase_25_runs_the_fifteen_rows():
    rows = [name for name, _ in chip_smoke.BENCH_ROWS]
    assert len(rows) == len(set(rows)) == 15 and set(rows) <= set(tb.CONFIGS)
    assert set(rows) == (set(chip_smoke.BENCH_RECALL_JAX) | set(chip_smoke.BENCH_EXACT)
                         | set(chip_smoke.BENCH_TPU_GATES)) == set(chip_smoke.BENCH_ROUTES)
