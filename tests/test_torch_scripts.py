"""The twins of the JAX package's tools (``pyrope_tpu_torch/scripts/``) on
the CPU, at tiny sizes.

Each twin runs through its ``main`` with ``--device cpu``, exits 0, prints
one JSON object as its last line with its keys, and writes it under
``--out``. Where a number does not depend on the platform, the twin's
equals the JAX package's on the same seeded rows: the quality gate's and
the sweep's recalls (the JAX side computed here with the JAX script's
settings: its own scripts write into the repo), the quickstart's top hits
(chip_smoke's ``QUICKSTART_HITS_JAX``, which phase 24 holds the card to),
and the skew script's per-shard counts of the layouts both packages share
(the JAX script's ``measure`` on the same partition). Without a card a twin
asked for its default device, CUDA, raises.
"""

import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import jax_native_build_dir  # noqa: F401 (an autouse fixture)

import pyrope_tpu as jpt
from pyrope_tpu.types import SearchOptions as JOptions
from pyrope_tpu_torch.scripts import (
    load_test,
    measure_sharded_ivf_skew,
    phase6_eval,
    profile_hnsw,
    quality_gate,
    quickstart,
    serving_bench,
    soak_test,
    sweep_indexes,
)
from pyrope_tpu_torch.utils.datasets import (
    ground_truth,
    id_lists_to_rows,
    recall_at_k,
    synthetic,
    synthetic_clustered,
    synthetic_clustered_queries,
    synthetic_queries,
)

REPO = Path(__file__).resolve().parent.parent


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


def run_twin(module, argv, capsys, tmp_path) -> dict:
    """``module.main`` on the CPU with ``--out tmp_path``: exit code 0, its
    last stdout line the JSON it also wrote there."""
    rc = module.main([*argv, "--device", "cpu", "--out", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    out = json.loads(lines[-1])
    name = module.__name__.rsplit(".", 1)[1]
    assert json.loads((tmp_path / f"{name}.json").read_text()) == out
    assert out["device"] == {"platform": "cpu"}
    return out


def test_load_test_twin(capsys, tmp_path):
    out = run_twin(load_test, ["--n", "500", "--dim", "8", "--duration", "0.3",
                               "--concurrency", "1", "2", "--pool", "8"], capsys, tmp_path)
    assert [(c["cache"], c["concurrency"]) for c in out["cells"]] == [
        ("off", 1), ("off", 2), ("on", 1), ("on", 2)]
    for c in out["cells"]:
        assert c["requests"] > 0 and c["errors"] == 0
        assert {"qps", "p50_ms", "p99_ms", "slo_met"} <= set(c)


def test_serving_bench_twin(capsys, tmp_path):
    out = run_twin(serving_bench, ["--n", "2000", "--dim", "16", "--nprobe", "3",
                                   "--concurrency", "2", "--duration", "0.3", "--pool", "64",
                                   "--writers", "2"], capsys, tmp_path)
    cells = {c["cell"]: c for c in out["cells"]}
    assert set(cells) == {"upsert", "search", "cache_hit"}
    assert cells["upsert"]["requests"] == 2000 and cells["upsert"]["vec_per_s"] > 0
    assert cells["search"]["route_b1"] == "dense-pallas"
    assert cells["search"]["microbatch"]["queries"] >= cells["search"]["requests"]
    assert all(c["errors"] == 0 for c in out["cells"])


def test_soak_test_twin(capsys, tmp_path):
    out = run_twin(soak_test, ["--seconds", "2", "--clients", "3", "--n", "500",
                               "--dim", "8"], capsys, tmp_path)
    assert out["ok"] and out["errors"] == 0 and out["known_row_found"]
    assert out["ops"]["search"] > 0 and out["count"] >= 500


def test_phase6_eval_twin(capsys, tmp_path):
    out = run_twin(phase6_eval, [], capsys, tmp_path)
    assert out["ok"]
    assert [s["scenario"] for s in out["scenarios"]] == [
        "delta_compaction", "semantic_cache_repeat", "prefetch_a_to_b"]
    assert out["scenarios"][2]["prefetch_hit"]


def test_profile_hnsw_twin(capsys, tmp_path):
    out = run_twin(profile_hnsw, ["--n", "2000", "--batch", "8", "--reps", "2",
                                  "--trace", str(tmp_path)], capsys, tmp_path)
    assert out["steps_run"]["layer0"] > 0 and out["timer"] == "host clock"
    assert {"upper_descent_ms", "layer0_ms", "visited_pool_test_ms_a_step",
            "visited_bitmap_ms_a_step", "fetch_ms", "qps"} <= set(out)
    assert Path(out["trace"]["path"]).exists()


def _jax_recall(ix, base, queries, truth, options, k=10):
    ix.add_batch([str(i) for i in range(len(base))], base)
    ix.build()
    res = ix.search_batch(queries, k, options)
    rows = np.array([[int(h.id) for h in r] + [-1] * (k - len(r)) for r in res])
    return recall_at_k(rows, truth, k)


def test_quality_gate_twin_matches_jax(capsys, tmp_path):
    """The twin's recalls, and its oracle's (numpy in both packages), are
    the JAX package's on the JAX script's settings."""
    from pyrope_tpu.utils import ref_oracle as jro

    n, nq = 5000, 32
    out = run_twin(quality_gate, ["--n", str(n), "--queries", str(nq)], capsys, tmp_path)
    assert out["passed"] and not out["failures"]
    base = synthetic_clustered(n, 128)
    queries = synthetic_clustered_queries(nq, 128)
    truth = ground_truth(base, queries, 10, "L2")
    want = {
        "quality_gate_ivf_clustered": _jax_recall(
            jpt.IvfFlatIndex(128, "L2", nlist=100), base, queries, truth, JOptions()),
        "quality_gate_ivfpq_clustered": _jax_recall(
            jpt.IvfPqIndex(128, "L2", nlist=100, pq_m=4), base, queries, truth, JOptions()),
        "quality_gate_hnsw_clustered": _jax_recall(
            jpt.HnswIndex(128, "L2", m=16, ef_construction=200, ef_search=50),
            base, queries, truth, JOptions(ef_search=50)),
    }
    assert {r["config"]: r["recall_at_k"] for r in out["rows"]} == want
    pc, pl, pcb, pco = jro.ref_ivfpq_build(base, 100, 4, 256)
    adc = recall_at_k(np.stack([jro.ref_ivfpq_search(pc, pl, pcb, pco, q, 3, 10)
                                for q in queries]), truth, 10)
    assert out["oracle"]["ivfpq_m4_pure_adc"] == adc


def test_sweep_twin_matches_jax(capsys, tmp_path, monkeypatch):
    import jax.numpy as jnp

    n, d, b = 3000, 32, 16
    # one timed call a row: QPS on the CPU says nothing, recall is the check
    monkeypatch.setattr(sweep_indexes, "measure",
                        functools.partial(sweep_indexes.measure, iters=1))
    out = run_twin(sweep_indexes, ["--n", str(n), "--dim", str(d), "--batch", str(b)],
                   capsys, tmp_path)
    base, q = synthetic(n, d), synthetic_queries(b, d)
    truth = ground_truth(base, q, 10, "L2")
    ids = [str(i) for i in range(n)]
    want = []

    def measure(ix, opts):
        _, r = ix.device_search(jnp.asarray(q), 10, opts)
        want.append(round(recall_at_k(id_lists_to_rows(ix.resolve_rows(np.asarray(r))),
                                      truth, 10), 4))

    for nlist in sweep_indexes.NLISTS:
        # the probe route: the probed lists scanned exactly, as the kernel
        # route scans them, without Pallas' interpret mode
        ix = jpt.IvfFlatIndex(d, "L2", nlist=nlist, scan_mode="probe")
        ix.add_batch(ids, base)
        ix.build()
        for nprobe in sweep_indexes.NPROBES:
            measure(ix, JOptions(nprobe=nprobe))
    ix = jpt.HnswIndex(d, "L2", m=16, ef_construction=200)
    ix.add_batch(ids, base)
    for ef in sweep_indexes.EFS:
        measure(ix, JOptions(ef_search=ef))
    assert [r["recall"] for r in out["rows"]] == want
    assert len(set(want)) > 3      # the sweep moves recall


def _jax_quickstart_hits() -> dict:
    """The top hits examples/quickstart.py prints, computed here with the
    JAX package on the same rows (the example itself writes under /tmp):
    for each section the top id and the ids that tie it in fp32 (within
    the parity tolerance), the Flat scan's three in order."""
    from _torch_parity import ATOL, RTOL

    rng = np.random.default_rng(42)
    n, dim = 20_000, 128
    base = rng.random((n, dim), dtype=np.float32)
    ids = [f"doc{i}" for i in range(n)]
    q = base[123] + 1e-4

    def ties(hits):
        return [h.id for h in hits
                if np.isclose(h.score, hits[0].score, rtol=RTOL, atol=ATOL)]

    flat = jpt.FlatIndex(dim, "L2")
    flat.add_batch(ids, base)
    out = {"flat_top3": [h.id for h in flat.search(q, top_k=3)]}
    ivf = jpt.IvfFlatIndex(dim, "L2", nlist=64)
    ivf.add_batch(ids, base)
    ivf.build()
    out["ivf_nprobe8_top"] = ties(ivf.search(q, 3, JOptions(nprobe=8)))
    pq = jpt.IvfPqIndex(dim, "L2", nlist=64, pq_m=8, ksub=256)
    pq.add_batch(ids, base)
    pq.build()
    out["ivfpq_top"] = ties(pq.search(q, 3))
    hnsw = jpt.HnswIndex(dim, "L2", m=16, ef_construction=100, ef_search=50)
    hnsw.add_batch(ids[:5000], base[:5000])
    out["hnsw_top"] = ties(hnsw.search(q, 3))
    delta = jpt.DeltaIndex(jpt.FlatIndex(dim, "L2"), jpt.IvfFlatIndex(dim, "L2", nlist=64))
    delta.add_batch(ids, base)
    delta.add("fresh-doc", q)
    out["delta_pre_compaction"] = sorted(ties(delta.search(q, 3)))
    delta.build()
    out["delta_post_compaction"] = sorted(ties(delta.search(q, 3)))
    return out


def test_quickstart_twin_hits_are_the_jax_quickstarts(capsys, tmp_path):
    import chip_smoke

    assert _jax_quickstart_hits() == chip_smoke.QUICKSTART_HITS_JAX
    out = run_twin(quickstart, [], capsys, tmp_path)
    assert chip_smoke.quickstart_hits_match(out["hits"]), out["hits"]
    assert out["native_available"] and out["restored_count"] == 20_000
    assert out["engine"]["hit_level"] == "L0"
    assert (tmp_path / "flat.npz").exists()


def _jax_skew_script():
    spec = importlib.util.spec_from_file_location(
        "jax_measure_sharded_ivf_skew", REPO / "scripts" / "measure_sharded_ivf_skew.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_skew_twin_counts_match_the_jax_script(capsys, tmp_path, monkeypatch):
    """On one partition (the JAX k-means', handed to both scripts) the
    padded counts both packages define are equal, and the twin's local-CSR
    rows add up to what the probes read."""
    jscript = _jax_skew_script()
    n, dim, nlist, nprobe, nd, nq = 6000, 16, 40, 6, 4, 200
    jax_partition, parts = jscript.ivf_partition, {}

    def partition(x, k, *rest):
        key = (x.shape, float(x[0, 0]))
        if key not in parts:
            parts[key] = jax_partition(x, k)
        return parts[key]

    monkeypatch.setattr(jscript, "ivf_partition", partition)
    monkeypatch.setattr(measure_sharded_ivf_skew, "ivf_partition", partition)
    for corpus, queries in measure_sharded_ivf_skew.CASES:
        want = jscript.measure(corpus, queries, n, dim, nlist, nprobe, nd, nq)
        got = measure_sharded_ivf_skew.measure(corpus, queries, n, dim, nlist, nprobe, nd,
                                               nq, "cpu")
        for key in ("l_pad_rr", "l_pad_cl", "p_cap", "drop_pct"):
            assert got[key] == want[key], key
        assert got["rr_padded"] == want["rr"].tolist()
        assert got["cl_padded"] == want["cl"].tolist()
        # every probed list's rows, read once a probe in either layout
        assert sum(got["rr_rows"]) == sum(got["cl_rows"])
    out = run_twin(measure_sharded_ivf_skew, ["--n", "3000", "--nlist", "20", "--nprobe",
                                              "4", "--nd", "4", "--queries", "64"],
                   capsys, tmp_path)
    assert [(c["corpus"], c["queries"]) for c in out["cases"]] == list(
        measure_sharded_ivf_skew.CASES)


@pytest.mark.parametrize("module", [load_test, serving_bench, soak_test, quality_gate,
                                    sweep_indexes, phase6_eval, profile_hnsw, quickstart,
                                    measure_sharded_ivf_skew])
def test_twins_run_on_the_card_by_default(module):
    """``--device`` is cuda unless the caller says cpu: without a card the
    twin raises before it does any work, and falls back to nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])


def test_score_convention_is_the_jax_packages():
    from pyrope_tpu.ops import score_convention as jax_convention
    from pyrope_tpu_torch.ops import score_convention

    for metric in ("L2", "IP", "COSINE"):
        assert score_convention(metric) == jax_convention(metric)


def test_native_available_reports_the_loader(monkeypatch):
    """True where the loader builds; False where the build fails, and the
    loader itself still raises then: nothing falls back."""
    from pyrope_tpu_torch.native import build as nb

    assert nb.native_available()
    monkeypatch.setattr(nb, "_lib", None)

    def failed_build():
        raise RuntimeError("g++ failed to build libpyrope_native.so (exit 1)")

    monkeypatch.setattr(nb, "_compile", failed_build)
    assert not nb.native_available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        nb.load_native()
