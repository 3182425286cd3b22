"""The bench twin (``pyrope_tpu_torch/scripts/bench.py``), its oracle
backfill and its dataset-file writer, against the JAX package's scripts on
the CPU.

bench.py is never imported here: importing it turns on the JAX compilation
cache. Its tables are read from its source (``ast.literal_eval``) and its
``build_index``, ``scan_tflops`` and oracle functions are compiled from
their own source text, so the twin is held to the code bench.py runs.

- The five tables equal bench.py's.
- ``build_index`` gives each algo the JAX side's class, metric, storage,
  selection and settings.
- ``run_config`` on small stand-in rows (flat COSINE and IP, IVF-Flat,
  IVF-PQ with ``refine=0``, Delta with an nprobe option, a file-backed
  row and a GloVe-text row written by the twin's writer) returns bench.py's
  keys; its route equals the JAX index's ``describe_scan`` on the same rows
  (the JAX index built with ``pyrope_tpu`` here); exact rows' recall equals
  the JAX index's, IVF rows meet the build-parity bound
  (``tests/test_torch_build_parity.py``: recall equal, >= 99% of hit sets
  equal); ``recall_ref`` is bit-equal to bench.py's oracle on the same rows.
- The index cache: the rows that differ only in serving knobs share a
  build (``ivfpq1m_np8`` takes ``ivfpq1m_clustered``'s), the others not.
- ``oracle_backfill.backfill`` gives the JAX oracle's value, and merges.
- The dataset files are byte-equal to the JAX writer's, and the full-size
  ``glove50k.txt`` has the JAX script's SHA-256.
- ``--device`` defaults to CUDA, which raises without a card.
"""

import ast
import hashlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import pyrope_tpu as jpt
from pyrope_tpu.types import SearchOptions as JOptions
from pyrope_tpu.utils import datasets as jds
from pyrope_tpu_torch.scripts import bench as tb
from pyrope_tpu_torch.scripts import make_dataset_files as tmake
from pyrope_tpu_torch.scripts import oracle_backfill as tback
from pyrope_tpu_torch.utils import datasets as tds

REPO = Path(__file__).resolve().parent.parent
TABLES = ("CONFIGS", "DEVICE_CONFIGS", "CLUSTERED", "ZIPF", "BASELINES")
# SHA-256 of glove50k.txt as scripts/make_dataset_files.py writes it (50k x 100)
GLOVE50K_SHA256 = "895a234e38fe63e10d5d16c54abbee30b61593c9d0b80d6579f1ad957fb3855b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module (the tier-1 run's
    workers share the host's cores); the pool is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bench_tree() -> ast.Module:
    return ast.parse((REPO / "bench.py").read_text())


def _bench_tables() -> dict:
    out = {}
    for node in _bench_tree().body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) in TABLES):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


@pytest.fixture(scope="module")
def bench_fns() -> dict:
    """bench.py's build_index, scan_tflops, _oracle_key and oracle_recall,
    compiled from its source into a namespace of their own."""
    wanted = {"build_index", "scan_tflops", "_oracle_key", "oracle_recall"}
    defs = [n for n in _bench_tree().body
            if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert {d.name for d in defs} == wanted
    ns = {"np": np, "_ORACLE_CACHE": {}}
    exec(compile(ast.Module(body=defs, type_ignores=[]), "bench.py", "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def bench_row_keys() -> tuple[set, set]:
    """(keys every run_config row has, keys some rows add) in bench.py."""
    fn = next(n for n in _bench_tree().body
              if isinstance(n, ast.FunctionDef) and n.name == "run_config")
    always, sometimes = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "out":
            always |= {ast.literal_eval(k) for k in node.value.keys}
        elif (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
              and getattr(node.targets[0].value, "id", None) == "out"):
            sometimes.add(ast.literal_eval(node.targets[0].slice))
    return always, sometimes


@pytest.mark.parametrize("table", TABLES)
def test_tables_equal_bench_py(table):
    assert getattr(tb, table) == _bench_tables()[table]


def test_every_row_has_a_baseline_entry_or_none():
    assert len(tb.CONFIGS) == 71 and len(tb.DEVICE_CONFIGS) == 2
    assert tb.CLUSTERED <= set(tb.CONFIGS) and tb.ZIPF <= set(tb.CONFIGS)


@pytest.mark.parametrize("args", [
    (1024, 100_000, 128, 0.5, "dense-pallas"),
    (64, 1_000_000, 128, 2.0, "flat-pallas"),
    (1024, 10_000_000, 128, 80.0, "device-pallas"),
    (256, 1_000_000, 128, 40.0, "probe-adc+rerank"),
    (64, 1_000, 128, None, "flat-exact"),
    (64, 1_000, 128, 1.0, None),
])
def test_scan_tflops_is_bench_pys(bench_fns, args):
    assert tb.scan_tflops(*args) == bench_fns["scan_tflops"](*args)


def _describe(ix) -> dict:
    """An index's class, metric and public settings (a Delta: its halves')."""
    if type(ix).__name__ == "DeltaIndex":
        return {"class": "DeltaIndex", "head": _describe(ix.head), "tail": _describe(ix.tail)}
    out = {"class": type(ix).__name__, "metric": ix.metric.value}
    for k, v in vars(ix).items():
        if k.startswith("_") or k in ("device", "metric", "pq"):
            continue
        out[k] = v
    if hasattr(ix, "pq"):
        out["pq"] = (ix.pq.m, ix.pq.ksub)
    return out


def _algo_kwargs() -> dict:
    """Each algo's settings on its rows (the serving knobs apart)."""
    out: dict = {}
    for algo, _, _, kw in tb.CONFIGS.values():
        index_kw = {k: v for k, v in kw.items() if k not in ("batch", "topk", "opts")}
        out.setdefault(algo, [])
        if index_kw not in out[algo]:
            out[algo].append(index_kw)
    return out


@pytest.mark.parametrize("algo,kwargs", [(a, kw) for a, kws in sorted(_algo_kwargs().items())
                                         for kw in kws])
def test_build_index_is_the_jax_sides(bench_fns, algo, kwargs):
    jix = bench_fns["build_index"](algo, 32, dict(kwargs))
    tix = tb.build_index(algo, 32, dict(kwargs), "cpu")
    assert _describe(tix) == _describe(jix)


def test_the_index_cache_shares_builds_as_bench_py():
    key = tb.cache_key
    assert key("ivfpq1m_np8") == key("ivfpq1m_clustered") == key("ivfpq1m_clustered_b256")
    assert len({key(n) for n in ("ivfpq1m_clustered", "ivfpq1m_r128", "ivfpq1m_probe",
                                 "ivfpq1m_adc")}) == 4
    assert key("delta20k_np96") == key("delta20k")
    assert key("hnsw1m_clustered_b1") == key("hnsw1m_clustered_ef200") == key("hnsw1m_clustered")
    assert len({key(n) for n in ("ivf100k_np16", "ivf100k_np32", "ivf100k_np64")}) == 3
    # bench.py's key tells clustered rows from the rest only: a Zipf row
    # would take a uniform row's build there; the twin's names the corpus
    assert key("ivf100k_zipf") != key("ivf100k")
    assert key("ivf1m_zipf_b1024") != key("ivf1m_b1024")
    assert key("ivf100k_fvecs_file", "a.fvecs") != key("ivf100k_fvecs_file", "b.fvecs")


# small stand-ins of the rows run_config meets: name -> (CONFIGS entry, clustered)
STAND_INS = {
    "s_flat_cos": (("FLAT_COS", 2_000, 32, {"batch": 128}), False),
    "s_flat_ip": (("FLAT_IP", 2_000, 32, {"batch": 128}), False),
    "s_ivf": (("IVF_FLAT", 4_000, 32, {"nlist": 16, "nprobe": 4}), True),
    "s_ivfpq_adc": (("IVF_PQ", 4_000, 32, {"nlist": 16, "pq_m": 4, "ksub": 16,
                                           "refine": 0}), True),
    "s_delta_np8": (("DELTA", 3_000, 32, {"opts": {"nprobe": 8}}), True),
    "s_fvecs_file": (("IVF_FLAT", 100_000, 128, {"nlist": 16, "batch": 128}), False),
    "s_glove_file": (("IVF_FLAT", 50_000, 100, {"nlist": 16, "batch": 128}), False),
}


def _jax_index(algo: str, dim: int, kw: dict):
    """The JAX package's index of a stand-in row, built with pyrope_tpu."""
    if algo == "FLAT_COS":
        return jpt.FlatIndex(dim, "COSINE")
    if algo == "FLAT_IP":
        return jpt.FlatIndex(dim, "IP")
    if algo == "IVF_FLAT":
        return jpt.IvfFlatIndex(dim, "L2", **kw)
    if algo == "IVF_PQ":
        return jpt.IvfPqIndex(dim, "L2", **kw)
    assert algo == "DELTA"
    return jpt.DeltaIndex(jpt.FlatIndex(dim, "L2"), jpt.IvfFlatIndex(dim, "L2", nlist=100))


def _jax_search(jix, queries, k, opts):
    """The JAX index's hits, its IVF tails on the plain dense scan (exact
    over the probed lists, as its kernel route: no Pallas interpret mode)."""
    for ix in (getattr(jix, "tail", None), jix):
        if isinstance(ix, jpt.IvfFlatIndex):
            ix.selection, ix.scan_mode = "exact", "dense"
    hits = jix.search_batch(queries, k, opts)
    return tds.id_lists_to_rows([[h.id for h in r] for r in hits], k)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = tmp_path_factory.mktemp("datasets")
    return tmake.write_dataset_files(out, n_base=3_000, n_glove=2_000, n_queries=256)


@pytest.mark.parametrize("name", list(STAND_INS))
def test_run_config_rows_are_bench_pys(name, files, bench_fns, bench_row_keys, monkeypatch):
    cfg, clustered = STAND_INS[name]
    monkeypatch.setitem(tb.CONFIGS, name, cfg)
    if clustered:
        monkeypatch.setattr(tb, "CLUSTERED", tb.CLUSTERED | {name})
    file_kw = {}
    if name == "s_fvecs_file":
        file_kw = dict(base_fvecs=str(files["clustered100k.fvecs"]),
                       query_fvecs=str(files["clustered100k_queries.fvecs"]))
    elif name == "s_glove_file":
        glove = str(files["glove50k.txt"])
        file_kw = dict(base_fvecs=tb.glove_to_fvecs(glove, tmp_dir=str(files["glove50k.txt"].parent)),
                       query_fvecs=str(files["glove50k_queries.fvecs"]), glove_src=glove)
    cache: dict = {}
    row = tb.run_config(name, 64, 10, 256, 0.01, index_cache=cache, device="cpu",
                        latency_samples=4, **file_kw)

    algo, _, _, kw = cfg
    kw = dict(kw)
    batch, opts = kw.pop("batch", 64), kw.pop("opts", {})
    base, queries, _, _ = tb.row_data(name, batch, 256, file_kw.get("base_fvecs"),
                                      file_kw.get("query_fvecs"))
    n, dim = base.shape
    jix = _jax_index(algo, dim, kw)
    jix.add_batch([str(i) for i in range(n)], base)
    jix.build()

    always, sometimes = bench_row_keys
    expect = set(always)
    if hasattr(jix, "describe_scan"):
        expect |= {"scan_path", "tflops"}
        assert row["scan_path"] == jix.describe_scan(batch, opts.get("nprobe"))
    if hasattr(jix, "memory_bytes"):
        expect.add("memory_bytes")
        assert row["memory_bytes"] == jix.memory_bytes()
    if file_kw:
        expect.add("dataset")
        assert row["dataset"]["loader"] == ("glove-txt" if "glove_src" in file_kw else "fvecs")
    assert expect <= always | sometimes and set(row) == expect
    assert (row["config"], row["algo"], row["n_base"], row["dim"], row["batch"]) == (
        name, algo, n, dim, batch)

    gt_q = queries[:row["n_eval"]]
    metric = {"FLAT_COS": "COSINE", "FLAT_IP": "IP"}.get(algo, "L2")
    truth = jds.ground_truth(base, gt_q, 10, metric)
    jrows = _jax_search(jix, gt_q, 10, JOptions(**opts))
    assert row["recall_at_k"] == round(tds.recall_at_k(jrows, truth, 10), 4)
    if algo.startswith(("IVF", "DELTA")):
        # the build-parity bound: >= 99% of hit sets equal
        tix = cache[tb.cache_key(name, file_kw.get("base_fvecs"), None, n, dim)][0]
        from pyrope_tpu_torch.types import SearchOptions

        _, r = tix.device_search(torch.from_numpy(gt_q), 10, SearchOptions(**opts))
        trows = tds.id_lists_to_rows(tix.resolve_rows(r.numpy()), 10)
        same = sum(set(a) == set(b) for a, b in zip(trows, jrows))
        assert same >= 0.99 * len(gt_q)

    ref = bench_fns["oracle_recall"](algo, {**kw, **opts}, base, gt_q[:256], truth[:256],
                                     10, jix)
    assert row["recall_ref"] == ref and row["n_oracle"] == min(len(gt_q), 256)


def test_a_cached_row_says_so(monkeypatch):
    rows = {"s_a": ("IVF_FLAT", 2_000, 16, {"nlist": 8}),
            "s_b": ("IVF_FLAT", 2_000, 16, {"nlist": 8, "batch": 32, "opts": {"nprobe": 4}})}
    for name, cfg in rows.items():
        monkeypatch.setitem(tb.CONFIGS, name, cfg)
    cache: dict = {}
    a = tb.run_config("s_a", 64, 10, 256, 0.01, index_cache=cache, device="cpu",
                      latency_samples=2, with_oracle=False)
    b = tb.run_config("s_b", 64, 10, 256, 0.01, index_cache=cache, device="cpu",
                      latency_samples=2, with_oracle=False)
    assert "build_cached" not in a and b["build_cached"] is True
    assert (b["build_s"], b["load_s"]) == (a["build_s"], a["load_s"])
    builds = [k for k in cache if k[0] not in ("corpus", "truth")]
    assert builds == [tb.cache_key("s_a")]
    assert "device_bytes" not in a   # measured on the card only
    assert a["recall_ref"] is None and a["n_oracle"] == 0


@pytest.mark.parametrize("slab,min_recall", [("fp32", 1.0), ("bf16", 0.9)])
def test_run_device_config_rows_are_bench_pys(slab, min_recall, monkeypatch):
    """A DEVICE_CONFIGS stand-in on the CPU: bench.py's keys, the route, and
    recall against the chunked exact truth (the fp32 slab exact)."""
    fn = next(n for n in _bench_tree().body
              if isinstance(n, ast.FunctionDef) and n.name == "run_device_config")
    keys = {ast.literal_eval(k) for node in ast.walk(fn) if isinstance(node, ast.Assign)
            and getattr(node.targets[0], "id", None) == "out" for k in node.value.keys}
    monkeypatch.setitem(tb.DEVICE_CONFIGS, "s_device", (5_000, 16, slab, 64))
    cache: dict = {}
    row = tb.run_device_config("s_device", 10, 0.01, index_cache=cache, device="cpu",
                               latency_samples=2)
    assert set(row) == keys and row["scan_path"] == "device-pallas"
    assert row["recall_at_k"] >= min_recall and row["n_truth"] == 64
    again = tb.run_device_config("s_device", 10, 0.01, index_cache=cache, device="cpu",
                                 latency_samples=2)
    assert again["load_s"] == row["load_s"]   # the drawn rows are kept for the next row


def test_merge_detail_keeps_a_backfilled_oracle(tmp_path):
    path = tmp_path / "bench_detail.json"
    tb.merge_detail([{"config": "x", "batch": 64, "recall_ref": 0.5, "n_oracle": 256}], path)
    tb.merge_detail([{"config": "x", "batch": 64, "recall_ref": None, "n_oracle": 0},
                     {"config": "x", "batch": 1024, "recall_ref": None}], path)
    rows = json.loads(path.read_text())
    assert [(r["batch"], r["recall_ref"], r.get("n_oracle")) for r in rows] == [
        (64, 0.5, 256), (1024, None, None)]


def test_oracle_backfill_is_the_jax_oracles(bench_fns, monkeypatch, tmp_path):
    monkeypatch.setitem(tb.CONFIGS, "s_backfill", ("IVF_FLAT", 3_000, 32,
                                                    {"nlist": 16, "nprobe": 4}))
    monkeypatch.setattr(tb, "CLUSTERED", tb.CLUSTERED | {"s_backfill"})
    got = tback.backfill("s_backfill")
    base = jds.synthetic_clustered(3_000, 32, n_clusters=16)
    gt_q = jds.synthetic_clustered_queries(1024, 32, n_clusters=16)[:256]
    truth = jds.ground_truth(base, gt_q, 10, "L2")
    want = bench_fns["oracle_recall"]("IVF_FLAT", {"nlist": 16, "nprobe": 4}, base, gt_q,
                                      truth, 10, None, oracle_max_n=3_000)
    assert got == {"config": "s_backfill", "batch": 64, "recall_ref": want, "n_oracle": 256}
    path = tmp_path / "bench_detail.json"
    path.write_text(json.dumps([{"config": "s_backfill", "batch": 64, "recall_ref": None}]))
    assert tback.merge([got, {**got, "config": "other"}], path) == ["other"]
    assert json.loads(path.read_text())[0]["recall_ref"] == want


def _jax_make_dataset_files():
    spec = importlib.util.spec_from_file_location(
        "jax_make_dataset_files", REPO / "scripts" / "make_dataset_files.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dataset_files_are_the_jax_writers(tmp_path):
    """At a small size the JAX script's pieces (its generators, write_fvecs,
    write_glove_txt) write the same bytes; the JAX script's own sizes are
    held by the full-size file's hash below."""
    jmake = _jax_make_dataset_files()
    got = tmake.write_dataset_files(tmp_path / "twin", n_base=700, n_glove=300, n_queries=40)
    want = tmp_path / "jax"
    want.mkdir()
    jds.write_fvecs(want / "clustered100k.fvecs", jds.synthetic_clustered(700, 128, n_clusters=100))
    jds.write_fvecs(want / "clustered100k_queries.fvecs",
                    jds.synthetic_clustered_queries(40, 128, n_clusters=100))
    jmake.write_glove_txt(want / "glove50k.txt", jds.synthetic_clustered(300, 100, n_clusters=100))
    jds.write_fvecs(want / "glove50k_queries.fvecs",
                    jds.synthetic_clustered_queries(40, 100, n_clusters=100))
    for name, path in got.items():
        assert path.read_bytes() == (want / name).read_bytes(), name


def test_full_size_glove_text_is_the_jax_scripts(tmp_path):
    path = tmp_path / "glove50k.txt"
    tmake.write_glove_txt(path, tds.synthetic_clustered(50_000, 100, n_clusters=100))
    assert hashlib.sha256(path.read_bytes()).hexdigest() == GLOVE50K_SHA256


def test_glove_rows_read_back_through_fvecs(files, tmp_path):
    path = tb.glove_to_fvecs(str(files["glove50k.txt"]), limit=500, tmp_dir=str(tmp_path))
    _, vecs = tds.read_glove_txt(files["glove50k.txt"], limit=500)
    assert np.array_equal(tds.read_fvecs(path), vecs) and vecs.shape == (500, 100)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without a GPU")
def test_device_defaults_to_cuda_and_raises_without_a_card():
    ap = tb.add_common(__import__("argparse").ArgumentParser())
    assert ap.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.main(["--configs", "flat1k", "--duration", "0.01"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.run_config("flat1k", 64, 10, 64, 0.01)
