"""BENCHMARK.json keeps to the contract's names and shapes, and every cell
finds its files by name."""

import json
import re

import pytest

from core import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert man["paths"] == ["perfbench"]
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert len(json.dumps(man)) < 64 * 1024


def test_names_units_and_texts(man):
    names = [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
    metrics = man["end_to_end"] + man["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["traffic"] for w in man["workloads"]] + [k for c in man["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in man[kind]]
        assert len(seen) == len(set(seen))
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert TEXT.match(m["layer"]) and m["moves"] in {e["name"] for e in man["end_to_end"]}
    for e in man["configs"] + man["workloads"]:
        assert TEXT.match(e["why"])
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and TEXT.match(c["source"])


def test_setup_s_and_every_cell_reports_enough(man):
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    for w in man["workloads"]:
        e2e = {m["name"] for m in manifest.metrics(man, w["name"], trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics(man, w["name"], trace=True)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_workloads_name_cells(man, kind):
    cells = {w["name"] for w in man["workloads"]}
    for m in man[kind]:
        assert set(m.get("workloads", [])) <= cells


def test_cells_resolve_their_files(man):
    pairs = set()
    for w in man["workloads"]:
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cfg = manifest.config(man, w["config"])
        traffic = manifest.traffic(w["traffic"])
        assert {"batch", "in_flight", "nprobe", "k", "pool", "warmup_batches"} <= set(traffic)
        assert traffic["pool"] % traffic["batch"] == 0
        assert set(manifest.limits(w["name"])) == {"bad_rows", "gap", "score_err", "kmeans_gain",
                                                   "recall_miss"}
        assert (manifest.BENCH_DIR / "adapters" / f"{cfg['index']}.py").exists()
        assert (manifest.BENCH_DIR / "references" / f"{cfg['reference']}.py").exists()
        for m in manifest.metrics(man, w["name"], False) + manifest.metrics(man, w["name"], True):
            assert callable(manifest.reader(m["name"]).read)
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files)) and all(f.startswith("perfbench/") for f in files)


def test_split_metrics_share_their_base_reader(man):
    assert manifest.reader("list_scan_ms.device_paced") is manifest.reader("list_scan_ms")
    assert manifest.reader("qps.device_paced") is manifest.reader("qps")
    with pytest.raises(FileNotFoundError):
        manifest.reader("no_such_metric")
