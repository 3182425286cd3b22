"""The benchmark's own CPU tests: ``python3 -m pytest perfbench/tests -q``
from the repo root. They import nothing of JAX."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from core import manifest  # noqa: E402


@pytest.fixture(scope="session")
def man():
    return manifest.load()


def tiny(man, cell: str) -> dict:
    """Overrides that shrink a cell to a CPU run's size: 20,000 rows in 64
    lists, 60 centres, batches of 128 (or 32) from a pool of 1,024."""
    cfg = manifest.config(man, manifest.workload(man, cell)["config"])
    traffic = manifest.traffic(manifest.workload(man, cell)["traffic"])
    return {"config": {"rows": 20_000, "index_args": {**cfg["index_args"], "nlist": 64},
                       "data": {**cfg["data"], "centres": 60}},
            "traffic": {"batch": 128 if traffic["batch"] >= 128 else 32, "pool": 1024,
                        "warmup_batches": 2, "nprobe": min(traffic["nprobe"], 20)}}


@pytest.fixture
def tiny_of(man):
    return lambda cell: tiny(man, cell)
