#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (PERF.md §2).

    python3 perfbench/calibrate.py --workload sift1m-ivf-flat.b1024 \
        --seeds 11,12,13 --seconds 2 [--control 1] [--fault two_probes] --out FILE

For each seed one run of the cell as ``run.py`` makes it (``harness.run_cell``
at the cell's own size and load, with a short window), in one process: with
``--control 1`` the reference at the next precision down is judged in the
program's place over the same answered batches; with ``--fault NAME`` a
fault of ``core/faults.py`` is planted under the timed path. One JSON line a
run, to stdout and to --out: the program's (or the fault's) numbers and
``correct``, and the control's. The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    from core import harness, manifest

    man = manifest.load()
    for seed in (int(s) for s in a.seeds.split(",")):
        out = harness.run_cell(man, a.workload, seed, a.seconds, False,
                               fault=a.fault, control=bool(a.control))
        line = {"workload": a.workload, "seed": seed, "fault": a.fault,
                "correct": out["correct"], "failed": out["failed"],
                "attempted": out["attempted"], "metrics": out["metrics"],
                "program": {k: c["value"] for k, c in out["checks"].items()}}
        if "control" in out:
            ctl = out["control"]
            line["control"] = {"correct": ctl["correct"], "failed": ctl["failed"],
                               **{k: c["value"] for k, c in ctl["checks"].items()}}
        text = json.dumps(line)
        print(text, flush=True)
        if a.out:
            with open(a.out, "a") as sink:
                sink.write(text + "\n")
    print(json.dumps({"total_s": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
