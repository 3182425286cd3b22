#!/usr/bin/env python3
"""The benchmark of pyrope_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload sift1m-ivf-flat.b1024 --seed 7 --seconds 10 --trace 0

From the root of a checkout on a host with an NVIDIA GPU. Builds the cell's
index from a corpus drawn from the seed, warms the cell's shapes, runs the
closed loop for --seconds (with --trace 1 a traced window after it), judges
every answer against the plain reference and prints one JSON line last on
standard output; the numbers compared, each beside its limit, are the last
lines on standard error. Without a card (or with fewer than the cell asks
for) it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "perfbench"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # every compile cache at a fixed path inside the checkout; the port's
    # kernel library builds into build/pyrope_tpu_torch/ by itself
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    from core import harness, manifest

    man = manifest.load()
    cell = manifest.workload(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        harness.say(f"no result: the cell needs {cell['chips']} CUDA device(s); "
                    f"available={torch.cuda.is_available()}, "
                    f"count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = harness.run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    found = harness.banned_modules()
    if found:
        harness.say(f"no result: JAX or the JAX package loaded in this process: {found}")
        return 3
    for name, c in out["checks"].items():
        harness.say(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
