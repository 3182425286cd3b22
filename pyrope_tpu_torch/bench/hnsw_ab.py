"""Run chip_smoke.py's phase 16 (hnsw1m_clustered) of two or more checkouts on one GPU, in turns.

    python3 -m pyrope_tpu_torch.bench.hnsw_ab --tree build/other --tree . \\
        [--order ABBA] [--out build/hnsw_ab.json]

Each tree is a directory holding ``chip_smoke.py`` and the
``pyrope_tpu_torch`` package (``git archive`` of a commit, or the repo
root). For every turn of ``--order`` (A = the first tree, B = the second,
...) a fresh worker process imports that tree's ``chip_smoke`` and runs its
``phase_hnsw_1m`` as ``chip_smoke.py`` runs it (TF32 off): the bootstrap
build of the 1M x 128 clustered graph, recall at ef 50 and 200, the beam's
batch times at b1, b8, b64 and b256, and a trace of 20 b64 batches. The
phase's line is kept as printed, beside the card and its power limit.
Prints one JSON object per turn and writes all of them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

WORKER = """
import chip_smoke, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
chip_smoke.phase_hnsw_1m(dev, chip_smoke.phase_device())
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default="build/hnsw_ab.json")
    args = ap.parse_args()
    if len(args.tree) < 2:
        ap.error("give two or more --tree directories")
    trees = [Path(t).resolve() for t in args.tree]
    letters = "ABCDEFGH"[:len(trees)]
    records = []
    for tag in args.order:
        tree = trees[letters.index(tag)]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(tree)
        proc = subprocess.run([sys.executable, "-c", WORKER], cwd=tree, env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        lines = proc.stdout.splitlines()
        rec = {"tree": str(tree), "turn": tag,
               "card": next(ln for ln in lines if ln.startswith("[1 device]")),
               "phase16": next(ln for ln in lines if ln.startswith("[16 hnsw 1m]"))}
        records.append(rec)
        print(json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
