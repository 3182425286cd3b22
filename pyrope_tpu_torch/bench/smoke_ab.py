"""Run phases of two or more checkouts' ``chip_smoke.py`` on one GPU, in turns.

    python3 -m pyrope_tpu_torch.bench.smoke_ab --tree build/parent --tree . \\
        [--order ABBA] [--phases 3,4,11,16,18] [--out build/smoke_ab.json]

Each tree is a directory holding ``chip_smoke.py`` and its
``pyrope_tpu_torch`` package (``git archive`` of a commit, or the repo
root). For every turn of ``--order`` (A = the first tree, B = the second,
...) a fresh process imports that tree's ``chip_smoke``, builds its kernels
and runs the phases asked for, each tree's own code on the same seeded
inputs: phase 3 (``phase_kernels``: every kernel against its plain version
at the main paths' shapes, with its wrapper, device, plain, composition and
library times), phase 4 (``phase_slice``: the 1M clustered IVF-Flat
slice, its per-layer times and the trace of 40 b1024 batches, idle share
included), phase 18 (``phase_resp``: the RESP cells, with the list scan's
host time at b1), both on phase 4's corpus (``clustered_1m``, made once a
turn), phase 11 (``phase_ivf_hybrid``: the IVF hybrid cells'
b256 batches, on phase 11's uniform 1M rows), phase 12 (``phase_pq_bf16``:
IVF-PQ's bf16 rerank slab at b64, on phase 4's corpus) and phase 16
(``phase_hnsw_1m``: the bootstrap build of the 1M x 128 clustered graph,
recall at ef 50 and 200, the beam's batch times at b1, b8, b64 and b256,
and a trace of 20 b64 batches). It is the comparison of two trees whose
wrappers differ, where ``scan_ab`` needs the same ones.

Prints each turn's phase lines as they come and writes, per turn, the card
and its power limit, the phase lines, phase 3's cells (name -> the fields of
its ``ms/plain/err/...`` record), phase 11's, 12's and 16's fields and
phase 4's and 18's lines to ``--out``.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

_TURN = r"""
import sys, time, torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
smi = cs.phase_device()
cs.kbuild.build()
cs.kbuild.load()
data = None
for phase in sys.argv[1].split(","):
    if phase in ("4", "12", "18") and data is None:
        data = cs.clustered_1m()
    t0 = time.perf_counter()
    if phase == "3":
        cs.phase_kernels(dev)
    elif phase == "4":
        cs.phase_slice(dev, dict(cs.fs.LAUNCHES), data)
    elif phase == "18":
        cs.phase_resp(dev, smi, data)
    elif phase == "11":
        cs.phase_ivf_hybrid(dev, cs.uniform_1m())
    elif phase == "12":
        cs.phase_pq_bf16(dev, data)
    elif phase == "16":
        cs.phase_hnsw_1m(dev, smi)
    else:
        raise SystemExit(f"smoke_ab runs phases 3, 4, 11, 12, 16 and 18, not {phase}")
    cs.say("time", step=f"phase_{phase}", seconds=round(time.perf_counter() - t0, 1))
"""


def _cells(line: str) -> dict:
    """Phase 3's line -> {case: {field: value}} from its
    ``name:1.0ms/plain 2.0ms/err 1e-06/...`` cells."""
    body = line.split("cells=", 1)[1]
    out = {}
    for cell in ast.literal_eval(body).split(" | "):
        name, rest = cell.split(":", 1)
        fields = {}
        for part in rest.split("/"):
            key, _, val = part.partition(" ")
            if not val:   # the first field: the wrapper's time
                key, val = "ms", key
            fields[key] = val
        out[name] = fields
    return out


def _fields(line: str) -> dict:
    """A ``[phase] key=value ...`` line -> {key: value}."""
    out = {}
    for part in line.split("] ", 1)[1].split(" "):
        key, eq, val = part.partition("=")
        if eq:
            out[key] = val
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--phases", default="3,11")
    ap.add_argument("--out", default="build/smoke_ab.json")
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
        proc = subprocess.run([sys.executable, "-c", _TURN, args.phases], cwd=tree, env=env,
                              capture_output=True, text=True, timeout=1800)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
        for ln in lines:
            print(f"{tag} {ln[:2000]}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        rec = {"tree": str(tree), "turn": tag, "lines": lines}
        for ln in lines:
            if ln.startswith("[1 device]"):
                card = re.search(r"card=('[^']*')", ln)
                rec["card"] = ast.literal_eval(card.group(1)) if card else None
            elif ln.startswith("[3 kernels]"):
                rec["cells"] = _cells(ln)
            elif ln.startswith("[11 ivf hybrid]"):
                rec["hybrid"] = _fields(ln)
            elif ln.startswith("[12 pq bf16]"):
                rec["pq_bf16"] = _fields(ln)
            elif ln.startswith("[16 hnsw 1m]"):
                rec["hnsw"] = _fields(ln)
            elif ln.startswith(("[4 slice]", "[18 resp]")):
                rec.setdefault("phase_lines", []).append(ln)
        records.append(rec)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
