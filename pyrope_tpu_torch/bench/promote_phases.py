"""Where the promote list scan's time goes, by phase, on one GPU.

    python3 -m pyrope_tpu_torch.bench.promote_phases [--out build/promote_phases.json]

Copies ``pyrope_tpu_torch`` to ``build/promote_phases/`` and adds
``clock64()`` counters to the copy's ``csrc/ivf_list_scan_promote.cu``
(each block's consumer warps: an item's set-up, the waits for a full
stage, a stage's products and offers, an item's end; its producer warp:
the waits for a free stage, the rest of a stage; a block's whole time),
summed by atomicAdd into a ``__device__`` array that a C entry of the copy
reads. Then it runs IVF-PQ's bf16 rerank slab shape (1M x 128 rows, nlist
1000, nprobe 3, k 10, seeded as ``bench/scan_ab.py``) at b64 and b1024 and
prints, per call, each phase's mean microseconds a consumer warp (or a
block) at the card's maximum SM clock (``nvidia-smi``'s clocks.max.sm;
under load the card runs at it or below, so a phase may take longer than
printed), items and stages a block, and the call's CUDA-event time. The
counters' own atomics cost some of the time they measure; compare phases,
not the call's time against an uncounted build. The copy is rebuilt at
every run; the anchors it patches must match the source (an assertion
names a stale one).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
COPY = ROOT / "build" / "promote_phases"
NAMES = ("setup", "wait_full", "compute", "item_end", "items", "stages", "p_wait_empty",
         "p_rest", "block", "blocks")

# (anchor in the source, what replaces it)
PATCHES = (
    ("namespace {\n\nconstexpr int PM_WARPS",
     "__device__ unsigned long long prof[16];\nnamespace {\n\nconstexpr int PM_WARPS"),
    ("  const int warp = tid >> 5;\n\n  if (tid == 0) {\n    for (int st = 0;",
     "  const int warp = tid >> 5;\n  const long long tk = clock64();\n\n"
     "  if (tid == 0) {\n    for (int st = 0;"),
    ("      mbar_wait(empty + st, ((it / nst) & 1) ^ 1);",
     "      long long t0 = clock64();\n      mbar_wait(empty + st, ((it / nst) & 1) ^ 1);\n"
     "      long long t1 = clock64();\n"
     "      if (lane == 0) atomicAdd(&prof[6], (unsigned long long)(t1 - t0));"),
    ("      mbar_arrive(full + st);\n#pragma unroll",
     "      mbar_arrive(full + st);\n"
     "      if (lane == 0) atomicAdd(&prof[7], (unsigned long long)(clock64() - t1));\n"
     "#pragma unroll"),
    ("    const int qn = m.qn;\n", "    const int qn = m.qn;\n    long long ti = clock64();\n"),
    ("    consumers_sync();\n\n    // the warp's groups of PM_NQ queries and its team's tiles",
     "    consumers_sync();\n    if (lane == 0) { atomicAdd(&prof[0], (unsigned long long)"
     "(clock64() - ti)); atomicAdd(&prof[4], 1ull); }\n\n"
     "    // the warp's groups of PM_NQ queries and its team's tiles"),
    ("      mbar_wait(full + st, (it / nst) & 1);",
     "      long long tw = clock64();\n      mbar_wait(full + st, (it / nst) & 1);\n"
     "      long long tc = clock64();\n      if (lane == 0) { atomicAdd(&prof[1], "
     "(unsigned long long)(tc - tw)); atomicAdd(&prof[5], 1ull); }"),
    ("      if (fk) atomicMax(qkey + fq, fk);   // read before the stage, raised after it",
     "      if (fk) atomicMax(qkey + fq, fk);   // read before the stage, raised after it\n"
     "      if (lane == 0) atomicAdd(&prof[2], (unsigned long long)(clock64() - tc));"),
    ("    // over all warps\n    consumers_sync();",
     "    // over all warps\n    long long tend = clock64();\n    consumers_sync();"),
    ("pub_g, fkey, lane);\n    }\n    consumers_sync();\n  }\n}",
     "pub_g, fkey, lane);\n    }\n    consumers_sync();\n"
     "    if (lane == 0) atomicAdd(&prof[3], (unsigned long long)(clock64() - tend));\n  }\n"
     "  if (tid == 0) { atomicAdd(&prof[8], (unsigned long long)(clock64() - tk)); "
     "atomicAdd(&prof[9], 1ull); }\n}"),
)

READER = '''
extern "C" int pyrope_promote_prof(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, prof, sizeof(prof));
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(prof, z, sizeof(z));
  return (int)e;
}
'''


def instrumented_copy() -> Path:
    """The package copied to COPY, its promote scan with the counters."""
    if COPY.exists():
        shutil.rmtree(COPY)
    shutil.copytree(ROOT / "pyrope_tpu_torch", COPY / "pyrope_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = COPY / "pyrope_tpu_torch" / "csrc" / "ivf_list_scan_promote.cu"
    text = src.read_text()
    for old, new in PATCHES:
        assert text.count(old) == 1, f"stale anchor: {old!r}"
        text = text.replace(old, new)
    src.write_text(text + READER)
    return COPY


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/promote_phases.json")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not args.worker:   # the copy's package, imported by a process of its own
        instrumented_copy()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(COPY)
        out = str(Path(args.out).resolve())
        return subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                               "--out", out, "--reps", str(args.reps)], cwd=COPY,
                              env=env).returncode
    import torch

    from pyrope_tpu_torch.kernels import build as kbuild
    from pyrope_tpu_torch.ops import fused_scan as fs

    assert str(COPY) in fs.__file__, fs.__file__
    lib = kbuild.load()
    lib.pyrope_promote_prof.restype = ctypes.c_int
    lib.pyrope_promote_prof.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    n, d, kp = 1_000_000, 128, 1000
    x = torch.rand((n, d), generator=g, device=dev)
    sq = (x * x).sum(1)
    alive = torch.rand(n, generator=g, device=dev) > 0.01
    q = torch.rand((1024, d), generator=g, device=dev)
    crow = torch.sort(torch.randint(0, kp, (n,), generator=g, device=dev)).values.int()
    probe = torch.rand((1024, kp), generator=g, device=dev).argsort(1)[:, :3]
    offs, lens = fs.list_csr(crow, kp)
    ml = int(lens.max())
    x16 = x.bfloat16()
    buf = (ctypes.c_ulonglong * 16)()
    out = {}
    for b in (64, 1024):
        qb, pb = q[:b].contiguous(), probe[:b].contiguous()

        def call():
            return fs.fused_ivf_topk(qb, x16, sq, alive, crow, offs, lens, pb, kp, 10,
                                     max_len=ml, promote_fp32=True)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        lib.pyrope_promote_prof(ctypes.addressof(buf))   # zeroes the counters
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            call()
        e.record()
        torch.cuda.synchronize()
        lib.pyrope_promote_prof(ctypes.addressof(buf))
        mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                    "--format=csv,noheader,nounits"], capture_output=True,
                                   text=True, timeout=60).stdout.split()[0])
        v = dict(zip(NAMES, list(buf)[:len(NAMES)]))
        blocks = max(v["blocks"], 1)
        warps = blocks * fs.PROMOTE_WARPS
        plan = fs.list_plan(10, fs.LIST_BF16, True, b, 3, kp, ml, d, fs.device_sms(dev))
        rec = {"b": b, "ms_call": a.elapsed_time(e) / args.reps, "sm_mhz": mhz,
               "seg": plan.seg, "blocks_per_call": blocks / args.reps,
               "items_per_block": v["items"] / warps, "stages_per_block": v["stages"] / warps,
               "block_us": v["block"] / blocks / mhz}
        for key in ("setup", "wait_full", "compute", "item_end"):
            rec[key + "_us_per_warp"] = v[key] / warps / mhz
        for key in ("p_wait_empty", "p_rest"):
            rec[key + "_us_per_block"] = v[key] / blocks / mhz
        out[b] = rec
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": smi, "calls": out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
