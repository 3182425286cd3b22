"""The list scan's host set-up on the card, step by step.

    python3 -m pyrope_tpu_torch.bench.list_setup [--calls 50] [--out FILE]

Times list-scan calls (``ops/fused_scan.fused_ivf_topk`` and
``fused_ivf_sq8_topk``, scan and merge) at chip_smoke.py's main shapes, on
random rows and probes made on the card from seed 1234 (chip_smoke's
``layout`` and ``probes``): 1M x 128 fp32, nlist 1000, nprobe 3 at b1, b8,
b64 and b1024 (k 10); the IVF hybrid's shortlist scan, 100k x 128 bf16,
nlist 100, nprobe 96, b256, k 64 (tensor cores, first pass) and k 512 (the
wide CUDA-core mode, first pass); SQ8 1M np3 b1024 k 10. For each: the host
time one call takes to return (the card synced first, no sync after: what
it costs to enqueue), that time by step (``fs.host_split``: checks, plan,
alloc, invert, first_pass, scan, merge), the CUDA-event time of a call
(median) and its device time (torch.profiler), all in ms. Prints one JSON
object with the card's name and power limit, and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

import chip_smoke as cs
from pyrope_tpu_torch.ops import fused_scan as fs
from pyrope_tpu_torch.ops.slab import sq8res_encode


def _host(call, calls: int) -> tuple[float, dict]:
    """Median host ms a call and the median of each step, the card synced
    before every call."""
    total = []
    with fs.host_split() as marks:
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            total.append((time.perf_counter() - t0) * 1e3)
    steps: dict = {}
    for step, sec in marks:
        steps.setdefault(step, []).append(sec * 1e3)
    return (statistics.median(total),
            {step: round(statistics.median(v), 4) for step, v in steps.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("list_setup measures on a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    n, d, kp = 1_000_000, 128, 1000
    x = torch.rand((n, d), generator=g, device=dev)
    sq = (x * x).sum(1)
    alive = torch.rand(n, generator=g, device=dev) > 0.01
    q = torch.rand((1024, d), generator=g, device=dev)
    crow, offs, lens, ml = cs.layout(n, kp, g, dev)
    n2, kp2 = 100_000, 100
    x2_16 = x[:n2].bfloat16()
    sq2, alive2 = sq[:n2].contiguous(), alive[:n2].contiguous()
    crow2, offs2, lens2, ml2 = cs.layout(n2, kp2, g, dev)
    q256 = q[:256].contiguous()
    p96 = cs.probes(256, kp2, 96, g, dev)
    cents = x[torch.randint(0, n, (kp,), generator=g, device=dev)]
    codes, mins, scales, sq8 = sq8res_encode(x, cents, crow)
    qc = q @ cents.T

    cases = {}
    for b in (1, 8, 64, 1024):
        qb, pb = q[:b].contiguous(), cs.probes(b, kp, 3, g, dev)
        cases[f"ivf_1M_np3_b{b}_k10"] = (lambda qb=qb, pb=pb: fs.fused_ivf_topk(
            qb, x, sq, alive, crow, offs, lens, pb, kp, 10, max_len=ml))
    for k in (64, 512):
        cases[f"ivf_bf16_100k_np96_b256_k{k}"] = (lambda k=k: fs.fused_ivf_topk(
            q256, x2_16, sq2, alive2, crow2, offs2, lens2, p96, kp2, k, max_len=ml2))
    p3 = cs.probes(1024, kp, 3, g, dev)
    cases["sq8_1M_np3_b1024_k10"] = lambda: fs.fused_ivf_sq8_topk(
        q, codes, mins, scales, sq8, alive, crow, offs, lens, p3, qc, kp, 10, max_len=ml)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out = {"card": smi.stdout.strip(), "calls": args.calls, "cases": {}}
    for name, call in cases.items():
        call()
        host_ms, split = _host(call, args.calls)
        out["cases"][name] = {
            "host_ms": round(host_ms, 4), "host_split_ms": split,
            "events_ms": round(cs.cuda_ms(call, 20), 4),
            "device_ms": round(cs.device_split(call, 10).get("device_ms", 0.0), 4)}
        print(name, json.dumps(out["cases"][name]), flush=True)
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
