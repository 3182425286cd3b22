"""Time the scan kernels of two or more checkouts of the port on one GPU, in turns.

    python3 -m pyrope_tpu_torch.bench.scan_ab --tree build/other --tree . \\
        [--order ABBA] [--trace] [--cases REGEX] [--out build/scan_ab.json]

Each tree is a directory holding a ``pyrope_tpu_torch`` package (``git
archive`` of a commit, or the repo root). For every turn of ``--order``
(A = the first tree, B = the second, C the third, ...) a fresh worker
process imports the
package from that tree, builds its kernels, makes the same seeded inputs on
the card and times each case: the wrapper (kernels and the device-side
bookkeeping around them) as the median of CUDA-event times over ``--reps``
launches, three times, so the spread shows. ``--trace`` adds, per case, a
torch.profiler trace of five calls: the device time per call, the
largest kernels' shares of it and their times. ``--cases`` keeps the cases
whose name matches a regular expression. The cases are the main paths'
shapes, the flat scan's other batch sizes and widths, and the merge alone
beside ``torch.topk`` over the same candidates (a ``topk_`` twin per merge
case: the library call, which keeps no row order at ties):

  ivf_1M_nlist1000_np3_b1024, ivf_100k_nlist100_np96_b4096,
  sq8_1000k_nlist1000_np3_b1024_{L2,IP}, sq8_100k_nlist100_np3_b1024_{L2,IP},
  flat_1M_b1024_k10, flat_1M_b1024_k100, flat_1M_b64_k10, flat_1M_b1_k10,
  flat_8k_b1024_k10, matmul_1M_b1024 (q @ x.T alone, fp32, TF32 off),
  merge_3lists_b1024_k10 (the slice: per-query slots),
  merge_flat_splits_b1024_k10 (66 lists a query, the flat path's splits at
  b1024), merge_108lists_b1024_k128 (a skewed list at nprobe 96),
  and where the tree has the bf16 slab modes: flat_bf16_1M_b1024_k10,
  flat_bf16_1M_b64_k10, flat_bf16_1M_b64_k64 (the hybrid's shortlist),
  ivf_bf16_100k_nlist100_np96_b256_k64 (no promote: the IVF hybrid),
  ivf_bf16_promote_1M_nlist1000_np3_b64_k10 (IVF-PQ's bf16 rerank slab),
  matmul_bf16_1M_b1024 (q16 @ x16.T alone, bf16 sums), and the fp32 modes
  at those shapes: flat_fp32_1M_b64_k64, ivf_fp32_100k_nlist100_np96_b256_k64,
  ivf_fp32_1M_nlist1000_np3_b64_k10

    --cases '_bf16_|_fp32_'    # the bf16 modes beside fp32 at their shapes

Prints one JSON object per worker and writes all of them to ``--out``;
every record names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

K = 10


def _kernel_shares(fn, calls: int = 5) -> dict:
    """Device time per call of ``fn`` and its largest kernels' shares."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:50]] = by_name.get(e.name[:50], 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms_per_call": round(busy / calls / 1e3, 4),
            "kernels": len(by_name),
            "shares": {n: round(us / busy, 3) for n, us in top} if busy else {},
            "kernel_ms_per_call": {n: round(us / calls / 1e3, 5) for n, us in top}}


def _worker(reps: int, trace: bool, cases: str) -> dict:
    import torch

    from pyrope_tpu_torch.kernels import build as kbuild
    from pyrope_tpu_torch.ops import fused_scan as fs
    from pyrope_tpu_torch.ops.slab import sq8res_encode

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kbuild.build(verbose=True)
    kbuild.load()
    traces = {}

    def timed(fn) -> list[float]:
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(3):
            times = []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            out.append(statistics.median(times))
        return out

    def case(name, fn):
        if not re.search(cases, name):
            return
        res[name] = timed(fn)
        if trace:
            traces[name] = _kernel_shares(fn)

    def lists(crow, kp):
        offs, lens = fs.list_csr(crow, kp)
        return offs, lens, int(lens.max())

    def ivf(q, x, sq, alive, crow, probe, kp, metric="L2"):
        offs, lens, ml = lists(crow, kp)
        return lambda: fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, kp,
                                         K, metric, max_len=ml)

    def sq8(q, codes, mins, scales, sqn, alive, crow, probe, qc, kp, metric):
        offs, lens, ml = lists(crow, kp)
        return lambda: fs.fused_ivf_sq8_topk(q, codes, mins, scales, sqn, alive, crow,
                                             offs, lens, probe, qc, kp, K, metric,
                                             max_len=ml)

    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    n, d, b = 1_000_000, 128, 1024
    x = torch.rand((n, d), generator=g, device=dev)
    sq = (x * x).sum(1)
    alive = torch.rand(n, generator=g, device=dev) > 0.01
    q = torch.rand((b, d), generator=g, device=dev)
    res = {}
    crow = torch.sort(torch.randint(0, 1000, (n,), generator=g, device=dev)).values.int()
    probe = torch.rand((b, 1000), generator=g, device=dev).argsort(1)[:, :3]
    case("ivf_1M_nlist1000_np3_b1024", ivf(q, x, sq, alive, crow, probe, 1000))
    n2, b2 = 100_000, 4096
    q2 = torch.rand((b2, d), generator=g, device=dev)
    crow2 = torch.sort(torch.randint(0, 100, (n2,), generator=g, device=dev)).values.int()
    probe2 = torch.rand((b2, 100), generator=g, device=dev).argsort(1)[:, :96]
    case("ivf_100k_nlist100_np96_b4096", ivf(
        q2, x[:n2].contiguous(), sq[:n2].contiguous(), alive[:n2].contiguous(), crow2,
        probe2, 100))
    for n_s, kp in ((n, 1000), (100_000, 100)):
        xs = x[:n_s]
        crow_s = torch.sort(torch.randint(0, kp, (n_s,), generator=g, device=dev)).values.int()
        cents = xs[torch.randint(0, n_s, (kp,), generator=g, device=dev)]
        codes, mins, scales, sq8n = sq8res_encode(xs, cents, crow_s)
        probe_s = torch.rand((b, kp), generator=g, device=dev).argsort(1)[:, :3]
        qc = q @ cents.T
        for metric in ("L2", "IP"):
            case(f"sq8_{n_s // 1000}k_nlist{kp}_np3_b1024_{metric}", sq8(
                q, codes, mins, scales, sq8n, alive[:n_s].contiguous(), crow_s, probe_s,
                qc, kp, metric))
        del codes, mins, scales, sq8n
    case("flat_1M_b1024_k10", lambda: fs.fused_flat_topk(q, x, sq, alive, n, K))
    case("flat_1M_b1024_k100", lambda: fs.fused_flat_topk(q, x, sq, alive, n, 100))
    for bs in (64, 1):
        qs = q[:bs].contiguous()
        case(f"flat_1M_b{bs}_k10", lambda: fs.fused_flat_topk(qs, x, sq, alive, n, K))
    x8, sq8k, alive8 = (t[:8192].contiguous() for t in (x, sq, alive))
    case("flat_8k_b1024_k10", lambda: fs.fused_flat_topk(q, x8, sq8k, alive8, 8192, K))
    case("matmul_1M_b1024", lambda: q @ x.T)
    if "flat_scan_bf16" in fs.LAUNCHES:   # trees with the bf16 slab modes
        x16, q16 = x.bfloat16(), q.bfloat16()
        for bs, k in ((b, K), (64, K), (64, 64)):
            qs = q[:bs].contiguous()
            case(f"flat_bf16_1M_b{bs}_k{k}",
                 lambda: fs.fused_flat_topk(qs, x16, sq, alive, n, k))
        q3 = q2[:256].contiguous()
        offs3, lens3, ml3 = lists(crow2, 100)
        x2_32 = x[:n2].contiguous()
        sq2, alive2, p3 = (t.contiguous() for t in (sq[:n2], alive[:n2], probe2[:256]))
        q4, p4 = q[:64].contiguous(), probe[:64].contiguous()
        offs4, lens4, ml4 = lists(crow, 1000)
        for tag, x2s, xs in (("bf16", x2_32.bfloat16(), x16), ("fp32", x2_32, x)):
            case(f"ivf_{tag}_100k_nlist100_np96_b256_k64", lambda: fs.fused_ivf_topk(
                q3, x2s, sq2, alive2, crow2, offs3, lens3, p3, 100, 64, max_len=ml3))
            name = ("ivf_bf16_promote_1M_nlist1000_np3_b64_k10" if tag == "bf16"
                    else "ivf_fp32_1M_nlist1000_np3_b64_k10")
            case(name, lambda: fs.fused_ivf_topk(q4, xs, sq, alive, crow, offs4, lens4,
                                                  p4, 1000, K, max_len=ml4, promote_fp32=True))
        case("flat_fp32_1M_b64_k64", lambda: fs.fused_flat_topk(q4, x, sq, alive, n, 64))
        case("matmul_bf16_1M_b1024", lambda: q16 @ x16.T)
        del x16, x2s, x2_32

    def merge_cases(name, lists, k):
        """``lists`` sorted lists a query, as [S, B, k] and as per-query
        slots, beside torch.topk over the same [B, lists * k] candidates."""
        pv = torch.rand((lists, b, k), generator=g, device=dev).sort(2, descending=True).values
        pi = torch.randint(0, n, (lists, b, k), generator=g, device=dev).int()
        case(f"merge_{name}", lambda: fs.merge_partials(pv, pi))
        sv = pv.permute(1, 0, 2).reshape(b * lists, k).contiguous()
        si = pi.permute(1, 0, 2).reshape(b * lists, k).contiguous()
        qend = (torch.arange(1, b + 1, device=dev, dtype=torch.int32) * lists).view(b, 1)
        case(f"merge_slots_{name}", lambda: fs.merge_partials(sv, si, qend))
        flat = sv.view(b, lists * k)
        case(f"topk_{name}", lambda: torch.topk(flat, k, dim=1))

    merge_cases("3lists_b1024_k10", 3, K)
    merge_cases("flat_splits_b1024_k10", 66, K)
    merge_cases("108lists_b1024_k128", 108, 128)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    regs = [ln.split("ptxas info")[-1].strip(" :") for ln in kbuild.build_log().splitlines()
            if "registers" in ln]
    return {"card": smi, "reps": reps, "ms": res, "ptxas": regs, "trace": traces}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--cases", default="", help="regular expression over case names")
    ap.add_argument("--out", default="build/scan_ab.json")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(_worker(args.reps, args.trace, args.cases)))
        return 0
    if len(args.tree) < 2:
        ap.error("give two or more --tree directories")
    trees = [Path(t).resolve() for t in args.tree]
    letters = "ABCDEFGH"[:len(trees)]
    records = []
    for tag in args.order:
        tree = trees[letters.index(tag)]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(tree)
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               "--reps", str(args.reps), "--cases", args.cases] + (
                   ["--trace"] if args.trace else [])
        proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        rec = {"tree": str(tree), "turn": tag, **json.loads(proc.stdout.splitlines()[-1])}
        records.append(rec)
        print(json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
