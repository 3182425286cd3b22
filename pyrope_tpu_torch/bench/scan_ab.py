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
  and where the tree has the bf16 slab modes: flat_bf16_1M_b1024_k10 (and
  its IP twin flat_bf16_1M_b1024_k10_IP), flat_bf16_1M_b64_k10, flat_bf16_1M_b64_k64 (the hybrid's shortlist),
  ivf_bf16_100k_nlist100_np96_b256_k64 (no promote: the IVF hybrid; the
  tensor-core list scan where the tree has it),
  ivf_bf16_promote_1M_nlist1000_np3_b64_k10 (IVF-PQ's bf16 rerank slab) and
  its b1024 twin, where the device time sets the pace,
  matmul_bf16_1M_b1024 (q16 @ x16.T alone, bf16 sums), and the fp32 modes
  at those shapes: flat_fp32_1M_b64_k64, ivf_fp32_100k_nlist100_np96_b256_k64,
  ivf_fp32_1M_nlist1000_np3_b64_k10, and where the tree has the wide modes
  (k > 128): flat_wide_1M_b1024_k1000, flat_bf16_wide_1M_b256_k512 (the
  k 100 hybrid's shortlist), flat_wide_1M_b64_k10000,
  ivf_wide_1M_nlist1000_np3_b1024_k1000 (layout B),
  ivf_wide_100k_nlist100_np96_b1024_k1000 (layout A),
  ivf_bf16_wide_100k_nlist100_np96_b256_k512 (the IVF hybrid at k 100),
  sq8_wide_100k_nlist100_np96_b1024_k200, ivf_d768_1M_nlist1000_np3_b1024
  (large D), merge_flat_splits_b1024_k1000, merge_flat8_b1024_k1000 (the
  wide flat scan's 8 splits),
  merge_wide_slots_b1024_k1000 (the list scan's layout at nprobe 96: 96 slots
  a query, 1000 entries a slot) beside topk_wide_slots_b1024_k1000, and the
  serving paths end to end, one b256 device_search:
  e2e_ivf100k_np96_hybrid_b256_k100 and _k10 (chip_smoke phase 11's 100k
  index), e2e_ivf1m_np256_hybrid_b256_k10 (phase 11's 1M index: nlist 1000,
  nprobe 256, bf16 training) and e2e_flat1m_hybrid_b256_k100 (phase 13's)

    --cases '_bf16_|_fp32_'    # the bf16 modes beside fp32 at their shapes
    --cases '_wide_'           # the wide modes

With ``--trace`` each case's record also splits its device time by kind
(``split``: the list scan, the merges, the flat scan, the rest; where the
tree has the wide modes' first pass, the scans' narrow and wide launches
apart, ``scan_narrow`` being the first pass in a wide case, and the floor
select), and each list-scan and wide flat case reports ``slot_entries``:
the mean real entries a query's partial slots (or the wide flat scan's
splits) hold after the scan (read off one more call).

``--sweep SPEC`` (trees with the first pass) adds, for each wide flat
and wide list case (or each case ``--sweep-cases`` matches), one run a
variant of SPEC: variants are separated by ``;``, each ``off`` (the first
pass off) or settings of ``ops/fused_scan`` constants joined by ``+``
(``FLAT_PREFLOOR_RATIO=5+FLAT_PREFLOOR_WAVES=1``), and the run is named
``<case>@<variant>``: the measurement the first pass's rules and the
tensor-core and promote list scans' segment rules were chosen by (the
list scan's plan cache is cleared around each variant).

Prints one JSON object per worker and writes all of them to ``--out``;
every record names the card and its power limit.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

K = 10


def _kind(name: str) -> str:
    """A kernel's kind for the device split: the scans' narrow and wide
    launches apart (a wide scan's narrow launch is its first pass), the
    floor select, the merges, the rest."""
    m = re.search(r"(ivf_list_scan(?:_tc)?|fused_scan|flat_scan_tc)_kernel<([^>]*)>", name)
    if m:   # <MODE, WIDE>, <IP, WIDE[, SPLIT]>, <BT, IP, WIDE[, CAP]>, <NC, IP, WIDE[, CAP]>
        base = "list_scan" if m.group(1).startswith("ivf_list_scan") else m.group(1)
        wide = m.group(2).replace(" ", "").split(",")[1 if base == "list_scan" else 2]
        return f"{base}_{'wide' if wide == 'true' else 'narrow'}"
    for kind in ("floor_select", "merge", "list_scan", "fused_scan"):
        if kind in name:
            return kind
    return "other"


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
    full: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:50]] = by_name.get(e.name[:50], 0.0) + e.time_range.elapsed_us()
            full[e.name] = full.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    split: dict[str, float] = {}
    for name, us in full.items():
        kind = _kind(name)
        split[kind] = split.get(kind, 0.0) + us / calls / 1e3
    return {"device_ms_per_call": round(busy / calls / 1e3, 4),
            "split": {kind: round(ms, 5) for kind, ms in split.items()},
            "kernels": len(by_name),
            "shares": {n: round(us / busy, 3) for n, us in top} if busy else {},
            "kernel_ms_per_call": {n: round(us / calls / 1e3, 5) for n, us in top}}


def _variants(spec: str) -> list[tuple[str, dict | None]]:
    """``--sweep``'s variants: (name, {constant: value}), None for off."""
    out = []
    for var in filter(None, (v.strip() for v in spec.split(";"))):
        if var == "off":
            out.append((var, None))
            continue
        sets = {}
        for item in var.split("+"):
            key, val = item.split("=")
            sets[key.strip()] = ast.literal_eval(val.strip())
        out.append((var, sets))
    return out


WIDE_CASES = r"^(flat|ivf|sq8)_(bf16_)?wide_"


def _worker(reps: int, trace: bool, cases: str, sweep: str = "",
            sweep_cases: str = WIDE_CASES) -> dict:
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

    # the partial slots each list-scan call hands the merge (qend given)
    filled: dict[str, float] = {}
    merge = fs.merge_partials
    counting = [None]

    def merge_counting(part_v, part_i, qend=None, k=None):
        if counting[0] is not None and qend is not None:
            used = int(qend[-1, -1])
            filled[counting[0]] = round(
                float(torch.isfinite(part_v[:used]).sum()) / max(qend.shape[0], 1), 1)
        return merge(part_v, part_i, qend, k)

    fs.merge_partials = merge_counting
    merge_launch = fs._merge_launch

    def merge_launch_counting(part_v, part_i, s, b, k, qend, *rest):
        if counting[0] is not None and qend is None and k > fs.NARROW_MAX_K:
            fills = rest[-1] if len(rest) == 5 else None   # trees that write fill counts
            real = fills.sum() if fills is not None else torch.isfinite(part_v).sum()
            filled[counting[0]] = round(float(real) / max(b, 1), 1)
        return merge_launch(part_v, part_i, s, b, k, qend, *rest)

    fs._merge_launch = merge_launch_counting
    prefloor = hasattr(fs, "FLAT_PREFLOOR_RATIO")

    def case(name, fn):
        if not re.search(cases, name):
            return
        run(name, fn)
        if not (sweep and prefloor and re.search(sweep_cases, name)):
            return
        for var, sets in _variants(sweep):
            names = ["flat_prefloor_plan", "list_prefloor_plan"] if sets is None else sets
            saved = {key: getattr(fs, key) for key in names}
            for key in names:
                setattr(fs, key, (lambda *a: None) if sets is None else sets[key])
            plans = getattr(fs, "_CALLS", {})   # plans cached by shape
            plans.clear()
            try:
                run(f"{name}@{var}", fn)
            finally:
                for key, val in saved.items():
                    setattr(fs, key, val)
                plans.clear()

    def run(name, fn):
        res[name] = timed(fn)
        if trace:
            traces[name] = _kernel_shares(fn)
            if name.startswith(("ivf_", "sq8_")) or "_wide_" in name:
                counting[0] = name
                fn()
                counting[0] = None
                traces[name]["slot_entries"] = filled.get(name)

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
        case("flat_bf16_1M_b1024_k10_IP",
             lambda: fs.fused_flat_topk(q, x16, sq, alive, n, K, "IP"))
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
            if tag == "bf16":
                case("ivf_bf16_promote_1M_nlist1000_np3_b1024_k10", lambda: fs.fused_ivf_topk(
                    q, xs, sq, alive, crow, offs4, lens4, probe, 1000, K, max_len=ml4,
                    promote_fp32=True))
        case("flat_fp32_1M_b64_k64", lambda: fs.fused_flat_topk(q4, x, sq, alive, n, 64))
        case("matmul_bf16_1M_b1024", lambda: q16 @ x16.T)
        del x16, x2s, x2_32

    if "flat_scan_wide" in fs.LAUNCHES:   # trees with the wide modes (k > 128)
        x16 = x.bfloat16()
        q256 = q[:256].contiguous()
        case("flat_wide_1M_b1024_k1000", lambda: fs.fused_flat_topk(q, x, sq, alive, n, 1000))
        case("flat_bf16_wide_1M_b256_k512",
             lambda: fs.fused_flat_topk(q256, x16, sq, alive, n, 512))
        q64 = q[:64].contiguous()
        case("flat_wide_1M_b64_k10000", lambda: fs.fused_flat_topk(q64, x, sq, alive, n, 10_000))
        offs, lens, ml = lists(crow, 1000)
        case("ivf_wide_1M_nlist1000_np3_b1024_k1000", lambda: fs.fused_ivf_topk(
            q, x, sq, alive, crow, offs, lens, probe, 1000, 1000, max_len=ml))
        x2w, sq2w, al2w = (t[:n2].contiguous() for t in (x, sq, alive))
        offs2, lens2, ml2 = lists(crow2, 100)
        q1k, p1k = q2[:1024].contiguous(), probe2[:1024].contiguous()
        case("ivf_wide_100k_nlist100_np96_b1024_k1000", lambda: fs.fused_ivf_topk(
            q1k, x2w, sq2w, al2w, crow2, offs2, lens2, p1k, 100, 1000, max_len=ml2))
        x2w16 = x2w.bfloat16()
        q3w, p3w = q2[:256].contiguous(), probe2[:256].contiguous()
        case("ivf_bf16_wide_100k_nlist100_np96_b256_k512", lambda: fs.fused_ivf_topk(
            q3w, x2w16, sq2w, al2w, crow2, offs2, lens2, p3w, 100, 512, max_len=ml2))
        cents2 = x2w[torch.randint(0, n2, (100,), generator=g, device=dev)]
        codes2, mins2, scales2, sq8n2 = sq8res_encode(x2w, cents2, crow2)
        qc2 = q1k @ cents2.T
        case("sq8_wide_100k_nlist100_np96_b1024_k200", lambda: fs.fused_ivf_sq8_topk(
            q1k, codes2, mins2, scales2, sq8n2, al2w, crow2, offs2, lens2, p1k, qc2, 100,
            200, max_len=ml2))
        del x16, x2w16, codes2
        # large D: 1M x 768 rows (ivf1m_d768_b1024's list scan), nlist 1000, np3
        x7 = torch.rand((n, 768), generator=g, device=dev)
        sq7 = (x7 * x7).sum(1)
        q7 = torch.rand((b, 768), generator=g, device=dev)
        case("ivf_d768_1M_nlist1000_np3_b1024", lambda: fs.fused_ivf_topk(
            q7, x7, sq7, alive, crow, offs, lens, probe, 1000, K, max_len=ml))
        del x7

    if "merge_wide" in fs.LAUNCHES:
        # end to end: the serving paths that reach the wide modes, a batch
        # of device_search (host work included: CUDA events around a call)
        from pyrope_tpu_torch.index.flat import FlatIndex
        from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
        from pyrope_tpu_torch.utils.datasets import synthetic, synthetic_queries

        q256 = torch.from_numpy(synthetic_queries(256, d)).to(dev)
        if re.search(cases, "e2e_ivf100k_np96_hybrid_b256_k100|e2e_ivf100k_np96_hybrid_b256_k10"):
            small = synthetic(100_000, d)   # phase 11's ivf100k_np96_hybrid_b256
            ix = IvfFlatIndex(d, "L2", device=dev, nlist=100, nprobe=96, selection="hybrid")
            ix.add_batch([str(i) for i in range(len(small))], small)
            ix.build()
            case("e2e_ivf100k_np96_hybrid_b256_k100", lambda: ix.device_search(q256, 100))
            case("e2e_ivf100k_np96_hybrid_b256_k10", lambda: ix.device_search(q256, K))
            del ix, small
        if re.search(cases, "e2e_ivf1m_np256_hybrid_b256_k10"):
            big = synthetic(1_000_000, d)   # phase 11's ivf1m_np256_hybrid_b256
            ix = IvfFlatIndex(d, "L2", device=dev, nlist=1000, nprobe=256,
                              train_dtype="bfloat16", selection="hybrid")
            ix.add_batch([str(i) for i in range(len(big))], big)
            ix.build()
            case("e2e_ivf1m_np256_hybrid_b256_k10", lambda: ix.device_search(q256, K))
            del ix, big
        if re.search(cases, "e2e_flat1m_hybrid_b256_k100"):
            big = synthetic(1_000_000, d)   # phase 13's flat1m_hybrid_k100
            fx = FlatIndex(d, "L2", device=dev, selection="hybrid")
            fx.add_batch([str(i) for i in range(len(big))], big)
            case("e2e_flat1m_hybrid_b256_k100", lambda: fx.device_search(q256, 100))
            del fx, big

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
    if "merge_wide" in fs.LAUNCHES:
        merge_cases("flat_splits_b1024_k1000", 33, 1000)
        merge_cases("flat8_b1024_k1000", 8, 1000)   # the wide flat scan's 8 splits
        # the list scan's slots at nprobe 96, k 1000: 96 sorted slots of 1000
        # a query, as [slots, 1000] rows cut by qend
        slots, kw = 96, 1000
        sv = torch.rand((b * slots, kw), generator=g, device=dev).sort(
            1, descending=True).values
        si = torch.randint(0, n, (b * slots, kw), generator=g, device=dev).int()
        qend = (torch.arange(1, b + 1, device=dev, dtype=torch.int32) * slots).view(b, 1)
        case("merge_wide_slots_b1024_k1000", lambda: fs.merge_partials(sv, si, qend, kw))
        case("topk_wide_slots_b1024_k1000",
             lambda: torch.topk(sv.view(b, slots * kw), kw, dim=1))
        del sv, si
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
    ap.add_argument("--sweep", default="",
                    help="variants of ops/fused_scan constants for the swept cases")
    ap.add_argument("--sweep-cases", default=WIDE_CASES,
                    help="regular expression of the cases --sweep runs (default: wide)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(_worker(args.reps, args.trace, args.cases, args.sweep,
                                 args.sweep_cases)))
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
                   ["--trace"] if args.trace else []) + (
                   ["--sweep", args.sweep, "--sweep-cases", args.sweep_cases]
                   if args.sweep else [])
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
