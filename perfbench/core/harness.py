"""One run of one cell: set-up, the measured window, the traced window, the
reference's judgement, the metrics.

``run_cell`` is what ``run.py`` calls once it has found the card; the
tests call it on the CPU at a small size, and ``calibrate.py`` on the card,
with a fault planted under the timed path or the control judged beside the
program where they check that ``correct`` comes out false.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from core import data, faults, loop, manifest, stats
from core.trace import Trace, library_kernels, traced

TRACE_SECONDS = 3.0   # the traced window's length at most: its events stay few enough to read
BANNED = ("jax", "jaxlib", "flax", "pyrope_tpu")


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's: ``pyrope_tpu_torch`` is not
    ``pyrope_tpu``."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in BANNED})


def card() -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        out = [f"nvidia-smi: {exc}"]
    return {"kind": name, "smi": out[0] if out else ""}


def merged(base: dict, over: dict | None) -> dict:
    return {**base, **(over or {})}


@dataclass
class Context:
    """What the metric readers read."""
    cell: str
    config: dict
    traffic: dict
    seconds: float
    window: loop.Window
    setup_s: float
    build_s: float
    index_bytes: int
    trace: Trace | None = None
    judge: object = None    # the reference's judge (its probe sets feed the cost counts)
    kernels: dict = field(default_factory=dict)    # the port's kernel name -> source file
    pool_batches: int = 1

    def read(self, name: str):
        return manifest.reader(name).read(self)

    def module(self, kind: str, name: str):
        return manifest.module(kind, name)


def make_data(cfg: dict, traffic: dict, seed: int, device):
    """The configuration's corpus and the run's query pool."""
    corpus = data.corpus(cfg["data"], cfg["rows"], cfg["dim"], device)
    pool = data.query_pool(cfg["data"], corpus, traffic["pool"], seed)
    return corpus, pool


def build(adapter, cfg: dict, x_host: np.ndarray, ids: list, device) -> tuple[object, float, int]:
    """The index from host rows: (index, build_s, device bytes it holds)."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        # cuBLAS's workspace (32 MiB on an H100) belongs to the process, not
        # to the index: the first fp32 product allocates it, so make that
        # product here, before the first reading
        torch.ones(8, 8, device=device) @ torch.ones(8, 8, device=device)
        torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    ix = adapter.build(cfg, x_host, ids, device)
    if cuda:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    return ix, build_s, (torch.cuda.memory_allocated() - before) if cuda else 0


def row_table(adapter, ix, n: int) -> np.ndarray:
    """Permuted row -> corpus row, through the index's own ``resolve_rows``
    (ids are the corpus rows' numbers)."""
    ids = adapter.resolve(ix, np.arange(n, dtype=np.int64)[None, :])[0]
    return np.array([int(s) if s else -1 for s in ids], np.int64)


def answers(windows: list, table: np.ndarray):
    """(batch number, corpus rows, scores) of every answered batch."""
    n = table.shape[0]
    for w in windows:
        for i, rows, vals in zip(w.index, w.rows, w.vals):
            r = rows.astype(np.int64)
            ok = (r >= 0) & (r < n)
            yield i, np.where(ok, table[np.where(ok, r, 0)], -1), vals


def control_answers(windows: list, judge, batch: int, npool: int):
    """The control's answers in place of the program's: for every batch the
    program answered, the reference at the next precision down over the
    same queries (corpus rows and scores)."""
    vals, rows = judge.control(slice(None))
    vals, rows = vals.cpu().numpy(), rows.cpu().numpy()
    for w in windows:
        for i in w.index:
            s = (i % npool) * batch
            yield i, rows[s:s + batch], vals[s:s + batch]


def host_state() -> tuple[float, float]:
    """(wall s, this thread's CPU s)."""
    return time.perf_counter(), time.thread_time()


def describe_window(w: loop.Window, host0: tuple, host1: tuple) -> str:
    """The window's latencies and how long the harness thread was off its
    core (it spins while it waits on the card), one line: a tail that moves
    where the device's pace does not is the host's."""
    lat = sorted(w.latencies_ms())
    pct = " ".join(f"p{p} {stats.nearest_rank(lat, p):.4f}" for p in (50, 90, 95, 99))
    wall, cpu = host1[0] - host0[0], host1[1] - host0[1]
    return (f"latency ms {pct} max {lat[-1]:.4f} (of {len(lat)}); harness thread off its "
            f"core {wall - cpu:.4f} s of {wall:.4f}; torch threads {torch.get_num_threads()}, "
            f"process threads {len(os.listdir('/proc/self/task'))}, "
            f"cores {len(os.sched_getaffinity(0))}")


def describe_partition(lens: torch.Tensor) -> str:
    """The list lengths that set a batch's work, one line."""
    top = torch.sort(lens, descending=True).values
    return (f"{lens.numel()} lists, longest {top[:5].tolist()}, "
            f"median {int(top[lens.numel() // 2])}, empty {int((lens == 0).sum())}")


def verdict(judged: dict, extra: dict, limits: dict) -> tuple[dict, int]:
    """The numbers compared, each beside its limit, and the failed queries."""
    some = judged["bad"].numel() > 0
    values = {
        "bad_rows": int(judged["bad"].sum()),
        "gap": float(judged["gap"].max()) if some else math.inf,
        "score_err": float(judged["err"].max()) if some else math.inf,
        "recall_miss": float(judged["miss"].mean()) if some else math.inf,
        **extra,
    }
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    failed = int(((judged["bad"] > 0) | (judged["gap"] > limits["gap"])
                  | (judged["err"] > limits["score_err"])).sum())
    return checks, failed


def judged_by(judge, batches, npool: int, b: int, limits: dict) -> dict:
    """Every answer of ``batches`` against the reference: the numbers
    compared beside their limits, the queries judged and failed, and
    ``correct``."""
    dev = judge.x32.device
    qpos = [torch.arange(s * b, (s + 1) * b, device=dev) for s in range(npool)]
    judged = judge.judge_batches(lambda n: qpos[n % npool], batches)
    checks, failed = verdict(judged, judge.extra_checks(), limits)
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": int(judged["bad"].numel()), "failed": failed, "checks": checks}


def run_cell(man: dict, cell: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None, overrides: dict | None = None,
             fault: str | None = None, control: bool = False) -> dict:
    """One run; returns the result line's object. ``overrides``: {"config":
    {...}, "traffic": {...}, "limits": {...}} merged over the files (tests).
    ``fault``: a fault of ``core.faults`` planted under the timed path;
    ``control``: the reference at the next precision down is judged in the
    program's place as well, over the batches the program answered, and
    its judgement is returned under "control" (tests, ``calibrate.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    if fault is not None:
        if fault not in faults.NAMES:
            raise KeyError(f"no fault {fault!r}")
        say(f"fault planted: {fault}")
    ov = overrides or {}
    w = manifest.workload(man, cell)
    cfg = merged(manifest.config(man, w["config"]), ov.get("config"))
    tr = merged(manifest.traffic(w["traffic"]), ov.get("traffic"))
    limits = merged(manifest.limits(cell), ov.get("limits"))
    adapter = manifest.module("adapters", cfg["index"])
    reference = manifest.module("references", cfg["reference"])
    cuda = torch.device(device).type == "cuda"
    # the configuration states fp32 products: no TF32 in the program or the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_info = {"platform": "cpu", "kind": "cpu", "count": 1}
    marks = [("start", time.perf_counter())]
    if cuda:
        info = card()
        dev_info = {"platform": "gpu", "kind": info["kind"], "count": w["chips"]}
        say(f"card: {info['smi']}")
        adapter.load_kernels()
    marks.append(("kernels", time.perf_counter()))

    corpus, pool_flat = make_data(cfg, tr, seed, device)
    b = tr["batch"]
    pool = list(pool_flat.view(-1, b, cfg["dim"]).unbind(0))
    x_host = corpus.x.cpu().numpy()
    corpus.x = None   # the harness's device copy, freed before the index's bytes are counted
    ids = [str(i) for i in range(cfg["rows"])]
    marks.append(("data", time.perf_counter()))
    with faults.BUILD[fault]() if fault in faults.BUILD else contextlib.nullcontext():
        ix, build_s, index_bytes = build(adapter, cfg, x_host, ids, device)
    marks.append(("build", time.perf_counter()))
    search = adapter.searcher(ix, tr["k"], tr["nprobe"])
    if fault in faults.SEARCH:
        env = SimpleNamespace(adapter=adapter, ix=ix, traffic=tr, rows=cfg["rows"])
        search = faults.SEARCH[fault](search, env)
    say(f"route: {adapter.route(ix, b, tr['nprobe'], tr['k'])}")
    warm = loop.run(search, pool, tr["in_flight"], batches=tr["warmup_batches"])
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", time.perf_counter()))
    say("setup: imports %.3f s, " % (marks[0][1] - t_start)
        + ", ".join(f"{m1[0]} {m1[1] - m0[1]:.3f} s" for m0, m1 in zip(marks, marks[1:])))
    first = warm.submitted
    host0 = host_state()
    window = loop.run(search, pool, tr["in_flight"], seconds=seconds, first=first)
    host1 = host_state()
    searches = [e - s for name, s, e in window.spans if name == "search"]
    say(f"window: {len(window.in_window())} batches done, search call "
        f"{sum(searches) / max(len(searches), 1) / 1e6:.4f} ms a batch on the host")
    say(describe_window(window, host0, host1))
    windows = [window]
    tr_obj = None
    if trace:
        if not cuda:
            raise RuntimeError("a traced run needs the card")
        events, tw = traced(lambda: loop.run(search, pool, tr["in_flight"],
                                             seconds=min(seconds, TRACE_SECONDS),
                                             first=first + window.submitted))
        tr_obj = Trace(events, tw.start, tw.spans[-1][2], tw.submitted, tw.spans, tw.index)
        windows.append(tw)
    if cuda:
        dev_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    state = adapter.state(ix)
    table = row_table(adapter, ix, cfg["rows"])
    del ix, search, warm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program's state is freed
    t_ref = time.perf_counter()
    x32 = torch.from_numpy(x_host).to(device)
    judge = reference.make_judge(x32, state, pool_flat, tr)
    npool = len(pool)
    result = judged_by(judge, answers(windows, table), npool, b, limits)
    say(f"reference: {time.perf_counter() - t_ref:.3f} s for {result['attempted']} queries")
    say(f"partition: {describe_partition(judge.lens)}")
    say(f"answers: {judge.spread()}")

    ctx = Context(cell, cfg, tr, seconds, window, setup_s, build_s, index_bytes, tr_obj, judge,
                  library_kernels(adapter.SOURCES) if trace else {}, npool)
    metrics = {}
    for m in manifest.metrics(man, cell, trace):
        value = ctx.read(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if tr_obj is not None:
        dev_info["busy_s"] = tr_obj.busy_s()
        dev_info["window_s"] = tr_obj.window_s
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics, "device": dev_info}
    if tr_obj is not None:
        out["breakdown"] = tr_obj.breakdown()
    if control:
        out["control"] = judged_by(judge, control_answers(windows, judge, b, npool), npool, b,
                                   limits)
    out["checks"] = result["checks"]
    return out
