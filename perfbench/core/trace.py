"""The device trace of a traced window, from torch.profiler.

The CUDA activity alone is traced (kernels, copies, memsets), so the host
pays little for it; the harness's own host steps come from its clock and
are placed on the trace's clock by a marker kernel launched on an idle
stream just after a host reading. A session that comes back with no CUDA
event is taken again with 50 ms of host idle at both ends, then with the
CPU activity on (the retry of ``chip_smoke.cuda_trace``, which found such
sessions on the H100).
"""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from core.loop import clock

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(", re.S)


def library_kernels(src_dir: Path) -> dict[str, str]:
    """Kernel name -> source file, for every ``__global__`` function in the
    port's CUDA sources."""
    return {name: p.name for p in sorted(Path(src_dir).glob("*.cu"))
            for name in _GLOBAL.findall(p.read_text())}


def kernel_base(name: str) -> str:
    """``void (anonymous namespace)::ivf_list_scan_kernel<1, false>(float
    const*, ...)`` -> ``ivf_list_scan_kernel``: the name without return
    type, namespaces, template arguments and parameters."""
    bare = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", "").strip())
    head = re.split(r"[<(]", bare, maxsplit=1)[0].strip()
    return head.split("::")[-1] if head else bare


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


@dataclass
class Trace:
    """Device events of the traced window on the host clock (ns), the
    window itself, the batches it ran and the harness's host steps."""
    events: list            # (name, start, end)
    start: int
    end: int
    batches: int
    spans: list = field(default_factory=list)
    index: list = field(default_factory=list)   # the traced batches' numbers

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy(self) -> list[tuple[int, int]]:
        """The union of the device's busy intervals inside the window."""
        out: list[list[int]] = []
        for _, s, e in sorted(self.events, key=lambda ev: ev[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def time_s(self, keep) -> float:
        """Seconds of the events whose name ``keep`` accepts."""
        return sum(e - s for n, s, e in self.events if keep(n)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        ops: dict[str, float] = {}
        for n, s, e in self.events:
            key = "copy:" + n.split("(")[0].strip() if is_copy(n) else kernel_base(n)
            ops[key] = ops.get(key, 0.0) + (e - s) / 1e9
        gaps: dict[str, float] = {}
        prev = self.start
        spans = sorted(self.spans, key=lambda sp: sp[1])
        starts = [sp[1] for sp in spans]
        for s, e in self.busy() + [(self.end, self.end)]:
            if s > prev:
                mid = (prev + s) // 2
                j = bisect.bisect_right(starts, mid) - 1
                what = f"host:{spans[j][0]}" if j >= 0 and mid < spans[j][2] else "host:other"
                gaps[what] = gaps.get(what, 0.0) + (s - prev) / 1e9
            prev = max(prev, e)
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def _session(body, activities, pad_s: float):
    from torch.profiler import profile

    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(pad_s)
        torch.cuda.synchronize()
        t_mark = clock()
        marker.add_(1.0)
        result = body()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    cuda = torch.autograd.DeviceType.CUDA
    raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    return raw, t_mark, result


def traced(body) -> tuple[list, object]:
    """Run ``body()`` under the profiler. Returns (device events on the
    host clock, body's result); the marker kernel is not among the events."""
    from torch.profiler import ProfilerActivity

    cuda_only = [ProfilerActivity.CUDA]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for activities, pad in ((cuda_only, 0.0), (cuda_only, 0.05), (both, 0.0)):
        raw, t_mark, result = _session(body, activities, pad)
        if raw:
            break
    else:
        raise RuntimeError("torch.profiler recorded no CUDA event in three sessions")
    raw.sort(key=lambda ev: ev[1])
    offset = raw[0][1] - t_mark    # the marker: the first device event
    return [(n, s - offset, e - offset) for n, s, e in raw[1:]], result
