"""Does torch.profiler record kernels when the card's memory sits in
PyTorch's caching allocator?

Profiles the same small workload (a product and a top-k, plain torch)
three times and counts the CUDA events the
profiler returns: with the card as it starts; after every free byte has been
taken by tensors and released to the caching allocator (still reserved,
not free on the device); and after ``torch.cuda.empty_cache()`` gave it
back. Prints one JSON object: per case the device bytes free
(``torch.cuda.mem_get_info``), reserved by the allocator, and the events
(kernels, and copies and memsets apart).

    python3 -m pyrope_tpu_torch.bench.profiler_probe [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def workload(dev: torch.device):
    a = torch.rand(2048, 512, device=dev)
    b = torch.rand(512, 8192, device=dev)
    return lambda: torch.topk(a @ b, 10, dim=1)


def profiled(fn, calls: int = 5) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    return {"cuda_events": len(events), "kernels": len(kernels),
            "kernel_us": round(sum(e.time_range.elapsed_us() for e in kernels), 1)}


def fill_cache(dev: torch.device) -> int:
    """Take every free byte of the device as tensors, then release them to
    the caching allocator (they stay reserved). Returns the bytes taken."""
    held, chunk = [], 1 << 30
    while chunk >= 1 << 20:
        try:
            held.append(torch.empty(chunk, dtype=torch.uint8, device=dev))
        except torch.cuda.OutOfMemoryError:
            chunk //= 2
    taken = sum(t.numel() for t in held)
    del held
    return taken


def case(dev: torch.device, fn) -> dict:
    free, total = torch.cuda.mem_get_info(dev)
    return {"free_bytes": free, "reserved_bytes": torch.cuda.memory_reserved(dev),
            "total_bytes": total, **profiled(fn)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe needs a GPU")
    dev = torch.device("cuda", 0)
    fn = workload(dev)
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "card": torch.cuda.get_device_name(dev), "fresh": case(dev, fn)}
    out["cache_full"] = {"taken_bytes": fill_cache(dev), **case(dev, fn)}
    torch.cuda.empty_cache()
    out["cache_emptied"] = case(dev, fn)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
