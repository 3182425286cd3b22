"""Concurrency soak: sustained mixed read/write load against one engine.

The port's twin of ``scripts/soak_test.py``: ``--clients`` threads hammer
one in-process ``PyropeEngine`` (IVF_FLAT, nlist 16) with interleaved
searches (70%), upserts (15%), deletes (10%) and stats (5%) while a builder
thread rebuilds the index every 3 s and a background thread ticks the
engine's services every 0.5 s, for ``--seconds``. It then checks: no
thread raised or hung, a known row is still found, the count never fell
below the base rows (which are never deleted). On the card this runs the
list scan's cached plans and per-call buffers from many threads while
rebuilds replace the slab.

    python -m pyrope_tpu_torch.scripts.soak_test [--seconds 30] [--clients 8]
        [--n 2000] [--dim 32] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np

from pyrope_tpu_torch.scripts import add_common, device_info, emit, start_device

OPS = ("search", "write", "delete", "build", "stats")


def run(seconds: float = 30, clients: int = 8, n: int = 2000, dim: int = 32,
        device: str = "cuda") -> dict:
    """The soak; returns its op counts, wall seconds, errors (as strings)
    and the final invariants' outcome (``ok``)."""
    from pyrope_tpu_torch.cache import StaticPolicyEngine
    from pyrope_tpu_torch.security import AuthSettings
    from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine
    from pyrope_tpu_torch.types import IndexConfig, IndexParams

    eng = PyropeEngine(EngineConfig(auth=AuthSettings(enabled=False), device=device))
    eng.policy = StaticPolicyEngine(ttl_seconds=5)
    rng = np.random.default_rng(42)
    base = rng.random((n, dim), dtype=np.float32)
    eng.create_index("soak", "idx", IndexConfig(dim=dim, algorithm="IVF_FLAT",
                                                params=IndexParams(nlist=16)))
    eng.add_batch("soak", "idx", [f"v{i}" for i in range(n)], base)
    eng.build_index("soak", "idx")

    stop_at = time.time() + seconds
    errors: list = []
    counters = dict.fromkeys(OPS, 0)
    clock = threading.Lock()

    def bump(k):
        with clock:
            counters[k] += 1

    def worker(wid: int):
        wrng = np.random.default_rng(wid)
        try:
            while time.time() < stop_at:
                op = wrng.random()
                i = int(wrng.integers(0, n))
                if op < 0.70:
                    r = eng.search("soak", "idx", base[i] + 1e-4, 10)
                    if not r.ok:
                        raise RuntimeError(f"search failed: {r.error_message}")
                    bump("search")
                elif op < 0.85:
                    v = wrng.random(dim).astype(np.float32)
                    r = eng.add("soak", "idx", f"w{wid}-{int(wrng.integers(0, 50))}",
                                v, upsert=True)
                    if not r.ok:
                        raise RuntimeError(f"upsert failed: {r.error_message}")
                    bump("write")
                elif op < 0.95:
                    eng.delete("soak", "idx", f"w{wid}-{int(wrng.integers(0, 50))}")
                    bump("delete")
                else:
                    s = eng.stats("soak", "idx")
                    if s is None or s["count"] < n:   # base rows are never deleted
                        raise RuntimeError(f"stats {s} below the {n} base rows")
                    bump("stats")
        except Exception as e:  # recorded, and the soak fails
            errors.append(f"worker {wid}: {e!r}")

    def builder():
        try:
            while time.time() < stop_at:
                time.sleep(3.0)
                eng.build_index("soak", "idx")
                bump("build")
        except Exception as e:
            errors.append(f"builder: {e!r}")

    def background():
        try:
            while time.time() < stop_at:
                time.sleep(0.5)
                eng.tick_background()
        except Exception as e:
            errors.append(f"background: {e!r}")

    threads = [threading.Thread(target=worker, args=(w,), name=f"worker-{w}")
               for w in range(clients)]
    threads += [threading.Thread(target=builder, name="builder"),
                threading.Thread(target=background, name="background")]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 120)
        if t.is_alive():
            errors.append(f"{t.name}: deadlock, still alive after the join timeout")
    wall = time.time() - t0
    # final invariants: a known row is still found; the count is sane
    r = eng.search("soak", "idx", base[1] + 1e-4, 5)
    found = bool(r.ok and r.hits)
    count = (eng.stats("soak", "idx") or {}).get("count", 0)
    return {"ops": counters, "seconds": round(wall, 2),
            "ops_per_s": round(sum(counters.values()) / wall, 1),
            "errors": len(errors), "error_sample": errors[:10],
            "known_row_found": found, "count": count,
            "ok": not errors and found and count >= n}


def main(argv=None) -> int:
    ap = add_common(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--dim", type=int, default=32)
    args = ap.parse_args(argv)
    dev = start_device(args.device)
    out = run(args.seconds, args.clients, args.n, args.dim, args.device)
    out["device"] = device_info(dev)
    for e in out["error_sample"]:
        print(f"ERROR {e}", file=sys.stderr)
    print(("SOAK OK" if out["ok"] else "SOAK FAILED")
          + f": {sum(out['ops'].values())} ops, {out['errors']} errors", file=sys.stderr)
    emit("soak_test", out, args.out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
