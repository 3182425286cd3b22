"""RESP load: VEC.SEARCH, VEC.UPSERT or VEC.ADD requests sent to a data-plane server by client processes.

``drive`` starts the client processes (``python3 -m
pyrope_tpu_torch.bench.resp_load``, each with its share of the requests
and connections), lets them all start at once, and gathers their replies,
latencies and spans. A client process reads its job and the vectors from
stdin, prints "ready" once every connection (one ``RespClient`` on a thread
each, taking the process's requests round-robin) is open (and has sent
``AUTH tenant:key`` where the server checks keys), starts on one
byte from stdin and writes its replies, latencies and span to stdout as
JSON. Spans are ``time.perf_counter`` (CLOCK_MONOTONIC: one clock for every
process of the host), so QPS runs from the first send to the last reply.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from pyrope_tpu_torch.server.resp_client import RespClient
from pyrope_tpu_torch.utils.stats import LatencySummary


def drive(port: int, op: str, vectors: np.ndarray, requests: list, conc: int, *,
          tenant: str, index: str, top_k: int = 10, extra=(), prefix: str = "",
          procs: int = 4, api_key: str | None = None) -> dict:
    """``requests`` ([request id, row of ``vectors``]) sent as ``op``
    ("search": VEC.SEARCH top ``top_k`` with ``extra`` arguments;
    "upsert" / "add": VEC.UPSERT / VEC.ADD of id ``prefix`` + request id)
    over ``conc`` connections spread across at most ``procs`` client
    processes, each connection one request at a time, authenticated as
    ``tenant`` with ``api_key`` where one is given. Returns the replies by request id,
    QPS, and p50 / p99 latency in ms; raises if a client or request failed."""
    root = Path(__file__).resolve().parents[2]
    env = {**os.environ, "PYTHONPATH": str(root)}
    raw = np.ascontiguousarray(vectors, "<f4").tobytes()
    nprocs = min(conc, procs)
    running, outs = [], []
    try:
        for p in range(nprocs):
            job = json.dumps({
                "port": port, "op": op, "tenant": tenant, "index": index,
                "top_k": top_k, "extra": list(extra), "prefix": prefix, "api_key": api_key,
                "dim": vectors.shape[1], "requests": requests[p::nprocs],
                "threads": conc // nprocs + (p < conc % nprocs)}).encode()
            proc = subprocess.Popen(
                [sys.executable, "-m", "pyrope_tpu_torch.bench.resp_load"], cwd=root,
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            running.append(proc)
            proc.stdin.write(struct.pack("<I", len(job)) + job
                             + struct.pack("<I", len(raw)) + raw)
            proc.stdin.flush()
        for proc in running:
            if proc.stdout.readline() != b"ready\n":
                raise RuntimeError("a RESP client did not start")
        for proc in running:
            proc.stdin.write(b"g")
            proc.stdin.close()
        for proc in running:
            data = proc.stdout.read()
            if proc.wait(timeout=600) != 0:
                raise RuntimeError("a RESP client failed")
            outs.append(json.loads(data))
    finally:
        for proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    errors = [e for o in outs for e in o["errors"]]
    if errors:
        raise RuntimeError(f"RESP {op} errors: {errors[:3]}")
    replies = {int(r): v for o in outs for r, v in o["replies"].items()}
    if len(replies) != len(requests):
        raise RuntimeError(f"{len(replies)} of {len(requests)} replies")
    span = max(o["end"] for o in outs) - min(o["start"] for o in outs)
    s = LatencySummary.from_samples([v for o in outs for v in o["lat_ms"].values()])
    return {"replies": replies, "qps": len(requests) / span,
            "p50_ms": s.p50_ms, "p99_ms": s.p99_ms}


def _client() -> None:
    inp = sys.stdin.buffer
    job = json.loads(inp.read(struct.unpack("<I", inp.read(4))[0]))
    raw = inp.read(struct.unpack("<I", inp.read(4))[0])
    width = job["dim"] * 4
    conns = [RespClient("127.0.0.1", job["port"], timeout=300)
             for _ in range(job["threads"])]
    if job["api_key"] is not None:
        for c in conns:
            if not c.auth(job["tenant"], job["api_key"]):
                raise RuntimeError("AUTH refused")
    out = {"replies": {}, "lat_ms": {}, "errors": []}

    def run(t, c):
        for r, v in job["requests"][t::len(conns)]:
            payload = raw[v * width:(v + 1) * width]
            t0 = time.perf_counter()
            try:
                if job["op"] == "search":
                    reply = c.vec_search(job["tenant"], job["index"], payload,
                                         job["top_k"], *job["extra"])
                else:
                    write = c.vec_upsert if job["op"] == "upsert" else c.vec_add
                    reply = write(job["tenant"], job["index"], job["prefix"] + str(r),
                                  payload)
            except Exception as e:
                out["errors"].append(f"request {r}: {type(e).__name__}: {e}")
                continue
            out["lat_ms"][r] = (time.perf_counter() - t0) * 1e3
            out["replies"][r] = reply

    sys.stdout.write("ready\n")
    sys.stdout.flush()
    inp.read(1)
    threads = [threading.Thread(target=run, args=(t, c)) for t, c in enumerate(conns)]
    out["start"] = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    out["end"] = time.perf_counter()
    for c in conns:
        c.close()
    json.dump(out, sys.stdout)


if __name__ == "__main__":
    _client()
