"""The benchmark rows of the JAX package's ``bench.py``, run on the port.

The twin of ``bench.py``: its rows (``CONFIGS``, ``DEVICE_CONFIGS``,
``CLUSTERED``, ``ZIPF``, ``BASELINES``) with the same names and values, the
same corpora and seeds, each ``algo`` on the port's index with the same
settings (``build_index``), the same timing (``measure_device_search``: one
warm-up, 32 calibration calls, up to 20,000 pipelined calls, then blocking
calls whose rows are fetched to the host), and the same recall, oracle and
row keys (``run_config``). On the card ``torch.cuda.synchronize()`` fences
the timed sections; on the CPU calls run in order and nothing is fenced.

Rows merge by (config, batch) into ``--out``/bench_detail.json after every
row (nothing is written without ``--out``); each row there also names the
device it ran on, and on the card the device bytes its build left
allocated. The last line of the standard output is bench.py's
headline JSON; progress goes to standard error.

    python -m pyrope_tpu_torch.scripts.bench [--config NAME | --configs A,B
        | --all | --quick] [--batch 64] [--topk 10] [--queries 1024]
        [--duration 5] [--base-fvecs F] [--query-fvecs F] [--glove F]
        [--base-limit N] [--oracle-max-n 200000] [--no-oracle]
        [--device cuda|cpu] [--out DIR]

The file-backed rows (``ivf100k_fvecs_file``, ``ivf_glove_file``) read the
files ``python -m pyrope_tpu_torch.scripts.make_dataset_files DIR`` writes;
``--base-fvecs`` / ``--glove`` apply to every row of a run, as in bench.py.
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from pyrope_tpu_torch.scripts import add_common, device_info, start_device, sync

# The tables below are bench.py's (:45-133, :136-399), value for value
# (tests/test_torch_bench_twin.py holds them equal); bench.py's comments
# say what each row is for. BASELINES: the reference's published QPS
# (BASELINE.md), None where it published none.
BASELINES = {
    "flat1k": 1894.3,
    "flat10k": 272.5,
    "flat100k": 69.6,
    "ivf100k": 673.2,
    "ivf500k": 192.7,
    "sq8_100k": 461.4,
    "hnsw10k": None,
    "ivfpq100k": None,
    "ivfpq100k_m16": None,
    "delta20k": None,
    "flat1m": None,
    "flat1m_approx": None,
    "flat100k_approx": None,
    "delta_hnsw_pq": None,
    "delta_hnsw_pq_wide": 460.4,
    "flat1m_pallas": None,
    "flat1m_pallas_fp32": None,
    "ivf1m": None,
    "ivf100k_clustered": None,
    "ivf1m_clustered": None,
    "hnsw100k_clustered": None,
    "hnsw1m_clustered": None,
    "ivf100k_np16": 673.2,
    "ivf100k_np32": 673.2,
    "ivf100k_np64": 673.2,
    "ivf100k_np96": 673.2,
    "flat100k_b1024": 69.6,
    "ivf100k_b1024": 673.2,
    "ivf100k_np96_b1024": 673.2,
    "ivf100k_np96_b4096": 673.2,
    "ivfpq100k_b1024": None,
    "ivfpq100k_m16_b1024": None,
    "ivf1m_b1024": None,
    "delta20k_np96": 460.4,
    "flat100k_cos_b1024": None,
    "flat1m_pallas_b1024": None,
    "ivf1m_np256": None,
    "ivf1m_np256_b1024": None,
    "ivfpq1m_clustered": None,
    "ivfpq1m_adc": None,
    "sq8_100k_b1024": 461.4,
    "flat100k_ip_b1024": 69.6,
    "flat1m_pallas_k100": None,
    "flat1m_pallas_k50": None,
    "flat1m_hybrid": None,
    "flat1m_hybrid_b256": None,
    "flat1m_hybrid_k100": None,
    "ivf100k_np96_hybrid_b256": None,
    "ivf1m_np256_hybrid_b256": None,
    "flat10k_d1024_b1024": 147.9,
    "flat100k_d1024_b1024": None,
    "ivf1m_d768_b1024": None,
    "flat10m_device_b1024": None,
    "flat10m_device_fp32_b1024": None,
}

# name: (n, dim, slab_dtype, batch); the corpus is drawn on the device
DEVICE_CONFIGS = {
    "flat10m_device_b1024": (10_000_000, 128, "bf16", 1024),
    "flat10m_device_fp32_b1024": (10_000_000, 128, "fp32", 1024),
}

# name: (algo, n_base, dim, kwargs); kwargs' "batch", "topk" and "opts"
# (SearchOptions) are the row's serving knobs, the rest the index's
CONFIGS = {
    "flat1k": ("FLAT", 1_000, 128, {}),
    "flat10k": ("FLAT", 10_000, 128, {}),
    "flat100k": ("FLAT", 100_000, 128, {}),
    "sq8_100k": ("FLAT_SQ8", 100_000, 128, {}),
    "ivf100k": ("IVF_FLAT", 100_000, 128, {"nlist": 100}),
    "ivf500k": ("IVF_FLAT", 500_000, 128, {"nlist": 100}),
    "ivfpq100k": ("IVF_PQ", 100_000, 128, {"nlist": 100, "pq_m": 4, "ksub": 256}),
    "ivfpq100k_m16": ("IVF_PQ", 100_000, 128, {"nlist": 100, "pq_m": 16, "ksub": 256}),
    "hnsw10k": ("HNSW", 10_000, 128, {"m": 16, "ef_construction": 200, "ef_search": 50}),
    "delta20k": ("DELTA", 20_000, 128, {}),
    "flat1m": ("FLAT", 1_000_000, 128, {}),
    "flat100k_approx": ("FLAT_APPROX", 100_000, 128, {}),
    "flat1m_approx": ("FLAT_APPROX", 1_000_000, 128, {}),
    "delta_hnsw_pq": ("DELTA_HNSW_PQ", 20_000, 128, {}),
    "flat1m_pallas": ("FLAT_PALLAS", 1_000_000, 128, {}),
    "flat1m_pallas_fp32": ("FLAT_PALLAS_FP32", 1_000_000, 128, {}),
    "ivf1m": ("IVF_FLAT", 1_000_000, 128, {"nlist": 1000, "train_dtype": "bfloat16"}),
    "ivf100k_clustered": ("IVF_FLAT", 100_000, 128, {"nlist": 100}),
    "ivf1m_clustered": ("IVF_FLAT", 1_000_000, 128,
                        {"nlist": 1000, "train_dtype": "bfloat16", "batch": 1024}),
    "hnsw100k_clustered": ("HNSW", 100_000, 128,
                           {"m": 16, "ef_construction": 200, "ef_search": 50}),
    "hnsw1m_clustered": ("HNSW", 1_000_000, 128,
                         {"m": 16, "ef_construction": 200, "ef_search": 50}),
    "ivf100k_np16": ("IVF_FLAT", 100_000, 128, {"nlist": 100, "nprobe": 16}),
    "ivf100k_np32": ("IVF_FLAT", 100_000, 128, {"nlist": 100, "nprobe": 32}),
    "ivf100k_np64": ("IVF_FLAT", 100_000, 128, {"nlist": 100, "nprobe": 64}),
    "ivf100k_np96": ("IVF_FLAT", 100_000, 128, {"nlist": 100, "nprobe": 96}),
    "flat100k_b1024": ("FLAT", 100_000, 128, {"batch": 1024}),
    "ivf100k_b1024": ("IVF_FLAT", 100_000, 128, {"nlist": 100, "batch": 1024}),
    "ivf100k_np96_b1024": ("IVF_FLAT", 100_000, 128,
                           {"nlist": 100, "nprobe": 96, "batch": 1024}),
    "ivf100k_np96_b4096": ("IVF_FLAT", 100_000, 128,
                           {"nlist": 100, "nprobe": 96, "batch": 4096}),
    "ivfpq100k_b1024": ("IVF_PQ", 100_000, 128,
                        {"nlist": 100, "pq_m": 4, "ksub": 256, "batch": 1024}),
    "ivfpq100k_m16_b1024": ("IVF_PQ", 100_000, 128,
                            {"nlist": 100, "pq_m": 16, "ksub": 256, "batch": 1024}),
    "ivf1m_b1024": ("IVF_FLAT", 1_000_000, 128,
                    {"nlist": 1000, "train_dtype": "bfloat16", "batch": 1024}),
    "delta20k_np96": ("DELTA", 20_000, 128, {"opts": {"nprobe": 96}}),
    "delta_hnsw_pq_wide": ("DELTA_HNSW_PQ", 20_000, 128,
                           {"opts": {"nprobe": 96, "ef_search": 200}}),
    "flat100k_cos_b1024": ("FLAT_COS", 100_000, 128, {"batch": 1024}),
    "flat1m_pallas_b1024": ("FLAT_PALLAS", 1_000_000, 128, {"batch": 1024}),
    "ivf1m_np256": ("IVF_FLAT", 1_000_000, 128,
                    {"nlist": 1000, "train_dtype": "bfloat16", "nprobe": 256}),
    "ivf1m_np256_b1024": ("IVF_FLAT", 1_000_000, 128,
                          {"nlist": 1000, "train_dtype": "bfloat16",
                           "nprobe": 256, "batch": 1024}),
    "ivfpq1m_clustered": ("IVF_PQ", 1_000_000, 128,
                          {"nlist": 1000, "pq_m": 16, "ksub": 256,
                           "train_dtype": "bfloat16"}),
    "ivfpq1m_probe": ("IVF_PQ", 1_000_000, 128,
                      {"nlist": 1000, "pq_m": 16, "ksub": 256,
                       "train_dtype": "bfloat16", "scan_mode": "probe",
                       "batch": 256}),
    "ivfpq1m_bf16slab": ("IVF_PQ", 1_000_000, 128,
                         {"nlist": 1000, "pq_m": 16, "ksub": 256,
                          "train_dtype": "bfloat16",
                          "refine_storage": "bf16"}),
    "ivfpq1m_sq8res": ("IVF_PQ", 1_000_000, 128,
                       {"nlist": 1000, "pq_m": 16, "ksub": 256,
                        "train_dtype": "bfloat16",
                        "refine_storage": "sq8res", "batch": 256}),
    "ivfpq100k_sq8res_b1024": ("IVF_PQ", 100_000, 128,
                               {"nlist": 100, "pq_m": 16, "ksub": 256,
                                "refine_storage": "sq8res", "batch": 1024}),
    "ivfpq1m_adc": ("IVF_PQ", 1_000_000, 128,
                    {"nlist": 1000, "pq_m": 8, "ksub": 256, "refine": 0,
                     "train_dtype": "bfloat16"}),
    "ivfpq1m_np8": ("IVF_PQ", 1_000_000, 128,
                    {"nlist": 1000, "pq_m": 16, "ksub": 256,
                     "train_dtype": "bfloat16", "opts": {"nprobe": 8}}),
    "ivfpq1m_r128": ("IVF_PQ", 1_000_000, 128,
                     {"nlist": 1000, "pq_m": 16, "ksub": 256, "refine": 128,
                      "train_dtype": "bfloat16"}),
    "ivfpq1m_clustered_b256": ("IVF_PQ", 1_000_000, 128,
                               {"nlist": 1000, "pq_m": 16, "ksub": 256,
                                "train_dtype": "bfloat16", "batch": 256}),
    "sq8_100k_b1024": ("FLAT_SQ8", 100_000, 128, {"batch": 1024}),
    "flat100k_ip_b1024": ("FLAT_IP", 100_000, 128, {"batch": 1024}),
    "flat1m_pallas_k100": ("FLAT_PALLAS", 1_000_000, 128,
                           {"batch": 256, "topk": 100}),
    "flat1m_pallas_k50": ("FLAT_PALLAS", 1_000_000, 128,
                          {"batch": 256, "topk": 50}),
    "flat1m_hybrid": ("FLAT_HYBRID", 1_000_000, 128, {}),
    "flat1m_hybrid_b256": ("FLAT_HYBRID", 1_000_000, 128, {"batch": 256}),
    "flat1m_hybrid_k100": ("FLAT_HYBRID", 1_000_000, 128,
                           {"batch": 256, "topk": 100}),
    "ivf100k_np96_hybrid_b256": ("IVF_FLAT", 100_000, 128,
                                 {"nlist": 100, "nprobe": 96,
                                  "selection": "hybrid", "batch": 256}),
    "ivf1m_np256_hybrid_b256": ("IVF_FLAT", 1_000_000, 128,
                                {"nlist": 1000, "train_dtype": "bfloat16",
                                 "nprobe": 256, "selection": "hybrid",
                                 "batch": 256}),
    "flat10k_d1024_b1024": ("FLAT", 10_000, 1024, {"batch": 1024}),
    "flat100k_d1024_b1024": ("FLAT", 100_000, 1024, {"batch": 1024}),
    "ivf1m_d768_b1024": ("IVF_FLAT", 1_000_000, 768,
                         {"nlist": 1000, "train_dtype": "bfloat16",
                          "batch": 1024}),
    "hnsw1m_clustered_b256": ("HNSW", 1_000_000, 128,
                              {"m": 16, "ef_construction": 200,
                               "ef_search": 50, "batch": 256}),
    "hnsw1m_clustered_ef200": ("HNSW", 1_000_000, 128,
                               {"m": 16, "ef_construction": 200,
                                "ef_search": 50, "batch": 256,
                                "opts": {"ef_search": 200}}),
    "hnsw1m_clustered_b1": ("HNSW", 1_000_000, 128,
                            {"m": 16, "ef_construction": 200,
                             "ef_search": 50, "batch": 1}),
    "hnsw1m_clustered_b8": ("HNSW", 1_000_000, 128,
                            {"m": 16, "ef_construction": 200,
                             "ef_search": 50, "batch": 8}),
    "ivf1m_clustered_b1": ("IVF_FLAT", 1_000_000, 128,
                           {"nlist": 1000, "train_dtype": "bfloat16",
                            "batch": 1}),
    "ivf1m_clustered_b8": ("IVF_FLAT", 1_000_000, 128,
                           {"nlist": 1000, "train_dtype": "bfloat16",
                            "batch": 8}),
    "ivf100k_zipf": ("IVF_FLAT", 100_000, 128, {"nlist": 100}),
    "ivf1m_zipf_b1024": ("IVF_FLAT", 1_000_000, 128,
                         {"nlist": 1000, "train_dtype": "bfloat16",
                          "batch": 1024}),
    "ivf1m_zipf_probe": ("IVF_FLAT", 1_000_000, 128,
                         {"nlist": 1000, "train_dtype": "bfloat16",
                          "scan_mode": "probe", "batch": 256}),
    "ivfpq1m_zipf_b256": ("IVF_PQ", 1_000_000, 128,
                          {"nlist": 1000, "pq_m": 16, "ksub": 256,
                           "train_dtype": "bfloat16", "batch": 256}),
    # file-backed: run with --base-fvecs / --glove; the file's shape wins
    "ivf100k_fvecs_file": ("IVF_FLAT", 100_000, 128,
                           {"nlist": 100, "batch": 1024}),
    "ivf_glove_file": ("IVF_FLAT", 50_000, 100,
                       {"nlist": 100, "batch": 1024}),
}

# rows on synthetic_clustered (natural clusters: the row's nlist, else 100)
CLUSTERED = {"ivf100k_clustered", "ivf1m_clustered", "hnsw100k_clustered",
             "hnsw1m_clustered", "ivfpq1m_clustered", "ivfpq1m_adc",
             "ivfpq1m_np8", "hnsw1m_clustered_b256", "hnsw1m_clustered_ef200",
             "ivfpq1m_r128", "ivfpq1m_bf16slab", "ivfpq1m_clustered_b256",
             "ivfpq1m_probe", "hnsw1m_clustered_b1", "hnsw1m_clustered_b8",
             "ivf1m_clustered_b1", "ivf1m_clustered_b8", "ivf1m_d768_b1024",
             "ivfpq1m_sq8res", "ivfpq100k_sq8res_b1024"}
# rows on synthetic_zipf (Zipf(1.0) cluster sizes, queries of the same popularity)
ZIPF = {"ivf1m_zipf_b1024", "ivf1m_zipf_probe", "ivfpq1m_zipf_b256",
        "ivf100k_zipf"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_index(algo: str, dim: int, kwargs: dict, device="cuda"):
    """The port's index for ``algo`` with bench.py's settings (:424-471);
    FLAT_APPROX scans exactly, as every approx selection of the port does."""
    from pyrope_tpu_torch.index.delta import DeltaIndex
    from pyrope_tpu_torch.index.flat import FlatIndex
    from pyrope_tpu_torch.index.hnsw import HnswIndex
    from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
    from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex

    flat = {
        "FLAT": ("L2", {}),
        "FLAT_COS": ("COSINE", {}),
        "FLAT_IP": ("IP", {}),
        "FLAT_APPROX": ("L2", {"storage": "bf16", "selection": "approx:0.95"}),
        "FLAT_PALLAS": ("L2", {"storage": "bf16", "selection": "pallas"}),
        "FLAT_PALLAS_FP32": ("L2", {"storage": "fp32", "selection": "pallas"}),
        "FLAT_HYBRID": ("L2", {"storage": "fp32", "selection": "hybrid"}),
        "FLAT_SQ8": ("L2", {"storage": "sq8"}),
    }
    if algo in flat:
        metric, kw = flat[algo]
        return FlatIndex(dim, metric, device=device, **kw)
    if algo == "IVF_FLAT":
        return IvfFlatIndex(dim, "L2", device=device, **kwargs)
    if algo == "IVF_PQ":
        return IvfPqIndex(dim, "L2", device=device, **kwargs)
    if algo == "HNSW":
        return HnswIndex(dim, "L2", device=device, **kwargs)
    if algo == "DELTA":
        return DeltaIndex(FlatIndex(dim, "L2", device=device),
                          IvfFlatIndex(dim, "L2", device=device, nlist=100))
    if algo == "DELTA_HNSW_PQ":
        return DeltaIndex(
            HnswIndex(dim, "L2", device=device, m=16, ef_construction=200, ef_search=50),
            IvfPqIndex(dim, "L2", device=device, nlist=100, pq_m=4, ksub=256),
        )
    raise ValueError(f"unknown algo {algo}")


def scan_tflops(batch, n_rows, dim, device_ms, scan_path):
    """Achieved TFLOP/s of the score product for routes that scan the whole
    slab (flat / dense / device): 2·B·N·D over the pipelined time a batch.
    None for probe, graph and ADC routes."""
    if not device_ms or not scan_path:
        return None
    if not scan_path.startswith(("dense", "device", "flat")):
        return None
    return round(2.0 * batch * n_rows * dim / (device_ms * 1e9), 3)


_ORACLE_CACHE: dict = {}


def _oracle_key(base, *params):
    # the corpus by its shape and corner values (seeded rows repeat them)
    return (base.shape, float(base[0, 0]), float(base[-1, -1]), *params)


def oracle_recall(algo, kwargs, base, gt_q, truth, topk, idx,
                  oracle_max_n=200_000):
    """recall@k of the reference's algorithm on the same rows at the same
    settings (``utils/ref_oracle.py``, numpy on the host), as bench.py's
    :495-582; None where no oracle applies or the corpus is above
    ``oracle_max_n``."""
    from pyrope_tpu_torch.utils import ref_oracle as ro
    from pyrope_tpu_torch.utils.datasets import recall_at_k

    if base.shape[0] > oracle_max_n:
        return None
    if algo in ("IVF_FLAT", "DELTA"):
        # a Delta row is compacted before it is searched: its tail, IVF-Flat
        # nlist 100, at the row's nprobe
        nlist = kwargs.get("nlist", 100) if algo == "IVF_FLAT" else 100
        key = _oracle_key(base, "ivf", nlist)
        if key not in _ORACLE_CACHE:
            _ORACLE_CACHE[key] = ro.ref_ivf_build(base, nlist, seed=42)
        cents, lists = _ORACLE_CACHE[key]
        rows = np.stack([
            ro.ref_ivf_search(base, cents, lists, q, kwargs.get("nprobe", 3), topk)
            for q in gt_q
        ])
    elif algo in ("IVF_PQ", "DELTA_HNSW_PQ"):
        # the compacted composite's tail is IVF-PQ nlist 100, m 4, ksub 256
        pq = ((kwargs.get("nlist", 100), kwargs.get("pq_m", 4), kwargs.get("ksub", 256))
              if algo == "IVF_PQ" else (100, 4, 256))
        key = _oracle_key(base, "ivfpq", *pq)
        if key not in _ORACLE_CACHE:
            _ORACLE_CACHE[key] = ro.ref_ivfpq_build(base, *pq)
        cents, lists, cbs, codes = _ORACLE_CACHE[key]
        rows = np.stack([
            ro.ref_ivfpq_search(cents, lists, cbs, codes, q, kwargs.get("nprobe", 3), topk)
            for q in gt_q
        ])
    elif algo == "FLAT_SQ8":
        key = _oracle_key(base, "sq8")
        if key not in _ORACLE_CACHE:
            _ORACLE_CACHE[key] = ro.ref_sq8_build(base)
        codes, code_sq = _ORACLE_CACHE[key]
        rows = np.stack([ro.ref_sq8_search(codes, code_sq, q, topk) for q in gt_q])
    elif algo == "HNSW":
        rows = np.stack([ro.ref_hnsw_search(idx, q, kwargs.get("ef_search", 10), topk)
                         for q in gt_q])
    else:
        return None
    return round(recall_at_k(rows, truth, topk), 4)


def hnsw_e2e_oracle(base, kwargs, gt_q, truth, topk, metric="L2", device="cuda"):
    """The reference's own HNSW recall (bench.py :585-612): a closest-M graph
    (``neighbor_heuristic=False``) searched by the sequential reference."""
    from pyrope_tpu_torch.index.hnsw import HnswIndex
    from pyrope_tpu_torch.utils import ref_oracle as ro
    from pyrope_tpu_torch.utils.datasets import recall_at_k

    key = _oracle_key(base, "hnsw_ref", kwargs.get("m", 16),
                      kwargs.get("ef_construction", 200))
    if key not in _ORACLE_CACHE:
        ref_idx = HnswIndex(
            base.shape[1], metric, device=device,
            m=kwargs.get("m", 16),
            ef_construction=kwargs.get("ef_construction", 200),
            ef_search=kwargs.get("ef_search", 10),
            neighbor_heuristic=False,
        )
        log(f"  [e2e oracle] building closest-M graph over {base.shape[0]} rows...")
        ref_idx.add_batch([str(i) for i in range(base.shape[0])], base)
        _ORACLE_CACHE[key] = ref_idx
    ref_idx = _ORACLE_CACHE[key]
    ef = kwargs.get("ef_search", 10)
    rows = np.stack([ro.ref_hnsw_search(ref_idx, q, ef, topk) for q in gt_q])
    return round(recall_at_k(rows, truth, topk), 4)


def measure_device_search(idx, q_dev, topk, opts, duration_s, batch,
                          latency_samples: int = 200):
    """Pipelined QPS (calls issued back to back, one fence at the end) and
    blocking latency a batch, the rows fetched to the host (bench.py
    :615-660). Returns (qps, ms a batch pipelined, LatencySummary)."""
    from pyrope_tpu_torch.utils.stats import LatencySummary

    dev = q_dev[0].device
    n_slices = len(q_dev)
    idx.device_search(q_dev[0], topk, opts)   # warm-up
    sync(dev)
    calib_iters = 32
    t0 = time.perf_counter()
    for i in range(calib_iters):
        idx.device_search(q_dev[i % n_slices], topk, opts)
    sync(dev)
    per_iter = (time.perf_counter() - t0) / calib_iters
    iters = max(calib_iters, min(int(duration_s / per_iter), 20000))
    t0 = time.perf_counter()
    for i in range(iters):
        idx.device_search(q_dev[i % n_slices], topk, opts)
    sync(dev)
    total_s = time.perf_counter() - t0
    lat_ms = []
    for i in range(latency_samples):
        t0 = time.perf_counter()
        idx.device_search(q_dev[i % n_slices], topk, opts)[1].cpu()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    return (iters * batch / total_s, round(total_s / iters * 1e3, 4),
            LatencySummary.from_samples(lat_ms))


def run_device_config(name: str, topk: int, duration_s: float,
                      index_cache: dict | None = None, device="cuda",
                      latency_samples: int = 200) -> dict:
    """A DEVICE_CONFIGS row (bench.py :663-763): the corpus drawn on the
    device (uniform, seed 42, padded to 4096 rows), served by
    DeviceFlatIndex; recall over min(batch, 256) queries against the
    chunked exact truth of the fp32 rows. No oracle at this scale."""
    from pyrope_tpu_torch.index.device_flat import DeviceFlatIndex
    from pyrope_tpu_torch.ops.topk import chunked_exact_topk
    from pyrope_tpu_torch.types import SearchOptions
    from pyrope_tpu_torch.utils.datasets import id_lists_to_rows, recall_at_k, synthetic_queries
    from pyrope_tpu_torch.utils.shapes import round_up

    n, dim, slab_dtype, batch = DEVICE_CONFIGS[name]
    dev = start_device(device)
    log(f"[{name}] device-resident: n={n} dim={dim} slab={slab_dtype} batch={batch}")
    npad = round_up(n, 4096)
    cache = index_cache if index_cache is not None else {}
    gen_key = ("devgen", n, dim)
    if gen_key not in cache:
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(42)
        xf = torch.rand((npad, dim), generator=g, device=dev)
        sync(dev)
        load_s = time.perf_counter() - t0
        log(f"[{name}] drew {npad}x{dim} fp32 on {dev}: {load_s:.2f}s")
        alive = torch.arange(npad, device=dev) < n
        cache[gen_key] = [xf, alive, None, load_s]
    xf, alive, truth_i, load_s = cache[gen_key]

    t0 = time.perf_counter()
    slab = xf if slab_dtype == "fp32" else xf.bfloat16()
    idx = DeviceFlatIndex(slab, "L2", n_valid=n, selection="pallas")
    sync(dev)
    build_s = time.perf_counter() - t0

    q_dev = [torch.from_numpy(synthetic_queries(batch, dim)).to(dev)]
    opts = SearchOptions()
    qps, device_ms_per_batch, summary = measure_device_search(
        idx, q_dev, topk, opts, duration_s, batch, latency_samples)
    n_truth = min(batch, 256)
    if truth_i is None:
        log(f"[{name}] chunked exact truth ({n_truth} queries)...")
        _, truth_i = chunked_exact_topk(xf, (xf * xf).sum(1), alive, q_dev[0][:n_truth],
                                        topk, "L2")
        cache[gen_key][2] = truth_i
    _, rows = idx.device_search(q_dev[0][:n_truth], topk, opts)
    recall = recall_at_k(id_lists_to_rows(idx.resolve_rows(rows.cpu().numpy()), topk),
                         truth_i[:, :topk], topk)
    scan_path = idx.describe_scan(batch)
    out = {
        "config": name,
        "algo": "FLAT_DEVICE",
        "n_base": n,
        "dim": dim,
        "batch": batch,
        "topk": topk,
        "qps": round(qps, 1),
        "device_ms_per_batch": device_ms_per_batch,
        "recall_at_k": round(recall, 4),
        "recall_ref": None,
        "n_oracle": 0,
        "n_truth": n_truth,
        "load_s": round(load_s, 3),
        "build_s": round(build_s, 3),
        "latency_batch_ms": summary.to_dict(),
        "baseline_qps": BASELINES.get(name),
        "scan_path": scan_path,
        "tflops": scan_tflops(batch, n, dim, device_ms_per_batch, scan_path),
        "memory_bytes": idx.memory_bytes(),
        "note": ("device-resident corpus (drawn on the device, seed 42); recall vs "
                 f"the chunked exact truth of the fp32 rows over {n_truth} queries"),
    }
    log(f"[{name}] QPS={qps:,.1f} recall@{topk}={recall:.4f} "
        f"p50={summary.p50_ms:.2f}ms p99={summary.p99_ms:.2f}ms")
    return out


def _corpus(kind: str, n: int, dim: int, nc: int, n_queries: int, cache: dict | None):
    """A synthetic corpus and its queries, kept in ``cache`` (the run's
    index cache) for the rows after it."""
    from pyrope_tpu_torch.utils import datasets as ds

    key = ("corpus", kind, n, dim, nc, n_queries)
    if cache is not None and key in cache:
        return key, cache[key]
    if kind == "clustered":
        pair = (ds.synthetic_clustered(n, dim, n_clusters=nc),
                ds.synthetic_clustered_queries(n_queries, dim, n_clusters=nc))
    elif kind == "zipf":
        pair = (ds.synthetic_zipf(n, dim, n_clusters=nc),
                ds.synthetic_zipf_queries(n_queries, dim, n_clusters=nc))
    else:
        pair = (ds.synthetic(n, dim), ds.synthetic_queries(n_queries, dim))
    if cache is not None:
        cache[key] = pair
    return key, pair


def corpus_kind(name: str) -> str:
    return "clustered" if name in CLUSTERED else "zipf" if name in ZIPF else "uniform"


def row_data(name: str, batch: int, n_queries: int, base_fvecs: str | None = None,
             query_fvecs: str | None = None, base_limit: int | None = None,
             glove_src: str | None = None, cache: dict | None = None):
    """A row's corpus and queries as bench.py's run_config makes them
    (:791-840): the files where given, else the row's generator (clustered,
    Zipf or uniform; natural clusters = the row's nlist, else 100), kept in
    ``cache`` where given. Returns (base, queries, dataset record or None,
    corpus key)."""
    from pyrope_tpu_torch.utils.datasets import read_fvecs, synthetic_queries

    _, n_base, dim, kwargs = CONFIGS[name]
    if not base_fvecs:
        kind = corpus_kind(name)
        nc = kwargs.get("nlist", 100) if kind != "uniform" else 0
        key, (base, queries) = _corpus(kind, n_base, dim, nc, max(n_queries, batch), cache)
        return base, queries, None, key
    base = read_fvecs(base_fvecs, limit=base_limit or n_base)
    dim = base.shape[1]
    queries = (read_fvecs(query_fvecs, limit=max(n_queries, batch)) if query_fvecs
               else synthetic_queries(max(n_queries, batch), dim))
    if queries.shape[1] != dim:
        raise SystemExit(f"query dim {queries.shape[1]} != base dim {dim} in {query_fvecs}")
    if len(queries) < batch:   # short query files tile up to one batch
        queries = np.tile(queries, (-(-batch // len(queries)), 1))[:batch]
    log(f"[{name}] fvecs dataset: {base.shape} base, {queries.shape} queries")
    dataset = {
        "loader": "glove-txt" if glove_src else "fvecs",
        "base_file": os.path.basename(glove_src or base_fvecs),
        "query_file": os.path.basename(query_fvecs) if query_fvecs else None,
    }
    key = ("file", os.path.abspath(base_fvecs), query_fvecs, base_limit, len(queries))
    return base, queries, dataset, key


def cache_key(name: str, base_fvecs: str | None = None,
              base_limit: int | None = None, n_base: int | None = None,
              dim: int | None = None) -> tuple:
    """The index cache's key of a row (bench.py :848-850): rows that differ
    only in serving knobs (batch, k, SearchOptions) share one build. The key
    names the row's corpus (bench.py's names only whether it is clustered,
    so a Zipf row could take a uniform row's build)."""
    algo, n0, d0, kwargs = CONFIGS[name]
    index_kw = {k: v for k, v in kwargs.items() if k not in ("batch", "topk", "opts")}
    return (algo, n0 if n_base is None else n_base, d0 if dim is None else dim,
            tuple(sorted((k, repr(v)) for k, v in index_kw.items())),
            corpus_kind(name), base_fvecs, base_limit)


def _truth(corpus_key, base, gt_q, topk, metric, cache: dict | None):
    from pyrope_tpu_torch.utils.datasets import ground_truth

    key = ("truth", corpus_key, len(gt_q), topk, metric)
    if cache is None:
        return ground_truth(base, gt_q, topk, metric)
    if key not in cache:
        cache[key] = ground_truth(base, gt_q, topk, metric)
    return cache[key]


def run_config(
    name: str, batch: int, topk: int, n_queries: int, duration_s: float,
    base_fvecs: str | None = None, query_fvecs: str | None = None,
    base_limit: int | None = None, with_oracle: bool = True,
    oracle_max_n: int = 200_000, index_cache: dict | None = None,
    glove_src: str | None = None, device="cuda", latency_samples: int = 200,
    keep: dict | None = None,
) -> dict:
    """One CONFIGS row, as bench.py's run_config (:766-962), on ``device``:
    its keys, its recall over n_eval = max(batch, min(queries, 256))
    queries against the exact float64 truth, and the oracle's over the
    first 256 of them; on the card also ``device_bytes``, the device
    memory the build left allocated. ``keep``: a dict the row leaves its index, corpus,
    eval queries, truth, eval output (scores, rows) and one timed batch's
    call (``search``) in, for checks beside the row."""
    from pyrope_tpu_torch.types import SearchOptions
    from pyrope_tpu_torch.utils.datasets import id_lists_to_rows, recall_at_k

    dev = start_device(device)
    algo, n_base, dim, kwargs = CONFIGS[name]
    kwargs = dict(kwargs)
    batch = kwargs.pop("batch", batch)
    topk = kwargs.pop("topk", topk)
    opt_kwargs = kwargs.pop("opts", {})
    metric = {"FLAT_COS": "COSINE", "FLAT_IP": "IP"}.get(algo, "L2")
    base, queries, dataset, corpus_key = row_data(
        name, batch, n_queries, base_fvecs, query_fvecs, base_limit, glove_src, index_cache)
    n_base, dim = base.shape
    log(f"[{name}] algo={algo} n={n_base} dim={dim} batch={batch} topk={topk}")

    key = cache_key(name, base_fvecs, base_limit, n_base, dim)
    cached = index_cache.get(key) if index_cache is not None else None
    build_cached = cached is not None
    if build_cached:
        idx, load_s, build_s, device_bytes = cached
        log(f"[{name}] reusing built index (load {load_s:.2f}s / build {build_s:.2f}s)")
    else:
        alloc0 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        idx = build_index(algo, dim, kwargs, dev)
        t0 = time.perf_counter()
        idx.add_batch([str(i) for i in range(n_base)], base)
        sync(dev)
        load_s = time.perf_counter() - t0
        log(f"[{name}] load: {load_s:.2f}s ({n_base / load_s:,.0f} vec/s)")
        t0 = time.perf_counter()
        idx.build()
        sync(dev)
        build_s = time.perf_counter() - t0
        log(f"[{name}] build: {build_s:.2f}s")
        device_bytes = None
        if dev.type == "cuda":
            for sub in (idx, getattr(idx, "tail", None)):
                if hasattr(sub, "_sync"):
                    sub._sync()   # Flat and HNSW upload at their first search
            sync(dev)
            device_bytes = torch.cuda.memory_allocated(dev) - alloc0
        if index_cache is not None:
            index_cache[key] = (idx, load_s, build_s, device_bytes)

    opts = SearchOptions(**opt_kwargs)
    n_slices = max(len(queries) // batch, 1)
    q_dev = [torch.from_numpy(queries[i * batch:(i + 1) * batch]).to(dev)
             for i in range(n_slices)]
    qps, device_ms_per_batch, summary = measure_device_search(
        idx, q_dev, topk, opts, duration_s, batch, latency_samples)

    n_eval = max(batch, min(len(queries), 256))
    gt_q = queries[:n_eval]
    truth = _truth(corpus_key, base, gt_q, topk, metric, index_cache)
    q_eval = q_dev[0] if n_eval == batch else torch.from_numpy(gt_q).to(dev)
    vals, rows = idx.device_search(q_eval, topk, opts)
    recall = recall_at_k(id_lists_to_rows(idx.resolve_rows(rows.cpu().numpy()), topk),
                         truth, topk)
    if keep is not None:
        keep.update(index=idx, base=base, queries=gt_q, truth=truth, out=(vals, rows),
                    options=opts, metric=metric,
                    search=lambda: idx.device_search(q_dev[0], topk, opts))

    n_oracle = min(len(gt_q), 256)
    oracle_kwargs = {**kwargs, **opt_kwargs}
    recall_ref = (oracle_recall(algo, oracle_kwargs, base, gt_q[:n_oracle],
                                truth[:n_oracle], topk, idx, oracle_max_n=oracle_max_n)
                  if with_oracle else None)
    recall_ref_e2e = (hnsw_e2e_oracle(base, oracle_kwargs, gt_q[:n_oracle],
                                      truth[:n_oracle], topk, metric, dev)
                      if with_oracle and algo == "HNSW" and n_base <= oracle_max_n
                      else None)

    out = {
        "config": name,
        "algo": algo,
        "n_base": n_base,
        "dim": dim,
        "batch": batch,
        "topk": topk,
        "qps": round(qps, 1),
        "device_ms_per_batch": device_ms_per_batch,
        "recall_at_k": round(recall, 4),
        "recall_ref": recall_ref,
        "n_oracle": n_oracle if with_oracle else 0,
        "n_eval": n_eval,
        "load_s": round(load_s, 3),
        "build_s": round(build_s, 3),
        "latency_batch_ms": summary.to_dict(),
        "baseline_qps": BASELINES.get(name),
    }
    if recall_ref_e2e is not None:
        out["recall_ref_e2e"] = recall_ref_e2e
    if dataset is not None:
        out["dataset"] = dataset
    if build_cached:
        out["build_cached"] = True
    if hasattr(idx, "describe_scan"):
        # Flat, IVF-Flat and IVF-PQ: the route at the row's batch, nprobe and k
        out["scan_path"] = idx.describe_scan(batch, opt_kwargs.get("nprobe"), top_k=topk)
        out["tflops"] = scan_tflops(batch, n_base, dim, device_ms_per_batch,
                                    out["scan_path"])
    if hasattr(idx, "memory_bytes"):
        out["memory_bytes"] = idx.memory_bytes()
    if device_bytes is not None:   # the twin's own: what the build left allocated
        out["device_bytes"] = device_bytes
    log(f"[{name}] QPS={qps:,.1f} recall@{topk}={recall:.4f} recall_ref={recall_ref} "
        f"p50={summary.p50_ms:.2f}ms p99={summary.p99_ms:.2f}ms")
    return out


def merge_detail(results: list[dict], path: Path) -> None:
    """Merge rows into ``path`` keyed by (config, batch), as bench.py's
    _merge_detail (:965-993): a row without ``recall_ref`` keeps the value
    an earlier row (or oracle_backfill) left there."""
    detail = []
    try:
        detail = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        pass
    merged = {(r["config"], r["batch"]): r for r in detail}
    for r in results:
        old = merged.get((r["config"], r["batch"]))
        if old is not None and r.get("recall_ref") is None:
            for k in ("recall_ref", "n_oracle", "recall_ref_e2e"):
                if old.get(k) not in (None, 0):
                    r[k] = old[k]
        merged[(r["config"], r["batch"])] = r
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(sorted(merged.values(),
                                      key=lambda r: (r["config"], r["batch"])), indent=2))


def glove_to_fvecs(glove: str, limit: int | None = None, tmp_dir: str | None = None) -> str:
    """The GloVe text's vectors as a temporary fvecs file (bench.py's main,
    :1026-1041), removed when the process exits."""
    from pyrope_tpu_torch.utils.datasets import read_glove_txt, write_fvecs

    _, vecs = read_glove_txt(glove, limit=limit)
    fd, path = tempfile.mkstemp(suffix=".fvecs", dir=tmp_dir)
    os.close(fd)
    atexit.register(lambda p=path: os.unlink(p) if os.path.exists(p) else None)
    write_fvecs(path, vecs)
    return path


def main(argv=None) -> int:
    ap = add_common(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--config", default="ivf100k_np96_b4096",
                    choices=sorted(list(CONFIGS) + list(DEVICE_CONFIGS)))
    ap.add_argument("--configs", default=None,
                    help="comma-separated rows run in one process")
    ap.add_argument("--all", action="store_true", help="run every row")
    ap.add_argument("--quick", action="store_true", help="small fast sanity run")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--base-fvecs", default=None, help="SIFT-style .fvecs base file")
    ap.add_argument("--query-fvecs", default=None, help=".fvecs query file")
    ap.add_argument("--glove", default=None, help="GloVe .txt base file")
    ap.add_argument("--base-limit", type=int, default=None)
    ap.add_argument("--oracle-max-n", type=int, default=200_000,
                    help="largest corpus the reference oracle runs on")
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the reference-semantics recall oracle")
    args = ap.parse_args(argv)

    dev = start_device(args.device)
    glove_src = None
    if args.glove:
        if args.base_fvecs:
            raise SystemExit("--glove and --base-fvecs are mutually exclusive")
        args.base_fvecs = glove_to_fvecs(args.glove, args.base_limit)
        glove_src = args.glove   # rows name the text loader
    if args.quick:
        names = ["flat10k"]
        args.duration = min(args.duration, 2.0)
    elif args.all:
        names = list(CONFIGS)
    elif args.configs:
        names = [n.strip() for n in args.configs.split(",") if n.strip()]
        unknown = [n for n in names if n not in CONFIGS and n not in DEVICE_CONFIGS]
        if unknown:
            raise SystemExit(f"unknown configs: {unknown}")
    else:
        names = [args.config]

    info = device_info(dev)
    index_cache: dict = {}
    results = []
    for n in names:
        r = (run_device_config(n, args.topk, args.duration, index_cache=index_cache,
                               device=dev)
             if n in DEVICE_CONFIGS
             else run_config(
                 n, args.batch, args.topk, args.queries, args.duration,
                 base_fvecs=args.base_fvecs, query_fvecs=args.query_fvecs,
                 base_limit=args.base_limit, with_oracle=not args.no_oracle,
                 oracle_max_n=args.oracle_max_n, index_cache=index_cache,
                 glove_src=glove_src, device=dev))
        r["device"] = info
        results.append(r)
        if args.out:   # after every row: a failed row loses only itself
            merge_detail([r], Path(args.out) / "bench_detail.json")

    head = next((r for r in results if r["config"] == "ivf100k"), results[0])
    baseline = head["baseline_qps"]
    print(json.dumps({
        "metric": f"search_qps_{head['config']}_batch{head['batch']}",
        "value": head["qps"],
        "unit": "qps",
        "vs_baseline": round(head["qps"] / baseline, 2) if baseline else None,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
