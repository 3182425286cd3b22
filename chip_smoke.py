#!/usr/bin/env python3
"""End-to-end check of the PyTorch + CUDA port (pyrope_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repo root, on a host with a GPU
    python3 chip_smoke.py --log build/smoke.log   # stdout's lines also to a file

Builds the CUDA kernels from pyrope_tpu_torch/csrc at first use, then runs
twenty-five phases, one line each (phases 8, 15 and 19 two, phase 18 one a
cell, phase 21 three, phase 22 one a family and layout, phase 23 one a
cell, phase 24 one a tool (serving_bench one a cell), phase 25 one a row
and one for its files);
any failed check exits non-zero. Each serving path's wall time and the
total are printed:

  1. device    torch/CUDA versions, the card's name and power limit
  2. build     nvcc build time, registers and spills per kernel, and the
               HGMMA instructions (cuobjdump -sass) of the bf16 flat scan and
               of the bf16 list scan on the tensor cores
  3. kernels   each kernel against its plain PyTorch version on the card at
               the main paths' shapes: equal hit sets, scores within
               |a-b| <= 1e-4 + 1e-5|b| (fp32 both sides, other summation
               order; the SQ8 scan 1e-4 + 1e-4|b|, the JAX package's SQ8
               tolerance), kernel and plain times (CUDA events, median),
               the nearest PyTorch composition's time (topk of the masked
               fp32 scores) beside each main case and the narrow rows, each
               case's bound (what its inputs need, bytes or operations); the
               flat scan at b1024 (k 10, k 100, max_scans 600k), b64, b1 and
               over an 8k-row slab, with q @ x.T alone (torch.matmul, fp32)
               timed beside the main case; the merge on the slice's
               per-query slots and on the flat path's [B, splits, k]; and
               the list scan's edge cases, IVF and SQ8 mode: a 50k-row list
               (at nprobe 3, and at nprobe 96 with k 128), nprobe >= the
               non-empty lists, probed empty lists, B 1000, k 128, a row
               copied into two lists, 30% tombstones; the bf16 slab modes:
               the flat scan on the tensor cores (flat_scan_tc.cu) at 1M x
               128 (b1024 at k 10 in L2 and IP, b64 at k 10, b64 at the
               hybrid's k 64), the list scan without promote at k <= 128 on
               the tensor cores (ivf_list_scan_tc.cu: 100k, nlist 100, nprobe
               96, b256, k 64, with its first pass) and with promote on the CUDA cores
               (ivf_list_scan_promote.cu, the rows on a ring of bulk copies:
               1M, nlist 1000, nprobe 3, b64 and b1024, k 10), each beside the
               composition, the bare
               bf16 q16 @ x16.T, and its bound (bf16 rows over the memory
               rate against the bf16 tensor-core peak, or the fp32 peak with
               promote); the wide modes (k > 128), each beside the
               composition and its bound: the flat scan fp32 at b1024 k 1000
               and b64 k 10,000, bf16 at b256 k 512; the list scan at k 1000
               in both layouts (1M nlist 1000 np3 b1024; 100k nlist 100 np96
               b1024), bf16 without promote at 100k np96 b256 k 512, with
               promote at 1M np3 b64 k 200, SQ8 at 100k np96 b1024 k 200; the
               wide merge on the flat path's [1024, 33, 1000] and on the list
               scan's slots; the wide modes' first pass alone against its
               plain version (the fp32 flat scan's at b1024 k 1000 and b64
               k 10,000, the bf16 flat scan's on the tensor cores at b256
               k 512, with the plain floor select's time beside it, the list
               scan's at 100k np96 b1024 k 1000 and bf16 b256 k 512, and
               the tensor-core list scan's at bf16 b256 k 64; floors' scores
               to the fp32 tolerance), and each first pass's
               floors (the flat pass takes them in its own launch, the list
               passes with the floor select kernel) bit-equal to the plain
               select (floor_select_plain) over the entries it published;
               the list floor select alone (bit-equal, beside torch.kthvalue
               through the same wrapping); each wide case's device time split
               into first pass, floor select, second pass and merge where the
               first pass ran, and the real
               entries a query's splits hold (the wide flat scan); and the
               list scan at D 768 (1M clustered rows,
               nlist 1000, np3, b1024, k 10), IVF and SQ8 modes; the probe
               inversion (invert_probes.cu) against its plain version,
               every table bit-equal, at 1M nlist 1000 np3 b1024 and b1,
               100k nlist 100 np96 b256 (the tensor-core segment) and
               b4096, with its time, device time and bytes bound. Each row
               adds its device time from torch.profiler (the scans split
               into scan and merge, the merges beside torch.topk's), and
               each wide list scan the mean real entries a query's partial
               slots hold after the scan; the library call (the bare
               product, q @ x.T or q16 @ x16.T, or q @ x̂ᵀ over the SQ8
               rows' fp32 reconstruction) beside every flat and list-scan
               row that has one, torch.topk at k = c over the sampled
               rows' scores beside the first passes, and torch.topk
               alone on the masked scores beside the wide list scan's
               layout A (100k, np96, b1024, k 1000). Last, k-means++
               (jax.random's draws, ops/jrandom.py) on the card and on the
               CPU from one seed: the rows both pick, printed
  4. slice     create_index(IVF_FLAT, nlist 1000, nprobe 3, dense) on 1M x
               128 clustered rows through the registry's Delta(Flat,
               IVF_FLAT): add_batch, build (compaction -> k-means -> slab),
               search_batch / device_search on b1024; route
               dense-pallas-win, recall@10 >= 0.995 against numpy ground
               truth; build_s, QPS, p50/p99 batch latency, per-layer
               times, and a torch.profiler trace of 40 pipelined b1024
               device_search batches (device idle share, kernel shares)
  5. narrow    IvfFlatIndex nlist 100, nprobe 96 on 100k uniform rows,
               b4096: route dense-pallas, recall@10 within 0.005 of 0.9972;
               selection="pallas" at k 200 (the wide list scan), held
               against the plain list scan
  6. flat      FlatIndex(selection="pallas") on 1M uniform rows, b1024:
               exact, recall@10 1.0; k 200 (the wide flat scan) held against
               the plain scan
  7. pq        create_index(IVF_PQ, nlist 1000, pq_m 16, ksub 256,
               refine_storage sq8res) on the same 1M clustered rows through
               Delta(Flat, IVF_PQ): add_batch, build; route
               dense-sq8-pallas-win at b256 (the SQ8 kernel), recall@10 >=
               0.9736 from search_batch and device_search on 1024 queries;
               build_s, QPS and p50/p99 at b256 and b1024, device bytes
  8. pq narrow IvfPqIndex nlist 100, pq_m 16, sq8res on 100k clustered rows,
               b1024: route dense-sq8-pallas, recall@10 >= 0.9783; the same
               index in probe mode (probe-adc+rerank-sq8, the ADC path);
               the registry default fp32 rerank slab (dense-exact-pallas,
               the IVF kernel); and a second build from the same seed with
               bit-equal centroids, codebooks, PQ codes and SQ8 codes; k 200
               (the wide SQ8 list scan) against the plain route's hits
  9. flat bf16 FlatIndex(storage="bf16", selection="pallas") on phase 6's
               1M uniform rows (flat1m_pallas): route flat-pallas, the bf16
               flat scan; recall@10 of b1024 within 0.005 of 0.9817, b64's
               beside 0.9855; QPS, p50/p99 at b1024 and b64
 10. flat hybrid FlatIndex(selection="hybrid") on the same rows
               (flat1m_hybrid, flat1m_hybrid_b256): flat-pallas-hybrid at
               b64 and b256, flat-pallas at b1024; no miss beyond fp32 ties
 11. ivf hybrid IvfFlatIndex(selection="hybrid"): 100k uniform, nlist 100,
               nprobe 96 (ivf100k_np96_hybrid_b256, dense-pallas-hybrid) and
               the 1M uniform rows, nlist 1000, nprobe 256, bf16 training
               (ivf1m_np256_hybrid_b256, dense-pallas-win-hybrid), b256:
               hits equal the fp32 list scan's on the same queries (sent
               inside a b1024 batch, above HYBRID_MAX_BATCH), but for k-th
               place ties; the 100k index also at k 100 (R 512: the list
               scan's wide bf16 mode, on the CUDA cores) against the fp32
               list scan at k 100; each k 10 cell prints the tensor-core list
               scan's launches and its first passes
 12. pq bf16   create_index(IVF_PQ, nlist 1000, pq_m 16, ksub 256,
               refine_storage bf16), bf16 training, on phase 4's clustered
               rows (ivfpq1m_bf16slab): route dense-exact-pallas-win at b64
               (the bf16 list scan with promote: ivf_list_scan_promote.cu,
               its launches counted), a 256,000,000-byte slab,
               recall@10 of 1024 queries within 0.03 of 0.725; k 200 (its
               wide mode) against the plain route's hits
 13. flat hybrid k100 FlatIndex(selection="hybrid") on phase 6's rows
               (flat1m_hybrid_k100): b256, k 100, route flat-pallas-hybrid
               at R 512 (the wide bf16 flat scan and its first pass),
               recall@100 1.0 with no miss beyond fp32 ties (truth in
               float64 on the card); ms a batch beside the scan's without a
               first pass (4.0686, the bench twin's flat1m_hybrid_k100); QPS
 14. ivf d768  IvfFlatIndex nlist 1000, bf16 training, default nprobe, on
               synthetic_clustered(1M, 768, 1000 centers) (ivf1m_d768_b1024):
               route dense-pallas-win (the list scan with q streamed by
               depth), recall@10 >= 0.9894 (the reference's 0.9994 less
               0.01); build_s, QPS, p50/p99, device bytes
 15. hnsw native HnswIndex(m 16, ef_construction 200, ef_search 50) built by
               the native C++ builder (g++ at first use) on
               synthetic_clustered(100k, 128, 100 centers)
               (hnsw100k_clustered) and synthetic(10k, 128) (hnsw10k): the
               beam at b64, recall@10 of 256 queries >= 0.9838 / 0.7244 (the
               records less 0.01), recall_ref (the copied oracle's
               sequential search over the same graph, 64 queries), build_s
               (the host build, run on a thread of its own beside phases
               3-14) and the upload's seconds, QPS, p50/p99;
               hnsw100k_clustered's graph hash equal to the
               CPU build's in both packages (HNSW100K_GRAPH_SHA256), and a
               bf16 beam over it: recall@10 within 0.005 of the JAX
               package's bf16 beam on the CPU, its gap under the fp32 beam
               at most the JAX package's gap + 0.005 (HNSW_BF16_GAP_JAX,
               scripts/torch_hnsw_bf16_gap.py)
 16. hnsw 1m   the same index on synthetic_clustered(1M, 128, 100 centers)
               (hnsw1m_clustered), built by the device bootstrap (build_s and
               its stage times): recall@10 of 256 queries >= 0.8084 at ef 50
               and >= 0.9404 at ef 200; QPS and ms a batch at b1, b8, b64,
               b256 and at ef 200 b256; a bf16 beam over the same graph
               (recall >= 0.8084 and at most 0.01 under the fp32 beam's;
               scores equal to an fp32 rescoring of its rows; the recall
               of its pool ordered by its bf16 scores, without the rerank,
               printed); the device bytes by storage; a
               torch.profiler trace of 20 b64 batches (kernels a batch,
               idle share); the steps one b64 batch runs and the bytes its
               gathers read in them, over the memory rate (the beam's bound)
 17. delta hnsw create_index's Delta(HNSW head, IVF_PQ tail) on 20k rows
               (delta_hnsw_pq_wide: head writes, compaction, nprobe 96 and
               ef_search 200, recall@10 >= 0.9853, the tail's list scan
               launched) and Delta(Flat, HNSW) (writes compacted into the
               HNSW tail; the Flat head set to the fused scan, K1, after
               create_index: the registry's Flat head scans exactly,
               flat-exact, and never runs K1); 32 streamed adds into each
               head, each found first
 18. resp      the data plane over the wire: PyropeEngine(device="cuda")
               behind a RespServer on port 0 in a thread, four client
               processes (pyrope_tpu_torch/bench/resp_load.py) speaking RESP
               (scripts/serving_bench.py's cells, cache off): its 100k x 128
               corpus (IVF_FLAT, nlist 100, dense-pallas) at nprobe 3 and 96,
               concurrency 4 and 64, 2,000 VEC.SEARCH top-10 a cell; phase
               4's 1M clustered rows (nlist 1000, nprobe 3, dense-pallas-win)
               at concurrency 64 (1,024 requests); 4 writers x 1,000
               VEC.UPSERT; one query
               repeated 500 times with the cache on. Checks: the list scan
               (scan and merge) against its plain version on each index's
               own tensors and probes at the server's micro-batch sizes, b1
               and b8 (100k np3 and np96, 1M np3 windowed; equal hit sets
               but for k-th place ties, scores within RTOL / ATOL; these
               launches and the b1 timing's are not counted); every reply
               names the hits of the index's own search_batch on the same
               queries (scores within RTOL / ATOL, a hit may differ only as a
               k-th place tie); recall@10 within 0.005 of the JAX package's
               on the 100k corpus (SERVING_RECALL_JAX), >= 0.995 at 1M; the
               list scan launched in every search cell and avg_batch > 1 at
               concurrency 64; every write acknowledged and its id its own
               vector's top-1, 100 deleted ids in no later reply, VEC.STATS
               counting n + writes - deletes; the repeated query's TRACE
               naming L0 and no list scan launched by the 500 hits. Prints
               QPS, p50/p99 ms and avg_batch a cell, upsert vec/s, cache-hit
               QPS, a torch.profiler trace of 500 requests at concurrency
               64 (idle share, device ms a request, and the medians of the
               engine's TRACE times), the list scan wrapper's host time
               against its device time at b1 and that host time by step
               (list_scan_host_split_b1: fs.host_split), and at 1M the
               smallest batch scan_mode "auto" would send to the list scan
               and the list-scan route against the probe route at b1, b8
               and b64 (the same hits; ms a device_search batch each)
 19. stack     the full stack as users start it: the sidecar (python -m
               pyrope_tpu_torch.sidecar.server) and the server (python -m
               pyrope_tpu_torch.server --device cuda --sidecar ..., auth on,
               an admin key) as processes of their own on free ports; the
               smoke builds phase 4's 1M clustered IVF_FLAT index (nlist
               1000, nprobe 3, dense) in an engine of its own and writes its
               snapshot; over HTTP: PUT /v1/cache/policies (cache off),
               POST /v1/tenants (a high-priority tenant), POST /v1/indexes,
               POST .../load. Over RESP (AUTH as the tenant): 1,024
               VEC.SEARCH top-10 at concurrency 64, every reply equal to the
               smoke's own search_batch, recall@10 >= 0.995; QPS, p50/p99,
               avg_batch beside phase 18's for the same cell; 6,000 TRACE
               requests while POST /v1/debug/trace records the server for
               3 s: the Chrome trace must name ivf_list_scan_kernel and
               merge_partials_kernel (counts, idle share); 4,000 VEC.ADD of
               new ids, POST .../build, each id its own vector's top-1 and
               GET .../stats counting them; SemanticModelTrainer (k 256 on
               65,536 rows, on the card here) pushes centroids (200, the
               index's epoch + 1); the SidecarMetricsReporter reached the
               sidecar (its decision log has a line, the engine's cache TTL
               is a logged decision's); GET /v1/ai/models through the proxy,
               POST /v1/ai/models/train where sklearn and joblib import;
               both processes stop on SIGINT with exit code 0
 20. flat sq8  FlatIndex(storage="sq8") on synthetic(100k, 128) (bench.py's
               sq8_100k at b64 and sq8_100k_b1024): route flat-sq8 (plain
               torch, as the JAX package's XLA scan; no kernel), recall@10
               of the first 256 / 1024 queries within 0.005 of the JAX
               package's on the CPU (SQ8_RECALL_JAX; the TPU records
               printed beside), QPS and p50/p99 at b64 and b1024, device
               bytes, capacity, one upsert scattered in place and read back
 21. device flat DeviceFlatIndex over 10M x 128 uniform rows generated on
               the card from seed 42 (flat10m_device_fp32_b1024,
               flat10m_device_b1024: the fp32 slab and its bf16 copy),
               adopted in place, device-pallas (K1, K1 bf16), b1024, k 10:
               the fp32 hits equal the port's chunked_exact_topk on 256
               queries but for k-th place fp32 ties, the bf16 hits equal
               K1 bf16's plain version's (its recall printed); QPS,
               p50/p99, build_s, device bytes, launches; a 100k
               DeviceFlatIndex's snapshot loaded into FlatIndex
 22. sharded   the parallel/ families on a 4-shard mesh of the one card
               (devices=[cuda:0] * 4; no interconnect is measured):
               ShardedIvfFlatIndex on phase 4's corpus (the partition of
               one IvfFlatIndex, nlist 1000, nprobe 3, dense) in the rows
               and cluster layouts and on a 2 x 2 batch x data mesh, route
               dense-pallas-win, the list scan once a shard and the shard
               merge, hits equal the single index's but for k-th place
               ties, recall@10 >= 0.995; ShardedFlatIndex on phase 6's 1M
               uniform rows, K1 on every shard, hits equal FlatIndex's with
               and without a max_scans budget that ends inside a shard, and
               its sq8 storage; ShardedIvfPqIndex at 100k clustered (phase
               8's index, fp32 rerank slab: the list scan per shard), recall
               no lower than the single index's; ShardedHnswIndex over
               phase 15's hnsw100k_clustered graph (the single beam's hits
               but for k-th place ties); ShardedHnswCorpusIndex on the same
               100k rows (recall >= the replicated graph's less 0.02, and
               >= 0.9, as its CPU twin test states). Per family: QPS,
               p50/p99, device ms split into scans and merges, the kernels
               one device_search launches
 23. zipf      bench.py's four skewed rows, the only corpora whose clusters
               differ in size (synthetic_zipf: Zipf(1.0) cluster sizes, the
               queries with the same popularity), through the indexes' own
               entry points: ivf100k_zipf (IvfFlatIndex nlist 100, nprobe 3,
               b64, dense-pallas; recall@10 of 256 queries within 0.005 of
               the JAX package's on the CPU, ZIPF_RECALL_JAX);
               ivf1m_zipf_b1024 (1M x 128, 1000 clusters, nlist 1000, bf16
               training, dense-pallas-win; hits held against the plain list
               scan on the card); ivf1m_zipf_probe (the same build,
               scan_mode probe, b256; hits equal to the list scan's on the
               same queries but for k-th place ties); ivfpq1m_zipf_b256
               (IvfPqIndex nlist 1000, pq_m 16, bf16 training,
               dense-exact-pallas-win; hits the plain list scan's over its
               fp32 slab). Their recall on the port's own build is printed,
               not gated (Lloyd's bf16 iterations do not converge there: it
               moves with the order of the fp32 sums); the three rows again
               on the JAX package's partition (its centroids,
               tests/data/zipf1m_jax_centroids.npz; the rows assigned on the
               card in fp32; the port's loaders; IVF-PQ's codebooks trained
               by the port), recall within 0.005 of the JAX package's on the
               CPU (ZIPF1M_RECALL_JAX), hits the plain list scan's (the
               probe row: the list-scan route's) but for k-th place ties.
               Each row: QPS,
               p50/p99, build_s, device bytes, the route, the partition
               (empty lists, the longest five, l_pad); for the list-scan
               rows the grid launched against the items that hold rows, the
               segments a chunk, the slots a query, the device ms split
               into scan and merge; at b1024 the list scan's ms, plain,
               composition, bare product and bytes bound; for the probe row
               its gather's query block and the peak device bytes
 24. tools     the twins of the JAX package's tools (pyrope_tpu_torch/
               scripts/, examples/), in this process on the card: soak_test
               for 15 s (8 client threads, rebuilds every 3 s; 0 errors, the
               known row found, the count never below the base rows),
               phase6_eval (its three scenarios' checks, the prefetch served
               from the cache), quickstart (its top hits the JAX
               quickstart's on the CPU, QUICKSTART_HITS_JAX, up to fp32
               ties), the demo notebook's code cells (DEMO_NOTEBOOK; its
               top hits DEMO_HITS_JAX's, the engine's repeat an L0 hit),
               serving_bench on 20,000 rows (SERVING_TOOL_ARGS: upserts by
               four thread writers and by four client processes, eight
               commands in flight each, every one acknowledged; a 1.5 s
               search cell at concurrency 128 under --max-batch 128
               --linger-ms 0.2 --inflight 3, 0 errors, no batch above 128),
               and check_quality.sh's import and native step
 25. bench rows fifteen of bench.py's rows that no other phase runs, through
               the bench twin's run_config (pyrope_tpu_torch/scripts/bench.py)
               at bench.py's sizes and batches, a short pipelined section
               (BENCH_DURATION_S) and 20 blocking samples: the nprobe sweep
               ivf100k_np16/32/64, delta20k and delta20k_np96,
               flat100k_cos_b1024 and flat100k_ip_b1024 (COSINE, IP),
               flat10k_d1024_b1024 and flat100k_d1024_b1024 (D 1024), the
               file-backed ivf100k_fvecs_file and ivf_glove_file (the files
               the twin of scripts/make_dataset_files.py writes into a
               temporary directory first; the GloVe text read through a
               temporary fvecs file), and the 1M IVF-PQ rows ivfpq1m_adc
               (pq_m 8, refine 0: probe-adc), ivfpq1m_probe
               (probe-adc+rerank, b256), ivfpq1m_np8 and ivfpq1m_r128. Gates:
               the exact rows no miss beyond fp32 ties against a float64
               truth; the IVF and Delta rows within 0.01 of the JAX
               package's CPU recall (BENCH_RECALL_JAX) and their eval batch's
               hits the list scan's plain version's on the row's own build
               (a k-th place tie apart); the 1M rows the TPU record less 0.01
               (BENCH_TPU_GATES). Every route the JAX package's (BENCH_ROUTES).
               Each row prints its route, QPS, ms a batch pipelined, p50/p99,
               recall, gate, recall_ref (the numpy oracle up to 200k rows),
               build_s, device bytes and a profiler trace of 5 of its
               batches (idle share, kernels a batch)

Every list-scan call inverts its probes with the inversion kernel once
(``invert_probes``): on every path its launches equal the list scan's.
The kernels' launch counters are zeroed before each serving path (phases
4-6, the IVF-Flat path; phases 7-8, the IVF-PQ path; phases 9-25, one path
each) and read after it: every kernel of a path must have run on it, the
wide modes (the ``_wide`` counters) on the paths that ask for k > 128 or
R > 128, and the wide modes' first pass and the list scans' floor select
(``flat_scan_prefloor``, ``list_scan_prefloor``, ``floor_select``; the flat
first passes take their floors in their own launch) on the IVF-Flat path
(phase 5 at k 200, nprobe 96; phase 6 at k 200) and the IVF-Flat hybrid
path (phase 11 at R 512, nprobe 96), the bf16 flat scan's
(``flat_scan_bf16_prefloor``) on the flat hybrid k100 path (phase 13). The HNSW beam is plain torch (no Pallas
kernel in the JAX package either): phases 15-16 launch none of
the port's kernels; phase 17 runs K1 and the list scan; phase 18 the list
scan and the merge, launched from the server's worker threads; phase 19's
server is a process of its own, so its kernels are read from its own trace
(the path counts nothing in this process); phase 20 (Flat sq8) runs no
kernel, as the JAX package's sq8 scan reaches no Pallas kernel; phase 21
launches K1 and K1 bf16 (and the merge), phase 22 K1, the list scan and
the merge, once a shard; phases 23 to 25 the list scan, the merge and the
inversion. The 1M corpora's ground truth is float64 on the card. The last
three
lines are the
kernels' JSON record, the card as nvidia-smi names it, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ast
import collections
import concurrent.futures
import contextlib
import glob
import hashlib
import io
import json
import logging
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from pyrope_tpu_torch.types import IndexConfig, IndexParams, Metric, SearchOptions
from pyrope_tpu_torch.utils.datasets import (
    ground_truth,
    id_lists_to_rows,
    recall_at_k,
    synthetic,
    synthetic_clustered,
    synthetic_clustered_queries,
    synthetic_queries,
    synthetic_zipf,
    synthetic_zipf_queries,
)
from pyrope_tpu_torch.utils.stats import LatencySummary
from pyrope_tpu_torch.bench import resp_load
from pyrope_tpu_torch.cache import CachePolicyConfig
from pyrope_tpu_torch.index.flat import FlatIndex
from pyrope_tpu_torch.index.hnsw import (
    DESCENT_BEAM,
    EXPAND_PER_STEP,
    HnswIndex,
    beam_schedule,
    beam_search_body,
)
from pyrope_tpu_torch.index.ivf_flat import DENSE_MAX_ELEMS as IVF_DENSE_MAX_ELEMS
from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex, pick_scan_mode, rank_probes
from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex
from pyrope_tpu_torch.kernels import build as kbuild
from pyrope_tpu_torch.ops import fused_scan as fs
from pyrope_tpu_torch.ops.slab import sq8res_encode
from pyrope_tpu_torch.registry import create_index
from pyrope_tpu_torch.security import AuthSettings
from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine
from pyrope_tpu_torch.server.resp import RespServer, ThreadedServer
from pyrope_tpu_torch.server.resp_client import RespClient
from pyrope_tpu_torch.sidecar.semantic_model import SemanticModelTrainer
from pyrope_tpu_torch.utils import ref_oracle
from pyrope_tpu_torch.utils.parsing import encode_vector

RTOL, ATOL = 1e-5, 1e-4
SQ8_RTOL = 1e-4   # the JAX package's SQ8 kernel tolerance
K = 10
SOURCE = "pyrope_tpu_torch/csrc/fused_scan.cu"
TC_SOURCE = "pyrope_tpu_torch/csrc/flat_scan_tc.cu"
LIST_SOURCE = "pyrope_tpu_torch/csrc/ivf_list_scan.cu"
LIST_TC_SOURCE = "pyrope_tpu_torch/csrc/ivf_list_scan_tc.cu"
LIST_PROMOTE_SOURCE = "pyrope_tpu_torch/csrc/ivf_list_scan_promote.cu"
PREFLOOR_SOURCE = "pyrope_tpu_torch/csrc/prefloor.cu"
INVERT_SOURCE = "pyrope_tpu_torch/csrc/invert_probes.cu"
# the list scan's LAUNCHES keys, one a call (list_partials): each call also
# launches the probe inversion once
LIST_SCAN_KEYS = ("ivf_scan", "ivf_scan_bf16", "ivf_scan_bf16_promote", "ivf_scan_bf16_tc",
                  "sq8_scan",
                  "ivf_scan_wide", "ivf_scan_bf16_wide", "sq8_scan_wide")
PALLAS = "pyrope_tpu/ops/pallas_scan.py"
T_START = time.perf_counter()


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median time of ``fn`` on the card (CUDA events), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(kernel_out, plain_out, what: str, rtol: float = RTOL) -> tuple[float, int]:
    """Hit sets equal, scores within tolerance. A hit may differ only as a
    tie at the k-th place: both scores within tolerance of the k-th score.
    Returns (max |score difference| at equal rank, tie swaps)."""
    kv, ki = (t.cpu().numpy() for t in kernel_out)
    pv, pi = (t.cpu().numpy() for t in plain_out)
    require(kv.shape == pv.shape, f"{what}: shapes {kv.shape} vs {pv.shape}")
    fin = np.isfinite(pv)
    require((np.isfinite(kv) == fin).all(), f"{what}: missing-hit slots differ")
    require(np.allclose(kv[fin], pv[fin], rtol=rtol, atol=ATOL),
            f"{what}: scores differ beyond tolerance")
    swaps = 0
    for b in np.nonzero((np.sort(ki, 1) != np.sort(pi, 1)).any(1))[0]:
        kth = pv[b][fin[b]][-1]
        only = set(ki[b]) ^ set(pi[b])
        score = {**dict(zip(pi[b], pv[b])), **dict(zip(ki[b], kv[b]))}
        require(all(np.isclose(score[r], kth, rtol=rtol, atol=ATOL) for r in only),
                f"{what}: query {b} hit sets differ outside a k-th place tie")
        swaps += len(only) // 2
    err = float(np.abs(kv[fin] - pv[fin]).max()) if fin.any() else 0.0
    return err, swaps


def recall(results, truth, top_k=K) -> float:
    """recall@k of search_batch results against ground-truth rows."""
    rows = id_lists_to_rows([[h.id for h in r] for r in results], top_k)
    return recall_at_k(rows, truth, top_k)


def serve(ix, q_dev: list[torch.Tensor], iters: int, k: int = K,
          options: SearchOptions = SearchOptions()) -> dict:
    """Pipelined device_search throughput (one synchronize at the end) and
    blocking per-batch latency including the rows' fetch to the host."""
    b = q_dev[0].shape[0]
    ix.device_search(q_dev[0], k, options)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [ix.device_search(q_dev[i % len(q_dev)], k, options) for i in range(iters)]
    torch.cuda.synchronize()
    qps = iters * b / (time.perf_counter() - t0)
    del outs
    lat = []
    for i in range(30):
        t0 = time.perf_counter()
        ix.device_search(q_dev[i % len(q_dev)], k, options)[1].cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    s = LatencySummary.from_samples(lat)
    return {"qps": round(qps, 1), "p50_ms": round(s.p50_ms, 3),
            "p99_ms": round(s.p99_ms, 3)}


def exact_misses_are_ties(ix, base, queries, truth, batch=None, k=K) -> tuple[float, int]:
    """Recall@k against float64 ground truth, and the number of misses that
    are not fp32 ties at the k-th place (float64 distance of the returned
    row within 1e-4 of the true k-th distance). ``batch``: search_batch in
    batches of that many queries (None: all at once)."""
    step = batch or len(queries)
    results = [r for s in range(0, len(queries), step)
               for r in ix.search_batch(queries[s:s + step], k)]
    rows = id_lists_to_rows([[h.id for h in r] for r in results], k)
    rec = recall_at_k(rows, truth, k)
    bad = 0
    for b in range(len(queries)):
        extra = set(rows[b]) - set(truth[b])
        if not extra:
            continue
        d = lambda r: float(np.sum((base[r].astype(np.float64) - queries[b]) ** 2))
        kth = d(truth[b][k - 1])
        bad += sum(abs(d(r) - kth) > ATOL for r in extra)
    return rec, bad


# sessions of cuda_trace that returned no CUDA event at first: what the
# profiler's raw results held in it and in the two sessions taken again
PROFILER_MISSES: list = []


def _session(fn, calls: int, activities, pad_s: float):
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        time.sleep(pad_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    raw = collections.Counter(e.device_type().name for e in prof.profiler.kineto_results.events())
    return events, {"events": len(prof.events()), "raw_by_device": dict(raw)}


def cuda_trace(fn, calls: int, cpu: bool = False) -> list:
    """The CUDA events (kernels, copies, memsets) of ``calls`` calls of
    ``fn`` under torch.profiler, after one warm-up; ``cpu``: the CPU
    activity traced too. In the whole smoke a few sessions returned no
    CUDA event at all (PERF.md), so such a session is taken again
    twice: with 50 ms of idle host time at both ends of the window, and
    with the CPU activity on; PROFILER_MISSES records all three and the
    first that recovered gives the events."""
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    events, first = _session(fn, calls, acts, 0.0)
    if events:
        return events
    padded, pad_diag = _session(fn, calls, acts, 0.05)
    with_cpu, cpu_diag = _session(fn, calls, [ProfilerActivity.CPU, ProfilerActivity.CUDA], 0.0)
    free, _ = torch.cuda.mem_get_info()
    PROFILER_MISSES.append({"caller": sys._getframe(2).f_code.co_name, "calls": calls,
                            "cpu_activity": cpu, "first": first, "padded": pad_diag,
                            "with_cpu": cpu_diag, "recovered": bool(padded or with_cpu),
                            "free_bytes": free, "reserved_bytes": torch.cuda.memory_reserved(),
                            "process_s": round(time.perf_counter() - T_START, 1)})
    return padded or with_cpu


def device_shares(fn, iters: int) -> dict:
    """A torch.profiler trace of ``iters`` pipelined calls: the device span
    (first kernel start to last kernel end), the kernels' busy time, the
    idle share of the span, the kernels launched a call (copies and
    memsets apart) and the largest kernels' shares of busy time.
    Where the profiler records no device time, the fields say so."""
    kernels = cuda_trace(fn, iters, cpu=True)
    if not kernels:
        return {"device_time": "not measured"}
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    launches = sum(not e.name.startswith(("Memcpy", "Memset")) for e in kernels)
    return {"span_ms": round(span / 1e3, 3), "busy_ms": round(busy / 1e3, 3),
            "idle_share": round(1.0 - busy / span, 4),
            "kernels_per_call": round(launches / iters, 1),
            "shares": {name: round(us / busy, 4) for name, us in top}}


def device_split(fn, calls: int = 5) -> dict:
    """Device time a call of ``fn`` (a torch.profiler trace of ``calls``
    calls after one warm-up), in all and by kind: the scans, the merges,
    the rest; where a call runs a wide scan and a narrow one, the narrow
    launch is the wide mode's first pass (``pass1_ms``; the flat one takes
    its floors in the same launch) and the list scans' floor select
    (``select_ms``) is apart. Empty where the profiler records no device
    time."""
    split = {"device_ms": 0.0, "scan_ms": 0.0, "merge_ms": 0.0, "pass1_ms": 0.0,
             "select_ms": 0.0}
    narrow = 0.0
    wide = False
    for e in cuda_trace(fn, calls):
        ms = e.time_range.elapsed_us() / calls / 1e3
        split["device_ms"] += ms
        if "floor_select" in e.name:
            split["select_ms"] += ms
        elif "scan" in e.name:   # list_scan[_tc], fused_scan, flat_scan_tc
            m = re.search(r"(list_scan(?:_tc)?|scan(?:_tc)?)_kernel<([^>]*)>", e.name)
            args = m.group(2).replace(" ", "").split(",") if m else []
            # <MODE, WIDE>, <IP, WIDE>; <BT, IP, WIDE[, CAP]>; <NC, IP, WIDE>
            if m and args[1 if m.group(1).startswith("list_scan") else 2] == "false":
                narrow += ms
            else:
                wide |= m is not None
                split["scan_ms"] += ms
        elif "merge" in e.name:
            split["merge_ms"] += ms
    split["pass1_ms" if wide else "scan_ms"] += narrow
    return split if split["device_ms"] > 0 else {}


def flat_entries(fn) -> float:
    """Mean real entries a query's splits hold after a wide flat scan (the
    partials its merge reads: the fp32 lists' fill counts, the bf16 ones'
    entries before their pads), off one call of ``fn``."""
    seen = []
    launch = fs._merge_launch

    def counting(part_v, part_i, s, b, k, qend, *rest):
        if qend is None:
            fills = rest[-1] if len(rest) == 5 else None
            real = fills.sum() if fills is not None else torch.isfinite(part_v).sum()
            seen.append(float(real) / max(b, 1))
        return launch(part_v, part_i, s, b, k, qend, *rest)

    fs._merge_launch = counting
    try:
        fn()
    finally:
        fs._merge_launch = launch
    return seen[-1] if seen else 0.0


def slot_entries(partials) -> float:
    """Mean real entries a query's partial slots hold after a list scan
    (``fs.list_partials``' output)."""
    part_v, _, slot_end = partials
    return float(torch.isfinite(part_v[:int(slot_end[-1, -1])]).sum()) / slot_end.shape[0]


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("1 device", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], card=repr(smi),
        count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    kbuild.build(verbose=True)
    kbuild.load()
    secs = time.perf_counter() - t0
    regs = [ln.replace("ptxas info", "").strip(" :")
            for ln in kbuild.build_log().splitlines()
            if "registers" in ln or "spill" in ln]
    # the bf16 flat scan's wgmma instructions in the built library's SASS
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(kbuild.library_path())], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs = sass.split("Function : ")[1:]
    hgmma = sum(f.count("HGMMA") for f in funcs if "flat_scan_tc_kernel" in f.split()[0])
    require(hgmma > 0, "the bf16 flat scan's SASS has no HGMMA")
    hgmma_list = sum(f.count("HGMMA") for f in funcs
                     if "ivf_list_scan_tc_kernel" in f.split()[0])
    require(hgmma_list > 0, "the bf16 list scan's SASS has no HGMMA")
    say("2 build", seconds=round(secs, 2), lib=kbuild.library_path().name, hgmma=hgmma,
        hgmma_list=hgmma_list, ptxas=repr("; ".join(regs)))


HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate (data sheet)
FP32_FLOP_S = 67e12     # H100 SXM fp32 rate outside the tensor cores
BF16_FLOP_S = 989e12    # H100 SXM bf16 tensor-core rate, dense


def bound(nbytes: float, flops: float, rate: float = FP32_FLOP_S) -> tuple[float, str]:
    """Least time on the card, ms, and what sets it: each input byte read
    once and each output written once over the memory rate, against the
    operations over the rate of their type (fp32, or bf16 products with
    fp32 sums: the tensor cores')."""
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def merge_wide_bytes(v, qend, k) -> int:
    """Bytes the wide merge must move on these lists (``v``: [B, S, w]
    scores, or [slots, w] rows cut by ``qend``): the entries at or above its
    floor, which it gathers (the floor: over g = 1, 2, 4, ... up to the
    first 256 lists, the g-th largest of their c-th entries, c = ceil(k /
    g) at most w, as merge_wide_kernel takes it; scores compared alone,
    which random scores allow), each level's c-th entries, and the [B, k]
    output; each a score and a row."""
    if qend is not None:   # per-query slots, padded with -inf to [B, most, w]
        qoff = torch.nn.functional.pad(qend[:, -1].long(), (1, 0))
        cnt = qoff.diff()
        j = torch.arange(int(cnt.max()), device=v.device)
        rows = (qoff[:-1, None] + j).clamp(max=v.shape[0] - 1)
        v = torch.where((j < cnt[:, None])[..., None], v[rows], float("-inf"))
    b, s, w = v.shape
    lists = v[:, :256]
    floor = torch.full((b,), float("-inf"), device=v.device)
    reads, g = 0, 1
    while g <= lists.shape[1]:
        c = -(-k // g)
        if c <= w:
            floor = torch.maximum(floor, lists[:, :, c - 1].topk(g, dim=1).values[:, -1])
            reads += b * lists.shape[1]
        g *= 2
    gathered = int((v >= floor[:, None, None]).logical_and_(v > float("-inf")).sum())
    return 8 * (gathered + reads + b * k)


def l2_or_ip(q, dots, sq, ip):
    return dots if ip else -torch.clamp((q * q).sum(1, keepdim=True) - 2.0 * dots
                                        + sq[None, :], min=0.0)


def composition_topk(scores, mask, k):
    """The nearest PyTorch composition of a masked scan + top-k: topk of the
    fp32 scores under torch.where (no single call computes the function)."""
    v, i = torch.topk(torch.where(mask, scores, float("-inf")), k, dim=1)
    return v, torch.where(torch.isfinite(v), i, -1).int()


def layout(n, kp, g, dev, *, big=0, empty=0):
    """A cluster-major crow of n rows over kp clusters: clusters 0..empty-1
    hold no rows, cluster ``empty`` gets ``big`` extra rows. Returns
    (crow, offsets, lens, max_len)."""
    ids = torch.randint(empty, kp, (n - big,), generator=g, device=dev)
    crow = torch.sort(torch.cat([ids, torch.full((big,), empty, device=dev)])).values.int()
    offs, lens = fs.list_csr(crow, kp)
    return crow, offs, lens, int(lens.max())


def probes(b, kp, nprobe, g, dev, *, lo=0, forced=None, every=1):
    """[b, nprobe] distinct probes among clusters lo..kp-1; with ``forced``
    (a cluster id, or a tensor of ids per row) in column 0 of every
    ``every``-th row."""
    p = torch.rand((b, kp - lo), generator=g, device=dev).argsort(1)[:, :nprobe] + lo
    if forced is not None:
        f = forced if torch.is_tensor(forced) else torch.full((b,), forced, device=dev)
        rows = torch.arange(0, b, every, device=dev)
        p[rows, 0] = f[rows]
    return p


def list_bound(x_bytes_per_row, q, probe, lens, alive, crow, kp, k, extra=0,
               rate=FP32_FLOP_S):
    """Bound of an IVF/SQ8 list scan on these inputs: each probed cluster's
    rows read once, the (query, alive row) pairs' FMAs."""
    b, d = q.shape
    used = torch.zeros(kp, dtype=torch.bool, device=q.device)
    used[probe.reshape(-1).long()] = True
    rows = int(lens[used].sum())
    alive_c = torch.zeros(kp, device=q.device).index_add_(0, crow.long(), alive.float())
    pairs = float(alive_c[probe.long()].sum())
    return bound(rows * x_bytes_per_row + b * d * 4 + probe.numel() * 8 + b * k * 8 + extra,
                 2.0 * d * pairs, rate)


def sample_bound(x_bytes_per_row, q, probe, lay, alive, kp, seg, sample, rate):
    """Bound of the list scan's first pass on these inputs: the first
    ``sample`` rows of each ``seg``-row segment of each probed list read
    once, the (query, sampled alive row) pairs' FMAs, the [B] keys out."""
    crow, offs, lens, _ = lay
    b, d = q.shape
    local = torch.arange(crow.shape[0], device=q.device) - offs[crow.long()]
    taken = (local % seg) < sample
    rows_c = torch.zeros(kp, device=q.device).index_add_(0, crow.long(), taken.float())
    alive_c = torch.zeros(kp, device=q.device).index_add_(0, crow.long(),
                                                          (taken & alive).float())
    used = torch.zeros(kp, dtype=torch.bool, device=q.device)
    used[probe.reshape(-1).long()] = True
    pairs = float(alive_c[probe.long()].sum())
    return bound(float(rows_c[used].sum()) * x_bytes_per_row + b * d * 4 + probe.numel() * 8
                 + b * 8, 2.0 * d * pairs, rate)


def phase_kernels(dev) -> dict:
    """Kernel vs plain at the main path's shapes, and the list scan's edge
    cases. Returns the JSON record's measured fields per kernel."""
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    n, d, b = 1_000_000, 128, 1024
    x = torch.rand((n, d), generator=g, device=dev)
    sq = (x * x).sum(1)
    alive = torch.rand(n, generator=g, device=dev) > 0.01
    q = torch.rand((b, d), generator=g, device=dev)
    rec = {kind: {"err": 0.0}
           for kind in ("flat", "ivf", "sq8", "merge", "flat_bf16", "ivf_bf16_tc",
                        "ivf_bf16p", "ivf_bf16p_b1024", "flat_wide", "flat_bf16_wide", "ivf_wide",
                        "ivf_bf16_wide", "ivf_bf16p_wide", "sq8_wide", "ivf_large_d",
                        "sq8_large_d", "merge_wide", "flat_prefloor", "flat_bf16_prefloor",
                        "list_prefloor", "list_prefloor_tc", "floor_select", "invert_probes")}
    cells = []

    def case(kind, name, kern, plain, reps=10, plain_reps=3, main=False, comp=None,
             bnd=None, lib=None, slots=None, entries=None):
        """``slots``: the list scan alone (``fs.list_partials``) on the same
        inputs, for the real entries its slots hold; ``entries``: the same
        count read another way (``flat_entries``)."""
        err, swaps = compare(kern(), plain(), name,
                             SQ8_RTOL if kind.startswith("sq8") else RTOL)
        rec[kind]["err"] = max(rec[kind]["err"], err)
        ms, pms = cuda_ms(kern, reps), cuda_ms(plain, plain_reps)
        cms = cuda_ms(comp, plain_reps) if comp is not None else None
        lms = cuda_ms(lib, reps) if lib is not None else None
        if main:
            rec[kind].update(ms=ms, plain_ms=pms, composition_ms=cms, library_ms=lms)
        cell = f"{name}:{ms:.3f}ms/plain {pms:.3f}ms/err {err:.2e}/ties {swaps}"
        if cms is not None:
            cell += f"/composition {cms:.3f}ms"
        if lms is not None:
            cell += f"/library {lms:.3f}ms"
        if bnd is not None:
            cell += f"/bound {bnd[0]:.4f}ms {bnd[1]}"
        # device time from the profiler beside the wrapper's: the list scans
        # and merges are short enough that the host's share shows
        split = device_split(kern)
        if split:
            cell += f"/device {split['device_ms']:.4f}ms"
            if split["pass1_ms"]:
                cell += (f" (first pass {split['pass1_ms']:.4f} floor select "
                         f"{split['select_ms']:.4f} second pass {split['scan_ms']:.4f} "
                         f"merge {split['merge_ms']:.4f})")
            elif not kind.startswith("merge"):
                cell += f" (scan {split['scan_ms']:.4f} merge {split['merge_ms']:.4f})"
        if kind.startswith("merge") and comp is not None:
            csplit = device_split(comp)
            if csplit:
                cell += f"/composition device {csplit['device_ms']:.4f}ms"
        if main:
            rec[kind]["device_ms"] = split.get("device_ms")
        if slots is not None:
            cell += f"/slot entries {slot_entries(slots()):.1f}"
        if entries is not None:
            cell += f"/split entries {entries():.1f}"
        cells.append(cell)

    rows = torch.arange(n, device=dev)
    for k, ms_cut in ((10, n), (100, n), (10, 600_000)):
        main = k == 10 and ms_cut == n
        case("flat", f"flat_1M_b1024_k{k}_ms{ms_cut}",
             lambda: fs.fused_flat_topk(q, x, sq, alive, ms_cut, k),
             lambda: fs.fused_flat_topk_plain(q, x, sq, alive, ms_cut, k,
                                              chunk_rows=65536),
             main=main, comp=(lambda: composition_topk(
                 l2_or_ip(q, q @ x.T, sq, False), (alive & (rows < ms_cut))[None, :], k))
             if main else None,
             # q @ x.T alone: the product, not the function (no metric, mask,
             # top-k); what fp32 on the CUDA cores reaches through the library
             lib=(lambda: q @ x.T) if main else None,
             bnd=bound(ms_cut * (d * 4 + 5) + b * d * 4 + b * k * 8,
                       2.0 * b * int(alive[:ms_cut].sum()) * d))
    live = int(alive.sum())
    rec["flat"]["bound"] = bound(n * (d * 4 + 5) + b * d * 4 + b * K * 8, 2.0 * b * live * d)
    # small batches (the 64-query tile) and a Delta-head-sized slab
    for name, qv, rows_n in (("flat_1M_b64_k10", q[:64].contiguous(), n),
                             ("flat_1M_b1_k10", q[:1].contiguous(), n),
                             ("flat_8k_b1024_k10", q, 8192)):
        xv, sqv, alv = (t[:rows_n].contiguous() for t in (x, sq, alive))
        bv = qv.shape[0]
        case("flat", name,
             lambda: fs.fused_flat_topk(qv, xv, sqv, alv, rows_n, K),
             lambda: fs.fused_flat_topk_plain(qv, xv, sqv, alv, rows_n, K, chunk_rows=65536),
             bnd=bound(rows_n * (d * 4 + 5) + bv * d * 4 + bv * K * 8,
                       2.0 * bv * int(alv.sum()) * d))
        del xv, sqv, alv

    def ivf_case(name, qv, xv, sqv, alv, lay, kp, probe, k=K, main=False, reps=10,
                 comp=False, kind="ivf", plain_reps=3, lib=None):
        crow, offs, lens, ml = lay
        bnd = list_bound(xv.shape[1] * 4 + 5, qv, probe, lens, alv, crow, kp, k)
        case(kind, name,
             lambda: fs.fused_ivf_topk(qv, xv, sqv, alv, crow, offs, lens, probe, kp, k,
                                       max_len=ml),
             lambda: fs.fused_ivf_topk_plain(qv, xv, sqv, alv, crow, probe, kp, k,
                                             chunk_rows=65536),
             reps=reps, plain_reps=plain_reps, main=main, comp=(lambda: composition_topk(
                 l2_or_ip(qv, qv @ xv.T, sqv, False),
                 fs.probe_table(probe, kp)[:, crow.long()] & alv[None, :], k))
             if main or comp else None, bnd=bnd, lib=lib,
             slots=(lambda: fs.list_partials(qv, xv, sqv, alv, offs, lens, probe, kp, k,
                                             False, ml)) if k > fs.NARROW_MAX_K else None)
        if main:
            rec[kind]["bound"] = bnd

    def sq8_case(name, qv, xv, alv, lay, kp, probe, metric="L2", k=K, main=False,
                 reps=10, comp=False, kind="sq8", cents=None, plain_reps=3):
        crow, offs, lens, ml = lay
        if cents is None:
            cents = xv[torch.randint(0, xv.shape[0], (kp,), generator=g, device=dev)]
        codes, mins, scales, sq8 = sq8res_encode(xv, cents, crow)
        qc = qv @ cents.T
        ip = metric == "IP"
        bnd = list_bound(xv.shape[1] + 13, qv, probe, lens, alv, crow, kp, k,
                         extra=probe.numel() * 4)
        # the library call beside a main case: the bare q @ x̂ᵀ over the
        # reconstructed fp32 rows x̂ = cent[crow] + min + scale·code, as K2's
        # row has q @ x.T (the product alone: no metric, mask or top-k)
        xhat = (cents[crow.long()] + mins[:, None] + scales[:, None] * codes.float()
                if main else None)
        case(kind, f"{name}_{metric}",
             lambda: fs.fused_ivf_sq8_topk(qv, codes, mins, scales, sq8, alv, crow, offs,
                                           lens, probe, qc, kp, k, metric, max_len=ml),
             lambda: fs.fused_ivf_sq8_topk_plain(qv, codes, mins, scales, sq8, alv, crow,
                                                 probe, qc, kp, k, metric,
                                                 chunk_rows=65536),
             reps=reps, plain_reps=plain_reps, main=main, comp=(lambda: composition_topk(
                 fs.sq8_scores(qv, qc, codes, mins, scales, sq8, crow, ip),
                 fs.probe_table(probe, kp)[:, crow.long()] & alv[None, :], k))
             if main or comp else None, bnd=bnd,
             slots=(lambda: fs.list_partials(qv, codes, sq8, alv, offs, lens, probe, kp, k,
                                             ip, ml, sq8=(mins, scales, qc)))
             if k > fs.NARROW_MAX_K else None,
             lib=(lambda: qv @ xhat.T) if main else None)
        del xhat
        if main:
            rec[kind]["bound"] = bnd

    kp = 1000
    lay = layout(n, kp, g, dev)
    for nprobe in (3, 32):
        ivf_case(f"ivf_1M_nlist1000_np{nprobe}_b1024", q, x, sq, alive, lay, kp,
                 probes(b, kp, nprobe, g, dev), main=(nprobe == 3),
                 lib=(lambda: q @ x.T) if nprobe == 3 else None)
    n2, b2, kp2 = 100_000, 4096, 100
    x2, sq2, alive2 = x[:n2].contiguous(), sq[:n2].contiguous(), alive[:n2].contiguous()
    q2 = torch.rand((b2, d), generator=g, device=dev)
    ivf_case("ivf_100k_nlist100_np96_b4096", q2, x2, sq2, alive2, layout(n2, kp2, g, dev),
             kp2, probes(b2, kp2, 96, g, dev), reps=5, comp=True)
    # the SQ8 scan: x stored as residual SQ8 against one centroid per cluster
    for n_s, kp_s in ((n, 1000), (100_000, 100)):
        lay_s = lay if n_s == n else layout(n_s, kp_s, g, dev)
        probe_s = probes(b, kp_s, 3, g, dev)
        for metric in ("L2", "IP"):
            sq8_case(f"sq8_{n_s // 1000}k_nlist{kp_s}_np3_b1024", q, x[:n_s],
                     alive[:n_s].contiguous(), lay_s, kp_s, probe_s, metric,
                     main=(n_s == n and metric == "L2"), comp=(metric == "L2"))

    # edge cases of the list scan's work layout, both modes, held to the same
    # tolerances
    skew = layout(n, kp, g, dev, big=50_000)        # one 50k-row list
    p_skew = probes(b, kp, 3, g, dev, lo=1, forced=0, every=2)
    p_skew96 = probes(b, kp, 96, g, dev, lo=1, forced=0, every=2)
    few = layout(100_000, 100, g, dev, empty=10)     # 90 non-empty lists
    holes = layout(n, kp, g, dev, empty=100)         # 100 empty lists, probed
    p_holes = probes(b, kp, 3, g, dev, lo=100, every=3,
                     forced=torch.randint(0, 100, (b,), generator=g, device=dev))
    p_main = probes(b, kp, 3, g, dev)
    dead = alive & (torch.rand(n, generator=g, device=dev) > 0.3)
    crow_m, offs_m = lay[0], lay[1]
    c1, c2 = int(p_main[0, 0]), int(p_main[0, 1])  # a row copied across two lists
    r1, r2 = int(offs_m[c1]), int(offs_m[c2])
    xd, qd = x.clone(), q.clone()
    xd[r2] = xd[r1]
    qd[0] = xd[r1]
    sqd = (xd * xd).sum(1)
    for name, args in (
        ("skewed_50k_np3_b1024", (q, x, sq, alive, skew, kp, p_skew)),
        ("skewed_50k_np96_k128_b1024", (q, x, sq, alive, skew, kp, p_skew96)),
        ("nprobe100_ge_90_lists_b256", (q[:256], x2, sq2, alive2, few, 100,
                                        probes(256, 100, 100, g, dev))),
        ("empty_lists_probed_np3_b1024", (q, x, sq, alive, holes, kp, p_holes)),
        ("ragged_b1000_np3", (q[:1000], x, sq, alive, lay, kp, p_main[:1000])),
        ("k128_np3_b1024", (q, x, sq, alive, lay, kp, p_main)),
        ("dup_rows_two_lists_np3_b1024", (qd, xd, sqd, alive, lay, kp, p_main)),
        ("tombstones_30pct_np3_b1024", (q, x, sq, dead, lay, kp, p_main)),
    ):
        qv, xv, sqv, alv, lay_e, kp_e, probe = args
        k = 128 if "k128" in name else K
        ivf_case(f"ivf_{name}", qv, xv, sqv, alv, lay_e, kp_e, probe, k=k, reps=3)
        sq8_case(f"sq8_{name}", qv, xv, alv, lay_e, kp_e, probe, k=k, reps=3)
    del xd

    # the bf16 slab modes at the shapes of phases 9-12: rows rounded to bf16,
    # sqnorm of the fp32 rows; the composition scores bf16(q)·x (or q·x with
    # promote) in fp32 and takes torch.topk; the library call is the bare
    # bf16 product q16 @ x16.T (bf16 sums: not the function, a yardstick)
    x16 = x.bfloat16()
    q16 = q.bfloat16()
    for name, bv, k, main, metric in (("flat_bf16_1M_b1024_k10", b, K, True, "L2"),
                                      ("flat_bf16_1M_b1024_k10_IP", b, K, False, "IP"),
                                      ("flat_bf16_1M_b64_k10", 64, K, False, "L2"),
                                      ("flat_bf16_1M_b64_k64", 64, 64, False, "L2")):
        qv, qv16 = q[:bv].contiguous(), q16[:bv].contiguous()
        bnd = bound(n * (d * 2 + 5) + bv * d * 4 + bv * k * 8, 2.0 * bv * live * d,
                    BF16_FLOP_S)
        if main:
            rec["flat_bf16"]["bound"] = bnd
        case("flat_bf16", name,
             lambda: fs.fused_flat_topk(qv, x16, sq, alive, n, k, metric),
             lambda: fs.fused_flat_topk_plain(qv, x16, sq, alive, n, k, metric,
                                              chunk_rows=65536),
             main=main,
             comp=lambda: composition_topk(l2_or_ip(qv, qv16.float() @ x16.float().T, sq,
                                                    metric == "IP"), alive[None, :], k),
             lib=lambda: qv16 @ x16.T, bnd=bnd)
    # without promote: the IVF-Flat hybrid's shortlist scan (100k, nprobe 96,
    # k 64) on the tensor cores (ivf_list_scan_tc.cu, with its first pass)
    x2_16 = x2.bfloat16()
    lay2 = layout(n2, kp2, g, dev)
    q3 = q2[:256].contiguous()
    q3_16 = q3.bfloat16()
    p3 = probes(256, kp2, 96, g, dev)
    bnd = list_bound(d * 2 + 5, q3, p3, lay2[2], alive2, lay2[0], kp2, 64, rate=BF16_FLOP_S)
    rec["ivf_bf16_tc"]["bound"] = bnd
    case("ivf_bf16_tc", "ivf_bf16_100k_nlist100_np96_b256_k64",
         lambda: fs.fused_ivf_topk(q3, x2_16, sq2, alive2, lay2[0], lay2[1], lay2[2], p3,
                                   kp2, 64, max_len=lay2[3]),
         lambda: fs.fused_ivf_topk_plain(q3, x2_16, sq2, alive2, lay2[0], p3, kp2, 64,
                                         chunk_rows=65536),
         main=True, bnd=bnd, lib=lambda: q3_16 @ x2_16.T,
         comp=lambda: composition_topk(
             l2_or_ip(q3, q3_16.float() @ x2_16.float().T, sq2, False),
             fs.probe_table(p3, kp2)[:, lay2[0].long()] & alive2[None, :], 64),
         slots=lambda: fs.list_partials(q3, x2_16, sq2, alive2, lay2[1], lay2[2], p3, kp2,
                                        64, False, lay2[3]))
    # with promote: IVF-PQ's bf16 rerank slab scanned exactly (1M, nprobe 3, k 10)
    q4 = q[:64].contiguous()
    q4_16 = q4.bfloat16()
    p4 = probes(64, kp, 3, g, dev)
    bnd = list_bound(d * 2 + 5, q4, p4, lay[2], alive, lay[0], kp, K)
    rec["ivf_bf16p"]["bound"] = bnd
    case("ivf_bf16p", "ivf_bf16_promote_1M_nlist1000_np3_b64_k10",
         lambda: fs.fused_ivf_topk(q4, x16, sq, alive, lay[0], lay[1], lay[2], p4, kp, K,
                                   max_len=lay[3], promote_fp32=True),
         lambda: fs.fused_ivf_topk_plain(q4, x16, sq, alive, lay[0], p4, kp, K,
                                         promote_fp32=True, chunk_rows=65536),
         main=True, bnd=bnd, lib=lambda: q4_16 @ x16.T,
         comp=lambda: composition_topk(
             l2_or_ip(q4, q4 @ x16.float().T, sq, False),
             fs.probe_table(p4, kp)[:, lay[0].long()] & alive[None, :], K))
    # the same at b1024 (p_main: ~95% of the lists), where the device time
    # sets the pace
    bnd = list_bound(d * 2 + 5, q, p_main, lay[2], alive, lay[0], kp, K)
    rec["ivf_bf16p_b1024"]["bound"] = bnd
    case("ivf_bf16p_b1024", "ivf_bf16_promote_1M_nlist1000_np3_b1024_k10",
         lambda: fs.fused_ivf_topk(q, x16, sq, alive, lay[0], lay[1], lay[2], p_main, kp, K,
                                   max_len=lay[3], promote_fp32=True),
         lambda: fs.fused_ivf_topk_plain(q, x16, sq, alive, lay[0], p_main, kp, K,
                                         promote_fp32=True, chunk_rows=65536),
         main=True, bnd=bnd, plain_reps=1, lib=lambda: q16 @ x16.T,
         comp=lambda: composition_topk(
             l2_or_ip(q, q @ x16.float().T, sq, False),
             fs.probe_table(p_main, kp)[:, lay[0].long()] & alive[None, :], K))
    require(fs.list_plan(K, fs.LIST_BF16, True, b, 3, kp, lay[3], d,
                         fs.device_sms(dev)).promote,
            "the b1024 promote call does not take the promote kernel")

    # ---- the wide modes (k > 128): flat scan, list scan in every mode ----
    for kind, name, bv, k, xs in (
            ("flat_wide", "flat_wide_1M_b1024_k1000", b, 1000, x),
            ("flat_bf16_wide", "flat_bf16_wide_1M_b256_k512", 256, 512, x16),
            ("flat_wide", "flat_wide_1M_b64_k10000", 64, 10_000, x)):
        qv = q[:bv].contiguous()
        bf = xs.dtype == torch.bfloat16
        main = name in ("flat_wide_1M_b1024_k1000", "flat_bf16_wide_1M_b256_k512")
        bnd = bound(n * (d * xs.element_size() + 5) + bv * d * 4 + bv * k * 8,
                    2.0 * bv * live * d, BF16_FLOP_S if bf else FP32_FLOP_S)
        if main:
            rec[kind]["bound"] = bnd
        qlib = qv.bfloat16() if bf else qv
        case(kind, name,
             lambda: fs.fused_flat_topk(qv, xs, sq, alive, n, k),
             lambda: fs.fused_flat_topk_plain(qv, xs, sq, alive, n, k, chunk_rows=65536),
             reps=5, plain_reps=2, main=main, bnd=bnd, lib=lambda: qlib @ xs.T,
             comp=lambda: composition_topk(l2_or_ip(
                 qv, (qv.bfloat16().float() @ xs.float().T) if bf else qv @ xs.T, sq, False),
                 alive[None, :], k),
             entries=lambda: flat_entries(lambda: fs.fused_flat_topk(qv, xs, sq, alive, n, k)))
    # layout B (about 3 queries a cluster) and layout A (~980 a cluster) at k 1000
    ivf_case("ivf_wide_1M_nlist1000_np3_b1024_k1000", q, x, sq, alive, lay, kp, p_main,
             k=1000, main=True, reps=5, comp=True, kind="ivf_wide", lib=lambda: q @ x.T)
    q5 = q2[:1024].contiguous()
    p5 = probes(1024, kp2, 96, g, dev)
    # torch.topk alone on the masked scores, computed once, beside it
    masked5 = torch.where(fs.probe_table(p5, kp2)[:, lay2[0].long()] & alive2[None, :],
                          l2_or_ip(q5, q5 @ x2.T, sq2, False), float("-inf"))
    ivf_case("ivf_wide_100k_nlist100_np96_b1024_k1000", q5, x2, sq2, alive2, lay2, kp2, p5,
             k=1000, reps=5, comp=True, kind="ivf_wide",
             lib=lambda: torch.topk(masked5, 1000, dim=1))
    del masked5
    # the IVF-Flat hybrid's shortlist scan at k 100 (R 512), no promote
    bnd = list_bound(d * 2 + 5, q3, p3, lay2[2], alive2, lay2[0], kp2, 512, rate=BF16_FLOP_S)
    rec["ivf_bf16_wide"]["bound"] = bnd
    case("ivf_bf16_wide", "ivf_bf16_wide_100k_nlist100_np96_b256_k512",
         lambda: fs.fused_ivf_topk(q3, x2_16, sq2, alive2, lay2[0], lay2[1], lay2[2], p3,
                                   kp2, 512, max_len=lay2[3]),
         lambda: fs.fused_ivf_topk_plain(q3, x2_16, sq2, alive2, lay2[0], p3, kp2, 512,
                                         chunk_rows=65536),
         main=True, bnd=bnd, reps=5, lib=lambda: q3_16 @ x2_16.T,
         comp=lambda: composition_topk(
             l2_or_ip(q3, q3_16.float() @ x2_16.float().T, sq2, False),
             fs.probe_table(p3, kp2)[:, lay2[0].long()] & alive2[None, :], 512),
         slots=lambda: fs.list_partials(q3, x2_16, sq2, alive2, lay2[1], lay2[2], p3, kp2,
                                        512, False, lay2[3]))
    # with promote at k 200: IVF-PQ's bf16 rerank slab scanned exactly
    bnd = list_bound(d * 2 + 5, q4, p4, lay[2], alive, lay[0], kp, 200)
    rec["ivf_bf16p_wide"]["bound"] = bnd
    case("ivf_bf16p_wide", "ivf_bf16_promote_wide_1M_nlist1000_np3_b64_k200",
         lambda: fs.fused_ivf_topk(q4, x16, sq, alive, lay[0], lay[1], lay[2], p4, kp, 200,
                                   max_len=lay[3], promote_fp32=True),
         lambda: fs.fused_ivf_topk_plain(q4, x16, sq, alive, lay[0], p4, kp, 200,
                                         promote_fp32=True, chunk_rows=65536),
         main=True, bnd=bnd, reps=5, lib=lambda: q4_16 @ x16.T,
         comp=lambda: composition_topk(
             l2_or_ip(q4, q4 @ x16.float().T, sq, False),
             fs.probe_table(p4, kp)[:, lay[0].long()] & alive[None, :], 200),
         slots=lambda: fs.list_partials(q4, x16, sq, alive, lay[1], lay[2], p4, kp, 200,
                                        False, lay[3], promote=True))
    sq8_case("sq8_wide_100k_nlist100_np96_b1024_k200", q5, x2, alive2, lay2, kp2, p5,
             k=200, main=True, reps=5, comp=True, kind="sq8_wide")

    # the first pass alone, each against its plain version (the floors'
    # scores to the fp32 tolerance: the plain scores sum in another order),
    # and its floors, taken in its own launch, bit-equal to the plain select
    # over what it published: the fp32 flat scan's at b1024 k1000 and b64
    # k10,000, the bf16 flat scan's (the tensor cores') at b256 k512 (the
    # Flat hybrid's R 512), the list scan's at 100k np96 b1024 k1000 (layout
    # A) and bf16 b256 k512 (the IVF hybrid's R 512), and the tensor-core
    # list scan's at bf16 b256 k64 (the hybrid's narrow shortlist)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    as_hits = lambda f: (f[:, None], torch.zeros((f.shape[0], 1), dtype=torch.int32,
                                                 device=dev))
    for bv, k, xs in ((b, 1000, x), (64, 10_000, x), (256, 512, x16)):
        qv = q[:bv].contiguous()
        bf = xs.dtype == torch.bfloat16
        kind = "flat_bf16_prefloor" if bf else "flat_prefloor"
        main = bv == b or bf
        plan = fs.flat_prefloor_plan(k, bv, d, n, sms, xs.element_size())
        require(plan is not None, f"no first pass at b{bv} k{k} ({xs.dtype})")
        sampled = torch.zeros(n, dtype=torch.bool, device=dev)
        for s0 in range(plan.splits):
            sampled[s0 * plan.per:s0 * plan.per + plan.rows] = True
        bnd = bound(int(sampled.sum()) * (d * xs.element_size() + 5) + bv * d * 4 + bv * 4,
                    2.0 * bv * int((sampled & alive).sum()) * d,
                    BF16_FLOP_S if bf else FP32_FLOP_S)
        if main:
            rec[kind]["bound"] = bnd
        # the library call: torch.topk at k = c over the sampled rows' scores
        qd = qv.bfloat16().float() if bf else qv
        sampled_sc = (torch.where(alive[sampled][None, :], l2_or_ip(
            qv, qd @ xs[sampled].float().T, sq[sampled], False), float("-inf"))
            if main else None)
        case(kind, f"flat{'_bf16' if bf else ''}_first_pass_1M_b{bv}_k{k}_c{plan.c}_g{plan.g}"
             f"_rows{plan.rows}of{plan.per}",
             lambda: as_hits(fs.flat_prefloor(qv, xs, sq, alive, n, plan)),
             lambda: as_hits(fs.flat_prefloor_plain(qv, xs, sq, alive, n, plan)),
             reps=5, plain_reps=2, main=main, bnd=bnd,
             lib=(lambda: torch.topk(sampled_sc, plan.c, dim=1)) if main else None)
        del sampled_sc
        floors, pub = fs.flat_prefloor(qv, xs, sq, alive, n, plan, published=True)
        require(torch.equal(floors, fs.floor_select_plain(pub, plan.g)),
                f"flat first pass b{bv} k{k}: its floors differ from the plain select's")
        cells[-1] += f"/floors = plain select over [{bv}, {plan.splits}]"
        if bf:   # the floor's plain version alone (the kernel takes it in the pass)
            cells[-1] += (f"/floor select plain "
                          f"{cuda_ms(lambda: fs.floor_select_plain(pub, plan.g), 10):.4f}ms")
    for name, qv, xv, k, bf in (("100k_np96_b1024_k1000", q5, x2, 1000, False),
                                ("bf16_100k_np96_b256_k512", q3, x2_16, 512, True),
                                ("bf16_100k_np96_b256_k64", q3, x2_16, 64, True)):
        pv_ = p5 if qv is q5 else p3
        keys, plan = fs.list_prefloor(qv, xv, sq2, alive2, lay2[1], lay2[2], pv_, kp2, k,
                                      False, lay2[3])
        require(plan is not None, f"no list first pass at {name}")
        qd = qv.bfloat16().float() if bf else qv
        scores = l2_or_ip(qv, qd @ xv.float().T, sq2, False)
        # the segments of the kernel the call takes
        lp = fs.list_plan(k, fs.LIST_BF16 if bf else fs.LIST_IVF, False, qv.shape[0], 96,
                          kp2, lay2[3], d, sms)
        tc, seg = lp.tc, lp.seg
        bnd = sample_bound(d * (2 if bf else 4) + 5, qv, pv_, lay2, alive2, kp2, seg,
                           plan.sample, BF16_FLOP_S if bf else FP32_FLOP_S)
        kind = "list_prefloor_tc" if tc else "list_prefloor"
        main = tc or not bf
        if main:
            rec[kind]["bound"] = bnd
        # the library call: torch.topk at k = c over the sampled rows' scores
        # (the first plan.sample rows of each segment, alive, in any list)
        local = torch.arange(n2, device=dev) - lay2[1][lay2[0].long()]
        taken = ((local % seg) < plan.sample) & alive2
        sampled_sc = scores[:, taken].contiguous() if main else None
        case(kind, f"list_first_pass_{name}_c{plan.c}_g{plan.g}_rows{plan.sample}",
             lambda: as_hits(fs.entry_of(fs.list_prefloor(
                 qv, xv, sq2, alive2, lay2[1], lay2[2], pv_, kp2, k, False, lay2[3])[0])[0]),
             lambda: as_hits(fs.entry_of(fs.list_prefloor_plain(
                 scores, alive2, lay2[0], lay2[1], lay2[2], pv_, seg, plan))[0]),
             reps=5, plain_reps=1, main=main, bnd=bnd,
             lib=(lambda: torch.topk(sampled_sc, plan.c, dim=1)) if main else None)
        del scores, sampled_sc
        floors, _, (keys, slot_end) = fs.list_prefloor(
            qv, xv, sq2, alive2, lay2[1], lay2[2], pv_, kp2, k, False, lay2[3], published=True)
        slots = keys.shape[0] - qv.shape[0]
        require(torch.equal(floors, fs.floor_select_plain(keys[:slots], plan.g, slot_end,
                                                          keys[slots:])),
                f"list first pass {name}: its floors differ from the plain select's")
        cells[-1] += f"/floors = plain select over {slots} slots"
    del x16, x2_16
    # the list floor select alone (csrc/prefloor.cu): the list scan's 96
    # slot keys a query (g 72); the library's torch.kthvalue of the same
    # keys timed through the same wrapping (entry_of)
    keys5 = fs.key_of(torch.rand((b * 96,), generator=g, device=dev),
                      torch.randperm(b * 96, device=dev).int())
    qend5 = (torch.arange(1, b + 1, device=dev, dtype=torch.int32) * 96).view(b, 1)
    bnd = bound(b * 96 * 8 + b * 8, 0.0)
    rec["floor_select"]["bound"] = bnd
    case("floor_select", "floor_select_list_b1024_96slots_g72",
         lambda: as_hits(fs.entry_of(fs.floor_select_list(keys5, 72, qend5))[0]),
         lambda: as_hits(fs.entry_of(fs.floor_select_plain(keys5, 72, qend5))[0]),
         reps=20, plain_reps=10, main=True, bnd=bnd,
         lib=lambda: as_hits(fs.entry_of(fs._unsigned_order(torch.kthvalue(
             fs._unsigned_order(keys5).view(b, 96), 96 - 72 + 1, dim=1).values))[0]))

    # the probe inversion alone (csrc/invert_probes.cu) against its plain
    # version (the torch invert_probes) on the same probes: every table
    # bit-equal, at the list-scan calls' shapes: the slice's b1024 np3 (kp
    # 1000, the CUDA-core segment), the serving b1, the IVF hybrid's b256
    # np96 (kp 100, the tensor-core segment) and phase 5's b4096 np96
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def inversion_case(name, probe, lay_i, kp_i, seg_i, main=False):
        _, _, lens_i, ml_i = lay_i
        n_i = lay_i[0].shape[0]
        kern = lambda: fs.invert_probes(probe, lens_i, kp_i, ml_i, seg_i, n_i)
        plain = lambda: fs.invert_probes_plain(probe, lens_i, kp_i, ml_i, seg_i, n_i)
        got, want = kern(), plain()
        for table in ("pairs", "cstart", "ccnt", "item_end", "item_c", "slot_end"):
            require(torch.equal(getattr(got, table), getattr(want, table)),
                    f"inversion {name}: {table} differs from the plain version's")
        ms, pms = cuda_ms(kern, 20), cuda_ms(plain, 10)
        split = device_split(kern)
        pairs = probe.numel()
        # probe and lens read once; pairs, slot_end, three [kp] tables and
        # item_c written once
        bnd = bound(pairs * probe.element_size() + kp_i * 4 + 2 * pairs * 4 + 3 * kp_i * 4
                    + got.grid * 4, 0.0)
        if main:
            rec["invert_probes"].update(ms=ms, plain_ms=pms, composition_ms=None,
                                        library_ms=None, device_ms=split.get("device_ms"),
                                        bound=bnd)
        cells.append(f"{name}:{ms:.3f}ms/plain {pms:.3f}ms/err 0/ties 0/bound "
                     f"{bnd[0]:.2e}ms {bnd[1]}/device {split.get('device_ms', 0.0):.4f}ms"
                     f"/grid {got.grid} seg {seg_i}")

    inversion_case("invert_1M_nlist1000_np3_b1024", p_main, lay, kp,
                   fs.list_plan(K, fs.LIST_IVF, False, b, 3, kp, lay[3], d, sms).seg,
                   main=True)
    inversion_case("invert_1M_nlist1000_np3_b1", p_main[:1].contiguous(), lay, kp,
                   fs.list_plan(K, fs.LIST_IVF, False, 1, 3, kp, lay[3], d, sms).seg)
    inversion_case("invert_100k_nlist100_np96_b256_tc", p3, lay2, kp2,
                   fs.list_plan(64, fs.LIST_BF16, False, 256, 96, kp2, lay2[3], d, sms).seg)
    # (its own generator: the later cases' inputs stay as they were)
    p6 = probes(b2, kp2, 96, torch.Generator(device=dev).manual_seed(96), dev)
    inversion_case("invert_100k_nlist100_np96_b4096", p6, lay2, kp2,
                   fs.list_plan(K, fs.LIST_IVF, False, b2, 96, kp2, lay2[3], d, sms).seg)

    # the merge alone, on partials of the slice's shape: each query's slots
    # (its lists' segments) from the list scan's inversion of the main probes
    seg = fs.list_seg(b, 3, kp, lay[3], sms)
    qend = fs.invert_probes(p_main, lay[2], kp, lay[3], seg, n).slot_end
    lists = int(qend[-1, -1])
    pv = torch.rand((lists, K), generator=g, device=dev).sort(1, descending=True).values
    pi = torch.randint(0, n, (lists, K), generator=g, device=dev).int()
    case("merge", f"merge_{lists}lists_b1024_k10",
         lambda: fs.merge_partials(pv, pi, qend), lambda: fs.merge_partials_plain(pv, pi, qend),
         reps=20, plain_reps=10, main=True, comp=lambda: torch.topk(
             pv[:lists // b * b].reshape(b, -1), K, dim=1))
    rec["merge"]["bound"] = bound(lists * K * 8 + (b + 1) * 4 + b * K * 8, 0.0)
    cells[-1] += f"/bound {rec['merge']['bound'][0]:.4f}ms bytes"
    # the merge on the flat path's partials at b1024: [B, splits, k], the
    # layout and split count fused_flat_topk hands it
    splits = fs.scan_splits(b, n, dev, fs.flat_tile(d, K, b)[0])[1]
    fv = torch.rand((b, splits, K), generator=g, device=dev).sort(2, descending=True).values
    fi = torch.randint(0, n, (b, splits, K), generator=g, device=dev).int()
    sbk = (fv.permute(1, 0, 2).contiguous(), fi.permute(1, 0, 2).contiguous())
    case("merge", f"merge_flat_{splits}splits_b1024_k10",
         lambda: fs._merge_launch(fv, fi, splits, b, K, None, 0, splits * K, K),
         lambda: fs.merge_partials_plain(*sbk), reps=20, plain_reps=10,
         comp=lambda: torch.topk(fv.view(b, -1), K, dim=1),
         bnd=bound(b * splits * K * 8 + b * K * 8, 0.0))
    del fv, fi, sbk

    # the wide merge: the flat path's [B, splits, k] at b1024 k1000, and the
    # list scan's slots of min(k, seg, max_len) entries (layout A case above)
    kw = 1000
    splits = fs.scan_splits(b, n, dev, fs.FLAT_WIDE_TILE, kw)[1]
    fv = torch.rand((b, splits, kw), generator=g, device=dev).sort(2, descending=True).values
    fi = torch.randint(0, n, (b, splits, kw), generator=g, device=dev).int()
    bnd = bound(merge_wide_bytes(fv, None, kw), 0.0)   # what its floor leaves to read
    rec["merge_wide"]["bound"] = bnd
    case("merge_wide", f"merge_wide_flat_{splits}splits_b1024_k{kw}",
         lambda: fs._merge_launch(fv, fi, splits, b, kw, None, 0, splits * kw, kw),
         lambda: fs.merge_partials_plain(fv.permute(1, 0, 2), fi.permute(1, 0, 2)),
         reps=5, plain_reps=2, main=True, bnd=bnd,
         comp=lambda: torch.topk(fv.view(b, -1), kw, dim=1))
    del fv, fi
    seg = fs.list_seg(1024, 96, kp2, lay2[3], sms)
    qend = fs.invert_probes(p5, lay2[2], kp2, lay2[3], seg, n2).slot_end
    width = fs.list_slot_width(kw, seg, lay2[3])
    lists = int(qend[-1, -1])
    pv = torch.rand((lists, width), generator=g, device=dev).sort(1, descending=True).values
    pi = torch.randint(0, n2, (lists, width), generator=g, device=dev).int()
    case("merge_wide", f"merge_wide_{lists}slots_w{width}_b1024_k{kw}",
         lambda: fs.merge_partials(pv, pi, qend, kw),
         lambda: fs.merge_partials_plain(pv, pi, qend, kw), reps=5, plain_reps=2,
         bnd=bound(merge_wide_bytes(pv, qend, kw) + 1024 * 4, 0.0),
         comp=lambda: torch.topk(pv[:lists // 1024 * 1024].reshape(1024, -1), kw, dim=1))
    del pv, pi

    # the list scan at large D: ivf1m_d768_b1024's scan, 1M x 768 clustered
    # rows (1000 centers, spread 0.05, made here on the card) in cluster-major
    # order, each query's 3 nearest centers probed; then the SQ8 mode on the
    # same rows, residuals against the centers
    d7 = 768
    cents7 = torch.rand((kp, d7), generator=g, device=dev)
    assign = torch.sort(torch.randint(0, kp, (n,), generator=g, device=dev)).values
    x7 = cents7[assign].add_(torch.randn((n, d7), generator=g, device=dev), alpha=0.05)
    sq7 = (x7 * x7).sum(1)
    q7 = cents7[torch.randint(0, kp, (b,), generator=g, device=dev)].add_(
        torch.randn((b, d7), generator=g, device=dev), alpha=0.05)
    crow7 = assign.int()
    offs7, lens7 = fs.list_csr(crow7, kp)
    lay7 = (crow7, offs7, lens7, int(lens7.max()))
    p7 = torch.cdist(q7, cents7).topk(3, dim=1, largest=False).indices
    ivf_case("ivf_large_d_1M_d768_nlist1000_np3_b1024_k10", q7, x7, sq7, alive, lay7, kp,
             p7, main=True, reps=5, plain_reps=2, comp=True, kind="ivf_large_d",
             lib=lambda: q7 @ x7.T)
    sq8_case("sq8_large_d_1M_d768_nlist1000_np3_b1024_k10", q7, x7, alive, lay7, kp, p7,
             main=True, reps=5, plain_reps=2, comp=True, kind="sq8_large_d", cents=cents7)
    del x7, sq7
    say("3 kernels", cells=repr(" | ".join(cells)))
    phase_kpp(dev)
    return rec


def phase_kpp(dev) -> None:
    """k-means++ seeding (jax.random's draws) on the card and on the CPU
    from one seed, on 100k clustered rows, k 100: the rows both pick. The
    draw compares log D² plus Gumbel noise; where the card rounds D² (its
    matvec sums in another order) or log otherwise than the CPU, a pick
    can differ, and every later pick with it. Printed, not a gate."""
    from pyrope_tpu_torch.ops.kmeans import _kpp_init

    data = synthetic_clustered(100_000, 128, n_clusters=100)
    x_cpu = torch.from_numpy(data)
    t0 = time.perf_counter()
    on_card = _kpp_init(x_cpu.to(dev), 100, 42).cpu()
    card_s = time.perf_counter() - t0
    on_cpu = _kpp_init(x_cpu, 100, 42)
    same = (on_card == on_cpu).all(dim=1)
    first = int((~same).nonzero()[0]) if not bool(same.all()) else None
    say("3 kmeans++", rows=100_000, k=100, seed=42, same_picks=int(same.sum()),
        first_differing_pick=first, card_seconds=round(card_s, 3))


def clustered_1m() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 1M x 128 clustered corpus of phases 4 and 7 (1000 centers), 8192
    queries, and the ground truth of the first 1024 (float64 on the card)."""
    base = synthetic_clustered(1_000_000, 128, n_clusters=1000)
    queries = synthetic_clustered_queries(8 * 1024, 128, n_clusters=1000)
    return base, queries, truth_on_card(base, queries[:1024], K, torch.device("cuda", 0))


def phase_slice(dev, counts_before, data) -> dict:
    base, queries, truth = data
    n, d = base.shape
    ix = create_index(IndexConfig(dim=d, metric=Metric.L2, algorithm="IVF_FLAT",
                                  params=IndexParams(nlist=1000, nprobe=3,
                                                     scan_mode="dense")),
                      device=dev)
    t0 = time.perf_counter()
    ix.add_batch([str(i) for i in range(n)], base)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    route = ix.tail.describe_scan(1024)
    require(route == "dense-pallas-win", f"1M nlist 1000 route is {route}")
    launches = fs.LAUNCHES["ivf_scan"]
    t0 = time.perf_counter()
    results = ix.search_batch(queries[:1024], K)
    search_batch_ms = (time.perf_counter() - t0) * 1e3
    r_search = recall(results, truth)
    q_dev = [torch.from_numpy(queries[i * 1024:(i + 1) * 1024]).to(dev)
             for i in range(8)]
    _, rows = ix.device_search(q_dev[0], K)
    r_device = recall_at_k(id_lists_to_rows(ix.resolve_rows(rows.cpu().numpy()), K),
                           truth, K)
    srv = serve(ix, q_dev, iters=200)
    require(fs.LAUNCHES["ivf_scan"] > launches, "IVF kernel never launched")
    require(r_search >= 0.995 and r_device >= 0.995,
            f"recall@10 {r_search}/{r_device} < 0.995")
    # per-layer times on one b1024 batch (CUDA events, median)
    tdev = ix.tail._sync()
    probe = rank_probes(q_dev[0], tdev["cents"], tdev["cvalid"], tdev["offsets"],
                        tdev["lens"], 3, n, Metric.L2)[0]
    rank_ms = cuda_ms(lambda: rank_probes(
        q_dev[0], tdev["cents"], tdev["cvalid"], tdev["offsets"], tdev["lens"],
        3, n, Metric.L2), 10)
    kp = tdev["cents"].shape[0]
    scan_ms = cuda_ms(lambda: fs.fused_ivf_topk(
        q_dev[0], tdev["xperm"], tdev["sqnorm"], tdev["alive"], tdev["crow"],
        tdev["offsets"], tdev["lens"], probe, kp, K, max_len=tdev["l_pad"]), 10)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    seg = fs.list_seg(1024, 3, kp, tdev["l_pad"], sms)
    with uncounted():   # the inversion alone is not the path's work
        invert_ms = cuda_ms(lambda: fs.invert_probes(probe, tdev["lens"], kp, tdev["l_pad"],
                                                     seg, tdev["xperm"].shape[0]), 10)
    invert_plain_ms = cuda_ms(lambda: fs.invert_probes_plain(
        probe, tdev["lens"], kp, tdev["l_pad"], seg, tdev["xperm"].shape[0]), 10)
    trace = device_shares(lambda: ix.device_search(q_dev[0], K), 40)
    t0 = time.perf_counter()
    ix.resolve_rows(rows.cpu().numpy())
    resolve_ms = (time.perf_counter() - t0) * 1e3
    say("4 slice", route=route, n=n, load_s=round(load_s, 2),
        build_s=round(build_s, 2), recall_search_batch=r_search,
        recall_device_search=r_device, **srv,
        search_batch_b1024_ms=round(search_batch_ms, 1),
        rank_probes_ms=round(rank_ms, 3), scan_plus_merge_ms=round(scan_ms, 3),
        inversion_ms=round(invert_ms, 3), inversion_plain_ms=round(invert_plain_ms, 3),
        trace_40_b1024=repr(trace),
        resolve_rows_ms=round(resolve_ms, 2),
        ivf_launches=fs.LAUNCHES["ivf_scan"] - counts_before["ivf_scan"])
    return srv


def phase_narrow(dev) -> None:
    n, d, b = 100_000, 128, 4096
    base = synthetic(n, d)
    queries = synthetic_queries(b, d)
    truth = ground_truth(base, queries, K, block=16384)
    ix = IvfFlatIndex(d, "L2", device=dev, nlist=100, nprobe=96)
    ix.add_batch([str(i) for i in range(n)], base)
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    route = ix.describe_scan(b)
    require(route == "dense-pallas", f"100k nlist 100 route is {route}")
    q_dev = [torch.from_numpy(queries).to(dev)]
    _, rows = ix.device_search(q_dev[0], K)
    r = recall_at_k(id_lists_to_rows(ix.resolve_rows(rows.cpu().numpy()), K), truth, K)
    require(abs(r - 0.9972) <= 0.005, f"recall@10 {r} not within 0.005 of 0.9972")
    srv = serve(ix, q_dev, iters=50)
    # selection="pallas" at k 200: the list scan's wide mode, as the JAX
    # package answers there; hits held against the list scan's plain version
    # on the same probes
    ix.selection = "pallas"
    wide_route = ix.describe_scan(1024, top_k=200)
    require(wide_route == "dense-pallas", f"pallas k200 route is {wide_route}")
    q1024 = q_dev[0][:1024].contiguous()
    launches = fs.LAUNCHES["ivf_scan_wide"]
    wide = ix.device_search(q1024, 200)
    require(fs.LAUNCHES["ivf_scan_wide"] > launches, "wide IVF list scan never launched")
    ix.selection = "auto"
    tdev = ix._sync()
    probe = rank_probes(q1024, tdev["cents"], tdev["cvalid"], tdev["offsets"],
                        tdev["lens"], 96, n, Metric.L2)[0]
    plain = fs.fused_ivf_topk_plain(q1024, tdev["xperm"], tdev["sqnorm"], tdev["alive"],
                                    tdev["crow"], probe, tdev["cents"].shape[0], 200)
    err, swaps = compare(wide, plain, "narrow k200 pallas vs plain")
    say("5 narrow", route=route, n=n, batch=b, build_s=round(build_s, 2),
        recall=r, **srv, pallas_k200_route=wide_route, pallas_k200_err=err,
        pallas_k200_kth_ties=swaps)


def uniform_1m() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 1M x 128 uniform corpus of phases 6 and 9-11 (the reference's
    flat1m and ivf1m rows), 4096 queries, and the ground truth of the first
    1024 (float64 on the card)."""
    base = synthetic(1_000_000, 128)
    queries = synthetic_queries(4 * 1024, 128)
    return base, queries, truth_on_card(base, queries[:1024], K, torch.device("cuda", 0))


def phase_flat(dev, data) -> None:
    base, queries, truth = data
    n, d, b = base.shape[0], base.shape[1], 1024
    ix = FlatIndex(d, "L2", device=dev, selection="pallas")
    ix.add_batch([str(i) for i in range(n)], base)
    require(ix.describe_scan(b) == "flat-pallas", "flat route")
    rec, not_ties = exact_misses_are_ties(ix, base, queries[:b], truth)
    require(not_ties == 0, f"exact flat recall {rec}: {not_ties} misses beyond fp32 ties")
    q_dev = [torch.from_numpy(queries[i * b:(i + 1) * b]).to(dev) for i in range(4)]
    srv = serve(ix, q_dev, iters=50)
    # k 200: the flat scan's wide mode on the same route
    require(ix.describe_scan(b, top_k=200) == "flat-pallas", "flat k200 route")
    launches = fs.LAUNCHES["flat_scan_wide"]
    wide = ix.device_search(q_dev[0], 200)
    require(fs.LAUNCHES["flat_scan_wide"] > launches, "wide flat scan never launched")
    dev_ = ix._sync()
    plain = fs.fused_flat_topk_plain(q_dev[0], dev_["vecs"], dev_["sqnorm"], dev_["alive"],
                                     n, 200, chunk_rows=65536)
    err, swaps = compare(wide, plain, "flat k200 vs plain")
    say("6 flat", route="flat-pallas", n=n, batch=b, recall=rec,
        misses_beyond_fp32_ties=not_ties, **srv, k200_err=err, k200_kth_ties=swaps)


def phase_pq(dev, data) -> None:
    """The IVF-PQ path at SIFT1M scale: Delta(Flat, IVF_PQ sq8res)."""
    base, queries, truth = data
    n, d = base.shape
    ix = create_index(IndexConfig(dim=d, metric=Metric.L2, algorithm="IVF_PQ",
                                  params=IndexParams(nlist=1000, pq_m=16, k=256,
                                                     refine_storage="sq8res")),
                      device=dev)
    ix.add_batch([str(i) for i in range(n)], base)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated(dev)
    tail = ix.tail
    require(all(key not in tail._dev for key in ("xraw", "xsqnorm")),
            "an sq8res index holds an fp32 rerank slab")
    route = tail.describe_scan(256)
    require(route == "dense-sq8-pallas-win", f"1M nlist 1000 sq8res route is {route}")
    launches = fs.LAUNCHES["sq8_scan"]
    r_search = recall(ix.search_batch(queries[:1024], K), truth)
    q1024 = [torch.from_numpy(queries[i * 1024:(i + 1) * 1024]).to(dev) for i in range(8)]
    _, rows = ix.device_search(q1024[0], K)
    r_device = recall_at_k(id_lists_to_rows(ix.resolve_rows(rows.cpu().numpy()), K),
                           truth, K)
    require(fs.LAUNCHES["sq8_scan"] > launches, "SQ8 kernel never launched")
    require(r_search >= 0.9736 and r_device >= 0.9736,
            f"recall@10 {r_search}/{r_device} < 0.9736")
    q256 = [torch.from_numpy(queries[i * 256:(i + 1) * 256]).to(dev) for i in range(32)]
    s256, s1024 = serve(ix, q256, iters=400), serve(ix, q1024, iters=100)
    # per-layer times of one batch (CUDA events, median)
    tdev = tail._sync()
    layers = {}
    for qb in (q256[0], q1024[0]):
        def rank():
            return rank_probes(qb, tdev["cents"], tdev["cvalid"], tdev["offsets"],
                               tdev["lens"], 3, n, Metric.L2)[0]
        probe, qc = rank(), qb @ tdev["cents"].T
        layers[f"b{len(qb)}_rank_probes_ms"] = round(cuda_ms(rank, 10), 3)
        layers[f"b{len(qb)}_qc_ms"] = round(cuda_ms(lambda: qb @ tdev["cents"].T, 10), 3)
        layers[f"b{len(qb)}_sq8_scan_plus_merge_ms"] = round(cuda_ms(
            lambda: fs.fused_ivf_sq8_topk(
                qb, tdev["codes8"], tdev["mins"], tdev["scales"], tdev["sq8norm"],
                tdev["alive"], tdev["crow"], tdev["offsets"], tdev["lens"], probe, qc,
                tdev["cents"].shape[0], K, max_len=tdev["l_pad"]), 10), 3)
    layers["trace_40_b1024"] = repr(device_shares(lambda: ix.device_search(q1024[0], K), 40))
    say("7 pq", route=route, n=n, build_s=round(build_s, 2),
        recall_search_batch=r_search, recall_device_search=r_device,
        **{f"b256_{k}": v for k, v in s256.items()},
        **{f"b1024_{k}": v for k, v in s1024.items()}, **layers,
        memory_bytes=repr(tail.memory_bytes()),
        cuda_memory_allocated=torch.cuda.memory_allocated(dev),
        build_peak_cuda_memory=build_peak)


def _pq_narrow_index(dev, base, **kw) -> tuple[IvfPqIndex, float]:
    ix = IvfPqIndex(base.shape[1], "L2", device=dev, nlist=100, pq_m=16, ksub=256, **kw)
    ix.add_batch([str(i) for i in range(len(base))], base)
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    return ix, time.perf_counter() - t0


def phase_pq_narrow(dev) -> None:
    n, d, b = 100_000, 128, 1024
    base = synthetic_clustered(n, d, n_clusters=100)
    queries = synthetic_clustered_queries(b, d, n_clusters=100)
    truth = ground_truth(base, queries, K, block=16384)
    q_dev = [torch.from_numpy(queries).to(dev)]

    def device_recall(ix) -> float:
        _, rows = ix.device_search(q_dev[0], K)
        return recall_at_k(id_lists_to_rows(ix.resolve_rows(rows.cpu().numpy()), K),
                           truth, K)

    ix, build_s = _pq_narrow_index(dev, base, refine_storage="sq8res")
    route = ix.describe_scan(b)
    require(route == "dense-sq8-pallas", f"100k nlist 100 sq8res route is {route}")
    launches = fs.LAUNCHES["sq8_scan"]
    r = device_recall(ix)
    require(fs.LAUNCHES["sq8_scan"] > launches, "SQ8 kernel never launched")
    require(r >= 0.9783, f"recall@10 {r} < 0.9783")
    srv = serve(ix, q_dev, iters=50)
    # k 200: the SQ8 list scan's wide mode on the same route, against the
    # plain route's hits (a max_scans budget takes dense-sq8-xla)
    require(ix.describe_scan(b, top_k=200) == "dense-sq8-pallas", "sq8res k200 route")
    launches = fs.LAUNCHES["sq8_scan_wide"]
    wide = ix.device_search(q_dev[0], 200)
    require(fs.LAUNCHES["sq8_scan_wide"] > launches, "wide SQ8 list scan never launched")
    budget = SearchOptions(max_scans=n - 1)
    require(ix.describe_scan(b, max_scans=n - 1, top_k=200) == "dense-sq8-xla",
            "sq8res budget route")
    err200, swaps200 = compare(wide, ix.device_search(q_dev[0], 200, budget),
                               "sq8res k200 vs plain route", SQ8_RTOL)
    ix.scan_mode = "probe"        # the ADC shortlist, reranked off the SQ8 slab
    probe_route = ix.describe_scan(b)
    require(probe_route == "probe-adc+rerank-sq8", f"probe route is {probe_route}")
    r_probe = device_recall(ix)
    s_probe = serve(ix, q_dev, iters=10)
    say("8 pq narrow", route=route, n=n, batch=b, build_s=round(build_s, 2),
        recall=r, **srv, probe_route=probe_route, probe_recall=r_probe,
        probe_qps=s_probe["qps"], probe_p50_ms=s_probe["p50_ms"],
        k200_route="dense-sq8-pallas", k200_err_vs_plain_route=err200,
        k200_kth_ties=swaps200)

    twin, _ = _pq_narrow_index(dev, base, refine_storage="sq8res")
    same = {
        "centroids": np.array_equal(ix.get_centroids(), twin.get_centroids()),
        "codebooks": np.array_equal(ix.pq.codebooks, twin.pq.codebooks),
        "pq_codes": np.array_equal(ix._codes, twin._codes),
        "sq8_codes": all(torch.equal(ix._dev[key], twin._dev[key])
                         for key in ("codes8", "mins", "scales", "sq8norm")),
    }
    require(all(same.values()), f"two builds from one seed differ: {same}")
    del ix, twin

    reg = create_index(IndexConfig(dim=d, metric=Metric.L2, algorithm="IVF_PQ",
                                   params=IndexParams(nlist=100, pq_m=16, k=256)),
                       device=dev)                 # refine_storage: fp32
    reg.add_batch([str(i) for i in range(len(base))], base)
    reg.build()
    fp32_route = reg.tail.describe_scan(b)
    require(fp32_route == "dense-exact-pallas", f"fp32 rerank slab route is {fp32_route}")
    launches = fs.LAUNCHES["ivf_scan"]
    r_fp32 = device_recall(reg)
    require(fs.LAUNCHES["ivf_scan"] > launches, "IVF kernel never launched")
    say("8 pq narrow", deterministic_rebuild=repr(same), fp32_route=fp32_route,
        fp32_recall=r_fp32, fp32_qps=serve(reg, q_dev, iters=20)["qps"])


def phase_flat_bf16(dev, data) -> None:
    """flat1m_pallas: the bf16 slab through the bf16 flat scan."""
    base, queries, truth = data
    n, d = base.shape
    ix = FlatIndex(d, "L2", device=dev, storage="bf16", selection="pallas")
    ix.add_batch([str(i) for i in range(n)], base)
    routes = {b: ix.describe_scan(b) for b in (1024, 64)}
    require(set(routes.values()) == {"flat-pallas"}, f"flat bf16 routes {routes}")
    require(ix._sync()["vecs"].dtype == torch.bfloat16, "the flat slab is not bf16")
    r1024 = recall(ix.search_batch(queries[:1024], K), truth)
    require(abs(r1024 - 0.9817) <= 0.005,
            f"flat bf16 b1024 recall@10 {r1024} not within 0.005 of 0.9817")
    r64 = recall([r for s in range(0, 256, 64) for r in ix.search_batch(queries[s:s + 64], K)],
                 truth[:256])
    q1024 = [torch.from_numpy(queries[i * 1024:(i + 1) * 1024]).to(dev) for i in range(4)]
    q64 = [torch.from_numpy(queries[i * 64:(i + 1) * 64]).to(dev) for i in range(16)]
    s1024, s64 = serve(ix, q1024, iters=50), serve(ix, q64, iters=200)
    say("9 flat bf16", route="flat-pallas", n=n, recall_b1024=r1024,
        recall_b64_first256=r64, reference="0.9817 (b1024), 0.9855 (b64)",
        **{f"b1024_{k}": v for k, v in s1024.items()},
        **{f"b64_{k}": v for k, v in s64.items()})


def phase_flat_hybrid(dev, data) -> None:
    """flat1m_hybrid (b64), flat1m_hybrid_b256: the bf16 twin scanned for a
    top-R shortlist, reranked off the fp32 slab; b1024 scans the fp32 slab."""
    base, queries, truth = data
    n, d = base.shape
    ix = FlatIndex(d, "L2", device=dev, selection="hybrid")
    ix.add_batch([str(i) for i in range(n)], base)
    routes = {b: ix.describe_scan(b) for b in (64, 256, 1024)}
    require(routes == {64: "flat-pallas-hybrid", 256: "flat-pallas-hybrid",
                       1024: "flat-pallas"}, f"flat hybrid routes {routes}")
    fields = {}
    for b in (64, 256, 1024):
        rec_b, not_ties = exact_misses_are_ties(ix, base, queries[:1024], truth, batch=b)
        require(not_ties == 0, f"flat hybrid b{b} recall {rec_b}: {not_ties} misses "
                "beyond fp32 ties")
        q_dev = [torch.from_numpy(queries[i * b:(i + 1) * b]).to(dev)
                 for i in range(len(queries) // b)]
        srv = serve(ix, q_dev, iters=max(50, 12_800 // b))
        fields.update({f"b{b}_route": routes[b], f"b{b}_recall": rec_b,
                       **{f"b{b}_{k}": v for k, v in srv.items()}})
    say("10 flat hybrid", n=n, R=ix._shortlist(K), misses_beyond_fp32_ties=0,
        reference="recall 1.0 (flat1m_hybrid, flat1m_hybrid_b256)", **fields)


def _hybrid_against_fp32(dev, ix, queries, truth, name, route, k=K, iters=200):
    """The b256 hybrid route's hits against the fp32 list scan's on the same
    queries (sent as the first 256 of a b1024 batch); recall@k and QPS."""
    require(ix.describe_scan(256, top_k=k) == route,
            f"{name} b256 route {ix.describe_scan(256, top_k=k)}")
    require(ix.describe_scan(1024, top_k=k) == route[:-len("-hybrid")],
            f"{name} b1024 route {ix.describe_scan(1024, top_k=k)}")
    q1024 = torch.from_numpy(queries[:1024]).to(dev)
    q256 = q1024[:256].contiguous()
    hybrid = ix.device_search(q256, k)
    fp32 = ix.device_search(q1024, k)
    err, swaps = compare(hybrid, tuple(t[:256] for t in fp32), f"{name} hybrid vs fp32")
    rows = id_lists_to_rows(ix.resolve_rows(hybrid[1].cpu().numpy()), k)
    srv = serve(ix, [q1024[i * 256:(i + 1) * 256].contiguous() for i in range(4)],
                iters=iters, k=k)
    return {f"{name}_route": route, f"{name}_max_abs_err_vs_fp32": err,
            f"{name}_kth_ties": swaps,
            f"{name}_recall_b256": recall_at_k(rows, truth[:256, :k], k),
            **{f"{name}_b256_{key}": v for key, v in srv.items()}}


def phase_ivf_hybrid(dev, data) -> None:
    """ivf100k_np96_hybrid_b256 and ivf1m_np256_hybrid_b256."""
    base, queries, truth = data
    n, d = base.shape
    small, small_q = synthetic(100_000, d), synthetic_queries(1024, d)
    narrow = IvfFlatIndex(d, "L2", device=dev, nlist=100, nprobe=96, selection="hybrid")
    narrow.add_batch([str(i) for i in range(len(small))], small)
    narrow.build()
    truth100 = ground_truth(small, small_q[:256], 100, block=16384)
    keys = ("ivf_scan_bf16_tc", "list_scan_prefloor_tc")

    def tc_cell(name, *args, **kw):
        """A k 10 cell: the tensor-core list scan and its first passes."""
        before = [fs.LAUNCHES[key] for key in keys]
        fields.update(_hybrid_against_fp32(dev, *args, **kw))
        got = [fs.LAUNCHES[key] - b0 for key, b0 in zip(keys, before)]
        fields[f"{name}_tc_launches"], fields[f"{name}_tc_first_passes"] = got
        require(got[0] > 0, f"{name} never launched the tensor-core list scan")

    fields = {}
    tc_cell("ivf100k_np96", narrow, small_q, truth100, "ivf100k_np96", "dense-pallas-hybrid")
    # k 100: R 512, the list scan's wide bf16 mode (on the CUDA cores),
    # against the fp32 list scan at k 100 (narrow) on the same queries
    launches = fs.LAUNCHES["ivf_scan_bf16_wide"]
    fields.update(_hybrid_against_fp32(dev, narrow, small_q, truth100, "ivf100k_np96_k100",
                                       "dense-pallas-hybrid", k=100, iters=100))
    require(fs.LAUNCHES["ivf_scan_bf16_wide"] > launches,
            "the IVF hybrid at k 100 never launched the wide bf16 list scan")
    fields["ivf100k_np96_k100_R"] = narrow._shortlist(narrow._sync(), 100)
    del narrow
    wide = IvfFlatIndex(d, "L2", device=dev, nlist=1000, nprobe=256,
                        train_dtype="bfloat16", selection="hybrid")
    wide.add_batch([str(i) for i in range(n)], base)
    t0 = time.perf_counter()
    wide.build()
    torch.cuda.synchronize()
    fields["ivf1m_np256_build_s"] = round(time.perf_counter() - t0, 2)
    tc_cell("ivf1m_np256", wide, queries, truth, "ivf1m_np256", "dense-pallas-win-hybrid")
    say("11 ivf hybrid", R=wide._shortlist(wide._sync(), K), **fields)


def phase_pq_bf16(dev, data) -> None:
    """ivfpq1m_bf16slab: Delta(Flat, IVF_PQ) with a bf16 rerank slab, scanned
    by the bf16 list scan with promote."""
    base, queries, truth = data
    n, d = base.shape
    ix = create_index(IndexConfig(dim=d, metric=Metric.L2, algorithm="IVF_PQ",
                                  params=IndexParams(nlist=1000, pq_m=16, k=256,
                                                     refine_storage="bf16")),
                      device=dev)
    ix.tail.train_dtype = "bfloat16"   # the reference row's training dtype
    ix.add_batch([str(i) for i in range(n)], base)
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_alloc = torch.cuda.memory_allocated(dev) - alloc0
    tail = ix.tail
    route = tail.describe_scan(64)
    require(route == "dense-exact-pallas-win", f"1M bf16-slab route is {route}")
    # the slab as it lies on the card: npad = slab_pad(n, l_pad) rows, padding
    # included; its storage must be half an fp32 slab of the same rows
    slab = tail._dev["xraw"]
    npad = slab.shape[0]
    slab_bytes = slab.untyped_storage().nbytes()
    require(slab.dtype == torch.bfloat16 and slab.shape[1] == d and npad >= n
            and 2 * slab_bytes == npad * d * 4 and n * d * 2 == 256_000_000,
            f"bf16 slab {slab.dtype} {tuple(slab.shape)}: {slab_bytes} B of storage, "
            f"an fp32 slab of the same rows {npad * d * 4} B")
    require(build_alloc >= slab_bytes,
            f"the build allocated {build_alloc} B, less than its {slab_bytes} B slab")
    q64 = [torch.from_numpy(queries[i * 64:(i + 1) * 64]).to(dev) for i in range(16)]
    # the route's b64 calls run the promote kernel (ivf_list_scan_promote.cu)
    before = {key: fs.LAUNCHES[key] for key in ("ivf_scan_bf16_promote", "ivf_scan_bf16")}
    rows = np.concatenate([ix.device_search(qb, K)[1].cpu().numpy() for qb in q64])
    promote_launches = fs.LAUNCHES["ivf_scan_bf16_promote"] - before["ivf_scan_bf16_promote"]
    require(promote_launches >= len(q64)
            and fs.LAUNCHES["ivf_scan_bf16"] == before["ivf_scan_bf16"],
            f"the b64 route launched the promote kernel {promote_launches} times "
            f"for {len(q64)} batches")
    r = recall_at_k(id_lists_to_rows(ix.resolve_rows(rows), K), truth, K)
    require(abs(r - 0.725) <= 0.03, f"bf16-slab recall@10 {r} not within 0.03 of 0.725")
    srv = serve(ix, q64, iters=400)
    # k 200: the bf16 list scan's wide mode with promote, against its plain
    # version on the same probes
    require(tail.describe_scan(64, top_k=200) == "dense-exact-pallas-win", "k200 route")
    launches = fs.LAUNCHES["ivf_scan_bf16_wide"]
    wide = ix.device_search(q64[0], 200)
    require(fs.LAUNCHES["ivf_scan_bf16_wide"] > launches, "wide bf16 list scan never launched")
    tdev = tail._sync()
    probe = rank_probes(q64[0], tdev["cents"], tdev["cvalid"], tdev["offsets"], tdev["lens"],
                        tail.nprobe, n, Metric.L2)[0]
    plain = fs.fused_ivf_topk_plain(q64[0], tdev["xraw"], tdev["xsqnorm"], tdev["alive"],
                                    tdev["crow"], probe, tdev["cents"].shape[0], 200,
                                    promote_fp32=True)
    err200, swaps200 = compare(wide, plain, "bf16 slab k200 vs plain")
    say("12 pq bf16", route=route, kernel="ivf_list_scan_promote_kernel",
        promote_launches=promote_launches, n=n, build_s=round(build_s, 2), recall_1024_b64=r,
        k200_route="dense-exact-pallas-win", k200_err_vs_plain=err200,
        k200_kth_ties=swaps200,
        reference=0.725, slab_rows=npad, slab_bytes=slab_bytes,
        slab_bytes_unpadded=n * d * 2, build_allocated_bytes=build_alloc,
        memory_bytes_as_counted=repr(tail.memory_bytes()),
        **{f"b64_{k}": v for k, v in srv.items()})


def truth_on_card(base: np.ndarray, queries: np.ndarray, k: int, dev) -> np.ndarray:
    """Exact top-k rows (L2) of each query, float64 products on the card in
    blocks of queries: plain torch, independent of the kernels under test."""
    x = torch.from_numpy(base).to(dev, torch.float64)
    sq = (x * x).sum(1)
    out = []
    for s in range(0, len(queries), 256):
        qb = torch.from_numpy(queries[s:s + 256]).to(dev, torch.float64)
        dist = sq[None, :] - 2.0 * (qb @ x.T)   # + |q|^2, the same for every row
        out.append(torch.topk(dist, k, dim=1, largest=False).indices.cpu().numpy())
    del x, sq
    return np.concatenate(out)


def phase_flat_hybrid_k100(dev, data) -> None:
    """flat1m_hybrid_k100 (bench.py:305-306): the bf16 twin scanned for a
    top-512 shortlist (the flat scan's wide bf16 mode), reranked off the
    fp32 slab, b256, k 100."""
    base, queries, _ = data
    n, d = base.shape
    b, k = 256, 100
    ix = FlatIndex(d, "L2", device=dev, selection="hybrid")
    ix.add_batch([str(i) for i in range(n)], base)
    route, r = ix.describe_scan(b, top_k=k), ix._shortlist(k)
    require(route == "flat-pallas-hybrid" and r == 512, f"flat hybrid k100: {route}, R {r}")
    truth = truth_on_card(base, queries[:1024], k, dev)
    rec, not_ties = exact_misses_are_ties(ix, base, queries[:1024], truth, batch=b, k=k)
    require(not_ties == 0,
            f"flat hybrid k100 recall@100 {rec}: {not_ties} misses beyond fp32 ties")
    q_dev = [torch.from_numpy(queries[i * b:(i + 1) * b]).to(dev)
             for i in range(len(queries) // b)]
    srv = serve(ix, q_dev, iters=40, k=k)
    say("13 flat hybrid k100", route=route, n=n, batch=b, k=k, R=r, recall_at_100=rec,
        misses_beyond_fp32_ties=not_ties, reference="recall 1.0 (flat1m_hybrid_k100)",
        ms_a_batch=round(1e3 * b / srv["qps"], 4),
        ms_a_batch_before="4.0686 (the wide bf16 scan without a first pass; H100 80GB "
                          "HBM3, 700 W)", **srv)


def phase_ivf_d768(dev) -> None:
    """ivf1m_d768_b1024 (bench.py:328-330): IVF-Flat on 1M x 768 clustered
    rows (1000 centers), nlist 1000, bf16 training, the default nprobe,
    b1024: the list scan with q streamed by depth."""
    t0 = time.perf_counter()
    n, d, b = 1_000_000, 768, 1024
    base = synthetic_clustered(n, d, n_clusters=1000)
    queries = synthetic_clustered_queries(2 * b, d, n_clusters=1000)
    data_s = time.perf_counter() - t0
    ix = IvfFlatIndex(d, "L2", device=dev, nlist=1000, train_dtype="bfloat16")
    ix.add_batch([str(i) for i in range(n)], base)
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index_bytes = torch.cuda.memory_allocated(dev) - alloc0
    route = ix.describe_scan(b)
    require(route == "dense-pallas-win", f"1M x 768 nlist 1000 route is {route}")
    truth = truth_on_card(base, queries[:b], K, dev)
    q_dev = [torch.from_numpy(queries[i * b:(i + 1) * b]).to(dev) for i in range(2)]
    launches = fs.LAUNCHES["ivf_scan"]
    _, rows = ix.device_search(q_dev[0], K)
    require(fs.LAUNCHES["ivf_scan"] > launches, "IVF kernel never launched at D 768")
    rec = recall_at_k(id_lists_to_rows(ix.resolve_rows(rows.cpu().numpy()), K), truth, K)
    require(rec >= 0.9894, f"ivf1m_d768_b1024 recall@10 {rec} < 0.9894")
    srv = serve(ix, q_dev, iters=40)
    say("14 ivf d768", route=route, n=n, d=d, batch=b, nprobe=ix.nprobe,
        data_s=round(data_s, 2), build_s=round(build_s, 2), recall=rec,
        reference="0.9994 self-recall, gate 0.9894", **srv,
        index_device_bytes=index_bytes)
    del ix, base


def hnsw_index(dev, base, **kw) -> tuple[HnswIndex, float]:
    """HnswIndex(m 16, ef_construction 200, ef_search 50) over ``base``
    through add_batch ('auto': the native builder below 200k rows, the
    bootstrap at and above), and its build seconds."""
    ix = HnswIndex(base.shape[1], "L2", device=dev, m=16, ef_construction=200,
                   ef_search=50, **kw)
    t0 = time.perf_counter()
    ix.add_batch([str(i) for i in range(len(base))], base)
    ix._sync()
    torch.cuda.synchronize()
    return ix, time.perf_counter() - t0


def hnsw_recall(ix, queries, truth, b, opts=None) -> float:
    """recall@10 of ``queries`` searched in batches of ``b``."""
    results = [r for s in range(0, len(queries), b)
               for r in ix.search_batch(queries[s:s + b], K, opts or SearchOptions())]
    return recall(results, truth)


HNSW_NATIVE_CELLS = (("hnsw100k_clustered", 0.9838), ("hnsw10k", 0.7244))


def prebuild_hnsw_native(dev) -> dict:
    """Phase 15's two graphs, built by the native builder on the host:
    hnsw100k_clustered (bench.py:172-173) and hnsw10k (:147), HnswIndex(m
    16, ef_construction 200, ef_search 50) through add_batch. The builder
    is a ctypes call that runs without the interpreter's lock and touches
    no card, so ``main`` starts this on a thread of its own before phase 3
    and the host builds the graphs while the card runs phases 3-14; phase
    15 uploads them. Returns {name: (index, build seconds, rows, queries)}."""
    out = {}
    for name, base, queries in (
        ("hnsw100k_clustered", synthetic_clustered(100_000, 128, n_clusters=100),
         synthetic_clustered_queries(256, 128, n_clusters=100)),
        ("hnsw10k", synthetic(10_000, 128), synthetic_queries(256, 128)),
    ):
        ix = HnswIndex(base.shape[1], "L2", device=dev, m=16, ef_construction=200,
                       ef_search=50)
        t0 = time.perf_counter()
        ix.add_batch([str(i) for i in range(len(base))], base)
        out[name] = (ix, time.perf_counter() - t0, base, queries)
    return out


def phase_hnsw_native(dev, smi, keep: dict, built=None) -> None:
    """hnsw100k_clustered (bench.py:172-173) and hnsw10k (:147): the native
    incremental builder, the beam at b64, recall@10 of 256 queries against
    the record less 0.01, and the copied oracle's sequential search over the
    same graph (recall_ref, 64 queries). ``built``: the graphs of
    ``prebuild_hnsw_native`` (a future of them, or None: built here; the
    build seconds are the host build's, the upload apart). ``keep`` takes
    the hnsw100k_clustered graph, its queries and truth (phase 22)."""
    graphs = (built.result() if hasattr(built, "result") else built) or \
        prebuild_hnsw_native(dev)
    for name, gate in HNSW_NATIVE_CELLS:
        ix, build_s, base, queries = graphs[name]
        t0 = time.perf_counter()
        ix._sync()
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        truth = ground_truth(base, queries, K)
        rec = hnsw_recall(ix, queries, truth, 64)
        ref_rows = np.stack([ref_oracle.ref_hnsw_search(ix, qv, 50, K) for qv in queries[:64]])
        rec_ref = recall_at_k(ref_rows, truth[:64], K)
        require(rec >= gate, f"{name} recall@10 {rec} < {gate}")
        q_dev = [torch.from_numpy(queries[i * 64:(i + 1) * 64]).to(dev) for i in range(4)]
        srv = serve(ix, q_dev, iters=100)
        extra = {}
        if name == "hnsw100k_clustered":
            keep["hnsw100k"] = (ix, queries, truth)
            extra = hnsw_bf16_beam_vs_jax(dev, ix, queries, truth, rec)
        say("15 hnsw native", cell=name, n=len(base), build_s=round(build_s, 2),
            upload_s=round(upload_s, 2), recall=rec, gate=gate, recall_ref=rec_ref,
            top_level=ix._top_level, batch_ms=round(64e3 / srv["qps"], 3), **srv, **extra,
            card=repr(smi))


def graph_hash(ix) -> dict:
    """SHA-256 of an HNSW graph as the index holds it on the host: layer 0's
    adjacency [n, 2m] int32, and the whole graph (levels, layer 0, the
    upper layers [L, n, m], entry row and top level), as
    scripts/torch_hnsw_bf16_gap.py computes it for both packages."""
    n = ix._count
    adj0 = np.ascontiguousarray(ix._adj0[:n], dtype=np.int32)
    up = np.ascontiguousarray(np.stack([a[:n] for a in ix._adj_up]) if ix._adj_up
                              else np.zeros((0, n, ix.m), np.int32), dtype=np.int32)
    whole = hashlib.sha256()
    for part in (np.ascontiguousarray(ix._levels[:n], dtype=np.int32), adj0, up,
                 np.array([ix._entry, ix._top_level], np.int64)):
        whole.update(part.tobytes())
    return {"adj0": hashlib.sha256(adj0.tobytes()).hexdigest(), "graph": whole.hexdigest()}


def hnsw_bf16_beam_vs_jax(dev, ix, queries, truth, rec32) -> dict:
    """hnsw100k_clustered's graph as the JAX package builds it on the CPU
    (HNSW100K_GRAPH_SHA256), and a bf16 beam over it (the final pool
    re-scored in fp32) held to the JAX package's bf16 beam on the CPU: its
    recall@10 within 0.005 of HNSW_BF16_GAP_JAX's, its gap under the fp32
    beam at most the JAX package's gap + 0.005."""
    got = graph_hash(ix)
    require(got == HNSW100K_GRAPH_SHA256,
            f"hnsw100k_clustered's graph differs from the CPU build's: {got}")
    ix16 = HnswIndex(128, "L2", device=dev, search_dtype="bfloat16")
    ix16._restore(ix._arrays())
    rec16 = hnsw_recall(ix16, queries, truth, 64)
    jax16, gap = HNSW_BF16_GAP_JAX["bf16"], HNSW_BF16_GAP_JAX["gap"]
    require(abs(rec16 - jax16) <= 0.005,
            f"bf16 beam recall@10 {rec16} not within 0.005 of the JAX package's {jax16}")
    require(rec32 - rec16 <= gap + 0.005,
            f"bf16 beam {rec16} trails the fp32 beam's {rec32} by more than the JAX "
            f"package's gap {gap} + 0.005")
    return {"adj0_sha256": got["adj0"], "graph_sha256": got["graph"], "recall_bf16": rec16,
            "bf16_minus_fp32": round(rec16 - rec32, 8), "recall_jax_cpu": repr(
                HNSW_BF16_GAP_JAX)}


def _bootstrap_stages():
    """A handler that keeps the bootstrap's stage marks (stage, seconds)."""
    class Marks(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.marks = []

        def emit(self, record):
            m = re.match(r"hnsw_bootstrap (.+) at ([0-9.]+)s", record.getMessage())
            if m:
                self.marks.append((m.group(1), float(m.group(2))))

    log = logging.getLogger("pyrope_tpu_torch.ops.hnsw_bootstrap")
    log.setLevel(logging.INFO)
    h = Marks()
    log.addHandler(h)
    return log, h


def phase_hnsw_1m(dev, smi) -> None:
    """hnsw1m_clustered (bench.py:176-177, :333-352): the bootstrap builder
    on 1M x 128 clustered rows (100 centers); the beam at ef 50 (b1, b8,
    b64, b256) and ef 200 (b256); recall@10 of 256 queries against the
    records less 0.01; a bf16 beam over the same graph, at most 0.01 under
    the fp32 beam, and the recall of its pool ordered by its own bf16
    scores; the
    device bytes; a trace of 20 b64 batches."""
    t0 = time.perf_counter()
    base = synthetic_clustered(1_000_000, 128, n_clusters=100)
    queries = synthetic_clustered_queries(256, 128, n_clusters=100)
    truth = truth_on_card(base, queries, K, dev)
    data_s = time.perf_counter() - t0
    log, marks = _bootstrap_stages()
    try:
        ix, build_s = hnsw_index(dev, base)
    finally:
        log.removeHandler(marks)
    stages, last = {}, 0.0
    for stage, at in marks.marks:
        stages[stage.replace(" ", "_").replace("+", "_")] = round(at - last, 2)
        last = at
    require(marks.marks, "the 1M build did not run the bootstrap")
    del base
    dev_t = ix._sync()
    nbytes, seen = {}, set()
    for name, v in dev_t.items():  # each storage once: x is x_exact in fp32
        if isinstance(v, torch.Tensor) and v.data_ptr() not in seen:
            seen.add(v.data_ptr())
            nbytes[name] = v.numel() * v.element_size()
    rec50 = hnsw_recall(ix, queries, truth, 256)
    rec200 = hnsw_recall(ix, queries, truth, 256, SearchOptions(ef_search=200))
    require(rec50 >= 0.8084, f"hnsw1m_clustered recall@10 {rec50} < 0.8084 at ef 50")
    require(rec200 >= 0.9404, f"hnsw1m_clustered recall@10 {rec200} < 0.9404 at ef 200")
    cells = {}
    for b in (1, 8, 64, 256):
        q_dev = [torch.from_numpy(queries[i * b:(i + 1) * b]).to(dev)
                 for i in range(min(256 // b, 32))]
        srv = serve(ix, q_dev, iters=max(20, 512 // b) if b > 1 else 50)
        cells[f"b{b}"] = {"batch_ms": round(b * 1e3 / srv["qps"], 3), **srv}
    q256 = torch.from_numpy(queries).to(dev)
    srv = serve(ix, [q256], iters=20, options=SearchOptions(ef_search=200))
    cells["b256_ef200"] = {"batch_ms": round(256e3 / srv["qps"], 3), **srv}
    # a bf16 beam over the same graph, the final pool re-scored in fp32
    ix16 = HnswIndex(128, "L2", device=dev, search_dtype="bfloat16")
    ix16._restore(ix._arrays())
    res16 = ix16.search_batch(queries, K)
    rec16 = recall(res16, truth)
    require(rec16 >= 0.8084, f"hnsw1m_clustered bf16 beam recall@10 {rec16} < 0.8084")
    # The bf16 walk trails the fp32 one (the JAX package's beams trail alike
    # on the CPU: tests/test_torch_hnsw.py); 0.0078 on this graph, held to
    # 0.01. The recall of its final pool ordered by its own bf16 scores,
    # without the rerank: recall_bf16_scores, printed.
    require(rec16 >= rec50 - 0.01,
            f"bf16 beam recall@10 {rec16} more than 0.01 under the fp32 beam's {rec50}")
    d16 = ix16._sync()
    pool, steps = beam_schedule(ix16.ef_search, K)
    _, walk = beam_search_body(
        d16["x"], d16["x_exact"], d16["sqnorm"], d16["adj0"], d16["adj_up"],
        d16["alive"], ix16._entry, q256, metric=Metric.L2, k=K, pool=pool,
        steps=steps, n_upper=d16["n_upper"])
    rec_walk = recall_at_k(id_lists_to_rows(ix16.resolve_rows(walk.cpu().numpy()), K),
                           truth, K)
    got = np.array([[h.score for h in r] for r in res16])
    rows = np.array([[ix16._id_to_row[h.id] for h in r] for r in res16])
    want = np.stack([ix16._scores(qv, rw) for qv, rw in zip(queries, rows)])
    require(np.allclose(got, want, rtol=RTOL, atol=ATOL),
            "bf16 beam scores differ from an fp32 rescoring of its rows")
    srv16 = serve(ix16, [q256], iters=20)
    bytes16 = dev_t["x"].numel() * 2
    del ix16
    trace = device_shares(lambda: ix.device_search(q256[:64], K), 20)
    # the beam's bound: the bytes its gathers read in the steps one b64
    # batch ran (adjacency rows; slab rows and their squared norms), over
    # the memory rate; every step gathers for every query of the batch
    pool, steps = beam_schedule(ix.ef_search, K)
    counts = {}
    beam_search_body(
        dev_t["x"], dev_t["x_exact"], dev_t["sqnorm"], dev_t["adj0"], dev_t["adj_up"],
        dev_t["alive"], ix._entry, q256[:64], metric=Metric.L2, k=K, pool=pool,
        steps=steps, n_upper=dev_t["n_upper"], counts=counts)
    row = 128 * dev_t["x"].element_size() + dev_t["sqnorm"].element_size()
    up = dev_t["adj_up"][0] if dev_t["n_upper"] else dev_t["adj0"]
    beam_bytes = 64 * (
        counts.get("upper", 0) * DESCENT_BEAM * up.shape[-1] * (up.element_size() + row)
        + counts.get("layer0", 0) * EXPAND_PER_STEP * dev_t["adj0"].shape[1]
        * (dev_t["adj0"].element_size() + row))
    say("16 hnsw 1m", cell="hnsw1m_clustered", n=ix._count, data_s=round(data_s, 2),
        build_s=round(build_s, 2), stages=repr(stages), top_level=ix._top_level,
        recall_ef50=rec50, recall_ef200=rec200, gates="0.8084 / 0.9404",
        cells=repr(cells), recall_bf16=rec16, bf16_minus_fp32=round(rec16 - rec50, 6),
        recall_bf16_scores=rec_walk,
        bf16_b256=repr(srv16), bf16_beam_slab_bytes=bytes16,
        device_bytes=repr(nbytes), trace_20_b64=repr(trace),
        b64_steps=repr(counts), b64_gather_bytes=beam_bytes,
        b64_bound_ms=round(beam_bytes / HBM_BYTES_S * 1e3, 4), card=repr(smi))


def phase_delta_hnsw(dev, smi) -> None:
    """The Delta composites through create_index: delta_hnsw_pq_wide
    (bench.py:466-470, :211-212; HNSW head, IVF-PQ tail nlist 100, pq_m 4,
    ksub 256; writes to the head, compaction, searched at nprobe 96 and
    ef_search 200, recall@10 of 256 queries >= 0.9853) and Delta(Flat,
    HNSW) (writes compacted into the HNSW tail, then head writes). The
    registry's Flat head scans exactly (flat-exact) and never runs K1: here
    it is set to the fused scan after create_index, so that the path runs
    K1 over the head. Each then takes streamed adds into its head and
    finds them."""
    n, d = 20_000, 128
    base, queries = synthetic(n, d), synthetic_queries(256, d)
    truth = ground_truth(base, queries, K)
    ids = [str(i) for i in range(n)]
    ix = create_index(IndexConfig(dim=d, metric=Metric.L2, algorithm="IVF_PQ",
                                  head_algorithm="HNSW",
                                  params=IndexParams(m=16, ef_construction=200,
                                                     ef_search=50, nlist=100, pq_m=4,
                                                     k=256)), device=dev)
    t0 = time.perf_counter()
    ix.add_batch(ids, base)
    head_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    opts = SearchOptions(nprobe=96, ef_search=200)
    route = ix.tail.describe_scan(64, 96)
    key = {"dense-sq8": "sq8_scan", "dense-exact": "ivf_scan"}.get(
        route.replace("-win", "").rsplit("-pallas", 1)[0])
    require(key is not None, f"delta_hnsw_pq_wide tail route {route} runs no list scan")
    before = fs.LAUNCHES[key]
    rec = hnsw_recall(ix, queries, truth, 64, opts)
    require(fs.LAUNCHES[key] > before, f"the tail's list scan ({key}) never launched")
    require(rec >= 0.9853, f"delta_hnsw_pq_wide recall@10 {rec} < 0.9853")
    streamed = queries[:32] + 0.001
    for i, v in enumerate(streamed):
        require(ix.add(f"s{i}", v), "a streamed add into the HNSW head was refused")
    found = sum(r[0].id == f"s{i}" for i, r in enumerate(ix.search_batch(streamed, K, opts)))
    require(found == 32, f"{found} of 32 streamed adds found first")

    tail = create_index(IndexConfig(dim=d, metric=Metric.L2, algorithm="HNSW",
                                    params=IndexParams(m=16, ef_construction=200,
                                                       ef_search=50)), device=dev)
    tail.head.selection = "pallas"  # forced: create_index gives flat-exact
    base10 = base[:10_000]
    tail.add_batch([str(i) for i in range(10_000)], base10)
    t0 = time.perf_counter()
    tail.build()
    tail_build_s = time.perf_counter() - t0
    rec_t = hnsw_recall(tail, queries, ground_truth(base10, queries, K), 64)
    for i, v in enumerate(streamed):
        tail.add(f"s{i}", v)
    require(tail.head.describe_scan(64) == "flat-pallas", "the Flat head is not on K1")
    before = fs.LAUNCHES["flat_scan"]
    res = tail.search_batch(streamed, K)
    require(fs.LAUNCHES["flat_scan"] > before, "the Flat head's K1 never launched")
    found_t = sum(r[0].id == f"s{i}" for i, r in enumerate(res))
    require(found_t == 32, f"{found_t} of 32 head writes found first over the HNSW tail")
    say("17 delta hnsw", cell="delta_hnsw_pq_wide", head_build_s=round(head_build_s, 2),
        compact_s=round(compact_s, 2), tail_route=route, tail_key=key, recall=rec,
        gate=0.9853, streamed_found=found, flat_hnsw_build_s=round(tail_build_s, 2),
        flat_hnsw_recall=rec_t, flat_hnsw_found=found_t,
        flat_head="pallas, set after create_index (its default: exact)", card=repr(smi))


# ---- phase 18: the RESP data plane -------------------------------------------

RESP_TENANT = "lt"       # scripts/serving_bench.py's tenant
# recall@10 of the JAX package (Delta(Flat, IVF_FLAT), nlist 100) on
# serving_bench's corpus and its first 2000 pool queries, by nprobe,
# measured on the CPU by tests/test_torch_serving_parity.py
# (test_chip_smoke_serving_recall_is_the_jax_packages)
SERVING_RECALL_JAX = {3: 0.13085, 96: 0.996}
# the JAX package's Flat sq8 recall@10 on bench.py's sq8_100k rows on the
# CPU (256 queries for the b64 row, 1024 for b1024), phase 20's gate:
# tests/test_torch_flat_sq8.py computes it
SQ8_RECALL_JAX = {64: 0.989453125, 1024: 0.98720703125}
# hnsw100k_clustered (phase 15), built by the native builder in both
# packages on the CPU: SHA-256 of layer 0's adjacency and of the whole graph
# (graph_hash), and the JAX package's fp32 and bf16 beams' recall@10 at ef 50
# over phase 15's 256 queries in batches of 64, and their gap; phase 15's
# gates. Reproduce: JAX_PLATFORMS=cpu python3 scripts/torch_hnsw_bf16_gap.py
HNSW100K_GRAPH_SHA256 = {"adj0": "3504a472aa996d4fb50264700d604180d795f1f58b74186a59be962905150567",
                         "graph": "d4fbb4dcc92b311887939940c8fb5759b6123d6b6fbf022c95faa9d49dee962b"}
HNSW_BF16_GAP_JAX = {"fp32": 0.990234375, "bf16": 0.989453125, "gap": 0.00078125}


def resp_clients(port: int, op: str, vectors: np.ndarray, requests: list, conc: int,
                 *, index: str, extra=(), prefix: str = "") -> dict:
    """``requests`` sent by bench/resp_load's client processes (at most
    four: the card's host has 8 cores) over ``conc`` connections: replies
    by request id, QPS, p50 / p99 ms."""
    return resp_load.drive(port, op, vectors, requests, conc, tenant=RESP_TENANT,
                           index=index, top_k=K, extra=extra, prefix=prefix, procs=4)


@contextlib.contextmanager
def uncounted():
    """Launches inside are taken back off the kernels' counts: a kernel held
    against its plain version, or timed alone, is not the path's work."""
    saved = dict(fs.LAUNCHES)
    try:
        yield
    finally:
        fs.LAUNCHES.update(saved)


def list_scan_at_serving_sizes(dev, tdev, queries: np.ndarray, nprobe: int,
                               what: str) -> dict:
    """The list scan's wrapper (scan and merge) against its plain version on
    an index's own device tensors and probes, at the micro-batch sizes the
    server hands it: 8 queries one at a time (b1) and 4 batches of 8 (b8).
    Equal hit sets but for k-th place ties, scores within RTOL / ATOL.
    Returns the largest score difference and the tie swaps by size."""
    kp = tdev["cents"].shape[0]
    n = tdev["xperm"].shape[0]   # no max_scans budget
    out = {}
    with uncounted():
        for b, batches in ((1, [queries[i:i + 1] for i in range(8)]),
                           (8, [queries[8 + 8 * i:16 + 8 * i] for i in range(4)])):
            err, swaps = 0.0, 0
            for qb in batches:
                q = torch.from_numpy(qb).to(dev)
                probe = rank_probes(q, tdev["cents"], tdev["cvalid"], tdev["offsets"],
                                    tdev["lens"], nprobe, n, Metric.L2)[0]
                args = (q, tdev["xperm"], tdev["sqnorm"], tdev["alive"], tdev["crow"])
                got = fs.fused_ivf_topk(*args, tdev["offsets"], tdev["lens"], probe, kp, K,
                                        max_len=tdev["l_pad"])
                e, sw = compare(got, fs.fused_ivf_topk_plain(*args, probe, kp, K),
                                f"{what} list scan b{b}")
                err, swaps = max(err, e), swaps + sw
            out[f"b{b}"] = {"max_abs_err": err, "tie_swaps": swaps}
    return out


def list_vs_probe_route(dev, tail, queries: np.ndarray) -> dict:
    """An IVF index's list-scan route (its scan_mode "dense") against its
    probe route (plain torch, which scan_mode "auto" takes at 1M nprobe 3
    below a few hundred queries) at the server's batch sizes b1, b8 and b64:
    the same hits but for k-th place ties, and each route's ms a
    device_search batch (host clock around the call and a sync, median of
    30), by route name."""
    out = {}
    mode, opts = tail.scan_mode, SearchOptions(nprobe=3)
    try:
        for b in (1, 8, 64):
            q = torch.from_numpy(queries[:b]).to(dev)
            got, times = {}, {}
            for scan_mode in ("dense", "probe"):
                tail.scan_mode = scan_mode
                route = tail.describe_scan(b, 3)
                got[scan_mode] = tail.device_search(q, K, opts)
                ms = []
                for _ in range(30):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    tail.device_search(q, K, opts)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t1) * 1e3)
                times[route] = round(statistics.median(ms), 4)
            compare(got["dense"], got["probe"], f"b{b} list scan route vs probe route")
            out[f"b{b}"] = times
    finally:
        tail.scan_mode = mode
    return out


def resp_search_cell(srv, index: str, queries: np.ndarray, n: int, conc: int,
                     nprobe: int, trace: bool = False) -> dict:
    """``n`` VEC.SEARCH top-10 requests over ``queries`` in turn, cache off:
    QPS, p50/p99 ms, the micro-batcher's batches and the list scan's
    launches in the cell. ``trace``: the requests ask for the engine's
    TRACE, and the cell adds the medians of its server-side times
    (``split_traces``)."""
    batcher = srv.server.engine.batcher
    b0, q0 = batcher.stats.batches, batcher.stats.queries
    l0 = fs.LAUNCHES["ivf_scan"]
    out = resp_clients(srv.port, "search", queries, [[r, r % len(queries)] for r in range(n)],
                       conc, index=index, extra=("NPROBE", nprobe) + (("TRACE",) if trace else ()))
    batches = batcher.stats.batches - b0
    out.update(requests=n, concurrency=conc, nprobe=nprobe, batches=batches,
               avg_batch=(batcher.stats.queries - q0) / max(batches, 1),
               ivf_launches=fs.LAUNCHES["ivf_scan"] - l0)
    if trace:
        split_traces(out)
    return out


def split_traces(out: dict) -> None:
    """Replies of TRACE requests: their hits stay in ``out["replies"]``, and
    ``out["server_ms"]`` takes the medians of the engine's TRACE times (ms):
    ``server`` from search_begin to the reply's assembly, ``engine`` in the
    micro-batcher (its wait, gate and search_batch), ``host_legs`` the
    policy, cache and metadata steps."""
    trs = [json.loads(reply[1]) for reply in out["replies"].values()]
    out["server_ms"] = {
        "server": statistics.median(t["latency_ms"] for t in trs),
        "engine": statistics.median(t["engine_ms"] for t in trs),
        "host_legs": statistics.median(t["policy_ms"] + t["cache_ms"] + t["metadata_ms"]
                                       for t in trs)}
    out["replies"] = {r: reply[0] for r, reply in out["replies"].items()}


def replies_match_search_batch(replies: dict, index, queries: np.ndarray,
                               opts: SearchOptions, what: str) -> float:
    """Every reply (request r asked for ``queries[r % len(queries)]``) names
    the hits of ``index.search_batch`` on the same queries, called directly
    now: equal hit sets (a hit may differ only as a tie at the k-th place)
    and scores within RTOL / ATOL of the direct ones. Returns the largest
    score difference."""
    direct = index.search_batch(queries, K, opts)
    err = 0.0
    for r, reply in replies.items():
        want = {h.id: h.score for h in direct[r % len(queries)]}
        got = {row[0]: float(row[1]) for row in reply}
        require(len(got) == len(want), f"{what}: request {r} has {len(got)} hits")
        kth = min(want.values())
        for rid in set(got) ^ set(want):
            score = got.get(rid, want.get(rid))
            require(np.isclose(score, kth, rtol=RTOL, atol=ATOL),
                    f"{what}: request {r} hit sets differ outside a k-th place tie")
        for rid in set(got) & set(want):
            require(np.isclose(got[rid], want[rid], rtol=RTOL, atol=ATOL),
                    f"{what}: request {r} score of {rid}: {got[rid]} vs {want[rid]}")
            err = max(err, abs(got[rid] - want[rid]))
    return err


def reply_recall(replies: dict, truth: np.ndarray) -> float:
    """recall@10 of the replies (request r asked for query r % len(truth))
    against exact truth rows; ids are "v<row>"."""
    rows = np.full((len(replies), K), -1, np.int64)
    want = np.empty((len(replies), K), np.int64)
    for i, (r, reply) in enumerate(sorted(replies.items())):
        ids = [int(row[0][1:]) for row in reply[:K]]
        rows[i, :len(ids)] = ids
        want[i] = truth[r % len(truth)]
    return recall_at_k(rows, want, K)


def phase_resp(dev, smi, data) -> dict:
    """The data plane over the wire: PyropeEngine + RespServer on port 0,
    client processes speaking RESP (scripts/serving_bench.py's cells).
    Returns the 1M cell's numbers, which phase 19 prints beside its own."""
    engine = PyropeEngine(EngineConfig(auth=AuthSettings(enabled=False), device="cuda"))
    # cache off, as serving_bench.py sets it: every request reaches the card
    engine.policy.store.update(CachePolicyConfig(enable_cache=False, default_ttl_seconds=60))
    srv = ThreadedServer(RespServer(engine, "127.0.0.1", 0))
    try:
        return _resp_cells(dev, smi, data, engine, srv)
    finally:
        srv.stop()


def _resp_cells(dev, smi, data, engine, srv) -> dict:
    t, card = RESP_TENANT, repr(smi)
    # serving_bench.py:255-257: the corpus and the query pool from one generator
    n, d, pool, nreq, nwrites = 100_000, 128, 4096, 2000, 4_000
    rng = np.random.default_rng(42)
    base = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((pool, d)).astype(np.float32)[:nreq]
    t0 = time.perf_counter()
    engine.create_index(t, "idx", IndexConfig(dim=d, algorithm="IVF_FLAT",
                                              params=IndexParams(nlist=100, nprobe=3)))
    require(engine.add_batch(t, "idx", [f"v{i}" for i in range(n)], base).ok, "add_batch")
    require(engine.build_index(t, "idx"), "build_index")
    build_s = time.perf_counter() - t0
    state = engine.registry.try_get(t, "idx")
    route = state.index.tail.describe_scan(64)
    require(route == "dense-pallas", f"serving_bench 100k route is {route}")
    truth = truth_on_card(base, queries, K, dev)
    with RespClient("127.0.0.1", srv.port) as c:   # the first request: warm
        c.vec_search(t, "idx", encode_vector(queries[0]), K)

    # the list scan against its plain version at the server's micro-batch
    # sizes, on the index's own tensors; then the host's share of one query:
    # the wrapper's call (host time to return, no sync) against its device
    # time, and search_batch b1
    tdev = state.index.tail._sync()
    plain = {nprobe: list_scan_at_serving_sizes(dev, tdev, queries, nprobe,
                                                f"100k np{nprobe}")
             for nprobe in (3, 96)}
    q1 = torch.from_numpy(queries[:1]).to(dev)
    kp = tdev["cents"].shape[0]
    probe = rank_probes(q1, tdev["cents"], tdev["cvalid"], tdev["offsets"], tdev["lens"],
                        3, n, Metric.L2)[0]
    call = lambda: fs.fused_ivf_topk(q1, tdev["xperm"], tdev["sqnorm"], tdev["alive"],
                                     tdev["crow"], tdev["offsets"], tdev["lens"], probe,
                                     kp, K, max_len=tdev["l_pad"])
    host = []
    with uncounted():
        for _ in range(50):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            call()
            host.append((time.perf_counter() - t1) * 1e3)
        events_ms, device_ms = cuda_ms(call, 20), device_split(call, 20).get("device_ms", 0.0)
        # the same call's host time by step (fs.host_split), the card synced
        # before each call: medians of 50 calls
        with fs.host_split() as marks:
            for _ in range(50):
                torch.cuda.synchronize()
                call()
    steps = {}
    for step, sec in marks:
        steps.setdefault(step, []).append(sec * 1e3)
    host_split = {step: round(statistics.median(v), 4) for step, v in steps.items()}
    wall = []
    for i in range(50):
        t1 = time.perf_counter()
        state.index.search_batch(queries[i:i + 1], K, SearchOptions(nprobe=3))
        wall.append((time.perf_counter() - t1) * 1e3)
    say("18 resp", cell="serving_bench_100k", n=n, build_s=round(build_s, 2), route=route,
        list_scan_vs_plain=repr(plain),
        list_scan_call_host_ms_b1=round(statistics.median(host), 4),
        list_scan_host_split_b1=repr(host_split),
        list_scan_cuda_events_ms_b1=round(events_ms, 4),
        list_scan_device_ms_b1=round(device_ms, 4),
        search_batch_b1_ms=round(statistics.median(wall), 4), card=card)

    # 1. search cells: replies equal a direct search_batch; recall; batching
    for nprobe in (3, 96):
        opts = SearchOptions(nprobe=nprobe)
        for conc in (4, 64):
            cell = resp_search_cell(srv, "idx", queries, nreq, conc, nprobe)
            err = replies_match_search_batch(cell["replies"], state.index, queries, opts,
                                             f"100k np{nprobe} c{conc}")
            rec = reply_recall(cell["replies"], truth)
            require(abs(rec - SERVING_RECALL_JAX[nprobe]) <= 0.005,
                    f"100k np{nprobe} recall {rec} vs the JAX package's "
                    f"{SERVING_RECALL_JAX[nprobe]}")
            require(cell["ivf_launches"] > 0, f"np{nprobe} c{conc}: no list scan launched")
            if conc == 64:
                require(cell["avg_batch"] > 1, f"np{nprobe} c64: avg_batch {cell['avg_batch']}")
            say("18 resp", cell=f"serving_bench_100k_np{nprobe}_c{conc}",
                requests=nreq, qps=round(cell["qps"], 1), p50_ms=round(cell["p50_ms"], 3),
                p99_ms=round(cell["p99_ms"], 3), avg_batch=round(cell["avg_batch"], 2),
                batches=cell["batches"], ivf_launches=cell["ivf_launches"],
                recall=rec, recall_jax_cpu=SERVING_RECALL_JAX[nprobe],
                max_abs_err_vs_search_batch=err, card=card)
    # where a request's time goes: 500 requests at concurrency 64 with the
    # engine's TRACE, under a torch.profiler trace of the card
    for nprobe in (3, 96):
        last = []
        tr = device_shares(lambda: last.append(
            resp_search_cell(srv, "idx", queries, 500, 64, nprobe, trace=True)), 1)
        per = {}
        if "busy_ms" in tr:
            per = {"device_ms_a_request": round(tr["busy_ms"] / 500, 4),
                   "span_ms_a_request": round(tr["span_ms"] / 500, 4)}
        cell = last[-1]
        say("18 resp", cell=f"serving_bench_100k_np{nprobe}_c64_trace", requests=500,
            qps=round(cell["qps"], 1), p50_ms=round(cell["p50_ms"], 3),
            avg_batch=round(cell["avg_batch"], 2),
            server_median_ms=repr({k: round(v, 3) for k, v in cell["server_ms"].items()}),
            trace=repr(tr), **per, card=card)

    # 2. writes: 4 writers x 1,000 VEC.UPSERT of new ids, each read back
    writes = np.random.default_rng(7).standard_normal((nwrites, d)).astype(np.float32)
    up = resp_clients(srv.port, "upsert", writes, [[r, r] for r in range(len(writes))], 4,
                      index="idx", prefix="w")
    require(all(v == "VEC_OK" for v in up["replies"].values()), "an upsert was refused")
    back = resp_clients(srv.port, "search", writes, [[r, r] for r in range(len(writes))], 64,
                        index="idx")
    missed = [r for r, reply in back["replies"].items() if reply[0][0] != f"w{r}"]
    require(not missed, f"{len(missed)} written ids not their own top-1, e.g. {missed[:3]}")
    gone = {f"w{r}" for r in range(100)}
    with RespClient("127.0.0.1", srv.port) as c:
        for rid in sorted(gone):
            require(c.vec_del(t, "idx", rid) == "VEC_OK", f"VEC.DEL {rid}")
    after = resp_clients(srv.port, "search", writes[:100], [[r, r] for r in range(100)], 4,
                         index="idx")
    seen = {row[0] for reply in after["replies"].values() for row in reply} & gone
    require(not seen, f"deleted ids still in replies: {sorted(seen)[:3]}")
    with RespClient("127.0.0.1", srv.port) as c:
        count = int(c.vec_stats(t, "idx")["count"])
    require(count == n + len(writes) - len(gone), f"VEC.STATS count {count}")
    say("18 resp", cell="serving_bench_100k_upsert", writers=4, writes=len(writes),
        vec_per_s=round(up["qps"], 1), p50_ms=round(up["p50_ms"], 3),
        p99_ms=round(up["p99_ms"], 3), coalescer=repr(srv.server.write_coalescer.to_dict()),
        read_back=len(back["replies"]), deleted=len(gone), stats_count=count, card=card)

    # 3. cache hits: one query repeated, cache on; hits stay on the host
    engine.policy.store.update(CachePolicyConfig(enable_cache=True, default_ttl_seconds=300))
    engine.flush_cache()
    with RespClient("127.0.0.1", srv.port) as c:
        first = c.vec_search(t, "idx", encode_vector(queries[0]), K, "TRACE")
        second = c.vec_search(t, "idx", encode_vector(queries[0]), K, "TRACE")
    require(json.loads(first[1])["cache_hit"] is False, "the first query hit the cache")
    level = json.loads(second[1])["cache_level"]
    require(level == "L0", f"the repeated query's TRACE names {level!r}, not L0")
    l0 = fs.LAUNCHES["ivf_scan"]
    hits = resp_clients(srv.port, "search", queries[:1], [[r, 0] for r in range(500)], 4,
                        index="idx")
    require(fs.LAUNCHES["ivf_scan"] == l0, "a cache hit launched the list scan")
    require(all(reply == second[0] for reply in hits["replies"].values()),
            "a cache hit's reply differs from the first")
    seen = {row[0] for reply in hits["replies"].values() for row in reply} & gone
    require(not seen, f"deleted ids in cache hits: {sorted(seen)[:3]}")
    engine.policy.store.update(CachePolicyConfig(enable_cache=False, default_ttl_seconds=60))
    say("18 resp", cell="serving_bench_100k_cache_hit", requests=500, concurrency=4,
        qps=round(hits["qps"], 1), p50_ms=round(hits["p50_ms"], 3),
        p99_ms=round(hits["p99_ms"], 3), trace_level=level, ivf_launches=0, card=card)

    # 4. 1M clustered (phase 4's corpus), nlist 1000, nprobe 3, concurrency 64
    base1m, queries1m, truth1m = data
    q1m = queries1m[:len(truth1m)]
    t0 = time.perf_counter()
    # scan_mode dense, as phase 4: "auto" sends 1M np3 batches below a few
    # hundred queries (every micro-batch) to the probe route, plain torch
    engine.create_index(t, "c1m", IndexConfig(dim=d, algorithm="IVF_FLAT",
                                              params=IndexParams(nlist=1000, nprobe=3,
                                                                 scan_mode="dense")))
    require(engine.add_batch(t, "c1m", [f"v{i}" for i in range(len(base1m))], base1m).ok,
            "add_batch 1M")
    require(engine.build_index(t, "c1m"), "build_index 1M")
    build_s = time.perf_counter() - t0
    state1m = engine.registry.try_get(t, "c1m")
    route = state1m.index.tail.describe_scan(64)
    require(route == "dense-pallas-win", f"1M nlist 1000 route is {route}")
    tdev = state1m.index.tail._sync()
    plain = list_scan_at_serving_sizes(dev, tdev, q1m, 3, "1M np3")
    routes = list_vs_probe_route(dev, state1m.index.tail, q1m)
    # the smallest batch that "auto" would send to the list scan here (the
    # JAX package's pick_scan_mode, the same rule and constants)
    npad, l_pad = tdev["xperm"].shape[0], tdev["l_pad"]
    auto_dense = next((b for b in range(1, 4097) if pick_scan_mode(
        "auto", npad, 3, l_pad, batch=b, pallas_ok=True) == "dense"), None)
    with RespClient("127.0.0.1", srv.port) as c:
        c.vec_search(t, "c1m", encode_vector(q1m[0]), K)
    cell = resp_search_cell(srv, "c1m", q1m, len(q1m), 64, 3)
    err = replies_match_search_batch(cell["replies"], state1m.index, q1m,
                                     SearchOptions(nprobe=3), "1M np3 c64")
    rec = reply_recall(cell["replies"], truth1m)
    require(rec >= 0.995, f"1M clustered recall {rec} < 0.995")
    require(cell["avg_batch"] > 1, f"1M c64: avg_batch {cell['avg_batch']}")
    last = []
    tr = device_shares(lambda: last.append(
        resp_search_cell(srv, "c1m", q1m, 512, 64, 3, trace=True)), 1)
    server_ms = {k: round(v, 3) for k, v in last[-1]["server_ms"].items()}
    say("18 resp", cell="ivf1m_clustered_np3_c64", n=len(base1m), build_s=round(build_s, 2),
        route=route, requests=cell["requests"], qps=round(cell["qps"], 1),
        p50_ms=round(cell["p50_ms"], 3), p99_ms=round(cell["p99_ms"], 3),
        avg_batch=round(cell["avg_batch"], 2), batches=cell["batches"],
        ivf_launches=cell["ivf_launches"], recall=rec, gate=0.995,
        max_abs_err_vs_search_batch=err, list_scan_vs_plain=repr(plain),
        list_vs_probe_route_ms=repr(routes), npad=npad,
        l_pad=l_pad, auto_dense_from_batch=auto_dense, trace_512=repr(tr),
        server_median_ms=repr(server_ms), card=card)
    engine.registry.drop(t, "c1m")
    return {"qps": round(cell["qps"], 1), "p50_ms": round(cell["p50_ms"], 3),
            "p99_ms": round(cell["p99_ms"], 3), "avg_batch": round(cell["avg_batch"], 2),
            "idle_share": tr.get("idle_share"), "server_median_ms": server_ms}


# ---- phase 19: the full stack as users start it ---------------------------------

STACK_TENANT, STACK_INDEX = "st", "c1m"
STACK_ADMIN_KEY = "smoke-admin-key"      # keys made up for the run
STACK_TENANT_KEY = "smoke-tenant-key"
STACK_TTL = 77.0   # the cache TTL the phase sets, which no sidecar policy has


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Child:
    """A process started with ``python -m <module>`` from the repo root, its
    stdout and stderr in files under ``tmp``; ``wait_for`` reads its stdout
    for a line."""

    def __init__(self, name: str, module: str, args: list, env: dict, tmp: str):
        self.name = name
        self.out_path = os.path.join(tmp, f"{name}.out")
        self.err_path = os.path.join(tmp, f"{name}.err")
        root = os.path.dirname(os.path.abspath(__file__))
        with open(self.out_path, "w") as out, open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", module, *map(str, args)], cwd=root,
                env={**os.environ, "PYTHONPATH": root, **env}, stdout=out, stderr=err)

    def stdout(self) -> str:
        with open(self.out_path) as f:
            return f.read()

    def stderr(self) -> str:
        with open(self.err_path) as f:
            return f.read()

    def wait_for(self, text: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            line = next((ln for ln in self.stdout().splitlines() if text in ln), None)
            if line is not None:
                return line
            require(self.proc.poll() is None,
                    f"{self.name} exited with {self.proc.returncode}: {self.stderr()[-3000:]}")
            time.sleep(0.2)
        raise RuntimeError(f"check failed: no {text!r} from {self.name} in {timeout} s: "
                           f"{self.stderr()[-3000:]}")

    def stop(self) -> int:
        """SIGINT, then the exit code (killed after 60 s)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode


def http(url: str, method: str, path: str, body=None, key: str = STACK_ADMIN_KEY,
         timeout: float = 600) -> tuple[int, object]:
    """(status, JSON body or text) of one control-plane request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    req.add_header("X-API-KEY", key)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw, ctype = r.status, r.read(), r.headers.get_content_type()
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers.get_content_type()
    return status, json.loads(raw) if ctype == "application/json" else raw.decode()


def http_ok(url: str, method: str, path: str, body=None, status: int = 200, **kw):
    got, reply = http(url, method, path, body, **kw)
    require(got == status, f"{method} {path}: {got} {str(reply)[:500]}")
    return reply


def trace_kernels(trace_dir: str) -> dict:
    """The card's kernels in the server's Chrome trace (the newest file
    under ``trace_dir``): counts of the list scan and the merge, every
    kernel by name, and the device's idle share of the span from the first
    kernel's start to the last one's end."""
    path = max(glob.glob(os.path.join(trace_dir, "pyrope_trace_*.json")),
               key=os.path.getmtime)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and "dur" in e]
    require(kernels, f"the server's trace {path} holds no device events")
    span = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
    busy = sum(e["dur"] for e in kernels)
    ours = ("ivf_list_scan_kernel", "merge_partials_kernel")
    by_name: dict[str, int] = {}
    for e in kernels:
        if e["cat"] == "kernel":   # names may come mangled: match ours inside
            name = next((k for k in ours if k in e["name"]), e["name"][:50])
            by_name[name] = by_name.get(name, 0) + 1
    return {**{k: by_name.get(k, 0) for k in ours},
            "kernels": sum(by_name.values()), "span_ms": round(span / 1e3, 3),
            "busy_ms": round(busy / 1e3, 3), "idle_share": round(1.0 - busy / span, 4),
            "top": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10]),
            "trace_mb": round(os.path.getsize(path) / 2**20, 1)}


def stack_cell(url: str, port: int, queries: np.ndarray, n: int, conc: int,
               trace: bool = False) -> dict:
    """``n`` VEC.SEARCH top-10 requests to the server process as the
    tenant: QPS, p50 / p99 ms and the micro-batcher's batches from its
    stats. ``trace``: the requests ask for the engine's TRACE, and the cell
    adds the medians of its server-side times (``split_traces``)."""
    path = f"/v1/indexes/{STACK_TENANT}/{STACK_INDEX}/stats"
    before = http_ok(url, "GET", path)["microbatch"]
    out = resp_load.drive(port, "search", queries, [[r, r % len(queries)] for r in range(n)],
                          conc, tenant=STACK_TENANT, index=STACK_INDEX, top_k=K,
                          extra=("NPROBE", 3) + (("TRACE",) if trace else ()), procs=4,
                          api_key=STACK_TENANT_KEY)
    after = http_ok(url, "GET", path)["microbatch"]
    batches = after["batches"] - before["batches"]
    out.update(requests=n, concurrency=conc, batches=batches,
               avg_batch=(after["queries"] - before["queries"]) / max(batches, 1))
    if trace:
        split_traces(out)
    return out


def phase_stack(dev, smi, data, in_thread: dict) -> None:
    """The full stack as users start it: the sidecar and the server as
    processes of their own (``python -m``), the 1M clustered IVF index
    loaded over HTTP, served over RESP, traced, written, rebuilt, and the
    sidecar's paths. ``in_thread``: phase 18's numbers for the same cell."""
    with tempfile.TemporaryDirectory(prefix="pyrope_stack_") as tmp:
        children = []
        try:
            _stack(dev, smi, data, in_thread, tmp, children)
        except BaseException:
            for child in children:
                child.stop()
                print(f"[19 stack] {child.name} exit {child.proc.returncode}, stderr:\n"
                      f"{child.stderr()[-6000:]}", file=sys.stderr, flush=True)
            raise


def _stack(dev, smi, data, in_thread: dict, tmp: str, children: list) -> None:
    t, ix, card = STACK_TENANT, STACK_INDEX, repr(smi)
    base1m, queries1m, truth1m = data
    q1m = queries1m[:len(truth1m)]
    snaps, sidecar_dir, trace_dir = (os.path.join(tmp, d) for d in
                                     ("snapshots", "sidecar", "trace"))
    sidecar_port, resp_port, http_port = free_port(), free_port(), free_port()
    url = f"http://127.0.0.1:{http_port}"
    times = {}
    t0 = time.perf_counter()
    # 1-2. both processes start while the smoke builds its own copy of the index
    sidecar = Child("sidecar", "pyrope_tpu_torch.sidecar.server", [],
                    {"PYROPE_SIDECAR_PORT": str(sidecar_port),
                     "PYROPE_SIDECAR_DATA": sidecar_dir}, tmp)
    children.append(sidecar)
    server = Child("server", "pyrope_tpu_torch.server",
                   ["--device", "cuda", "--resp-port", resp_port, "--http-port", http_port,
                    "--sidecar", f"127.0.0.1:{sidecar_port}"],
                   {"PYROPE_ADMIN_API_KEY": STACK_ADMIN_KEY, "PYROPE_SNAPSHOT_DIR": snaps},
                   tmp)
    children.append(server)
    engine = PyropeEngine(EngineConfig(auth=AuthSettings(enabled=False), device="cuda",
                                       snapshot_dir=snaps))
    config = {"dim": base1m.shape[1], "algorithm": "IVF_FLAT",
              "params": {"nlist": 1000, "nprobe": 3, "scan_mode": "dense"}}
    engine.create_index(t, ix, IndexConfig.from_dict(config))
    require(engine.add_batch(t, ix, [f"v{i}" for i in range(len(base1m))], base1m).ok,
            "add_batch 1M")
    require(engine.build_index(t, ix), "build_index 1M")
    times["build_s"] = round(time.perf_counter() - t0, 2)
    t1 = time.perf_counter()
    snap_bytes = engine.snapshot_index(t, ix, ix)
    times["snapshot_s"] = round(time.perf_counter() - t1, 2)
    state = engine.registry.try_get(t, ix)
    require(state.index.tail.describe_scan(64) == "dense-pallas-win", "the smoke's 1M route")
    sidecar.wait_for("listening", 60)
    serving = server.wait_for("serving RESP", 300)
    require("device cuda" in serving, f"the server says {serving!r}")
    t_up = time.perf_counter()
    times["server_up_s"] = round(t_up - t0, 2)

    # 3. cache off, as phase 18 serves this cell (every request reaches the
    # card), at a TTL no sidecar policy has: set before the reporter's first
    # report (~11 s after start), which replaces the TTL only
    http_ok(url, "PUT", "/v1/cache/policies",
            {"enable_cache": False, "default_ttl_seconds": STACK_TTL})
    # tenant, index and the snapshot, over HTTP with the admin key. The
    # tenant is high priority (0): the app's SLO monitor, which phase 18's
    # engine never ticks, caps a normal tenant's scans (max_scans 5000, the
    # plain dense-xla route) while p99 is above 50 ms, as c64 keeps it
    http_ok(url, "POST", "/v1/tenants", {"tenant": t, "api_key": STACK_TENANT_KEY,
                                         "quotas": {"priority": 0}}, 201)
    http_ok(url, "POST", "/v1/indexes", {"tenant": t, "index": ix, **config}, 201)
    t1 = time.perf_counter()
    loaded = http_ok(url, "POST", f"/v1/indexes/{t}/{ix}/load", {"path": ix})
    times["load_s"] = round(time.perf_counter() - t1, 2)
    require(loaded["stats"]["count"] == len(base1m), f"loaded {loaded['stats']}")

    # 4. serve over RESP: the replies against the smoke's own search_batch
    with RespClient("127.0.0.1", resp_port) as c:
        require(c.auth(t, STACK_TENANT_KEY), "AUTH")
        c.vec_search(t, ix, encode_vector(q1m[0]), K)
    cell = stack_cell(url, resp_port, q1m, len(q1m), 64)
    with uncounted():
        err = replies_match_search_batch(cell["replies"], state.index, q1m,
                                         SearchOptions(nprobe=3), "stack 1M np3 c64")
    rec = reply_recall(cell["replies"], truth1m)
    require(rec >= 0.995, f"the server process's recall {rec} < 0.995")
    require(cell["avg_batch"] > 1, f"stack c64: avg_batch {cell['avg_batch']}")

    # 5. the server traces itself while it serves (TRACE requests, as phase
    # 18's trace cell): its list scan and merge by name, its idle share
    # the requests outlast the trace: the profiler's first start takes
    # seconds (CUPTI's set-up), and the 3 s window begins after it
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        load = pool.submit(stack_cell, url, resp_port, q1m, 6000, 64, trace=True)
        time.sleep(0.5)
        t1 = time.perf_counter()
        traced = http_ok(url, "POST", "/v1/debug/trace", {"seconds": 3, "path": trace_dir})
        trace_call_s = time.perf_counter() - t1
        tcell = load.result(timeout=600)
    require(traced["status"] == "captured", f"debug trace: {traced}")
    tr = trace_kernels(trace_dir)
    require(tr["ivf_list_scan_kernel"] > 0 and tr["merge_partials_kernel"] > 0,
            f"the server's trace names no list scan or merge: {tr['top']}")
    say("19 stack", cell="ivf1m_clustered_np3_c64", process="server of its own",
        requests=cell["requests"], qps=round(cell["qps"], 1),
        p50_ms=round(cell["p50_ms"], 3), p99_ms=round(cell["p99_ms"], 3),
        avg_batch=round(cell["avg_batch"], 2), batches=cell["batches"], recall=rec,
        gate=0.995, max_abs_err_vs_search_batch=err, trace_3s=repr(tr),
        trace_call_s=round(trace_call_s, 2), traced_requests=tcell["requests"],
        traced_qps=round(tcell["qps"], 1), traced_avg_batch=round(tcell["avg_batch"], 2),
        server_median_ms=repr({k: round(v, 3) for k, v in tcell["server_ms"].items()}),
        in_thread_phase_18=repr(in_thread),
        snapshot_bytes=snap_bytes, times=repr(times), card=card)

    # 6. writes of new ids, then a rebuild on the card: each read back
    nwrites = 4_000
    writes = np.random.default_rng(19).standard_normal((nwrites, base1m.shape[1])).astype(
        np.float32)
    added = resp_load.drive(resp_port, "add", writes, [[r, r] for r in range(nwrites)], 4,
                            tenant=t, index=ix, prefix="w", api_key=STACK_TENANT_KEY)
    require(all(v == "VEC_OK" for v in added["replies"].values()), "a VEC.ADD was refused")
    t1 = time.perf_counter()
    built = http_ok(url, "POST", f"/v1/indexes/{t}/{ix}/build", key=STACK_TENANT_KEY)
    build_http_s = time.perf_counter() - t1
    back = resp_load.drive(resp_port, "search", writes, [[r, r] for r in range(nwrites)], 64,
                           tenant=t, index=ix, top_k=K, extra=("NPROBE", 3),
                           api_key=STACK_TENANT_KEY)
    missed = [r for r, reply in back["replies"].items() if reply[0][0] != f"w{r}"]
    require(not missed, f"{len(missed)} added ids not their own top-1, e.g. {missed[:3]}")
    stats = http_ok(url, "GET", f"/v1/indexes/{t}/{ix}/stats", key=STACK_TENANT_KEY)
    require(built["stats"]["count"] == stats["count"] == len(base1m) + nwrites,
            f"stats count {stats['count']}")

    # 7. the sidecar's paths: the centroid push (trained on the card here) ...
    sample = base1m[np.random.default_rng(7).choice(len(base1m), 65_536, replace=False)]
    trainer = SemanticModelTrainer(url, api_key=STACK_ADMIN_KEY, k=256, device="cuda")
    t1 = time.perf_counter()
    cents = trainer.train(sample)
    train_s = time.perf_counter() - t1
    require(cents.shape == (256, base1m.shape[1]) and np.isfinite(cents).all(),
            f"centroids {cents.shape}")
    pushed = trainer.push(t, ix, cents)
    require(pushed == {"status": "updated", "clusters": 256}, f"centroid push: {pushed}")
    epoch = http_ok(url, "GET", f"/v1/indexes/{t}/{ix}/stats")["epoch"]
    require(epoch == stats["epoch"] + 1, f"epoch {stats['epoch']} -> {epoch}")
    # ... the metrics reporter (first report on its second tick, ~11 s after
    # start), the AI proxy
    decisions_path = os.path.join(sidecar_dir, "decisions.jsonl")
    while True:
        decisions = []
        if os.path.exists(decisions_path):
            with open(decisions_path) as f:
                decisions = [json.loads(ln) for ln in f if ln.strip()]
        if decisions or time.perf_counter() - t_up > 60:
            break
        time.sleep(0.5)
    require(decisions, "the sidecar logged no decision")
    policy = http_ok(url, "GET", "/v1/cache/policies")
    ttls = {float(d["policy"]["ttl_seconds"]) for d in decisions}
    require(policy["default_ttl_seconds"] in ttls and policy["enable_cache"] is False,
            f"the engine's policy {policy} holds no sidecar decision's TTL {sorted(ttls)}")
    metrics = http_ok(url, "GET", "/v1/metrics")
    fallbacks = int(re.search(r"^pyrope_ai_fallback_total (\d+)$", metrics, re.M).group(1))
    sklearn = subprocess.run([sys.executable, "-c", "import sklearn, joblib"],
                             capture_output=True, timeout=120).returncode == 0
    models = http_ok(url, "GET", "/v1/ai/models")
    require({"active", "canary", "canary_tenants", "staged"} <= set(models),
            f"/v1/ai/models: {models}")
    # AI fallbacks are printed, not held to a number: each is a report that
    # missed the 50 ms warm-path deadline, which the host's load decides
    # (and the sidecar's first sklearn import, bandit_engine.py
    # _ensure_model), or failed where sklearn is missing
    train = http_ok(url, "POST", "/v1/ai/models/train") if sklearn else "not run"
    if sklearn:
        require(train["status"] == "training", f"/v1/ai/models/train: {train}")
    say("19 stack", writes=nwrites, add_vec_per_s=round(added["qps"], 1),
        build_over_http_s=round(build_http_s, 2), read_back=len(back["replies"]),
        readback_qps=round(back["qps"], 1), stats_count=stats["count"],
        centroids_trained_s=round(train_s, 3), centroid_push=repr(pushed),
        epoch=f"{stats['epoch']}->{epoch}", decisions=len(decisions),
        engine_ttl=policy["default_ttl_seconds"], sidecar_ttls=repr(sorted(ttls)),
        ai_fallbacks=fallbacks, sklearn_imports=sklearn, ai_models=repr(models),
        ai_train=repr(train), seconds_since_server_up=round(time.perf_counter() - t_up, 1),
        card=card)

    # 8. stop both: clean exits
    for child in (server, sidecar):
        code = child.stop()
        require(code == 0, f"{child.name} exited with {code}: {child.stderr()[-3000:]}")
    children.clear()
    engine.registry.drop(t, ix)


# ---- phases 20-22: Flat sq8, DeviceFlatIndex at 10M, the sharded families ----


def index_device_bytes(dev_state: dict) -> int:
    """Bytes of the tensors of an index's device state."""
    return sum(t.numel() * t.element_size() for t in dev_state.values()
               if isinstance(t, torch.Tensor))


def phase_flat_sq8(dev, smi) -> None:
    """sq8_100k (b64) and sq8_100k_b1024 (bench.py:141, :284): FlatIndex
    storage="sq8" on synthetic(100k, 128), L2, k 10, route flat-sq8 (plain
    torch, as the JAX package's XLA scan); recall of the first 256 / 1024
    queries within 0.005 of the JAX package's on the CPU; one incremental
    upsert read back."""
    n, d = 100_000, 128
    base = synthetic(n, d)
    queries = synthetic_queries(1024, d)
    truth = ground_truth(base, queries, K, block=16384)
    ix = FlatIndex(d, "L2", device=dev, storage="sq8")
    t0 = time.perf_counter()
    ix.add_batch([str(i) for i in range(n)], base)
    ix._sync()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    route = ix.describe_scan(1024)
    require(route == "flat-sq8", f"sq8 route is {route}")
    q_dev = [torch.from_numpy(queries[s:s + 256]).to(dev) for s in range(0, 1024, 256)]
    rows = np.concatenate([ix.device_search(q, K)[1].cpu().numpy() for q in q_dev])
    ids = id_lists_to_rows(ix.resolve_rows(rows), K)
    rec = {b: recall_at_k(ids[:m], truth[:m], K) for b, m in ((64, 256), (1024, 1024))}
    for b, r in rec.items():
        require(abs(r - SQ8_RECALL_JAX[b]) <= 0.005,
                f"sq8 b{b} recall@10 {r} not within 0.005 of the JAX package's "
                f"{SQ8_RECALL_JAX[b]}")
    q64 = [torch.from_numpy(queries[s:s + 64]).to(dev) for s in range(0, 1024, 64)]
    q1024 = [torch.from_numpy(queries).to(dev)]
    s64, s1024 = serve(ix, q64, iters=200), serve(ix, q1024, iters=50)
    split = device_split(lambda: ix.device_search(q1024[0], K))
    codes = ix._dev["codes"]
    moved = base[77] * 0.5 + 0.25
    ix.upsert("5", moved)
    hit = ix.search(moved, 1)[0]
    require(hit.id == "5", f"the upserted row reads back as {hit.id}")
    require(ix._dev["codes"] is codes, "the upsert re-uploaded the slab")
    say("20 flat sq8", cells="sq8_100k (b64), sq8_100k_b1024", route=route, n=n,
        build_s=round(build_s, 2), capacity=ix.capacity,
        device_bytes=index_device_bytes(ix._dev), recall_b64_first256=rec[64],
        recall_b1024=rec[1024], recall_jax_cpu=repr(SQ8_RECALL_JAX),
        tpu_records="0.9891 (b64) / 0.9871 (b1024), taken on a TPU (BENCH_DETAIL.json)",
        **{f"b64_{k}": v for k, v in s64.items()},
        **{f"b1024_{k}": v for k, v in s1024.items()},
        b1024_device_split=repr(split), upsert_read_back=hit.id, card=repr(smi))


def phase_device_flat(dev, smi) -> None:
    """flat10m_device_fp32_b1024 and flat10m_device_b1024 (bench.py:119-133,
    :663-760): DeviceFlatIndex over 10M x 128 uniform rows generated on the
    card from seed 42 (no host slab), L2, k 10, selection "pallas" (K1 fp32,
    K1 bf16); truth the port's chunked_exact_topk over the fp32 rows for 256
    queries; then a 100k DeviceFlatIndex's snapshot loaded into FlatIndex."""
    from pyrope_tpu_torch.index.device_flat import DeviceFlatIndex
    from pyrope_tpu_torch.ops.topk import chunked_exact_topk

    n, d, b, nt = 10_000_000, 128, 1024, 256
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(42)
    xf = torch.rand((n, d), generator=g, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    queries = synthetic_queries(b, d)
    q_dev = [torch.from_numpy(queries).to(dev)]
    t0 = time.perf_counter()
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    truth_v, truth_i = chunked_exact_topk(xf, (xf * xf).sum(1), alive, q_dev[0][:nt], K, "L2")
    truth_s = time.perf_counter() - t0
    del alive
    for name, dtype, key in (("flat10m_device_fp32_b1024", torch.float32, "flat_scan"),
                             ("flat10m_device_b1024", torch.bfloat16, "flat_scan_bf16")):
        t0 = time.perf_counter()
        slab = xf if dtype == torch.float32 else xf.bfloat16()
        ix = DeviceFlatIndex(slab, "L2", selection="pallas")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        require(ix._dev["vecs"] is slab and ix.describe_scan(b) == "device-pallas",
                f"{name}: the slab was not adopted in place on device-pallas")
        before = fs.LAUNCHES[key]
        out = ix.device_search(q_dev[0][:nt], K)
        require(fs.LAUNCHES[key] == before + 1, f"{name}: {key} not launched once")
        ids = id_lists_to_rows(ix.resolve_rows(out[1].cpu().numpy()), K)
        rec = recall_at_k(ids, truth_i, K)
        extra = {}
        if dtype == torch.float32:
            err, ties = compare(out, (torch.from_numpy(truth_v), torch.from_numpy(truth_i)),
                                f"{name} vs chunked exact truth")
            extra.update(max_abs_err_vs_truth=err, kth_ties=ties)
        with uncounted():   # the served batch, b1024, against the plain version
            d_ = ix._dev
            plain = fs.fused_flat_topk_plain(q_dev[0], d_["vecs"], d_["sqnorm"],
                                             d_["alive"], n, K, chunk_rows=1 << 18)
            err, ties = compare(ix.device_search(q_dev[0], K), plain,
                                f"{name} b{b} vs K1's plain version")
        extra.update(max_abs_err_vs_plain_b1024=err, kth_ties_vs_plain=ties)
        srv = serve(ix, q_dev, iters=20 if dtype == torch.float32 else 100)
        split = device_split(lambda: ix.device_search(q_dev[0], K), calls=3)
        say("21 device flat", cell=name, n=n, d=d, slab=str(dtype).split(".")[-1],
            batch=b, gen_s=round(gen_s, 2), truth_s=round(truth_s, 2),
            build_s=round(build_s, 3), device_bytes=ix.memory_bytes(),
            recall_256=rec, **extra, **srv, device_split=repr(split),
            launches={key: fs.LAUNCHES[key]}, card=repr(smi))
        del ix, slab, out
    del xf
    torch.cuda.empty_cache()
    small = torch.rand((100_000, d), generator=g, device=dev)
    ix = DeviceFlatIndex(small, "L2")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "device_flat.npz")
        ix.snapshot(path)
        host = FlatIndex(d, "L2", device=dev, selection="pallas")
        host.load(path)
    a = [[h.id for h in r] for r in ix.search_batch(queries[:64], K)]
    h = [[x.id for x in r] for r in host.search_batch(queries[:64], K)]
    require(a == h, "the 100k snapshot loaded into FlatIndex searches otherwise")
    say("21 device flat", snapshot_100k="loaded into FlatIndex, same hits on 64 queries")


def one_card_mesh(dev, n=4, two_d=False):
    """n shards on the one card (devices repeated): the shard layouts,
    per-shard launches and the merge, no interconnect."""
    from pyrope_tpu_torch.parallel import make_mesh, make_mesh_2d

    devs = [dev] * n
    return make_mesh_2d(2, n // 2, devices=devs) if two_d else make_mesh(devices=devs)


def hits_arrays(results, k=K) -> tuple[torch.Tensor, torch.Tensor]:
    """search_batch results as (scores, int ids) tensors, -inf/-1 padded."""
    v = np.full((len(results), k), -np.inf, np.float32)
    i = np.full((len(results), k), -1, np.int64)
    for r, row in enumerate(results):
        for j, h in enumerate(row):
            v[r, j], i[r, j] = h.score, int(h.id)
    return torch.from_numpy(v), torch.from_numpy(i)


def shard_merge_vs_plain(groups: list, what: str, dev) -> None:
    """The shard merge on each batch group's [nd, B, k] lists (the shards'
    encoded lists, as the path hands them over) bit-equal to its plain
    version on the same stacked tensors."""
    from pyrope_tpu_torch.parallel.mesh import allgather_merge_topk

    with uncounted():
        for g, lists in enumerate(groups):
            got = allgather_merge_topk(lists, K, dev)
            plain = fs.merge_partials_plain(torch.stack([v for v, _ in lists]),
                                            torch.stack([r for _, r in lists]), k=K)
            require(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]),
                    f"{what}: group {g}'s shard merge differs from its plain version")


def shards_vs_plain(dv: dict, q, scan, plain, what: str, dev) -> dict:
    """A shard kernel's wrapper against its plain version on every shard's
    own device tensors at the batch the path gives it (a 2 x 2 mesh splits
    q over its batch groups), then the merge of the shards' lists. ``scan``
    and ``plain`` map (shard state, q) to a (scores, local rows) pair.
    Equal hit sets but for k-th place ties, scores within RTOL / ATOL.
    These launches are not the path's."""
    from pyrope_tpu_torch.parallel.mesh import encode_rows

    shards = dv["shards"]
    err, swaps, groups = 0.0, 0, []
    with uncounted():
        for g, qg in enumerate(torch.tensor_split(q, len(shards))):
            lists = []
            for s, st in enumerate(shards[g]):
                got = scan(st, qg)
                e, sw = compare(got, plain(st, qg), f"{what} shard {s} b{len(qg)}")
                err, swaps = max(err, e), swaps + sw
                lists.append((got[0], encode_rows(got[1], st["base"])))
            groups.append(lists)
    shard_merge_vs_plain(groups, what, dev)
    return {"max_abs_err": err, "tie_swaps": swaps,
            "shape": f"{len(shards[0])} shards x b{len(q) // len(shards)}"}


def list_scan_shards_vs_plain(dv: dict, q, nprobe: int, what: str, dev,
                              slab: str = "xperm", sqnorm: str = "sqnorm",
                              promote: bool = False) -> dict:
    """shards_vs_plain for the list scan over each shard's local CSR, the
    probes ranked off its own centroids, as the sharded routes call it."""
    from pyrope_tpu_torch.index.ivf_flat import top_probes

    def args(st, qg):
        probe = top_probes(qg, st["cents"], st["cvalid"], nprobe, Metric.L2)
        return (qg, st[slab], st[sqnorm], st["alive"], st["crow"]), probe, st["cents"].shape[0]

    def scan(st, qg):
        a, probe, kp = args(st, qg)
        return fs.fused_ivf_topk(*a, st["offsets"], st["lens"], probe, kp, K,
                                 max_len=dv["l_pad"], promote_fp32=promote)

    def plain(st, qg):
        a, probe, kp = args(st, qg)
        return fs.fused_ivf_topk_plain(*a, probe, kp, K, promote_fp32=promote)

    return shards_vs_plain(dv, q, scan, plain, what, dev)


def sharded_cell(ix, q_dev, iters: int) -> dict:
    """QPS and latency, the device ms of one device_search split into the
    shards' scans and the merges (torch.profiler), and the kernels one
    device_search launches."""
    srv = serve(ix, q_dev, iters=iters)
    split = device_split(lambda: ix.device_search(q_dev[0], K), calls=3)
    before = dict(fs.LAUNCHES)
    ix.device_search(q_dev[0], K)
    torch.cuda.synchronize()
    per_call = {k: n - before[k] for k, n in fs.LAUNCHES.items() if n != before[k]}
    return {**srv, "device_split": repr(split), "launches_a_call": repr(per_call)}


def ivf_flat_arrays(ix) -> dict:
    """An IvfFlatIndex's ``pyrope_tpu.ivf_flat.v1`` state as arrays (what
    its snapshot writes, without the compression)."""
    bids, bvecs = ix._buffer.live_vectors()
    meta = {"format": "pyrope_tpu.ivf_flat.v1", "dim": ix.dim, "metric": ix.metric.value,
            "nlist": ix.nlist, "nprobe": ix.nprobe, "built": ix._built, "seed": ix.seed,
            "scan_mode": ix.scan_mode}
    return {"meta": json.dumps(meta), "centroids": ix._centroids, "xperm": ix._xperm,
            "perm_ids": np.array(ix._perm_ids), "alive": ix._alive, "offsets": ix._offsets,
            "lens": ix._lens, "buf_ids": np.array(bids, dtype=np.str_), "buf_vecs": bvecs}


def phase_sharded(dev, smi, clustered, uniform, hnsw100k) -> None:
    """The sharded families on a 4-shard mesh of the one card
    (devices=[cuda:0] * 4): IVF-Flat at 1M in both layouts and on a 2 x 2
    batch x data mesh, Flat at 1M (K1 on every shard, the max_scans budget
    rebased; sq8 storage), IVF-PQ at 100k with an fp32 rerank slab, HNSW
    with the graph replicated (phase 15's hnsw100k_clustered graph) and
    partitioned (100k clustered)."""
    from pyrope_tpu_torch import convert
    from pyrope_tpu_torch.parallel import (
        ShardedFlatIndex,
        ShardedHnswCorpusIndex,
        ShardedHnswIndex,
    )
    from pyrope_tpu_torch.parallel.mesh import allgather_merge_topk

    mesh = one_card_mesh(dev)
    say("22 sharded", mesh=repr(mesh), note="4 shards on one card: no interconnect measured")
    base, queries, truth = clustered
    d, b = base.shape[1], 1024
    q_dev = [torch.from_numpy(queries[i * b:(i + 1) * b]).to(dev) for i in range(4)]

    # IVF-Flat 1M: one k-means (the single index), its partition laid out
    # per shard three ways
    single = IvfFlatIndex(d, "L2", device=dev, nlist=1000, nprobe=3, scan_mode="dense")
    single.add_batch([str(i) for i in range(len(base))], base)
    t0 = time.perf_counter()
    single.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ref = single.search_batch(queries[:b], K)
    arrays = ivf_flat_arrays(single)
    for layout, m, shard_by in (("rows", mesh, "rows"), ("cluster", mesh, "cluster"),
                                ("rows_2x2", one_card_mesh(dev, two_d=True), "rows")):
        sh = convert.sharded_ivf_flat_from_arrays(arrays, m, shard_by=shard_by)
        t0 = time.perf_counter()
        sh._sync()
        torch.cuda.synchronize()
        layout_s = time.perf_counter() - t0
        route = sh.describe_scan(b)
        require(route == "dense-pallas-win", f"sharded IVF {layout} route is {route}")
        before = dict(fs.LAUNCHES)
        got = sh.search_batch(queries[:b], K)
        scans = fs.LAUNCHES["ivf_scan"] - before["ivf_scan"]
        require(scans == 4 and fs.LAUNCHES["merge"] - before["merge"] >= 5,
                f"sharded IVF {layout}: {scans} list scans for 4 shards")
        err, ties = compare(hits_arrays(got), hits_arrays(ref), f"sharded IVF {layout}")
        rec = recall(got, truth)
        require(rec >= 0.995, f"sharded IVF {layout} recall@10 {rec} < 0.995")
        dv = sh._sync()
        vs_plain = list_scan_shards_vs_plain(dv, q_dev[0], sh.nprobe,
                                             f"sharded IVF {layout}", dev)
        with uncounted():   # the shard merge of 4 [1024, 10] lists alone
            per = [sh.device_search(q, K) for q in q_dev]
            merge_ms = cuda_ms(lambda: allgather_merge_topk(per, K, dev), 20)
        say("22 sharded", family="ShardedIvfFlatIndex", cell="ivf1m_clustered_b1024",
            layout=layout, route=route, stride=dv["stride"], l_pad=dv["l_pad"],
            single_build_s=round(build_s, 2), layout_s=round(layout_s, 2), recall=rec,
            max_abs_err_vs_single=err, kth_ties=ties, kernel_vs_plain=repr(vs_plain),
            **sharded_cell(sh, q_dev, 50),
            shard_merge_ms=round(merge_ms, 4), card=repr(smi))
        del sh, dv, per
    del single, arrays
    torch.cuda.empty_cache()

    # Flat 1M exact: K1 on every shard, the budget rebased; then sq8
    ubase, uqueries, _ = uniform
    ids = [str(i) for i in range(len(ubase))]
    uq = [torch.from_numpy(uqueries[i * b:(i + 1) * b]).to(dev) for i in range(2)]
    for storage, sel in (("fp32", "pallas"), ("sq8", "exact")):
        sh = ShardedFlatIndex(d, "L2", mesh=mesh, storage=storage, selection=sel)
        one = FlatIndex(d, "L2", device=dev, storage=storage, selection=sel)
        for ix in (sh, one):
            ix.add_batch(ids, ubase)
        route = sh.describe_scan(b)
        rtol = RTOL if storage == "fp32" else SQ8_RTOL
        checks = {}
        for name, opts in (("full", SearchOptions()), ("max_scans_600001",
                                                       SearchOptions(max_scans=600_001))):
            before = fs.LAUNCHES["flat_scan"]
            got = sh.device_search(uq[0], K, opts)
            if storage == "fp32":
                require(fs.LAUNCHES["flat_scan"] - before == 4, "K1 not once a shard")
            checks[name] = compare(got, one.device_search(uq[0], K, opts),
                                   f"sharded flat {storage} {name}", rtol)
            if storage == "fp32":   # K1 on each shard's block, the budget rebased
                ms = sh._count if opts.max_scans is None else opts.max_scans
                dv = sh._sync()

                def local_ms(st):
                    return min(max(ms - st["base"], 0), st["alive"].shape[0])
                checks[f"{name}_K1_vs_plain"] = shards_vs_plain(
                    dv, uq[0],
                    lambda st, qg: fs.fused_flat_topk(qg, st["vecs"], st["sqnorm"],
                                                      st["alive"], local_ms(st), K),
                    lambda st, qg: fs.fused_flat_topk_plain(qg, st["vecs"], st["sqnorm"],
                                                            st["alive"], local_ms(st), K,
                                                            chunk_rows=1 << 17),
                    f"sharded flat K1 {name}", dev)
        say("22 sharded", family="ShardedFlatIndex", cell=f"flat1m_{storage}_b1024",
            route=route, vs_single=repr(checks), **sharded_cell(sh, uq, 20), card=repr(smi))
        del sh, one
    torch.cuda.empty_cache()

    # IVF-PQ 100k, fp32 rerank slab: the list scan per shard (promote)
    pbase = synthetic_clustered(100_000, d, n_clusters=100)
    pq_q = synthetic_clustered_queries(b, d, n_clusters=100)
    ptruth = ground_truth(pbase, pq_q, K, block=16384)
    single, pq_build_s = _pq_narrow_index(dev, pbase)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pq.npz")
        single.snapshot(path)
        with np.load(path) as z:
            sh = convert.sharded_ivf_pq_from_arrays(z, mesh)
    pq_dev = [torch.from_numpy(pq_q).to(dev)]
    route = sh.describe_scan(b)
    require(route == "dense-exact-pallas", f"sharded IVF-PQ route is {route}")
    before = fs.LAUNCHES["ivf_scan"]
    r_sh = recall(sh.search_batch(pq_q, K), ptruth)
    require(fs.LAUNCHES["ivf_scan"] - before == 4, "the list scan not once a shard")
    r_one = recall(single.search_batch(pq_q, K), ptruth)
    require(r_sh >= r_one, f"sharded IVF-PQ recall {r_sh} < the single index's {r_one}")
    vs_plain = list_scan_shards_vs_plain(sh._sync(), pq_dev[0], sh.nprobe,
                                         "sharded IVF-PQ rerank slab", dev, slab="xraw",
                                         sqnorm="xsqnorm", promote=True)
    say("22 sharded", family="ShardedIvfPqIndex", cell="ivfpq100k_fp32slab_b1024",
        route=route, build_s=round(pq_build_s, 2), recall=r_sh, single_recall=r_one,
        kernel_vs_plain=repr(vs_plain),
        **sharded_cell(sh, pq_dev, 50), card=repr(smi))
    del sh, single

    # HNSW: phase 15's graph replicated, queries split over the shards
    graph, hq, htruth = hnsw100k
    sh = ShardedHnswIndex(d, "L2", mesh=mesh, ef_search=50)
    sh._restore(graph._arrays())
    opts = SearchOptions(ef_search=50)
    a = sh.search_batch(hq, K, opts)
    err, ties = compare(hits_arrays(a), hits_arrays(graph.search_batch(hq, K, opts)),
                        "sharded HNSW vs the single beam")
    hq_dev = [torch.from_numpy(hq[:64]).to(dev)]
    say("22 sharded", family="ShardedHnswIndex", cell="hnsw100k_clustered_b64",
        recall=recall(a, htruth), max_abs_err_vs_single=err, kth_ties=ties,
        **sharded_cell(sh, hq_dev, 50), card=repr(smi))
    r_ref = hnsw_recall(graph, hq, htruth, 64, opts)
    del sh

    # HNSW partitioned: k-means cells, a native sub-graph a shard
    cbase = synthetic_clustered(100_000, d, n_clusters=100)
    sh = ShardedHnswCorpusIndex(d, "L2", mesh=mesh, ef_search=50)
    t0 = time.perf_counter()
    sh.add_batch([str(i) for i in range(len(cbase))], cbase)
    sh.build()
    build_s = time.perf_counter() - t0
    r_sh = hnsw_recall(sh, hq, htruth, 64, opts)
    require(r_sh >= r_ref - 0.02 and r_sh >= 0.9,
            f"corpus-sharded HNSW recall {r_sh} (replicated {r_ref})")
    before = fs.LAUNCHES["merge"]
    sh.device_search(hq_dev[0], K, opts)
    require(fs.LAUNCHES["merge"] == before + 1, "the shard merge not launched once")
    say("22 sharded", family="ShardedHnswCorpusIndex", cell="hnsw100k_clustered_b64",
        build_s=round(build_s, 2), recall=r_sh, replicated_recall=r_ref,
        cells=[s.get_stats().count for s in sh._subs], memory=repr(sh.memory_bytes()),
        **sharded_cell(sh, hq_dev, 50), card=repr(smi))


# recall@10 of ivf100k_zipf (IvfFlatIndex nlist 100, nprobe 3 on
# synthetic_zipf(100k, 128, 100), the first 256 of 1024 Zipf queries) in the
# JAX package on the CPU; tests/test_torch_zipf.py holds it
ZIPF_RECALL_JAX = 0.98984375
# the 1M Zipf rows' partition recall@10 at nprobe 3 on the JAX package's own
# partition (tests/data/zipf1m_jax_centroids.npz: kmeans_build on the CPU,
# nlist 1000, bf16 Lloyd, seed 42 for IVF-Flat, 123 for IVF-PQ), keyed by
# (seed, queries): tests/make_zipf1m_partition.py wrote both, and
# tests/test_torch_zipf_partition.py holds them. Phase 23 rebuilds the three
# rows on those centroids and holds the card within 0.005.
ZIPF1M_CENTROIDS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                                "zipf1m_jax_centroids.npz")
ZIPF1M_RECALL_JAX = {(42, 256): 0.944921875, (42, 1024): 0.95439453125,
                     (123, 256): 0.94375}


def zipf_data(n: int, nc: int, dev) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """bench.py's Zipf corpus (``synthetic_zipf(n, 128, nc)``), its 1024
    queries (``synthetic_zipf_queries``, the same popularity), and the exact
    top-10 of all of them, float64 on the card."""
    base = synthetic_zipf(n, 128, n_clusters=nc)
    queries = synthetic_zipf_queries(1024, 128, n_clusters=nc)
    return base, queries, truth_on_card(base, queries, K, dev)


def zipf_lists(ix) -> dict:
    """The partition an IVF build left (IvfFlatIndex or IvfPqIndex): lists,
    empty ones, the longest five, the slab's l_pad (what the list scan's
    max_len and the probe route's gather take)."""
    lens = np.sort(ix._lens)
    return {"lists": int(lens.size), "empty_lists": int((lens == 0).sum()),
            "longest": lens[::-1][:5].tolist(), "l_pad": int(ix._sync()["l_pad"]),
            "rows": int(lens.sum())}


def list_scan_shape(dev, tdev, q, nprobe: int, slab="xperm", sqnorm="sqnorm") -> dict:
    """One list-scan call at an index's own probes for ``q``: the grid it
    launches against the items that hold rows, the segments a chunk, the
    slots it allocates against those a query fills (mean, most), the
    segment, its one buffer's bytes, its first pass (None: none runs), the
    plans the process has cached (``fs.list_call``, keyed by shapes, max_len
    among them), and its device ms split into scan and merge
    (torch.profiler; empty where it records no device time). Its launches
    are taken off the path's counts."""
    kp, n = tdev["cents"].shape[0], tdev["alive"].shape[0]
    b = q.shape[0]
    probe = rank_probes(q, tdev["cents"], tdev["cvalid"], tdev["offsets"], tdev["lens"],
                        nprobe, n, Metric.L2)[0]
    call = fs.list_call(K, fs.LIST_IVF, False, b, nprobe, kp, tdev["l_pad"], q.shape[1], n,
                        fs.device_sms(dev))
    with uncounted():
        work = fs.invert_probes(probe, tdev["lens"], kp, tdev["l_pad"], call.plan.seg, n)
        items = int(work.item_end[-1])
        per_q = work.slot_end[:, -1].diff(prepend=work.slot_end.new_zeros(1))
        split = device_split(lambda: fs.fused_ivf_topk(
            q, tdev[slab], tdev[sqnorm], tdev["alive"], tdev["crow"], tdev["offsets"],
            tdev["lens"], probe, kp, K, max_len=tdev["l_pad"]))
    return {"seg": call.plan.seg, "grid": call.grid, "items_with_rows": items,
            "buffer_bytes": 4 * call.total, "first_pass": repr(call.prefloor),
            "plans_cached": len(fs._CALLS),
            "segs_a_chunk": call.segs, "slots_alloc_a_query": call.slots // b,
            "slots_a_query_mean": round(float(per_q.float().mean()), 2),
            "slots_a_query_max": int(per_q.max()), "slots_filled": int(per_q.sum()),
            "device": {k: round(v, 4) for k, v in split.items()},
            "merge_share": round(split["merge_ms"] / split["device_ms"], 4) if split else None}


def zipf_list_scan_times(tdev, q, probe, slots: int) -> dict:
    """The list scan (scan and merge) at an index's own tensors and probes,
    timed as phase 3 times its rows: the wrapper (CUDA events, median of
    10), its plain version, the composition (topk of the masked fp32
    scores), the bare product q @ x.T, and the bytes bound: the probed
    lists' rows (512 B of fp32, the squared norm, the alive flag) read
    once, q, the probes, the ``slots`` partials the scan writes and the
    hits."""
    kp = tdev["cents"].shape[0]
    args = (q, tdev["xperm"], tdev["sqnorm"], tdev["alive"], tdev["crow"])
    with uncounted():
        ms = cuda_ms(lambda: fs.fused_ivf_topk(*args, tdev["offsets"], tdev["lens"], probe, kp,
                                               K, max_len=tdev["l_pad"]), 10)
    plain_ms = cuda_ms(lambda: fs.fused_ivf_topk_plain(*args, probe, kp, K), 3)
    comp_ms = cuda_ms(lambda: composition_topk(
        l2_or_ip(q, q @ tdev["xperm"].T, tdev["sqnorm"], False),
        fs.probe_table(probe, kp)[:, tdev["crow"].long()] & tdev["alive"][None, :], K), 3)
    lib_ms = cuda_ms(lambda: q @ tdev["xperm"].T, 10)
    bnd = list_bound(q.shape[1] * 4 + 5, q, probe, tdev["lens"], tdev["alive"], tdev["crow"],
                     kp, K, extra=slots * K * 8)
    return {"ms": round(ms, 4), "plain_ms": round(plain_ms, 3),
            "composition_ms": round(comp_ms, 3), "library_ms": round(lib_ms, 3),
            "bound_ms": round(bnd[0], 4), "bound_by": bnd[1]}


def zipf_serve(ix, queries, b, dev, iters) -> dict:
    q_dev = [torch.from_numpy(queries[i * b:(i + 1) * b]).to(dev)
             for i in range(max(len(queries) // b, 1))]
    return serve(ix, q_dev, iters=iters)


def zipf_build(ix, base) -> tuple[float, int]:
    """add_batch and build ``ix`` over ``base``: the build's seconds and the
    device bytes it left allocated."""
    ix.add_batch([str(i) for i in range(len(base))], base)
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, torch.cuda.memory_allocated() - alloc0


def zipf1m_jax_index(kind: str, base: np.ndarray, dev):
    """bench.py's 1M Zipf index ``kind`` ("ivf_flat": IVF-Flat, seed 42;
    "ivf_pq": IVF-PQ, seed 123) on the JAX package's partition: the
    centroids of ZIPF1M_CENTROIDS, every row assigned on the card in fp32
    (``kmeans_assign``), the lists, slab and ids through the port's loaders
    (``convert.ivf_*_from_arrays``), IVF-PQ's codebooks and codes trained by
    the port on that partition's residuals as its build trains them. The
    options are bench.py's row's (a constructed index's). Returns (index,
    seconds, the longest list)."""
    from pyrope_tpu_torch import convert
    from pyrope_tpu_torch.ops.kmeans import kmeans_assign
    from pyrope_tpu_torch.ops.pq import ProductQuantizer, pq_train_encode_device

    t0 = time.perf_counter()
    pq = kind == "ivf_pq"
    ref = (IvfPqIndex(128, "L2", device=dev, nlist=1000, pq_m=16, ksub=256,
                      train_dtype="bfloat16") if pq
           else IvfFlatIndex(128, "L2", device=dev, nlist=1000, train_dtype="bfloat16"))
    with np.load(ZIPF1M_CENTROIDS) as z:
        cents = z[f"seed{ref.seed}"]
    assign = kmeans_assign(base, cents, "L2", device=dev)
    order = np.argsort(assign, kind="stable")
    lens = np.bincount(assign, minlength=cents.shape[0]).astype(np.int32)
    meta = {"format": "pyrope_tpu.ivf_pq.v1" if pq else "pyrope_tpu.ivf_flat.v1",
            "dim": 128, "metric": "L2", "nlist": ref.nlist, "nprobe": ref.nprobe,
            "built": True, "seed": ref.seed}
    arrays = {"meta": meta, "centroids": cents, "xperm": base[order],
              "perm_ids": np.array([str(i) for i in order]), "alive": np.ones(len(base), bool),
              "offsets": (np.cumsum(lens) - lens).astype(np.int32), "lens": lens,
              "buf_ids": np.array([], dtype=np.str_),
              "buf_vecs": np.zeros((0, 128), np.float32)}
    if not pq:
        ix = convert.ivf_flat_from_arrays(arrays, device=dev)
    else:
        x_dev = torch.from_numpy(base).to(dev)
        r_dev = x_dev - torch.from_numpy(cents).to(dev)[torch.from_numpy(assign).to(dev).long()]
        del x_dev
        quant = ProductQuantizer(m=ref.pq.m, ksub=ref.pq.ksub, dim=128)
        codebooks, codes = pq_train_encode_device(r_dev, len(base), quant, seed=42,
                                                  compute=ref.train_dtype)
        del r_dev
        meta.update(pq_m=ref.pq.m, ksub=ref.pq.ksub, refine=ref.refine,
                    refine_storage=ref.refine_storage)
        arrays.update(codebooks=codebooks, codes=codes.cpu().numpy().astype(np.uint8)[order])
        ix = convert.ivf_pq_from_arrays(arrays, device=dev)
    ix._sync()
    torch.cuda.synchronize()
    return ix, time.perf_counter() - t0, int(lens.max())


def phase_zipf(dev, smi) -> None:
    """Phase 23: bench.py's four Zipf rows through the indexes' own entry
    points (add_batch, build, device_search / search_batch); the three 1M
    rows also on the JAX package's partition (``zipf1m_jax_index``), whose
    recall is held to the JAX package's (ZIPF1M_RECALL_JAX): on the port's
    own build it moves with the order of Lloyd's fp32 sums."""
    # ivf100k_zipf: nlist 100, nprobe 3, b64, recall of 256 queries
    t0 = time.perf_counter()
    base, queries, truth = zipf_data(100_000, 100, dev)
    data_s = time.perf_counter() - t0
    ix = IvfFlatIndex(128, "L2", device=dev, nlist=100)
    build_s, index_bytes = zipf_build(ix, base)
    route = ix.describe_scan(64)
    require(route == "dense-pallas", f"ivf100k_zipf route is {route}")
    launches = fs.LAUNCHES["ivf_scan"]
    rec = recall(ix.search_batch(queries[:256], K), truth[:256])
    require(fs.LAUNCHES["ivf_scan"] > launches, "ivf100k_zipf: the list scan never launched")
    require(abs(rec - ZIPF_RECALL_JAX) <= 0.005,
            f"ivf100k_zipf recall@10 {rec} not within 0.005 of the JAX package's "
            f"{ZIPF_RECALL_JAX}")
    tdev = ix._sync()
    say("23 zipf", cell="ivf100k_zipf", route=route, batch=64, data_s=round(data_s, 2),
        build_s=round(build_s, 2), index_device_bytes=index_bytes, recall=rec,
        recall_jax_cpu=ZIPF_RECALL_JAX,
        **zipf_serve(ix, queries, 64, dev, 200), lists=repr(zipf_lists(ix)),
        list_scan_b64=repr(list_scan_shape(dev, tdev, torch.from_numpy(queries[:64]).to(dev),
                                           3)),
        card=repr(smi))
    del ix, tdev

    # the 1M rows: one IVF-Flat build serves ivf1m_zipf_b1024 and _probe
    t0 = time.perf_counter()
    base, queries, truth = zipf_data(1_000_000, 1000, dev)
    data_s = time.perf_counter() - t0
    ix = IvfFlatIndex(128, "L2", device=dev, nlist=1000, train_dtype="bfloat16")
    build_s, index_bytes = zipf_build(ix, base)
    lists = zipf_lists(ix)
    tdev = ix._sync()
    q1024 = torch.from_numpy(queries).to(dev)
    route = ix.describe_scan(1024)
    require(route == "dense-pallas-win", f"ivf1m_zipf_b1024 route is {route}")
    launches = fs.LAUNCHES["ivf_scan"]
    got = ix.device_search(q1024, K)
    require(fs.LAUNCHES["ivf_scan"] > launches, "ivf1m_zipf_b1024: the list scan never launched")
    rows = id_lists_to_rows(ix.resolve_rows(got[1].cpu().numpy()), K)
    rec = recall_at_k(rows, truth, K)
    # the b1024 call's hits against the list scan's plain version on the card
    probe = rank_probes(q1024, tdev["cents"], tdev["cvalid"], tdev["offsets"], tdev["lens"],
                        3, tdev["alive"].shape[0], Metric.L2)[0]
    plain = fs.fused_ivf_topk_plain(q1024, tdev["xperm"], tdev["sqnorm"], tdev["alive"],
                                    tdev["crow"], probe, tdev["cents"].shape[0], K)
    err, swaps = compare(got, plain, "ivf1m_zipf_b1024 vs the plain list scan")
    del plain
    shape = list_scan_shape(dev, tdev, q1024, 3)
    shape.update(zipf_list_scan_times(tdev, q1024, probe, shape["slots_filled"]))
    say("23 zipf", cell="ivf1m_zipf_b1024", route=route, batch=1024, data_s=round(data_s, 2),
        build_s=round(build_s, 2), index_device_bytes=index_bytes, port_build_recall=rec,
        reference=ZIPF1M_SPREAD, vs_plain_err=err,
        vs_plain_kth_ties=swaps, **zipf_serve(ix, queries, 1024, dev, 40),
        lists=repr(lists), list_scan_b1024=repr(shape), card=repr(smi))

    # ivf1m_zipf_probe: the same index, scan_mode "probe", b256
    q256 = q1024[:256].contiguous()
    listed = ix.device_search(q256, K)   # the list-scan route, the same queries
    ix.scan_mode = "probe"
    try:
        route = ix.describe_scan(256)
        require(route == "probe", f"ivf1m_zipf_probe route is {route}")
        t0 = time.perf_counter()
        probed = ix.device_search(q256, K)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        rec = recall_at_k(id_lists_to_rows(ix.resolve_rows(probed[1].cpu().numpy()), K),
                          truth[:256], K)
        err, swaps = compare(probed, listed, "ivf1m_zipf_probe: probe route vs list scan")
        torch.cuda.reset_peak_memory_stats(dev)
        srv = zipf_serve(ix, queries, 256, dev, 8)
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        ix.scan_mode = "auto"
    step = max(1, IVF_DENSE_MAX_ELEMS // (lists["l_pad"] * 128))
    say("23 zipf", cell="ivf1m_zipf_probe", route=route, batch=256, port_build_recall=rec,
        reference=ZIPF1M_SPREAD, vs_list_scan_err=err,
        vs_list_scan_kth_ties=swaps, first_call_ms=round(first_ms, 1), **srv,
        gather_block_queries=step, peak_device_bytes=peak, build="shared with b1024",
        card=repr(smi))
    del ix, tdev, listed, probed, got
    zipf1m_jax_rows(dev, smi, "ivf_flat", base, truth, q1024)
    del q1024, q256

    # ivfpq1m_zipf_b256: IVF-PQ nlist 1000, pq_m 16, ksub 256, bf16 training,
    # the fp32 rerank slab scanned exactly by the list scan
    pq = IvfPqIndex(128, "L2", device=dev, nlist=1000, pq_m=16, ksub=256,
                    train_dtype="bfloat16")
    build_s, index_bytes = zipf_build(pq, base)
    route = pq.describe_scan(256)
    require(route == "dense-exact-pallas-win", f"ivfpq1m_zipf_b256 route is {route}")
    launches = fs.LAUNCHES["ivf_scan"]
    q256 = torch.from_numpy(queries[:256]).to(dev)
    got = pq.device_search(q256, K)
    require(fs.LAUNCHES["ivf_scan"] > launches, "ivfpq1m_zipf_b256: the list scan never launched")
    rec = recall_at_k(id_lists_to_rows(pq.resolve_rows(got[1].cpu().numpy()), K), truth[:256], K)
    pdev = pq._sync()
    err, swaps = compare(got, zipf_plain_scan(pdev, q256, "xraw", "xsqnorm"),
                         "ivfpq1m_zipf_b256 vs the plain list scan")
    say("23 zipf", cell="ivfpq1m_zipf_b256", route=route, batch=256, build_s=round(build_s, 2),
        index_device_bytes=index_bytes, port_build_recall=rec, reference=ZIPF1M_SPREAD,
        vs_plain_err=err, vs_plain_kth_ties=swaps, **zipf_serve(pq, queries, 256, dev, 100),
        lists=repr(zipf_lists(pq)),
        list_scan_b256=repr(list_scan_shape(dev, pdev, q256, 3, slab="xraw",
                                            sqnorm="xsqnorm")),
        card=repr(smi))
    del pq, pdev, got
    zipf1m_jax_rows(dev, smi, "ivf_pq", base, truth, torch.from_numpy(queries).to(dev))


# the 1M Zipf rows' recall on the port's own builds, printed beside the
# JAX-partition rows: Lloyd's bf16 iterations do not converge there, and a
# change of the fp32 sums' order alone moved the recall by 0.05 (CPU: the
# JAX package 0.9449 / 0.9438, with another k-means block 0.9309; the port
# 0.9066 / 0.8973; the card 0.9422 / 0.9523; seeds 42 / 123, 256 queries)
ZIPF1M_SPREAD = "port build, not gated: it moves with Lloyd's fp32 order (0.897-0.952)"


def zipf_plain_scan(tdev, q, slab="xperm", sqnorm="sqnorm"):
    """The list scan's plain version at an index's own probes for ``q``."""
    probe = rank_probes(q, tdev["cents"], tdev["cvalid"], tdev["offsets"], tdev["lens"], 3,
                        tdev["alive"].shape[0], Metric.L2)[0]
    return fs.fused_ivf_topk_plain(q, tdev[slab], tdev[sqnorm], tdev["alive"], tdev["crow"],
                                   probe, tdev["cents"].shape[0], K)


def zipf1m_jax_rows(dev, smi, kind: str, base, truth, q1024) -> None:
    """The 1M Zipf rows of ``kind`` on the JAX package's partition
    (``zipf1m_jax_index``): IVF-Flat at b1024 (``ivf1m_zipf_b1024``) and on
    the probe route at b256 (``ivf1m_zipf_probe``), IVF-PQ at b256
    (``ivfpq1m_zipf_b256``); each recall within 0.005 of the JAX package's
    (ZIPF1M_RECALL_JAX), each call's hits the plain list scan's (the probe
    route's: the list-scan route's) but for k-th place ties."""
    ix, build_s, longest = zipf1m_jax_index(kind, base, dev)
    tdev = ix._sync()
    q256 = q1024[:256].contiguous()
    pq = kind == "ivf_pq"
    cells = ([("ivfpq1m_zipf_b256", q256, "dense-exact-pallas-win", (123, 256))] if pq else
             [("ivf1m_zipf_b1024", q1024, "dense-pallas-win", (42, 1024)),
              ("ivf1m_zipf_probe", q256, "probe", (42, 256))])
    for cell, q, want_route, key in cells:
        b = q.shape[0]
        listed = None
        if want_route == "probe":
            listed = ix.device_search(q, K)   # the list-scan route, the same queries
            ix.scan_mode = "probe"
        try:
            route = ix.describe_scan(b)
            require(route == want_route, f"{cell} (JAX partition) route is {route}")
            launches = fs.LAUNCHES["ivf_scan"]
            got = ix.device_search(q, K)
            require(route == "probe" or fs.LAUNCHES["ivf_scan"] > launches,
                    f"{cell} (JAX partition): the list scan never launched")
        finally:
            ix.scan_mode = "auto"
        rec = recall_at_k(id_lists_to_rows(ix.resolve_rows(got[1].cpu().numpy()), K),
                          truth[:b], K)
        ref = ZIPF1M_RECALL_JAX[key]
        require(abs(rec - ref) <= 0.005, f"{cell} recall@10 {rec} on the JAX package's "
                f"partition not within 0.005 of its {ref}")
        plain = listed if listed is not None else zipf_plain_scan(
            tdev, q, *(("xraw", "xsqnorm") if pq else ()))
        err, swaps = compare(got, plain, f"{cell} (JAX partition) vs the "
                             + ("list-scan route" if listed is not None else "plain list scan"))
        say("23 zipf", cell=cell, partition=f"JAX package's (seed {key[0]})", route=route,
            batch=b, load_s=round(build_s, 2), longest_list=longest, recall=rec,
            recall_jax_cpu=ref, vs_plain_err=err, vs_plain_kth_ties=swaps, card=repr(smi))
    del ix, tdev


# the top hits examples/quickstart.py prints, from the JAX package on the
# CPU: the Flat scan's three, every other section's first, each with the ids
# that tie it in fp32 (section 5's fresh document is the query itself);
# tests/test_torch_scripts.py holds it
QUICKSTART_HITS_JAX = {"flat_top3": ["doc123", "doc3346", "doc995"],
                       "ivf_nprobe8_top": ["doc123"], "ivfpq_top": ["doc123"],
                       "hnsw_top": ["doc123"],
                       "delta_pre_compaction": ["doc123", "fresh-doc"],
                       "delta_post_compaction": ["doc123", "fresh-doc"]}


def quickstart_hits_match(hits: dict, want: dict = QUICKSTART_HITS_JAX) -> bool:
    """The twin's hits against ``want`` (QUICKSTART_HITS_JAX): the Flat
    scan's three in order, every other section's first among the JAX hit's
    fp32 ties."""
    return (hits["flat_top3"] == want["flat_top3"]
            and all(hits[key] in ids for key, ids in want.items() if key != "flat_top3"))


# the demo notebook: its sections are the quickstart's on the same rows and
# calls, so its top hits are QUICKSTART_HITS_JAX's, and the engine's top hit
# (tests/test_torch_tools_rest.py holds both against the JAX notebook's)
DEMO_NOTEBOOK = "pyrope_tpu_torch/examples/pyrope_tpu_torch_demo.ipynb"
DEMO_HITS_JAX = {**QUICKSTART_HITS_JAX, "engine_top": ["doc123"]}


def notebook_code(path: str, drop: tuple[str, ...] = ()) -> list[str]:
    """The code cells of the notebook at ``path`` in order, without the
    lines equal to one of ``drop``."""
    with open(path) as f:
        nb = json.load(f)
    return ["\n".join(line for line in "".join(c["source"]).splitlines()
                      if line.strip() not in drop)
            for c in nb["cells"] if c["cell_type"] == "code"]


def run_cells(cells: list[str], ns: dict) -> list[tuple]:
    """The cells run in order in one namespace ``ns``, as a notebook runs
    them: for each, its last expression's value (None where it ends in a
    statement) and what it printed."""
    outs = []
    for i, src in enumerate(cells):
        tree = ast.parse(src)
        last = tree.body.pop() if tree.body and isinstance(tree.body[-1], ast.Expr) else None
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            exec(compile(tree, f"<cell {i}>", "exec"), ns)
            value = (eval(compile(ast.Expression(last.value), f"<cell {i}>", "eval"), ns)
                     if last else None)
        outs.append((value, printed.getvalue()))
    return outs


def run_demo(device: str) -> tuple[list[tuple], dict]:
    """The port's demo notebook on ``device``: its first cell, ``DEVICE =
    "cuda"``, set to ``device``."""
    cells = notebook_code(DEMO_NOTEBOOK)
    require(cells[0].startswith("DEVICE = "), f"the demo's first cell is {cells[0]!r}")
    ns: dict = {}
    return run_cells([f"DEVICE = {device!r}", *cells[1:]], ns), ns


def demo_hits(outs: list[tuple], ns: dict) -> dict:
    """The top hits of the demo's last six code cells (Flat, IVF-Flat,
    IVF-PQ, HNSW, Delta, engine), keyed as DEMO_HITS_JAX (held to it by
    quickstart_hits_match), and the engine's cache level on the repeated
    query; for either package's notebook."""
    flat, ivf, pq, hnsw, delta, _ = outs[-6:]
    pre, post = re.findall(r"id='([^']*)'", delta[1])
    return {"flat_top3": [h.id for h in flat[0]], "ivf_nprobe8_top": ivf[0][0].id,
            "ivfpq_top": pq[0][0].id, "hnsw_top": hnsw[0][0].id,
            "delta_pre_compaction": pre, "delta_post_compaction": post,
            "engine_top": ns["r_miss"].hits[0].id,
            "engine_hit_level": ns["r_hit"].trace.cache_level}


# phase 24's serving_bench cells: a 20,000-row corpus, 1.5 s a search cell
SERVING_TOOL_ARGS = ("--n", "20000", "--dim", "128", "--nprobe", "3", "--duration", "1.5",
                     "--writers", "4", "--pipeline", "8")
SERVING_TOOL_BATCHER = {"max_batch": 128, "linger_ms": 0.2, "max_inflight": 3}


def serving_bench_cells(dev) -> list[dict]:
    """The serving_bench twin at a small size: upserts with thread writers
    and the search cell under the micro-batcher flags, then upserts with
    process writers; each upsert cell every row acknowledged, 0 errors."""
    from pyrope_tpu_torch.scripts import serving_bench

    b = SERVING_TOOL_BATCHER
    runs = (
        ("threads", ["--cells", "upsert", "search", "--concurrency", "128",
                     "--max-batch", str(b["max_batch"]), "--linger-ms", str(b["linger_ms"]),
                     "--inflight", str(b["max_inflight"])]),
        ("procs", ["--cells", "upsert", "--writer-procs"]),
    )
    cells = []
    for writers, extra in runs:   # writers: threads, or client processes
        t0 = time.perf_counter()
        out = serving_bench.run(serving_bench.parse_args(
            ["--device", dev.type, *SERVING_TOOL_ARGS, *extra]))
        for cell in out["cells"]:
            require(cell["errors"] == 0, f"serving_bench {writers} {cell['cell']}: "
                    f"{cell['errors']} errors {cell['error_sample']}")
            if cell["cell"] == "upsert":
                require(cell["requests"] == cell["n"] == 20_000,
                        f"serving_bench {writers}: {cell['requests']} of {cell['n']} "
                        "upserts acknowledged")
                require(cell.get("writer_procs", False) == (writers == "procs"),
                        f"serving_bench {writers}: writer_procs {cell.get('writer_procs')}")
            else:
                require({k: out["microbatcher"][k] for k in b} == b
                        and cell["microbatch"]["max_batch_seen_cum"] <= b["max_batch"],
                        f"serving_bench micro-batcher {out['microbatcher']}, "
                        f"{cell['microbatch']}")
        seconds = round(time.perf_counter() - t0, 1)
        cells += [{"run": writers, "run_seconds": seconds, **cell} for cell in out["cells"]]
    return cells


def phase_tools(dev, smi) -> None:
    """Phase 24: the twins of the JAX package's tools, in this process on
    the card, each held to its own success condition."""
    from pyrope_tpu_torch.scripts import phase6_eval, quickstart, soak_test

    t0 = time.perf_counter()
    soak = soak_test.run(seconds=15, device=dev.type)
    require(soak["ok"] and soak["errors"] == 0,
            f"soak_test: {soak['errors']} errors {soak['error_sample'][:3]}, "
            f"known row found {soak['known_row_found']}, count {soak['count']}")
    say("24 tools", tool="soak_test", seconds=round(time.perf_counter() - t0, 1),
        ops=repr(soak["ops"]), ops_per_s=soak["ops_per_s"], errors=soak["errors"],
        count=soak["count"], card=repr(smi))
    t0 = time.perf_counter()
    report = phase6_eval.run(dev.type)
    require(all(s["ok"] for s in report), f"phase6_eval: {report}")
    say("24 tools", tool="phase6_eval", seconds=round(time.perf_counter() - t0, 1),
        scenarios=repr(report), card=repr(smi))
    t0 = time.perf_counter()
    tour = quickstart.run(dev.type)
    require(quickstart_hits_match(tour["hits"]),
            f"quickstart hits {tour['hits']} are not the JAX quickstart's "
            f"{QUICKSTART_HITS_JAX}")
    require(tour["native_available"] and tour["restored_count"] == 20_000,
            f"quickstart: native {tour['native_available']}, "
            f"restored {tour['restored_count']}")
    say("24 tools", tool="quickstart", seconds=round(time.perf_counter() - t0, 1),
        hits=repr(tour["hits"]), engine=repr(tour["engine"]), card=repr(smi))
    t0 = time.perf_counter()
    outs, ns = run_demo(dev.type)
    hits = demo_hits(outs, ns)
    require(quickstart_hits_match(hits, DEMO_HITS_JAX) and hits["engine_hit_level"] == "L0",
            f"demo notebook hits {hits} are not the JAX notebook's {DEMO_HITS_JAX} "
            "(engine hit level L0)")
    say("24 tools", tool="demo_notebook", seconds=round(time.perf_counter() - t0, 1),
        cells=len(outs), hits=repr(hits), routes=repr({
            "ivf": ns["ivf"].describe_scan(1, 8, top_k=3),
            "ivfpq": ns["pq"].describe_scan(1, top_k=3)}),
        card=repr(smi))
    del outs, ns
    for cell in serving_bench_cells(dev):
        say("24 tools", tool="serving_bench", **{k: repr(v) if isinstance(v, dict) else v
                                                  for k, v in cell.items()}, card=repr(smi))
    t0 = time.perf_counter()
    step = subprocess.run(["bash", "pyrope_tpu_torch/scripts/check_quality.sh", "2"],
                          capture_output=True, text=True, timeout=600)
    require(step.returncode == 0 and "native builder: available" in step.stdout,
            f"check_quality.sh 2: rc {step.returncode} {step.stdout[-400:]} "
            f"{step.stderr[-400:]}")
    say("24 tools", tool="check_quality_step2", seconds=round(time.perf_counter() - t0, 1),
        output=repr(step.stdout.strip().splitlines()[-2]), card=repr(smi))


# Phase 25: fifteen of bench.py's rows that no other phase runs, through the
# bench twin (pyrope_tpu_torch/scripts/bench.py) at bench.py's sizes and
# batches: (name, the dataset files it reads)
BENCH_ROWS = (("ivf100k_np16", None), ("ivf100k_np32", None), ("ivf100k_np64", None),
              ("delta20k", None), ("delta20k_np96", None),
              ("flat100k_cos_b1024", None), ("flat100k_ip_b1024", None),
              ("flat10k_d1024_b1024", None), ("flat100k_d1024_b1024", None),
              ("ivf100k_fvecs_file", "fvecs"), ("ivf_glove_file", "glove"),
              ("ivfpq1m_adc", None), ("ivfpq1m_probe", None), ("ivfpq1m_np8", None),
              ("ivfpq1m_r128", None))
# recall@10 of the IVF and Delta rows in the JAX package on the CPU (256
# queries at b64, 1024 at b1024); the card is held within BENCH_RECALL_TOL;
# tests/test_torch_bench_rows.py holds both packages to them
BENCH_RECALL_JAX = {"ivf100k_np16": 0.451171875, "ivf100k_np32": 0.666015625,
                    "ivf100k_np64": 0.90078125, "delta20k": 0.14375, "delta20k_np96": 1.0,
                    "ivf100k_fvecs_file": 0.999609375, "ivf_glove_file": 0.9998046875}
BENCH_RECALL_TOL = 0.01
# exact rows: no miss beyond an fp32 tie at the k-th place (float64 truth)
BENCH_EXACT = ("flat100k_cos_b1024", "flat100k_ip_b1024", "flat10k_d1024_b1024",
               "flat100k_d1024_b1024")
# the 1M rows, which the CPU here cannot build: (BENCH_DETAIL.json's recall,
# taken on a TPU, and the gate: that less 0.01)
BENCH_TPU_GATES = {"ivfpq1m_adc": (0.1391, 0.1291), "ivfpq1m_probe": (0.9691, 0.9591),
                   "ivfpq1m_np8": (1.0, 0.99), "ivfpq1m_r128": (1.0, 0.99)}
# each row's route: the JAX index's describe_scan on the CPU up to 100k rows
# (none for a Delta), BENCH_DETAIL.json's record at 1M
BENCH_ROUTES = {"ivf100k_np16": "dense-pallas", "ivf100k_np32": "dense-pallas",
                "ivf100k_np64": "dense-pallas", "delta20k": None, "delta20k_np96": None,
                "flat100k_cos_b1024": "flat-exact", "flat100k_ip_b1024": "flat-exact",
                "flat10k_d1024_b1024": "flat-exact", "flat100k_d1024_b1024": "flat-exact",
                "ivf100k_fvecs_file": "dense-pallas", "ivf_glove_file": "dense-pallas",
                "ivfpq1m_adc": "probe-adc", "ivfpq1m_probe": "probe-adc+rerank",
                "ivfpq1m_np8": "dense-exact-pallas-win", "ivfpq1m_r128": "dense-exact-pallas-win"}
BENCH_DURATION_S = 0.5      # bench.py's pipelined section: 5 s
BENCH_LATENCY_SAMPLES = 20  # bench.py's blocking samples: 200


def exact_misses(kept: dict, k: int = K) -> int:
    """Hits of an exact row that are not in the float64 truth and not an fp32
    tie at its k-th place (scores in float64 within RTOL / ATOL of the k-th
    true score), in the row's metric."""
    base, q, truth = kept["base"], kept["queries"], kept["truth"]
    rows = id_lists_to_rows(kept["index"].resolve_rows(kept["out"][1].cpu().numpy()), k)
    cosine = kept["metric"] == "COSINE"

    def score(b, r):
        x, y = base[r].astype(np.float64), q[b].astype(np.float64)
        if kept["metric"] == "L2":
            return -float(np.sum((x - y) ** 2))
        dot = float(x @ y)
        return dot / (np.linalg.norm(x) * np.linalg.norm(y)) if cosine else dot

    bad = 0
    for b in range(len(q)):
        extra = set(rows[b]) - set(truth[b])
        if extra:
            kth = score(b, truth[b][k - 1])
            bad += sum(not np.isclose(score(b, r), kth, rtol=RTOL, atol=ATOL) for r in extra)
    return bad


def list_scan_vs_plain(kept: dict) -> dict:
    """The row's eval output against the list scan's plain version on the
    index's own tensors and probes (a Delta: its IVF tail's)."""
    ix = getattr(kept["index"], "tail", kept["index"])
    tdev = ix._sync()
    q = torch.from_numpy(kept["queries"]).to(tdev["xperm"].device)
    nprobe = min(kept["options"].nprobe or ix.nprobe, tdev["k_actual"])
    probe = rank_probes(q, tdev["cents"], tdev["cvalid"], tdev["offsets"], tdev["lens"],
                        nprobe, tdev["alive"].shape[0], Metric.L2)[0]
    plain = fs.fused_ivf_topk_plain(q, tdev["xperm"], tdev["sqnorm"], tdev["alive"],
                                    tdev["crow"], probe, tdev["cents"].shape[0], K)
    err, ties = compare(kept["out"], plain, f"{kept['name']}: list scan vs its plain version")
    return {"route": ix.describe_scan(len(q), nprobe), "queries": len(q), "nprobe": nprobe,
            "max_abs_err": err, "kth_ties": ties}


def phase_bench_rows(dev, smi) -> None:
    """Phase 25: BENCH_ROWS through the bench twin's run_config, each held to
    its gate (BENCH_RECALL_JAX, BENCH_EXACT, BENCH_TPU_GATES) and its route
    (BENCH_ROUTES); the file-backed rows read files the twin of
    make_dataset_files writes at the phase's start."""
    from pyrope_tpu_torch.scripts import bench, make_dataset_files

    t0 = time.perf_counter()
    cache: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        files = make_dataset_files.write_dataset_files(tmp)
        glove = str(files["glove50k.txt"])
        row_files = {
            "fvecs": {"base_fvecs": str(files["clustered100k.fvecs"]),
                      "query_fvecs": str(files["clustered100k_queries.fvecs"])},
            "glove": {"base_fvecs": bench.glove_to_fvecs(glove, tmp_dir=tmp),
                      "query_fvecs": str(files["glove50k_queries.fvecs"]), "glove_src": glove},
        }
        say("25 bench rows", dataset_files=repr({p.name: p.stat().st_size
                                                  for p in files.values()}),
            seconds=round(time.perf_counter() - t0, 1))
        for name, kind in BENCH_ROWS:
            t1 = time.perf_counter()
            kept = {"name": name}
            row = bench.run_config(name, 64, K, 1024, BENCH_DURATION_S, index_cache=cache,
                                   device=dev.type, latency_samples=BENCH_LATENCY_SAMPLES,
                                   keep=kept, **row_files.get(kind, {}))
            route, rec = row.get("scan_path"), row["recall_at_k"]
            require(route == BENCH_ROUTES[name],
                    f"{name}: route {route}, the JAX package's {BENCH_ROUTES[name]}")
            extra = {}
            if name in BENCH_EXACT:
                bad = exact_misses(kept)
                require(bad == 0, f"{name}: {bad} misses beyond fp32 ties")
                gate = "exact: no miss beyond fp32 ties (float64 truth)"
                extra["misses_beyond_ties"] = bad
            elif name in BENCH_RECALL_JAX:
                want = BENCH_RECALL_JAX[name]
                require(abs(rec - want) <= BENCH_RECALL_TOL,
                        f"{name}: recall@10 {rec} not within {BENCH_RECALL_TOL} of the JAX "
                        f"package's {want}")
                gate = f"{want} (JAX, CPU) +- {BENCH_RECALL_TOL}"
                with uncounted():
                    extra["list_scan_vs_plain"] = repr(list_scan_vs_plain(kept))
            else:
                record, floor = BENCH_TPU_GATES[name]
                require(rec >= floor, f"{name}: recall@10 {rec} < {floor}")
                gate = f">= {floor} ({record}, the TPU record, less 0.01)"
            lat = row["latency_batch_ms"]
            say("25 bench rows", row=name, route=route, batch=row["batch"], n=row["n_base"],
                d=row["dim"], qps=row["qps"], device_ms_per_batch=row["device_ms_per_batch"],
                p50_ms=round(lat["p50_ms"], 3), p99_ms=round(lat["p99_ms"], 3), recall=rec,
                gate=repr(gate), recall_ref=row["recall_ref"], n_oracle=row["n_oracle"],
                build_s=row["build_s"], build_cached=row.get("build_cached", False),
                memory_bytes=repr(row.get("memory_bytes")), device_bytes=row.get("device_bytes"),
                **extra,
                device_share=repr(device_shares(kept["search"], 5)),
                seconds=round(time.perf_counter() - t1, 1), card=repr(smi))
            del kept
    del cache
    torch.cuda.empty_cache()


def run_path(name: str, fn, kernels: tuple[str, ...]) -> dict:
    """One serving path: the launch counts zeroed before it and read after;
    each of ``kernels`` must have run on it. Prints its wall time."""
    fs.reset_launches()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    say("time", path=name.replace(" ", "_"), seconds=round(time.perf_counter() - t0, 1))
    got = dict(fs.LAUNCHES)
    for kernel in kernels:
        require(got[kernel] > 0, f"kernel {kernel} was not launched on the {name} path")
    return got


class Tee(io.TextIOBase):
    """Writes go to every stream it was given: the smoke's standard output
    and its ``--log`` file."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self) -> None:
        for stream in self.streams:
            stream.flush()


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="the port's smoke run on one NVIDIA GPU")
    parser.add_argument("--log", help="also write every line printed to standard output "
                        "to this file (for runners that keep only the end of the output)")
    args = parser.parse_args(argv)
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        log = open(args.log, "w", buffering=1)
        stdout = sys.stdout
        sys.stdout = Tee(stdout, log)
        try:
            return run(args)
        finally:
            sys.stdout = stdout
            log.close()
    return run(args)


def run(args) -> int:
    """The smoke itself (``main`` parses the arguments)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_device()
    phase_build()
    # phase 15's graphs build on the host while the card runs phases 3-14
    prebuild = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="hnsw-native")
    hnsw_native = prebuild.submit(prebuild_hnsw_native, dev)
    prebuild.shutdown(wait=False)
    t0 = time.perf_counter()
    rec = phase_kernels(dev)
    say("time", step="3_kernels", seconds=round(time.perf_counter() - t0, 1))

    t0 = time.perf_counter()
    data, uniform = clustered_1m(), uniform_1m()
    say("time", step="data", seconds=round(time.perf_counter() - t0, 1))

    def ivf_flat():  # phases 4-6
        phase_slice(dev, dict(fs.LAUNCHES), data)
        phase_narrow(dev)
        phase_flat(dev, uniform)

    def ivf_pq():    # phases 7-8
        phase_pq(dev, data)
        phase_pq_narrow(dev)

    resp1m = {}   # phase 18's 1M cell, printed beside phase 19's
    keep = {}     # phase 15's 100k clustered graph, replicated in phase 22
    paths = {name: run_path(name, fn, kernels) for name, fn, kernels in (
        ("IVF-Flat", ivf_flat, ("flat_scan", "ivf_scan", "merge", "flat_scan_wide",
                                "ivf_scan_wide", "merge_wide", "flat_scan_prefloor",
                                "list_scan_prefloor", "floor_select", "invert_probes")),
        ("IVF-PQ", ivf_pq, ("sq8_scan", "ivf_scan", "merge", "sq8_scan_wide", "merge_wide",
                            "invert_probes")),
        ("flat bf16", lambda: phase_flat_bf16(dev, uniform), ("flat_scan_bf16", "merge")),
        ("flat hybrid", lambda: phase_flat_hybrid(dev, uniform),
         ("flat_scan_bf16", "flat_scan", "merge")),
        ("IVF-Flat hybrid", lambda: phase_ivf_hybrid(dev, uniform),
         ("ivf_scan_bf16_tc", "ivf_scan", "merge", "ivf_scan_bf16_wide", "merge_wide",
          "list_scan_prefloor", "list_scan_prefloor_tc", "floor_select", "invert_probes")),
        ("IVF-PQ bf16", lambda: phase_pq_bf16(dev, data),
         ("ivf_scan_bf16_promote", "merge", "ivf_scan_bf16_wide", "merge_wide",
          "invert_probes")),
        ("flat hybrid k100", lambda: phase_flat_hybrid_k100(dev, uniform),
         ("flat_scan_bf16_wide", "flat_scan_bf16_prefloor", "merge_wide")),
        ("IVF-Flat d768", lambda: phase_ivf_d768(dev), ("ivf_scan", "merge", "invert_probes")),
        ("HNSW native", lambda: phase_hnsw_native(dev, smi, keep, hnsw_native), ()),
        ("HNSW 1M", lambda: phase_hnsw_1m(dev, smi), ()),
        ("Delta HNSW", lambda: phase_delta_hnsw(dev, smi),
         ("flat_scan", "merge", "invert_probes")),
        ("RESP serving", lambda: resp1m.update(phase_resp(dev, smi, data)),
         ("ivf_scan", "merge", "invert_probes")),
        # the server is a process of its own: its launches are not counted
        # here; the phase holds its trace to the list scan and the merge
        ("full stack", lambda: phase_stack(dev, smi, data, resp1m), ()),
        ("flat sq8", lambda: phase_flat_sq8(dev, smi), ()),
        ("DeviceFlatIndex 10M", lambda: phase_device_flat(dev, smi),
         ("flat_scan", "flat_scan_bf16", "merge")),
        ("sharded", lambda: phase_sharded(dev, smi, data, uniform, keep.pop("hnsw100k")),
         ("flat_scan", "ivf_scan", "merge", "invert_probes")),
        ("Zipf", lambda: phase_zipf(dev, smi), ("ivf_scan", "merge", "invert_probes")),
        ("tools", lambda: phase_tools(dev, smi), ("ivf_scan", "merge", "invert_probes")),
        ("bench rows", lambda: phase_bench_rows(dev, smi), ("ivf_scan", "merge", "invert_probes")),
    )}
    say("launches", **{name.replace(" ", "_"): repr(got) for name, got in paths.items()})
    say("profiler", sessions_without_cuda_events=len(PROFILER_MISSES),
        recovered=sum(m["recovered"] for m in PROFILER_MISSES), misses=repr(PROFILER_MISSES))
    # every list-scan call inverts its probes with the kernel, once
    for name, got in paths.items():
        calls = sum(got[key] for key in LIST_SCAN_KEYS)
        require(got["invert_probes"] == calls,
                f"{name}: {got['invert_probes']} inversions for {calls} list-scan calls")
    launches = {name: sum(got[name] for got in paths.values()) for name in fs.LAUNCHES}
    # the list scan's bf16 mode runs without promote on the hybrid path only
    # (narrow: the tensor-core kernel and its first passes; wide: the CUDA
    # cores'), with promote on the bf16-slab path only (narrow: the promote
    # kernel; wide: the CUDA cores'); large D on the d768 path only
    bf16_promote = paths["IVF-PQ bf16"]["ivf_scan_bf16_promote"]
    bf16_plain_wide = paths["IVF-Flat hybrid"]["ivf_scan_bf16_wide"]
    bf16_promote_wide = paths["IVF-PQ bf16"]["ivf_scan_bf16_wide"]
    large_d = paths["IVF-Flat d768"]["ivf_scan"]

    def entry(name, kind, source, replaces, launched):
        r = rec[kind]
        bound_ms, bound_by = r["bound"]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launched, "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": r["library_ms"], "composition_ms": r["composition_ms"],
                "device_ms": r.get("device_ms")}

    wide = f"{PALLAS}:372, {PALLAS}:192, {PALLAS}:200, {PALLAS}:496"
    kernels = [
        entry("fused_scan_kernel", "flat", SOURCE, f"{PALLAS}:672", launches["flat_scan"]),
        entry("flat_scan_tc_kernel", "flat_bf16", TC_SOURCE, f"{PALLAS}:672, {PALLAS}:232",
              launches["flat_scan_bf16"]),
        entry("ivf_list_scan_kernel<IVF>", "ivf", LIST_SOURCE,
              f"{PALLAS}:1035, {PALLAS}:992", launches["ivf_scan"] - large_d),
        entry("ivf_list_scan_tc_kernel", "ivf_bf16_tc", LIST_TC_SOURCE,
              f"{PALLAS}:1035, {PALLAS}:992, {PALLAS}:232", launches["ivf_scan_bf16_tc"]),
        entry("ivf_list_scan_promote_kernel", "ivf_bf16p", LIST_PROMOTE_SOURCE,
              f"{PALLAS}:992, {PALLAS}:1035, {PALLAS}:232", bf16_promote),
        entry("ivf_list_scan_kernel<SQ8>", "sq8", LIST_SOURCE,
              f"{PALLAS}:1204, {PALLAS}:1341", launches["sq8_scan"]),
        entry("merge_partials_kernel", "merge", SOURCE, f"{PALLAS}:401", launches["merge"]),
        entry("fused_scan_kernel<wide>", "flat_wide", SOURCE, f"{PALLAS}:672, {wide}",
              launches["flat_scan_wide"]),
        entry("flat_scan_tc_kernel<wide>", "flat_bf16_wide", TC_SOURCE,
              f"{PALLAS}:672, {PALLAS}:232, {wide}", launches["flat_scan_bf16_wide"]),
        entry("ivf_list_scan_kernel<IVF, wide>", "ivf_wide", LIST_SOURCE,
              f"{PALLAS}:1035, {PALLAS}:992, {wide}", launches["ivf_scan_wide"]),
        entry("ivf_list_scan_kernel<BF16, wide>", "ivf_bf16_wide", LIST_SOURCE,
              f"{PALLAS}:1035, {PALLAS}:992, {PALLAS}:232, {wide}", bf16_plain_wide),
        entry("ivf_list_scan_kernel<BF16, wide> promote_fp32", "ivf_bf16p_wide", LIST_SOURCE,
              f"{PALLAS}:992, {PALLAS}:1035, {PALLAS}:232, {wide}", bf16_promote_wide),
        entry("ivf_list_scan_kernel<SQ8, wide>", "sq8_wide", LIST_SOURCE,
              f"{PALLAS}:1204, {PALLAS}:1341, {wide}", launches["sq8_scan_wide"]),
        entry("ivf_list_scan_kernel<IVF> large D", "ivf_large_d", LIST_SOURCE,
              f"{PALLAS}:1035, {PALLAS}:992, {PALLAS}:49", large_d),
        entry("merge_wide_kernel", "merge_wide", SOURCE,
              f"{PALLAS}:401, {PALLAS}:642, {wide}", launches["merge_wide"]),
        entry("fused_scan_kernel<narrow> first pass", "flat_prefloor", SOURCE,
              f"{PALLAS}:672, {wide}", launches["flat_scan_prefloor"]),
        entry("flat_scan_tc_kernel<narrow> first pass", "flat_bf16_prefloor", TC_SOURCE,
              f"{PALLAS}:672, {PALLAS}:232, {wide}", launches["flat_scan_bf16_prefloor"]),
        entry("ivf_list_scan_kernel<narrow> first pass", "list_prefloor", LIST_SOURCE,
              f"{PALLAS}:1035, {PALLAS}:1204, {wide}", launches["list_scan_prefloor"]),
        entry("ivf_list_scan_tc_kernel first pass", "list_prefloor_tc", LIST_TC_SOURCE,
              f"{PALLAS}:1035, {PALLAS}:232, {wide}", launches["list_scan_prefloor_tc"]),
        entry("floor_select_list_kernel", "floor_select", PREFLOOR_SOURCE,
              f"{PALLAS}:1035, {PALLAS}:1204, {wide}", launches["floor_select"]),
        entry("invert_probes_kernel", "invert_probes", INVERT_SOURCE,
              "pyrope_tpu/index/ivf_flat.py:224, pyrope_tpu/ops/pallas_scan.py:841",
              launches["invert_probes"]),
    ]
    say("time", total_seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
