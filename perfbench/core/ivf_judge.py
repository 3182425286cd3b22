"""The plain reference of an IVF search and the comparison that decides
``correct``. Plain torch: no kernel, no module of the program.

The reference cannot draw the program's k-means partition again (Lloyd's
fp32 sums and the k-means++ draws are the program's), so it takes the
centroids that ``get_centroids()`` returns and works out everything else
itself, in float64: each row's list, each query's probed lists and the rows
a query can see. Where fp32 rounding can decide (a row nearly as close to a
second centroid, a list nearly tied for the nprobe-th place) both outcomes
are allowed: a list is *surely* probed where no rounding of the program's
ranking can push it out, *maybe* probed where some rounding could take it
in, and a row within TAU of a second centroid is in both lists. Then, for
every answered query:

- ``bad_rows``: returned rows that no rounding allows (outside every maybe
  probed list, repeated, missing where the surely probed rows hold k);
- ``gap``: the widest excess of the program's j-th distance (exact, float64)
  over the j-th best of the surely probed rows, over ‖q‖² + mean ‖x‖² (the
  size of what fp32 rounds);
- ``score_err``: the widest distance between a returned score and the exact
  distance of its row, on the same scale.

The centroids are checked by themselves: ``kmeans_gain`` is how much one
more Lloyd step (float64, from the program's centroids) lowers the k-means
objective, as a share: near 0 where the program's Lloyd iterations ran.
And the answers are held to a number that uses nothing of the program:
``recall_miss``, the share of each query's exact k nearest rows over the
whole corpus (float64 brute force) that its answer leaves out, over all
answers. IVF misses some by design; a partition that scatters neighbours,
or a search that probes fewer lists than asked, misses many more.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

TAU = 2.0 ** -16   # a bound of fp32's error in ‖a‖² - 2a·b + ‖b‖² at D 128, relative to ‖a‖² + ‖b‖²
BLOCK = 65536      # rows a step in the [rows, K] distance blocks
QBLOCK = 4096      # queries a step in the exact search over all rows
CHUNK = 1 << 20    # (query, rank) entries judged a step


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 mantissa bits, to nearest even): the
    operands a TF32 tensor-core product takes."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


@dataclass
class Partition:
    a1: torch.Tensor       # [N] nearest list
    a2: torch.Tensor       # [N] a second list within TAU, or -1
    multi: torch.Tensor    # [N] a third list within TAU too: any list may hold the row
    objective: float       # mean squared distance to the nearest centroid


def partition(x64: torch.Tensor, c64: torch.Tensor) -> Partition:
    cc = (c64 * c64).sum(1)
    parts = []
    for s in range(0, x64.shape[0], BLOCK):
        xb = x64[s:s + BLOCK]
        xx = (xb * xb).sum(1)
        d = xx[:, None] - 2.0 * (xb @ c64.T) + cc[None, :]
        top = torch.topk(d, min(3, c64.shape[0]), dim=1, largest=False)
        tol = TAU * (xx + cc.max())
        near = (top.values - top.values[:, :1]) <= tol[:, None]
        a2 = torch.where(near[:, 1], top.indices[:, 1], -1) if near.shape[1] > 1 else \
            torch.full_like(top.indices[:, 0], -1)
        multi = near[:, 2] if near.shape[1] > 2 else torch.zeros_like(near[:, 0])
        parts.append((top.indices[:, 0], a2, multi, top.values[:, 0].clamp(min=0).sum()))
    a1, a2, multi, obj = zip(*parts)
    return Partition(torch.cat(a1), torch.cat(a2), torch.cat(multi),
                     float(sum(obj)) / x64.shape[0])


def lloyd_gain(x64: torch.Tensor, c64: torch.Tensor, part: Partition) -> float:
    """objective(c) / objective(one Lloyd step from c) - 1."""
    k = c64.shape[0]
    sums = torch.zeros_like(c64).index_add_(0, part.a1, x64)
    counts = torch.bincount(part.a1, minlength=k).to(x64.dtype)
    step = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], c64)
    return part.objective / partition(x64, step).objective - 1.0


def probe_sets(q64: torch.Tensor, c64: torch.Tensor, nprobe: int):
    """(surely probed [Q, K], maybe probed [Q, K], exact top-nprobe [Q, nprobe])."""
    qq = (q64 * q64).sum(1, keepdim=True)
    cc = (c64 * c64).sum(1)
    d = (qq - 2.0 * (q64 @ c64.T) + cc[None, :]).contiguous()
    s = d.sort(dim=1).values
    tol = 2.0 * TAU * (qq + cc.max())
    sure = torch.searchsorted(s, d + tol) <= nprobe      # itself and < nprobe others can rank ahead
    maybe = torch.searchsorted(s, d - tol) < nprobe      # fewer than nprobe surely rank ahead
    return sure, maybe, torch.topk(d, nprobe, dim=1, largest=False).indices


def exact_topk(x32: torch.Tensor, q64: torch.Tensor, k: int) -> torch.Tensor:
    """Each query's k nearest rows over the whole corpus, by float64 L2:
    [Q, k] row numbers, nearest first. Blocks of queries and of rows."""
    best_d = torch.full((q64.shape[0], k), float("inf"), dtype=torch.float64, device=q64.device)
    best_r = torch.full((q64.shape[0], k), -1, dtype=torch.int64, device=q64.device)
    qq = (q64 * q64).sum(1, keepdim=True)
    for s in range(0, x32.shape[0], BLOCK):
        xb = x32[s:s + BLOCK].double()
        xx = (xb * xb).sum(1)
        for t in range(0, q64.shape[0], QBLOCK):
            d = qq[t:t + QBLOCK] - 2.0 * (q64[t:t + QBLOCK] @ xb.T) + xx[None, :]
            top = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
            dd = torch.cat([best_d[t:t + QBLOCK], top.values], 1)
            rr = torch.cat([best_r[t:t + QBLOCK], top.indices + s], 1)
            keep = torch.topk(dd, k, dim=1, largest=False).indices
            best_d[t:t + QBLOCK] = torch.gather(dd, 1, keep)
            best_r[t:t + QBLOCK] = torch.gather(rr, 1, keep)
    return best_r


def _csr(lists: torch.Tensor, keep: torch.Tensor, k: int):
    """Rows with ``keep``, grouped by list: (rows in list order, starts [k+1])."""
    rows = torch.nonzero(keep).squeeze(1)
    rows = rows[torch.argsort(lists[rows], stable=True)]
    counts = torch.bincount(lists[rows], minlength=k)
    starts = torch.zeros(k + 1, dtype=torch.int64, device=lists.device)
    starts[1:] = torch.cumsum(counts, 0)
    return rows, starts.tolist()


def list_topk(mask: torch.Tensor, rows: torch.Tensor, starts: list, dist, k: int):
    """For each query, the k least ``dist(queries, rows)`` over the rows of
    the lists ``mask`` [Q, K] selects. Returns (d [Q, k] ascending, +inf
    where fewer; rows [Q, k], -1 there)."""
    nq = mask.shape[0]
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float64, device=mask.device)
    best_r = torch.full((nq, k), -1, dtype=torch.int64, device=mask.device)
    for c in range(mask.shape[1]):
        if starts[c + 1] == starts[c]:
            continue
        qi = torch.nonzero(mask[:, c]).squeeze(1)
        if qi.numel() == 0:
            continue
        rc = rows[starts[c]:starts[c + 1]]
        d = torch.cat([best_d[qi], dist(qi, rc).double()], 1)
        r = torch.cat([best_r[qi], rc[None, :].expand(qi.numel(), -1)], 1)
        top = torch.topk(d, k, dim=1, largest=False)
        best_d[qi] = top.values
        best_r[qi] = torch.gather(r, 1, top.indices)
    return best_d, best_r


class Judge:
    """The reference for one built index and one pool of queries.

    ``rows_under(x32, c32, rows, lists)`` gives the rows as the
    configuration scores them, in float64, when they sit in ``lists``: the
    fp32 rows themselves, or their decoded codes (the reference's file).
    """

    def __init__(self, x32: torch.Tensor, cents: np.ndarray, pool: torch.Tensor,
                 nprobe: int, k: int, rows_under):
        dev = x32.device
        self.x32, self.k, self.nprobe, self.rows_under = x32, k, nprobe, rows_under
        self.c32 = torch.from_numpy(np.ascontiguousarray(cents, np.float32)).to(dev)
        self.kc = self.c32.shape[0]
        x64 = x32.double()
        self.part = partition(x64, self.c32.double())
        self.kmeans_gain = lloyd_gain(x64, self.c32.double(), self.part)
        self.mean_xx = float((x64 * x64).sum(1).mean())
        del x64
        self.lens = torch.bincount(self.part.a1, minlength=self.kc)
        # each row as the configuration scores it, in its nearest list
        n = x32.shape[0]
        self.r64 = torch.cat([rows_under(x32, self.c32, torch.arange(s, min(s + BLOCK, n), device=dev),
                                         self.part.a1[s:s + BLOCK]) for s in range(0, n, BLOCK)])
        self.rr = (self.r64 * self.r64).sum(1)
        self.q64 = pool.double()
        self.qq = (self.q64 * self.q64).sum(1)
        self.scale = self.qq + self.mean_xx
        self.sure, self.maybe, self.probes = probe_sets(self.q64, self.c32.double(), nprobe)
        plain = (self.part.a2 < 0) & ~self.part.multi
        rows, starts = _csr(self.part.a1, plain, self.kc)
        self.best_d, self.best_r = list_topk(self.sure, rows, starts, self._dist64, k)
        self.exact = exact_topk(x32, self.q64, k)

    def extra_checks(self) -> dict:
        return {"kmeans_gain": self.kmeans_gain}

    def spread(self) -> str:
        """Where the answers lie, one line: how many lists the k best rows
        of the probed lists span a query, the probe rank of the farthest,
        and the share of the exact k nearest rows that the probed lists hold."""
        d = (self.c32.double() ** 2).sum(1)[None, :] - 2.0 * (self.q64 @ self.c32.double().T)
        order = d.argsort(1)
        rank = torch.empty(order.shape, dtype=torch.int64, device=d.device)
        rank.scatter_(1, order, torch.arange(self.kc, device=d.device).expand_as(order))
        found = self.best_r >= 0
        lists = torch.where(found, self.part.a1[self.best_r.clamp(min=0)], -1)
        far = torch.gather(rank, 1, lists.clamp(min=0)).masked_fill(~found, -1).amax(1).double()
        s = lists.sort(1).values
        span = ((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum(1) + (s[:, 0] >= 0).long()
        span = span.double()
        held = torch.gather(self.sure, 1, self.part.a1[self.exact])
        q = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=far.device)
        return (f"the k best rows of the probed lists span {float(span.mean()):.3f} lists a query "
                f"(max {int(span.max())}); the farthest one's probe rank p50/p90/p99/max "
                f"{torch.quantile(far, q).tolist()}/{int(far.max())}; the probed lists hold "
                f"{float(held.double().mean()):.6f} of the exact k nearest rows")

    def _dist64(self, qi, rc):
        return (self.qq[qi, None] - 2.0 * (self.q64[qi] @ self.r64[rc].T)
                + self.rr[rc][None, :]).clamp(min=0)

    def judge(self, qpos: torch.Tensor, rows: torch.Tensor, scores: torch.Tensor) -> dict:
        """Per answered query (pool positions ``qpos`` [M]; corpus rows
        [M, k], -1 for none; scores [M, k], higher is better): the bad rows,
        the gap and the score error. Tensors on the judge's device."""
        m, k = rows.shape
        valid = rows >= 0
        r = rows.clamp(min=0)
        a1, a2 = self.part.a1[r], self.part.a2[r]
        maybe = self.maybe[qpos]
        allowed = (torch.gather(maybe, 1, a1) | ((a2 >= 0) & torch.gather(maybe, 1, a2.clamp(min=0)))
                   | self.part.multi[r])
        srt = torch.sort(torch.where(valid, rows, -1 - torch.arange(k, device=rows.device)), 1).values
        dup = torch.zeros_like(valid)
        dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
        have = torch.isfinite(self.best_d[qpos])       # rank j is due: k surely probed rows exist
        bad = (valid & ~allowed).sum(1) + dup.sum(1) + (~valid & have).sum(1)
        q = self.q64[qpos]
        d1 = ((q[:, None, :] - self.r64[r]) ** 2).sum(-1)
        amb = a2 >= 0
        d2 = d1
        if bool(amb.any()):
            alt = self.rows_under(self.x32, self.c32, r[amb], a2[amb])
            d2 = d1.clone()
            d2[amb] = ((q[:, None, :].expand(-1, k, -1)[amb] - alt) ** 2).sum(-1)
        big = torch.tensor(float("inf"), dtype=torch.float64, device=rows.device)
        dmin = torch.where(valid, torch.minimum(d1, d2), big)
        excess = (dmin.sort(1).values - self.best_d[qpos]).clamp(min=0)
        excess = torch.where(torch.isfinite(excess), excess, 0.0)
        dp = -scores.double()
        err = torch.where(valid, torch.minimum((dp - d1).abs(), (dp - d2).abs()), 0.0)
        scale = self.scale[qpos][:, None]
        hit = (self.exact[qpos][:, :, None] == torch.where(valid, rows, -1)[:, None, :]).any(2)
        return {"bad": bad, "gap": (excess / scale).amax(1), "err": (err / scale).amax(1),
                "miss": 1.0 - hit.double().mean(1)}

    def judge_batches(self, qpos_of, batches) -> dict:
        """``judge`` over many answered batches, a chunk at a time:
        ``batches`` yields (batch number, rows np [B, k], scores np [B, k]),
        ``qpos_of(n)`` the pool positions of batch n's queries."""
        out = {"bad": [], "gap": [], "err": [], "miss": []}
        buf: list = []

        def flush():
            if not buf:
                return
            qpos = torch.cat([p for p, _, _ in buf])
            rows = torch.from_numpy(np.concatenate([r for _, r, _ in buf])).to(self.x32.device)
            vals = torch.from_numpy(np.concatenate([v for _, _, v in buf])).to(self.x32.device)
            for key, val in self.judge(qpos, rows.long(), vals).items():
                out[key].append(val.cpu())
            buf.clear()

        size = 0
        for n, rows, vals in batches:
            buf.append((qpos_of(n), rows, vals))
            size += rows.size
            if size >= CHUNK:
                flush()
                size = 0
        flush()
        return {key: torch.cat(v) if v else torch.zeros(0) for key, v in out.items()}

    def control(self, qsel: slice) -> tuple[torch.Tensor, torch.Tensor]:
        """The reference in the program's place at the next precision down:
        the probe ranking and the scan as fp32 products of TF32-rounded
        operands (the configuration states fp32 with TF32 off). Over the
        pool queries ``qsel``; returns (scores [Q, k], corpus rows [Q, k])."""
        q = self.q64[qsel].float()
        qq = (q * q).sum(1)
        cc = (self.c32 * self.c32).sum(1)
        dq = qq[:, None] - 2.0 * (tf32(q) @ tf32(self.c32).T) + cc[None, :]
        probes = torch.topk(dq, self.nprobe, dim=1, largest=False).indices
        mask = torch.zeros(dq.shape, dtype=torch.bool, device=q.device)
        mask.scatter_(1, probes, True)
        r32 = self.r64.float()
        rr = (r32 * r32).sum(1)
        rows, starts = _csr(self.part.a1, torch.ones_like(self.part.multi), self.kc)

        def dist(qi, rc):
            return (qq[qi, None] - 2.0 * (tf32(q[qi]) @ tf32(r32[rc]).T) + rr[rc][None, :]).clamp(min=0)

        d, r = list_topk(mask, rows, starts, dist, self.k)
        return -d.float(), r
