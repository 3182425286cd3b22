"""Operations and bytes of one batch's list scan, from its probe sets and
the list lengths (the reference's, from the centroids):

- operations: 2·D for every (query, probed row) pair;
- bytes: each list some query of the batch probes read once (fp32: 4·D
  bytes of row and 4 of squared norm; residual SQ8: D bytes of codes and 12
  of min, scale and norm), the queries (4·D each), the probe ids (4 each),
  SQ8's per-probe q·c (4 each), and the hits written (8 each: score and row).
"""

from __future__ import annotations

import torch

ROW_BYTES = {"fp32": lambda d: 4 * d + 4, "sq8res": lambda d: d + 12}
PROBE_EXTRA = {"fp32": 0, "sq8res": 4}


def batch(probes: torch.Tensor, lens: torch.Tensor, d: int, k: int,
          storage: str) -> tuple[float, float]:
    """(operations, bytes) of a batch with probe sets ``probes`` [B, P]."""
    b, p = probes.shape
    pairs = float(lens[probes].sum())
    listed = float(lens[torch.unique(probes)].sum())
    nbytes = (listed * ROW_BYTES[storage](d) + b * d * 4 + b * p * (4 + PROBE_EXTRA[storage])
              + b * k * 8)
    return 2.0 * d * pairs, nbytes


def per_slot(ctx, combine) -> list[float]:
    """``combine(ops, bytes)`` for each batch of the query pool, in order."""
    b = ctx.traffic["batch"]
    probes, lens = ctx.judge.probes, ctx.judge.lens
    return [combine(*batch(probes[s * b:(s + 1) * b], lens, ctx.config["dim"],
                           ctx.traffic["k"], ctx.config["storage"]))
            for s in range(ctx.pool_batches)]
