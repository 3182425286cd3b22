"""The corpus and the queries, drawn on the device in a few large calls.

A Gaussian mixture whose centres lie in a subspace of few dimensions, as
the neighbours of a real embedding do: ``centres`` centres uniform in
[0, 1)^L (L = ``latent_dim``), each row a centre plus N(0, spread²) in those
L dimensions, carried into D dimensions by a fixed random orthonormal map
scaled by sqrt(D / L), plus N(0, noise²) in all D. The components overlap
their neighbours, so a query's nearest rows lie in several lists of the
index, the lists whose centroids rank next to its own: the recall of an
IVF search rises with nprobe as it does on SIFT1M, and every probed list
can hold an answer. Every centre gets the same number of rows (and of pool
queries, to one), in a shuffled order.

The corpus is the deployment's dataset, as SIFT1M is one fixed set: it is
drawn anew in every run from the configuration's ``corpus_seed``. The run's
seed draws the query pool from the same mixture (held-out queries, as
ann-benchmarks' are). The index's k-means partition follows the corpus,
and its shape sets the work of a batch, so a corpus drawn from the run's
seed would change the work from seed to seed; the queries change only
which of the same lists a batch probes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Corpus:
    x: torch.Tensor | None   # [N, D] fp32 on the device
    centres: torch.Tensor    # [C, L] fp32, in the mixture's own dimensions
    embed: torch.Tensor      # [L, D] fp32: the map into D dimensions


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def _balanced(n: int, c: int, g: torch.Generator, device) -> torch.Tensor:
    """n labels, each of the c centres n // c or n // c + 1 times, shuffled."""
    return torch.randperm(n, generator=g, device=device) % c


def _draw(data: dict, centres: torch.Tensor, embed: torch.Tensor, n: int,
          g: torch.Generator) -> torch.Tensor:
    """``n`` rows of the mixture, [n, D] fp32."""
    device = centres.device
    labels = _balanced(n, centres.shape[0], g, device)
    z = torch.randn((n, centres.shape[1]), generator=g, device=device)
    z.mul_(data["spread"]).add_(centres[labels])
    x = torch.randn((n, embed.shape[1]), generator=g, device=device)
    return x.mul_(data["noise"]).addmm_(z, embed)


def corpus(data: dict, n: int, dim: int, device) -> Corpus:
    """``n`` rows of the mixture ``data`` describes, from its ``corpus_seed``."""
    g = _generator(data["corpus_seed"], device)
    latent = data["latent_dim"]
    centres = torch.rand((data["centres"], latent), generator=g, device=device)
    basis = torch.randn((dim, latent), generator=g, device=device)
    # orthonormal columns by a QR on the host (a [D, L] matrix: no time)
    embed = torch.linalg.qr(basis.cpu().double())[0].T.float().to(device) * (dim / latent) ** 0.5
    return Corpus(_draw(data, centres, embed, n, g), centres, embed)


def query_pool(data: dict, corpus: Corpus, count: int, seed: int) -> torch.Tensor:
    """``count`` queries of the corpus's mixture, [count, D] fp32, from the
    run's seed."""
    g = _generator(seed, corpus.centres.device)
    return _draw(data, corpus.centres, corpus.embed, count, g)
