"""The reference against a brute-force search at a tiny size, and its
TF32 rounding."""

import numpy as np
import pytest
import torch

from core import data, manifest
from core.ivf_judge import Judge, exact_topk, tf32


def brute(x, cents, q, nprobe, k, rows_under):
    x64, c64, q64 = x.double(), torch.from_numpy(cents).double(), q.double()
    assign = torch.cdist(x64, c64).argmin(1)
    rep = rows_under(x, torch.from_numpy(cents), torch.arange(x.shape[0]), assign)
    probes = torch.cdist(q64, c64).topk(nprobe, largest=False).indices
    out_d, out_r = [], []
    for i in range(q.shape[0]):
        rows = torch.nonzero(torch.isin(assign, probes[i])).squeeze(1)
        d = ((rep[rows] - q64[i]) ** 2).sum(1)
        top = d.topk(k, largest=False)
        out_d.append(top.values)
        out_r.append(rows[top.indices])
    return torch.stack(out_d), torch.stack(out_r)


@pytest.mark.parametrize("ref_name", ["ivf_flat", "ivf_sq8res"])
def test_reference_equals_brute_force(ref_name):
    rows_under = manifest.module("references", ref_name).rows_under
    spec = {"centres": 12, "latent_dim": 4, "spread": 0.02, "noise": 0.01, "corpus_seed": 99}
    corpus = data.corpus(spec, 3000, 16, "cpu")
    q = data.query_pool(spec, corpus, 64, 99)
    # a partition near the generating one
    cents = (corpus.centres @ corpus.embed).numpy() + 0.01
    judge = Judge(corpus.x, cents, q, 3, 5, rows_under)
    assert not bool((judge.part.a2 >= 0).any())    # no ambiguous row at this spread
    want_d, want_r = brute(corpus.x, cents, q, 3, 5, rows_under)
    np.testing.assert_allclose(judge.best_d.numpy(), want_d.numpy(), rtol=1e-9, atol=1e-9)
    got = judge.judge(torch.arange(64), want_r, -want_d.float())
    assert int(got["bad"].sum()) == 0
    assert float(got["gap"].max()) < 1e-12     # float64 orders only
    assert float(got["err"].max()) < 1e-7
    # a row of an unprobed list is never allowed
    far = torch.nonzero(~judge.maybe[0][judge.part.a1]).squeeze(1)[0]
    wrong = want_r.clone()
    wrong[0, 0] = far
    assert int(judge.judge(torch.arange(64), wrong, -want_d.float())["bad"][0]) == 1


def test_exact_search_over_all_rows_and_the_miss():
    spec = {"centres": 30, "latent_dim": 8, "spread": 0.3, "noise": 0.05, "corpus_seed": 5}
    corpus = data.corpus(spec, 70_000, 32, "cpu")     # two blocks of rows, one of them short
    q = data.query_pool(spec, corpus, 40, 6).double()
    got = exact_topk(corpus.x, q, 7)
    want = torch.cdist(q, corpus.x.double()).topk(7, largest=False).indices
    assert torch.equal(got, want)
    rows_under = manifest.module("references", "ivf_flat").rows_under
    cents = (corpus.centres @ corpus.embed).numpy()
    judge = Judge(corpus.x, cents, q.float(), 4, 7, rows_under)
    half = torch.cat([want[:, :3], torch.full((40, 4), -1)], 1)
    miss = judge.judge(torch.arange(40), half, torch.zeros(40, 7))["miss"]
    assert torch.allclose(miss, torch.full((40,), 4 / 7, dtype=torch.float64))


def test_tf32_keeps_ten_mantissa_bits_rounding_to_nearest_even():
    one = 1.0
    vals = torch.tensor([one + 2.0 ** -11, one + 3 * 2.0 ** -11, one + 2.0 ** -10 + 2.0 ** -12,
                         -(one + 2.0 ** -12), 3.0])
    want = torch.tensor([one, one + 2.0 ** -9, one + 2.0 ** -10, -one, 3.0])
    assert torch.equal(tf32(vals), want)
    x = torch.randn(1000)
    assert bool(((tf32(x).view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((tf32(x) - x).abs() / x.abs()).max()) <= 2.0 ** -11
