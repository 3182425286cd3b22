"""The list scan's operations and bytes, against a count by hand."""

import pytest
import torch

from core import manifest


@pytest.mark.parametrize("storage,row_bytes,extra", [("fp32", 4 * 8 + 4, 0), ("sq8res", 8 + 12, 4)])
def test_batch_cost_by_hand(storage, row_bytes, extra):
    cost = manifest.module("costs", "list_scan")
    lens = torch.tensor([5, 0, 7, 3])
    probes = torch.tensor([[0, 2], [2, 3], [0, 2]])     # 3 queries, 2 probes each, d 8, k 4
    ops, nbytes = cost.batch(probes, lens, 8, 4, storage)
    pairs = (5 + 7) + (7 + 3) + (5 + 7)
    assert ops == 2 * 8 * pairs
    lists = 5 + 7 + 3                                   # lists 0, 2 and 3, each read once
    assert nbytes == lists * row_bytes + 3 * 8 * 4 + 3 * 2 * (4 + extra) + 3 * 4 * 8
