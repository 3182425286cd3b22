"""The control of ``correct``: the program at a tiny size passes; the
reference put in its place at TF32, judged over the same answered batches,
fails the gap and the score error; the program's k-means without a Lloyd
iteration fails the objective ratio."""

import pytest

from core import harness

CELLS = ["sift1m-ivf-flat.b1024", "sift1m-ivf-sq8.b1024"]


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_tf32_control_fails(man, tiny_of, cell):
    out = harness.run_cell(man, cell, 4_000_000_007, 0.5, False, device="cpu",
                           overrides=tiny_of(cell), control=True)
    assert out["correct"], out["checks"]
    ctl = out["control"]
    assert not ctl["correct"] and ctl["failed"] > 0
    assert ctl["attempted"] == out["attempted"]
    assert ctl["checks"]["gap"]["value"] > ctl["checks"]["gap"]["limit"]
    assert ctl["checks"]["score_err"]["value"] > ctl["checks"]["score_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_kmeans_without_lloyd_fails(man, tiny_of, cell):
    out = harness.run_cell(man, cell, 4_000_000_009, 0.5, False, device="cpu",
                           overrides=tiny_of(cell), fault="no_lloyd")
    assert not out["correct"]
    assert out["checks"]["kmeans_gain"]["value"] > out["checks"]["kmeans_gain"]["limit"]
