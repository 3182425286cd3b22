"""A run with the timed path broken underneath comes out not correct: a
search that returns its state unchanged, half of each batch left out (the
rest answered twice), one answer altered where it is produced, and a scan
of only the two nearest lists where the cell asks for more. (One chip: no
exchange between chips to leave out.)"""

import pytest

from core import harness

CELLS = ["sift1m-ivf-flat.b1024", "sift1m-ivf-flat.b1024-np100"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(man, tiny_of, cell):
    out = harness.run_cell(man, cell, 4_000_000_011, 0.5, False, device="cpu",
                           overrides=tiny_of(cell))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "two_probes"])
def test_broken_search_is_not_correct(man, tiny_of, fault):
    cell = CELLS[0]
    out = harness.run_cell(man, cell, 4_000_000_011, 0.5, False, device="cpu",
                           overrides=tiny_of(cell), fault=fault)
    assert not out["correct"]
    assert out["failed"] > 0


def test_two_probes_misses_the_neighbours_of_later_probes(man, tiny_of):
    """Where the cell probes 20 lists, the k best rows lie beyond the two
    nearest lists for many queries: the fault fails the gap and misses
    several times the exact neighbours that a sound run does."""
    cell = CELLS[1]
    sound = harness.run_cell(man, cell, 4_000_000_015, 0.5, False, device="cpu",
                             overrides=tiny_of(cell))
    out = harness.run_cell(man, cell, 4_000_000_015, 0.5, False, device="cpu",
                           overrides=tiny_of(cell), fault="two_probes")
    assert out["checks"]["gap"]["value"] > out["checks"]["gap"]["limit"]
    miss = out["checks"]["recall_miss"]["value"]
    assert miss > out["checks"]["recall_miss"]["limit"]
    assert miss > 3 * sound["checks"]["recall_miss"]["value"]
