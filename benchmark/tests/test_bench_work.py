"""The engine's per-stage work against counts made by hand."""

import copy

import pytest

from benchmark import work
from benchmark.catalog import Catalog


def tiny(name, H, W, D):
    c = copy.deepcopy(Catalog().config(name))
    c["rig"].update(height=H, width=W)
    c["pipeline"]["params"]["num_disparities"] = D
    return c


def test_full_search_by_hand():
    # H=4, W=8, D=4, 5x5 census (24 bits: 3 bytes, one word), four paths
    # (4 x (24 + 96) = 480 > 255: a two-byte sum), LR, speckle 100/32, median 5
    got = {s.name: (s.bytes, s.ops) for s in work.engine_stages(tiny("full", 4, 8, 4))}
    n, v = 32, 128
    assert got == {
        "census": (2 * n * (4 + 3), 2 * n * 24),
        "cost": (n * 2 * 3 + v, v * 2),
        "aggregate": (v * (1 + 2), v * (6 * 4 + 3)),
        "wta": (v * 2 + n * (8 + 1 / 8), v * 3 + n * 12),
        # the diagonals: 4 rows x (8 x 4 - 4 x 3 / 2) = 104 entries
        "lr": (104 * 2 + n * (4 + 2 / 8), 2 * 104 + 4 * n),
        # (4 + 32) // 32 + 2 = 3 bins
        "speckle": (n * (4 + 2 / 8), n * (2 * (2 + 5 * 3) + 1)),
        "median": (n * 8, n * 25),
        "select": (n * (8 + 1 / 8), 3 * n),
        "confidence": (n * (8 + 1 / 8), 3 * n),
    }


def test_hier2_stages_and_sizes():
    stages = work.engine_stages(tiny("production", 48, 96, 64))
    names = [s.name for s in stages]
    assert names[:2] == ["downscale", "coarse census"]
    assert "refine aggregate" in names and names[-1] == "confidence"
    by = {s.name: s for s in stages}
    # the coarse search: 16 x 32 pixels, max(16, ceil(64 / 3)) = 22 disparities
    assert by["coarse cost"].bytes == 16 * 32 * 6 + 16 * 32 * 22
    # the refine stack: 48 rows of A and 16 of B (H % 24 == 0), R = 32, two paths
    # (2 x 120 = 240: a one-byte sum)
    assert by["refine aggregate"].bytes == 64 * 96 * 32 * 2
    assert by["refine lr"].bytes == 48 * (96 * 32 - 32 * 31 // 2) + 48 * 96 * (4 + 2 / 8)


def test_least_seconds_is_the_larger_bound():
    stages = [work.Stage("a", 3.35e12, 1.0), work.Stage("b", 0.0, 134e12)]
    assert work.least_seconds(stages) == pytest.approx(2.0)
    assert work.least_seconds(stages[:1]) == pytest.approx(1.0)


def test_count_reads_shapes_not_the_implementation():
    a = tiny("full", 4, 8, 4)
    b = copy.deepcopy(a)
    b["pipeline"]["params"].update(impl="xla", stats_impl="xla")
    assert work.engine_stages(a) == work.engine_stages(b)
