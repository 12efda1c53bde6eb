"""Terrain parity: our Perlin + stacking must reproduce the reference's heights
bit-for-bit.  The golden fixture was produced by compiling the reference's own
perlin.cu with g++ (tools/reforacle stubs) and printing per-cell samples/stack
offsets for grids 1..16 (see tools/reforacle)."""

import math
import os

import numpy as np
import pytest

from raytracer.perlin import Perlin

f32 = np.float32

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "terrain_heights.txt")


def _parse_golden():
    runs = []
    cur = []
    with open(GOLDEN) as fh:
        for ln in fh:
            cur.append(ln.split())
            if ln.startswith("max_height"):
                runs.append(cur)
                cur = []
    return runs


@pytest.mark.parametrize("run_idx,grid", [(0, 1), (1, 2), (2, 4), (3, 8), (4, 16)])
def test_terrain_matches_reference(run_idx, grid):
    runs = _parse_golden()
    run = runs[run_idx]
    golden = {}
    golden_max = None
    for parts in run:
        if parts[0] == "max_height":
            golden_max = float(parts[1])
            continue
        c, i, j = int(parts[1]), int(parts[3]), int(parts[4])
        golden[(c, i, j)] = (float(parts[6]), float(parts[8]))

    last = np.zeros(grid * grid, np.float32)
    max_h = 0.0
    for c in range(2):
        p = Perlin(42, (grid + 4) // 5)
        p.set_amplitude(4.0)
        p.set_period(grid)
        for i in range(grid):
            for j in range(grid):
                s = p.sample(f32(i), f32(j), f32(0.0))
                yoff = f32(math.floor(f32(0.5) * (s + f32(4.0))) + 1)
                gs, gy = golden[(c, i, j)]
                assert abs(float(s) - gs) <= 1e-6 * max(1.0, abs(gs)), (c, i, j)
                assert float(yoff) == gy, (c, i, j)
                last[i * grid + j] += yoff
                max_h = max(max_h, float(last[i * grid + j]))
    assert max_h == golden_max
