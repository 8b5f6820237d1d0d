"""The port's test fixtures (ocrs_tpu_torch.testing) against the JAX
package's (ocrs_tpu.testing): equal rect grids, unions and fills."""

import numpy as np
import pytest

from ocrs_tpu import testing as J
from ocrs_tpu_torch import testing as T


def _tlbr(rects):
    return [(r.top, r.left, r.bottom, r.right) for r in rects]


@pytest.mark.parametrize(
    "top_left, grid, size, gap",
    [((0, 0), (1, 1), (5, 5), (0, 0)), ((10, 20), (3, 4), (8.5, 20), (4, 6)), ((2.5, 3), (2, 7), (12, 9), (0.5, 3.25))],
)
def test_gen_rect_grid_and_union_equal_jax(top_left, grid, size, gap):
    t, j = T.gen_rect_grid(top_left, grid, size, gap), J.gen_rect_grid(top_left, grid, size, gap)
    assert len(t) == grid[0] * grid[1]
    assert _tlbr(t) == _tlbr(j)
    assert _tlbr([T.union_rects(t)]) == _tlbr([J.union_rects(j)])
    a, b = np.zeros((80, 120), np.float32), np.zeros((80, 120), np.float32)
    for rt, rj in zip(t, j):
        T.fill_rect(a, rt, 1.0)
        J.fill_rect(b, rj, 1.0)
    np.testing.assert_array_equal(a, b)
    assert a.sum() > 0


def test_union_of_nothing_is_none():
    assert T.union_rects([]) is None
