"""The committed reference decks (decks/256x256.*, decks/1024x1024.*)
against what the reference says of them and against the goldens they
were recovered from: the golden final state's last column prints the
transposed obstacle mask (d2q9-bgk.c:2978; square grids)."""

import lzma

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.utils import io as lbm_io

from conftest import DECKS_DIR, GOLDENS_DIR

# SURVEY.md "Input decks" / "Obstacle decks" rows
PARAMS = {
    "256x256": (256, 256, 80000, 10, 0.1, 0.005, 1.85),
    "1024x1024": (1024, 1024, 20000, 10, 0.1, 0.01, 1.85),
}
OBSTACLE_LINES = {"256x256": 1024, "1024x1024": 5120}


def _load(deck):
    p = lbm_io.load_params(f"{DECKS_DIR}/{deck}.params")
    return p, lbm_io.load_obstacles(f"{DECKS_DIR}/{deck}.obstacles.dat", p)


@pytest.mark.parametrize("deck", sorted(PARAMS))
def test_params_match_the_reference(deck):
    p, _ = _load(deck)
    assert (p.nx, p.ny, p.max_iters, p.reynolds_dim, p.density, p.accel,
            p.omega) == PARAMS[deck]


@pytest.mark.parametrize("deck", sorted(PARAMS))
def test_obstacle_file_line_count(deck):
    with open(f"{DECKS_DIR}/{deck}.obstacles.dat") as fh:
        assert sum(1 for _ in fh) == OBSTACLE_LINES[deck]


@pytest.mark.parametrize("deck", sorted(PARAMS))
def test_mask_matches_golden_obstacle_column(deck):
    p, mask = _load(deck)
    with lzma.open(f"{GOLDENS_DIR}/{deck}.final_state.dat.xz", "rt") as fh:
        cols = np.loadtxt(fh, usecols=[0, 1, 6], dtype=np.int64)
    column = np.zeros((p.ny, p.nx), np.int64)
    column[cols[:, 1], cols[:, 0]] = cols[:, 2]
    np.testing.assert_array_equal(mask, column.T.astype(bool))
    # and the writer reproduces that column from the mask
    _, _, obs_col = lbm_io.final_state_table(
        np.ones((9, p.ny, p.nx), np.float32), mask, p
    )
    np.testing.assert_array_equal(obs_col, cols[:, 2])


def test_geometries():
    _, m256 = _load("256x256")
    _, m1024 = _load("1024x1024")
    for m in (m256, m1024):  # closed boxes
        assert m[0].all() and m[-1].all() and m[:, 0].all() and m[:, -1].all()
    assert not m256[1:-1, 1:-1].any()
    # 1024x1024: plus a full-height interior wall at x = 341
    inner = m1024[1:-1, 1:-1]
    assert inner[:, 340].all() and inner.sum() == 1022
