"""Checkpoint/resume segment lengths on the fused and the sharded paths:
a run cut into segments of any length (dividing the run or leaving a
tail, shorter or longer than the run) equals the straight run, and a
resume from the middle equals it too.  Same compiled step on both sides
of each comparison, so equality is exact on one device; the sharded
snapshot round trip through the host is exact as well."""

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation
from advanced_hpc_lbm_tpu.params import LBMParams
from advanced_hpc_lbm_tpu.utils.checkpoint import CheckpointManager

ITERS = 12
LAYOUTS = {
    "fused": {},
    "ring4": {"devices": 4},
    "torus2x2": {"mesh": (2, 2)},
}


@pytest.fixture(scope="module")
def sims():
    params = LBMParams(
        nx=32, ny=16, max_iters=ITERS, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((16, 32), dtype=bool)
    mask[0] = mask[-1] = True
    mask[5:8, 9:13] = True
    sim = Simulation(params, mask, backend="fused")
    straight = {name: sim.run(**kw) for name, kw in LAYOUTS.items()}
    return sim, straight


@pytest.mark.parametrize("every", [1, 2, 3, 5, 7, 12, 13])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_segmented_equals_straight(sims, tmp_path, layout, every):
    sim, straight = sims
    ck = sim.run(
        checkpoint_every=every, checkpoint_dir=tmp_path / "ck",
        **LAYOUTS[layout],
    )
    np.testing.assert_array_equal(ck.f_final, straight[layout].f_final)
    np.testing.assert_array_equal(ck.av_vels, straight[layout].av_vels)
    # one snapshot per segment boundary, the last at the full horizon
    assert CheckpointManager(tmp_path / "ck").latest_step() == ITERS


@pytest.mark.parametrize("stop", [4, 6, 9])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_resume_from_the_middle(sims, tmp_path, layout, stop):
    sim, straight = sims
    ckdir = tmp_path / "ck"
    sim.run(
        n_iters=stop, checkpoint_every=stop, checkpoint_dir=ckdir,
        **LAYOUTS[layout],
    )
    resumed = sim.run(
        checkpoint_every=4, checkpoint_dir=ckdir, resume=True,
        **LAYOUTS[layout],
    )
    np.testing.assert_array_equal(resumed.f_final, straight[layout].f_final)
    np.testing.assert_array_equal(resumed.av_vels, straight[layout].av_vels)
