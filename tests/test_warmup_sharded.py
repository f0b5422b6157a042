"""Sharded warmup + flag-composition semantics (VERDICT round-2 items 3/7).

The CLI's timer contract needs warmup() to AOT-build the exact sharded
runner run() will dispatch (one cached jit per config); and ca_steps must
either take effect or fail loudly — never be silently dropped.
"""

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation
from advanced_hpc_lbm_tpu.params import LBMParams


@pytest.fixture(scope="module")
def deck():
    params = LBMParams(
        nx=32, ny=32, max_iters=12, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((params.ny, params.nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[10:14, 8:16] = True
    return params, mask


def test_warmup_caches_sharded_runner_and_run_reuses_it(deck):
    params, mask = deck
    sim = Simulation(params, mask, backend="sharded")
    sim.warmup(devices=4)
    key = ("sharded", params.max_iters, 4, None, 1, False)
    assert key in sim._compiled
    runner_before = sim._compiled[key][0]
    res = sim.run(devices=4)
    assert sim._compiled[key][0] is runner_before  # same jit object reused

    ref = Simulation(params, mask, backend="fused").run()
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-5)
    np.testing.assert_allclose(res.f_final, ref.f_final, rtol=1e-6, atol=1e-9)


def test_warmup_2d_mesh_with_ca(deck):
    params, mask = deck
    sim = Simulation(params, mask, backend="sharded")
    sim.warmup(mesh=(2, 2), ca_steps=2)
    res = sim.run(mesh=(2, 2), ca_steps=2)
    ref = Simulation(params, mask, backend="fused").run()
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=5e-4)
    np.testing.assert_allclose(res.f_final, ref.f_final, rtol=1e-5, atol=1e-7)


def test_ca_steps_without_sharding_raises(deck):
    params, mask = deck
    sim = Simulation(params, mask, backend="fused")
    with pytest.raises(ValueError, match="sharded"):
        sim.run(ca_steps=4)
