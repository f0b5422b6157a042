"""Sharded jnp path against the single-device fused run on the virtual
8-device CPU mesh: the 1-D ring over 1/2/4/8 devices × ca_steps
{1, 2, 3, 4, 8}, with step counts that leave a non-multiple tail, and the
per-step debug densities.

The sharded step computes the same physics in another grouping (the
communication-avoiding schedule in the pairwise collide form, psum'd
partial sums), so f and av_vels agree to fp32 rounding (rtol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from advanced_hpc_lbm_tpu.ops import fused, reference
from advanced_hpc_lbm_tpu.parallel import halo
from advanced_hpc_lbm_tpu.params import LBMParams

N_ITERS = 19  # not a multiple of any ca_steps below: every run has a tail


@pytest.fixture(scope="module")
def deck():
    params = LBMParams(
        nx=24, ny=128, max_iters=N_ITERS, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    rng = np.random.RandomState(17)
    mask = np.zeros((params.ny, params.nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[40:46, 6:12] = True
    mask[params.ny - 2, 3] = True  # an obstacle on the forcing row
    for _ in range(10):
        mask[rng.randint(1, params.ny - 1), rng.randint(0, params.nx)] = True
    return params, mask


@pytest.fixture(scope="module")
def single(deck):
    params, mask = deck
    f, av, dens = fused.run_simulation(
        reference.initial_state(params), jnp.asarray(mask), params,
        collect_density=True,
    )
    return np.asarray(f), np.asarray(av), np.asarray(dens)


@pytest.mark.parametrize("ca_steps", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_ring_matches_single_device(deck, single, n_devices, ca_steps):
    params, mask = deck
    f_ref, av_ref, _ = single
    f, av = halo.run_sharded(
        None, mask, params, n_devices=n_devices, ca_steps=ca_steps
    )
    assert av.shape == (N_ITERS,)
    np.testing.assert_allclose(np.asarray(f), f_ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(av), av_ref, rtol=1e-5)


@pytest.mark.parametrize("ca_steps", [1, 3, 4])
@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_ring_debug_densities(deck, single, n_devices, ca_steps):
    """One total density per STEP, also inside a K-step exchange window;
    psum of per-shard fp32 sums vs one global fp32 sum (rtol 1e-4)."""
    params, mask = deck
    _, _, dens_ref = single
    _, av, dens = halo.run_sharded(
        None, mask, params, n_devices=n_devices, ca_steps=ca_steps,
        collect_density=True,
    )
    assert dens.shape == av.shape == (N_ITERS,)
    np.testing.assert_allclose(np.asarray(dens), dens_ref, rtol=1e-4)
