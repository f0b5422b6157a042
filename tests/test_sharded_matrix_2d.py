"""The 2-D torus (rows AND columns sharded) against the single-device
fused run on the virtual 8-device CPU mesh: meshes × ca_steps {1, 2, 3, 4}
with a non-multiple tail, and the per-step debug densities.  Same
tolerances as tests/test_sharded_matrix.py, for the same reasons."""

import jax.numpy as jnp
import numpy as np
import pytest

from advanced_hpc_lbm_tpu.ops import fused, reference
from advanced_hpc_lbm_tpu.parallel import halo
from advanced_hpc_lbm_tpu.params import LBMParams

N_ITERS = 13


@pytest.fixture(scope="module")
def deck():
    params = LBMParams(
        nx=32, ny=32, max_iters=N_ITERS, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    rng = np.random.RandomState(29)
    mask = np.zeros((params.ny, params.nx), dtype=bool)
    mask[0] = True
    mask[:, 5] = True
    mask[12:15, 18:23] = True
    for _ in range(8):
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


@pytest.mark.parametrize("ca_steps", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4), (4, 2), (1, 4), (4, 1)])
def test_torus_matches_single_device(deck, single, mesh_shape, ca_steps):
    params, mask = deck
    f_ref, av_ref, _ = single
    f, av = halo.run_sharded_2d(
        None, mask, params, mesh_shape, ca_steps=ca_steps
    )
    assert av.shape == (N_ITERS,)
    np.testing.assert_allclose(np.asarray(f), f_ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(av), av_ref, rtol=1e-5)


@pytest.mark.parametrize("ca_steps", [1, 3])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2)])
def test_torus_debug_densities(deck, single, mesh_shape, ca_steps):
    params, mask = deck
    _, _, dens_ref = single
    _, av, dens = halo.run_sharded_2d(
        None, mask, params, mesh_shape, ca_steps=ca_steps,
        collect_density=True,
    )
    assert dens.shape == av.shape == (N_ITERS,)
    np.testing.assert_allclose(np.asarray(dens), dens_ref, rtol=1e-4)
