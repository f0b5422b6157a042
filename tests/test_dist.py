"""Sharded-vs-single-device equivalence on the virtual 8-device CPU mesh.

This is the distributed test tier the reference never had (its array job
ran 5 independent copies — job_submit_array:11); here we assert the
halo-exchanged decomposition reproduces the single-device trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advanced_hpc_lbm_tpu.ops import fused, reference
from advanced_hpc_lbm_tpu.parallel import halo
from advanced_hpc_lbm_tpu.params import LBMParams


@pytest.fixture(scope="module")
def deck():
    params = LBMParams(
        nx=32, ny=64, max_iters=40, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    rng = np.random.RandomState(7)
    mask = np.zeros((params.ny, params.nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[20:24, 10:16] = True
    for _ in range(8):
        mask[rng.randint(1, params.ny - 1), rng.randint(0, params.nx)] = True
    return params, mask


def test_eight_devices_available():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_sharded_matches_single(deck, n_devices):
    params, mask = deck
    f0 = reference.initial_state(params)
    obst = jnp.asarray(mask)

    f_ref, av_ref = fused.run_simulation(f0, obst, params, n_iters=params.max_iters)
    f_sh, av_sh = halo.run_sharded(
        reference.initial_state(params), obst, params, n_devices=n_devices
    )

    # identical math modulo reduction order: bitwise for the field,
    # ~1 ulp for the psum'd scalar
    np.testing.assert_allclose(
        np.asarray(f_sh), np.asarray(f_ref), rtol=1e-6, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(av_sh), np.asarray(av_ref), rtol=1e-5
    )


def test_sharded_rejects_indivisible(deck):
    params, mask = deck
    bad = LBMParams(
        nx=params.nx, ny=30, max_iters=2, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    f0 = reference.initial_state(bad)
    with pytest.raises(ValueError, match="not divisible"):
        halo.run_sharded(f0, jnp.zeros((30, params.nx), bool), bad, n_devices=8)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4), (4, 2), (1, 8)])
def test_2d_mesh_matches_single(deck, mesh_shape):
    """2-D torus decomposition: rows AND columns sharded, corners carried
    by the two-phase exchange.  Any error in the corner plumbing shows up
    through the diagonal speeds immediately."""
    params, mask = deck
    obst = jnp.asarray(mask)
    f0 = reference.initial_state(params)
    fa, ava = fused.run_simulation(f0, obst, params, n_iters=10)
    fb, avb = halo.run_sharded_2d(
        reference.initial_state(params), obst, params, mesh_shape, n_iters=10
    )
    np.testing.assert_allclose(
        np.asarray(fb), np.asarray(fa), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(np.asarray(avb), np.asarray(ava), rtol=5e-4)


def test_2d_mesh_rejects_indivisible(deck):
    params, mask = deck
    f0 = reference.initial_state(params)
    with pytest.raises(ValueError, match="not divisible"):
        halo.run_sharded_2d(
            f0, jnp.asarray(mask), params, (3, 2), n_iters=1
        )


def test_forcing_row_crosses_shard_boundary(deck):
    """Row ny-2 lives on the last shard; make sure its effect propagates
    across shard edges identically (halo correctness around the forcing)."""
    params, mask = deck
    obst = jnp.asarray(mask)
    f0 = reference.initial_state(params)
    _, av1 = fused.run_simulation(f0, obst, params, n_iters=3)
    _, av8 = halo.run_sharded(
        reference.initial_state(params), obst, params, n_iters=3, n_devices=8
    )
    np.testing.assert_allclose(np.asarray(av8), np.asarray(av1), rtol=1e-6)


def test_driver_dryrun_contract():
    """dryrun_multichip(8) runs in a FRESH process with no device flags;
    the function must self-provision the virtual CPU mesh.  Run it the
    same way."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c",
         "from __graft_entry__ import dryrun_multichip; dryrun_multichip(8)"],
        cwd=repo, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("n_devices,k", [(2, 2), (4, 4), (8, 3)])
def test_comm_avoiding_matches_single(deck, n_devices, k):
    """K steps per halo exchange (communication-avoiding ghost zones):
    the ring ships K rows once, each shard runs K shrinking-window steps.
    Must reproduce the single-device trajectory incl. a non-multiple tail."""
    params, mask = deck
    obst = jnp.asarray(mask)
    n_iters = 2 * k + 1  # exercises the tail path too
    f0 = reference.initial_state(params)
    fa, ava = fused.run_simulation(f0, obst, params, n_iters=n_iters)
    fb, avb = halo.run_sharded(
        reference.initial_state(params), obst, params,
        n_iters=n_iters, n_devices=n_devices, ca_steps=k,
    )
    np.testing.assert_allclose(
        np.asarray(fb), np.asarray(fa), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(np.asarray(avb), np.asarray(ava), rtol=5e-4)


def test_comm_avoiding_rejects_thin_slabs(deck):
    params, mask = deck
    f0 = reference.initial_state(params)
    with pytest.raises(ValueError, match="too thin"):
        halo.run_sharded(
            f0, jnp.asarray(mask), params, n_devices=8, ca_steps=8
        )


@pytest.mark.parametrize("mesh_shape,k", [((2, 2), 2), ((2, 4), 3), ((4, 2), 4)])
def test_comm_avoiding_2d_matches_single(deck, mesh_shape, k):
    """CA ghost zones on the 2-D torus: the two-phase ±K exchange carries
    the corner blocks, then K shrinking-window steps per exchange.  Any
    corner error shows up through the diagonal speeds immediately; the
    non-multiple tail exercises the 1-step fallback."""
    params, mask = deck
    obst = jnp.asarray(mask)
    n_iters = 2 * k + 1
    f0 = reference.initial_state(params)
    fa, ava = fused.run_simulation(f0, obst, params, n_iters=n_iters)
    fb, avb = halo.run_sharded_2d(
        reference.initial_state(params), obst, params, mesh_shape,
        n_iters=n_iters, ca_steps=k,
    )
    np.testing.assert_allclose(
        np.asarray(fb), np.asarray(fa), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(np.asarray(avb), np.asarray(ava), rtol=5e-4)


def test_comm_avoiding_2d_rejects_thin_blocks(deck):
    params, mask = deck  # 64x32 grid
    f0 = reference.initial_state(params)
    with pytest.raises(ValueError, match="too thin"):
        halo.run_sharded_2d(
            f0, jnp.asarray(mask), params, (2, 4), n_iters=4, ca_steps=5
        )


class TestShardedDebugDensity:
    """The reference's #ifdef DEBUG output (per-step av velocity AND total
    density, d2q9-bgk.c:196-200) on the distributed path: the density is
    one extra psum'd scalar streamed through the sharded scan (VERDICT
    round-3 item 8 — this used to raise on the sharded backend)."""

    def _single_device_debug(self, deck, n_iters):
        params, mask = deck
        obst = jnp.asarray(mask)
        return fused.run_simulation(
            reference.initial_state(params), obst, params, n_iters=n_iters,
            collect_density=True,
        )

    @pytest.mark.parametrize("n_devices", [2, 4])
    def test_1d_matches_single_device_stream(self, deck, n_devices):
        params, mask = deck
        obst = jnp.asarray(mask)
        f_ref, av_ref, dens_ref = self._single_device_debug(deck, 40)
        f_sh, av_sh, dens_sh = halo.run_sharded(
            reference.initial_state(params), obst, params,
            n_devices=n_devices, collect_density=True,
        )
        np.testing.assert_allclose(
            np.asarray(f_sh), np.asarray(f_ref), rtol=1e-6, atol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(av_sh), np.asarray(av_ref), rtol=1e-5
        )
        # density = psum of per-shard sums vs one global fp32 sum:
        # summation-order error only (the fp64 masses are identical;
        # a sequential fp32 sum of 18k elements carries ~1e-4 relative)
        np.testing.assert_allclose(
            np.asarray(dens_sh), np.asarray(dens_ref), rtol=1e-4
        )
        assert dens_sh.shape == (40,)

    def test_2d_mesh_density(self, deck):
        params, mask = deck
        obst = jnp.asarray(mask)
        _, _, dens_ref = self._single_device_debug(deck, 40)
        _, av, dens = halo.run_sharded_2d(
            reference.initial_state(params), obst, params, (2, 2),
            collect_density=True,
        )
        np.testing.assert_allclose(
            np.asarray(dens), np.asarray(dens_ref), rtol=1e-4
        )
        assert av.shape == dens.shape == (40,)

    def test_ca_density(self, deck):
        """CA ghost zones (K steps per exchange) still emit one density
        per STEP (own-rows sum of each intermediate window)."""
        params, mask = deck
        obst = jnp.asarray(mask)
        _, _, dens_ref = self._single_device_debug(deck, 40)
        _, av, dens = halo.run_sharded(
            reference.initial_state(params), obst, params,
            n_devices=4, ca_steps=4, collect_density=True,
        )
        np.testing.assert_allclose(
            np.asarray(dens), np.asarray(dens_ref), rtol=1e-4
        )
        assert dens.shape == (40,)

    def test_model_run_sharded_debug(self, deck):
        """Simulation.run(devices=N, debug=True) — the user-facing
        composition — returns the density stream and matches the
        single-device debug run."""
        from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation

        params, mask = deck
        single = Simulation(params, mask, backend="fused").run(
            n_iters=24, debug=True
        )
        sharded = Simulation(params, mask, backend="fused").run(
            n_iters=24, devices=4, debug=True
        )
        assert sharded.densities is not None
        np.testing.assert_allclose(
            sharded.densities, single.densities, rtol=1e-4
        )
        # and both sit at the analytic mass (density * n_cells = 204.8)
        np.testing.assert_allclose(
            sharded.densities, params.density * params.nx * params.ny,
            rtol=1e-4,
        )
        np.testing.assert_allclose(
            sharded.av_vels, single.av_vels, rtol=1e-5
        )
