"""Unit tests for the composable ops and the fused step.

The reference had no unit tests (SURVEY.md section 4); these add the op-level
coverage its end-to-end goldens imply: streaming against an explicit index
map, bounce-back reflexivity, equilibrium moment identities, mass
conservation, and fused-vs-pipeline bitwise agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advanced_hpc_lbm_tpu.ops import fused, lattice, reference


def random_state(params, seed=0):
    rng = np.random.RandomState(seed)
    # positive distributions around the rest equilibrium
    base = np.asarray(reference.initial_state(params))
    noise = rng.uniform(0.5, 1.5, size=base.shape).astype(np.float32)
    return jnp.asarray(base * noise)


class TestStreaming:
    def test_matches_explicit_gather(self, small_params):
        f = random_state(small_params)
        out = np.asarray(reference.stream_pull(f))
        fn = np.asarray(f)
        ny, nx = small_params.ny, small_params.nx
        for k in range(lattice.NSPEEDS):
            cx, cy = int(lattice.CX[k]), int(lattice.CY[k])
            for jj in (0, 1, ny // 2, ny - 1):
                for ii in (0, 1, nx // 2, nx - 1):
                    src = fn[k, (jj - cy) % ny, (ii - cx) % nx]
                    assert out[k, jj, ii] == src, (k, jj, ii)

    def test_stream_is_permutation(self, small_params):
        f = random_state(small_params)
        out = reference.stream_pull(f)
        for k in range(lattice.NSPEEDS):
            np.testing.assert_array_equal(
                np.sort(np.asarray(out[k]), axis=None),
                np.sort(np.asarray(f[k]), axis=None),
            )


class TestBounceBack:
    def test_involution(self, small_params, small_obstacles):
        f = random_state(small_params)
        obst = jnp.asarray(small_obstacles)
        once = reference.apply_bounce_back(f, obst)
        twice = reference.apply_bounce_back(once, obst)
        np.testing.assert_array_equal(np.asarray(twice), np.asarray(f))

    def test_fluid_cells_untouched(self, small_params, small_obstacles):
        f = random_state(small_params)
        out = reference.apply_bounce_back(f, jnp.asarray(small_obstacles))
        fluid = ~small_obstacles
        np.testing.assert_array_equal(
            np.asarray(out)[:, fluid], np.asarray(f)[:, fluid]
        )

    def test_opposite_pairs(self):
        # 1<->3, 2<->4, 5<->7, 6<->8 (d2q9-bgk.c:2199-2228)
        assert list(lattice.OPP) == [0, 3, 4, 1, 2, 7, 8, 5, 6]


class TestEquilibrium:
    def test_moment_identities(self):
        rho = jnp.asarray(np.float32([[1.0, 0.7], [1.3, 0.1]]))
        ux = jnp.asarray(np.float32([[0.05, -0.02], [0.0, 0.1]]))
        uy = jnp.asarray(np.float32([[-0.03, 0.04], [0.08, 0.0]]))
        feq = reference.equilibrium(rho, ux, uy)
        np.testing.assert_allclose(jnp.sum(feq, 0), rho, rtol=1e-5)
        cx = lattice.CX[:, None, None]
        cy = lattice.CY[:, None, None]
        np.testing.assert_allclose(
            np.sum(np.asarray(feq) * cx, 0), rho * ux, rtol=1e-4, atol=1e-6
        )
        np.testing.assert_allclose(
            np.sum(np.asarray(feq) * cy, 0), rho * uy, rtol=1e-4, atol=1e-6
        )

    def test_rest_equilibrium_is_initial_state(self, small_params):
        f0 = reference.initial_state(small_params)
        rho = jnp.full(
            (small_params.ny, small_params.nx),
            small_params.density_f32,
        )
        zero = jnp.zeros_like(rho)
        feq = reference.equilibrium(rho, zero, zero)
        np.testing.assert_allclose(np.asarray(feq), np.asarray(f0), rtol=1e-6)


class TestAccelerate:
    def test_only_row_ny_minus_2(self, small_params, small_obstacles):
        f = random_state(small_params)
        out = reference.accelerate_flow(
            f,
            jnp.asarray(small_obstacles),
            small_params.accel_w1,
            small_params.accel_w2,
        )
        diff = np.asarray(out) != np.asarray(f)
        rows_changed = set(np.nonzero(diff)[1])
        assert rows_changed <= {small_params.ny - 2}

    def test_positivity_guard(self, small_params, small_obstacles):
        # a state where speed 3 would go negative must be skipped
        f = np.asarray(random_state(small_params)).copy()
        jj = small_params.ny - 2
        f[3, jj, 5] = small_params.accel_w1 * 0.5  # guard trips
        out = np.asarray(
            reference.accelerate_flow(
                jnp.asarray(f),
                jnp.asarray(small_obstacles),
                small_params.accel_w1,
                small_params.accel_w2,
            )
        )
        np.testing.assert_array_equal(out[:, jj, 5], f[:, jj, 5])

    def test_mass_preserved(self, small_params, small_obstacles):
        f = random_state(small_params)
        out = reference.accelerate_flow(
            f,
            jnp.asarray(small_obstacles),
            small_params.accel_w1,
            small_params.accel_w2,
        )
        np.testing.assert_allclose(
            float(jnp.sum(out)), float(jnp.sum(f)), rtol=1e-6
        )


class TestFusedStep:
    def test_fused_equals_pipeline(self, small_params, small_obstacles):
        """The fused production step must agree with the 4-op legacy
        pipeline — same guarantee the reference kept its pre-fusion kernels
        around for (d2q9-bgk.c:1815-1886)."""
        f = random_state(small_params)
        obst = jnp.asarray(small_obstacles)
        n_fluid = jnp.sum(~obst).astype(jnp.float32)
        f_a, av_a = jax.jit(
            lambda x: fused.fused_step(x, obst, n_fluid, small_params)
        )(f)
        f_b, av_b = jax.jit(
            lambda x: reference.timestep_pipeline(x, obst, small_params)
        )(f)
        np.testing.assert_allclose(
            np.asarray(f_a), np.asarray(f_b), rtol=1e-6, atol=1e-9
        )
        np.testing.assert_allclose(float(av_a), float(av_b), rtol=1e-6)

    def test_mass_conservation_over_time(self, small_params, small_obstacles):
        """total_density is invariant in time up to fp noise
        (d2q9-bgk.c:2900-2916, the reference's DEBUG oracle).  Acceleration
        shifts mass between speeds, never creates it."""
        f = reference.initial_state(small_params)
        obst = jnp.asarray(small_obstacles)
        f_final, _, densities = fused.run_simulation(
            f, obst, small_params, n_iters=50, collect_density=True
        )
        d0 = float(reference.total_density(f))
        # fp32 tree-sum noise grows ~sqrt(steps); 5e-5 bounds 50 steps with
        # margin while still catching any real mass leak (which would drift
        # linearly and blow past this within a few steps)
        np.testing.assert_allclose(np.asarray(densities), d0, rtol=5e-5)

    def test_av_vels_positive_and_growing_initially(
        self, small_params, small_obstacles
    ):
        f = reference.initial_state(small_params)
        _, av = fused.run_simulation(
            f, jnp.asarray(small_obstacles), small_params, n_iters=10
        )
        av = np.asarray(av)
        assert np.all(av > 0)
        assert av[5] > av[0]  # forcing spins the flow up from rest

    def test_no_nans_long_run(self, small_params, small_obstacles):
        f = reference.initial_state(small_params)
        f_final, av = fused.run_simulation(
            f, jnp.asarray(small_obstacles), small_params, n_iters=500
        )
        assert np.all(np.isfinite(np.asarray(f_final)))
        assert np.all(np.isfinite(np.asarray(av)))


class TestDonationSafety:
    def test_donated_buffer_run_matches_fresh(self, small_params, small_obstacles):
        """The production path donates the state buffer into the scan (the
        analogue of the reference's pointer swap, d2q9-bgk.c:190); a
        bad aliasing choice would corrupt the trajectory.  Compare a
        donated run against an undonated one."""
        import jax

        obst = jnp.asarray(small_obstacles)

        def runit(donate):
            f0 = reference.initial_state(small_params)
            fn = lambda f, o: fused.run_simulation(
                f, o, small_params, n_iters=20
            )
            jitted = jax.jit(fn, donate_argnums=(0,) if donate else ())
            f, av = jitted(f0, obst)
            return np.asarray(f), np.asarray(av)

        f_plain, av_plain = runit(False)
        f_donated, av_donated = runit(True)
        np.testing.assert_array_equal(f_donated, f_plain)
        np.testing.assert_array_equal(av_donated, av_plain)


class TestObstacleSemantics:
    def test_obstacle_cells_conserve_their_mass(self, small_params):
        """An isolated obstacle cell's outgoing mass returns after two
        steps of reflection; globally, obstacles never absorb mass."""
        mask = np.zeros((small_params.ny, small_params.nx), dtype=bool)
        mask[7, 11] = True
        f = random_state(small_params)
        obst = jnp.asarray(mask)
        n_fluid = jnp.sum(~obst).astype(jnp.float32)
        total0 = float(jnp.sum(f))
        f1, _ = fused.fused_step(f, obst, n_fluid, small_params)
        # forcing row adds zero net mass, so total is conserved
        np.testing.assert_allclose(float(jnp.sum(f1)), total0, rtol=1e-6)
