"""Randomized differential fuzzing across backends.

Random grid shapes, physics parameters and obstacle geometries, run through
the legacy pipeline (reference-granularity oracle) and the fused production
step — both must agree.  Seeded and bounded so the suite stays
deterministic and fast.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from advanced_hpc_lbm_tpu.ops import fused, reference
from advanced_hpc_lbm_tpu.params import LBMParams


def random_case(rng):
    ny = int(rng.choice([8, 16, 24, 32, 48]))
    nx = int(rng.choice([128, 256]))
    params = LBMParams(
        nx=nx,
        ny=ny,
        max_iters=int(rng.randint(2, 7)),
        reynolds_dim=int(rng.randint(2, 50)),
        density=float(rng.uniform(0.05, 0.5)),
        accel=float(rng.uniform(0.001, 0.02)),
        omega=float(rng.uniform(0.5, 1.95)),
    )
    mask = rng.rand(ny, nx) < rng.uniform(0.0, 0.25)
    # never fully blocked
    mask[ny // 2, nx // 2] = False
    f0 = np.asarray(reference.initial_state(params)) * rng.uniform(
        0.7, 1.3, (9, ny, nx)
    ).astype(np.float32)
    return params, jnp.asarray(mask), jnp.asarray(f0)


@pytest.mark.parametrize("seed", range(8))
def test_backends_agree_on_random_decks(seed):
    rng = np.random.RandomState(1000 + seed)
    params, obst, f0 = random_case(rng)
    n_fluid = jnp.sum(~obst).astype(jnp.float32)

    f_pipe, f_fused = f0, f0
    for _ in range(params.max_iters):
        f_pipe, _ = reference.timestep_pipeline(f_pipe, obst, params)
        f_fused, _ = fused.fused_step(f_fused, obst, n_fluid, params)
    np.testing.assert_allclose(
        np.asarray(f_fused), np.asarray(f_pipe), rtol=1e-5, atol=1e-7,
        err_msg=f"fused vs pipeline diverged (seed {seed}, {params})",
    )

    # the whole-run scan over the same horizon (the production entry)
    f_run, _ = fused.run_simulation(f0, obst, params, n_iters=params.max_iters)
    np.testing.assert_allclose(
        np.asarray(f_run), np.asarray(f_fused), rtol=1e-5, atol=1e-7,
        err_msg=f"run_simulation vs stepped fused diverged (seed {seed})",
    )
