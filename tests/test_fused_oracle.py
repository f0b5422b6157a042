"""The fused production step against the reference pipeline
(ops/reference.timestep_pipeline) over the shapes, step counts and
geometries the retired hand-written kernels were tested on: lane-aligned,
non-aligned and odd shapes, step counts around the old 2- and 8-step
tails, obstacles on the forcing row, and random decks.

Both sides are plain jnp compiled by XLA on the CPU here; they differ only
in how the step is grouped, so agreement is to fp32 rounding (rtol 1e-5)
over the few steps run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advanced_hpc_lbm_tpu.ops import fused, reference
from advanced_hpc_lbm_tpu.params import LBMParams

SHAPES = [(8, 8), (16, 24), (17, 31), (24, 128), (33, 65), (8, 136), (48, 20)]
GEOMETRIES = ["open", "box", "forcing_row", "random"]


def _params(ny, nx, iters=9, **kw):
    base = dict(reynolds_dim=10, density=0.1, accel=0.005, omega=1.85)
    base.update(kw)
    return LBMParams(nx=nx, ny=ny, max_iters=iters, **base)


def _mask(ny, nx, geometry, seed=0):
    mask = np.zeros((ny, nx), dtype=bool)
    if geometry == "box":
        mask[0] = mask[-1] = True
        mask[:, 0] = mask[:, -1] = True
    elif geometry == "forcing_row":
        # obstacles ON row ny-2, where the forcing acts, and next to it
        mask[ny - 2, :: 3] = True
        mask[ny - 3, 1::4] = True
        mask[0] = True
    elif geometry == "random":
        mask = np.random.RandomState(seed).rand(ny, nx) < 0.2
        mask[ny // 2, nx // 2] = False
    return mask


def _stepped(params, mask, f0, steps):
    obst = jnp.asarray(mask)
    n_fluid = jnp.sum(~obst).astype(jnp.float32)
    step_f = jax.jit(lambda f: fused.fused_step(f, obst, n_fluid, params))
    step_p = jax.jit(lambda f: reference.timestep_pipeline(f, obst, params))
    fa, fb = f0, f0
    avs_a, avs_b = [], []
    for _ in range(steps):
        fa, av_a = step_f(fa)
        fb, av_b = step_p(fb)
        avs_a.append(float(av_a))
        avs_b.append(float(av_b))
    return fa, fb, np.array(avs_a), np.array(avs_b)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("ny,nx", SHAPES)
def test_fused_step_matches_pipeline(ny, nx, geometry):
    params = _params(ny, nx)
    mask = _mask(ny, nx, geometry)
    f0 = reference.initial_state(params)
    fa, fb, ava, avb = _stepped(params, mask, f0, 9)
    np.testing.assert_allclose(np.asarray(fa), np.asarray(fb), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(ava, avb, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("steps", [0, 1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 33])
def test_whole_run_lengths_match_pipeline_scan(steps):
    """The whole-run scan at lengths around the old 2- and 8-step kernel
    tails, against a scan of the pipeline of the same length."""
    params = _params(24, 40, iters=steps)
    mask = _mask(24, 40, "box")
    obst = jnp.asarray(mask)

    fa, ava = fused.run_simulation(
        reference.initial_state(params), obst, params, n_iters=steps
    )
    fb, avb = fused.run_simulation(
        reference.initial_state(params), obst, params, n_iters=steps,
        step_fn=fused.pipeline_step,
    )
    assert ava.shape == avb.shape == (steps,)
    np.testing.assert_allclose(np.asarray(fa), np.asarray(fb), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ava), np.asarray(avb), rtol=1e-5)


@pytest.mark.parametrize("seed", range(12))
def test_random_decks_match_pipeline(seed):
    """Random shapes, physics and perturbed initial states."""
    rng = np.random.RandomState(3000 + seed)
    ny = int(rng.choice([4, 8, 13, 16, 30]))
    nx = int(rng.choice([5, 16, 37, 64, 130]))
    params = _params(
        ny, nx,
        reynolds_dim=int(rng.randint(2, 50)),
        density=float(rng.uniform(0.05, 0.5)),
        accel=float(rng.uniform(0.001, 0.02)),
        omega=float(rng.uniform(0.5, 1.95)),
    )
    mask = rng.rand(ny, nx) < rng.uniform(0.0, 0.3)
    f0 = jnp.asarray(
        np.asarray(reference.initial_state(params))
        * rng.uniform(0.7, 1.3, (9, ny, nx)).astype(np.float32)
    )
    steps = int(rng.randint(1, 6))
    fa, fb, ava, avb = _stepped(params, mask, f0, steps)
    np.testing.assert_allclose(np.asarray(fa), np.asarray(fb), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(ava, avb, rtol=1e-5, atol=1e-12)
