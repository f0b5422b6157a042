"""Comm/compute-overlapped ring schedule (VERDICT round-4 item 8).

``overlap=True`` reorders the 1-step jnp local step: halo ppermutes are
issued first and the halo-independent interior rows are computed before
anything consumes the wire, so XLA's latency-hiding scheduler can fly
the collective-permutes behind the interior compute on real links.  Pure
schedule change — the per-row math is elementwise-identical, so outputs
must be BITWISE equal to the default schedule (and hence to the oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from advanced_hpc_lbm_tpu.ops import reference
from advanced_hpc_lbm_tpu.parallel import halo
from advanced_hpc_lbm_tpu.params import LBMParams


def _deck(ny, nx, iters, seed=11):
    params = LBMParams(
        nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    rng = np.random.RandomState(seed)
    mask = rng.rand(ny, nx) < 0.05
    mask[0] = True
    mask[ny - 2] = False
    return params, mask


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_overlap_bitwise_equals_default(n_devices):
    params, mask = _deck(32, 128, iters=7)
    obst = jnp.asarray(mask)
    f_d, av_d = halo.run_sharded(
        reference.initial_state(params), obst, params, n_devices=n_devices,
    )
    f_o, av_o = halo.run_sharded(
        reference.initial_state(params), obst, params, n_devices=n_devices,
        overlap=True,
    )
    np.testing.assert_array_equal(np.asarray(f_o), np.asarray(f_d))
    np.testing.assert_array_equal(np.asarray(av_o), np.asarray(av_d))


def test_overlap_with_debug_densities():
    params, mask = _deck(32, 128, iters=5)
    obst = jnp.asarray(mask)
    out_d = halo.run_sharded(
        reference.initial_state(params), obst, params, n_devices=4,
        collect_density=True,
    )
    out_o = halo.run_sharded(
        reference.initial_state(params), obst, params, n_devices=4,
        collect_density=True, overlap=True,
    )
    # f and av are bitwise; the density scalar's big jnp.sum may get a
    # DIFFERENT reduction tree when its producer is the overlap path's
    # concatenate (XLA fusion choice), so the last ulps can move
    np.testing.assert_array_equal(np.asarray(out_o[0]), np.asarray(out_d[0]))
    np.testing.assert_array_equal(np.asarray(out_o[1]), np.asarray(out_d[1]))
    np.testing.assert_allclose(
        np.asarray(out_o[2]), np.asarray(out_d[2]), rtol=1e-4
    )


def test_overlap_rejects_nonjnp_schedules():
    params, mask = _deck(32, 128, iters=4)
    with pytest.raises(ValueError, match="1-step jnp"):
        halo.prepare_sharded(
            params, 4, n_devices=4, ca_steps=2, overlap=True,
        )


def test_overlap_rejects_two_row_slabs():
    params, mask = _deck(16, 128, iters=4)
    with pytest.raises(ValueError, match="interior"):
        halo.prepare_sharded(params, 4, n_devices=8, overlap=True)
