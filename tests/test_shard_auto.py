"""The sharded path as a user reaches it: ``Simulation.run(devices=N)``
and ``halo.run_sharded_2d`` run the XLA-fused local step, start from the
equilibrium built in place per shard, and must equal the direct
halo-runner call bitwise (one program, two entry points).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation
from advanced_hpc_lbm_tpu.ops import reference
from advanced_hpc_lbm_tpu.parallel import halo
from advanced_hpc_lbm_tpu.params import LBMParams


def _params(ny, nx, iters=4):
    return LBMParams(
        nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_model_default_auto_matches_explicit_jnp(n_devices):
    """Simulation.run(devices=N) with no further flags must run, and equal
    the halo runner called directly from an explicit f0, bitwise."""
    params = _params(32, 128, iters=5)
    mask = np.zeros((params.ny, params.nx), dtype=bool)
    mask[0] = mask[-1] = True
    r_model = Simulation(params, mask, backend="sharded").run(
        devices=n_devices
    )
    f_direct, av_direct = halo.run_sharded(
        reference.initial_state(params), jnp.asarray(mask), params,
        n_devices=n_devices,
    )
    np.testing.assert_array_equal(r_model.av_vels, np.asarray(av_direct))
    np.testing.assert_array_equal(r_model.f_final, np.asarray(f_direct))


def test_run_sharded_auto_2d():
    """The 2-D prepare path, started from the in-place equilibrium."""
    from advanced_hpc_lbm_tpu.ops import fused

    params = _params(16, 256, iters=3)
    mask = np.zeros((params.ny, params.nx), dtype=bool)
    mask[0] = True
    obst = jnp.asarray(mask)
    f_ref, av_ref = fused.run_simulation(
        reference.initial_state(params), obst, params, n_iters=3
    )
    f_a, av_a = halo.run_sharded_2d(None, obst, params, (2, 2))
    np.testing.assert_allclose(
        np.asarray(f_a), np.asarray(f_ref), rtol=1e-6, atol=1e-9
    )
    np.testing.assert_allclose(np.asarray(av_a), np.asarray(av_ref), rtol=5e-4)


@pytest.mark.parametrize("mesh_shape", [None, (2, 2), (4, 2)])
def test_initial_state_sharded_equals_reference(mesh_shape):
    """The in-place equilibrium is the reference initial state, laid out in
    the runner's sharding with one block per device."""
    params = _params(16, 32)
    if mesh_shape is None:
        _, sh = halo.prepare_sharded(params, 1, n_devices=4)
    else:
        _, sh = halo.prepare_sharded_2d(params, 1, mesh_shape)
    f0 = halo.initial_state_sharded(params, sh["f"])
    assert f0.sharding == sh["f"]
    np.testing.assert_array_equal(
        np.asarray(f0), np.asarray(reference.initial_state(params))
    )
    n = 4 if mesh_shape is None else mesh_shape[0] * mesh_shape[1]
    assert len(f0.addressable_shards) == n
    for shard in f0.addressable_shards:
        assert shard.data.size == f0.size // n
