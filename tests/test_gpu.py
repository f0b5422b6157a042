"""Tests that need the card.  They skip on the CPU; on the GPU run them
with ``LBM_TESTS_ON_GPU=1 python -m pytest -m gpu tests/``."""

import jax.numpy as jnp
import numpy as np
import pytest

from advanced_hpc_lbm_tpu.models import d2q9_bgk
from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation
from advanced_hpc_lbm_tpu.ops import fused, reference
from advanced_hpc_lbm_tpu.params import LBMParams

pytestmark = pytest.mark.gpu


def _deck(n, iters):
    params = LBMParams(n, n, iters, 10, 0.1, 0.01, 1.85)
    mask = np.zeros((n, n), dtype=bool)
    mask[0] = mask[-1] = True
    mask[:, 0] = mask[:, -1] = True
    mask[:, n // 3] = True
    return params, mask


def test_memory_limit_comes_from_the_card(gpu):
    limit = d2q9_bgk._device_hbm_bytes()
    assert limit == gpu.memory_stats()["bytes_limit"] > 2**30


def test_fit_gate_refuses_a_grid_beyond_one_card(gpu):
    params, mask = _deck(32768, 2)
    with pytest.raises(ValueError, match="--devices N"):
        Simulation(params, mask).warmup()


def test_fused_matches_pipeline_on_the_card(gpu):
    params, mask = _deck(256, 200)
    obst = jnp.asarray(mask)

    fa, ava = fused.run_simulation(reference.initial_state(params), obst, params)
    fb, avb = fused.run_simulation(
        reference.initial_state(params), obst, params, step_fn=fused.pipeline_step
    )
    np.testing.assert_allclose(np.asarray(fa), np.asarray(fb), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ava), np.asarray(avb), rtol=1e-4)
