"""Test configuration.

Forces JAX onto the host CPU with 8 virtual devices BEFORE jax is imported
anywhere, so (a) the suite is hermetic (no accelerator needed), and (b) the
sharded path is exercised on a real 8-way mesh — the honest "multi-node
without a cluster" mechanism for JAX (SURVEY.md section 4).

Tests marked ``gpu`` need the card.  They take the ``gpu`` fixture, which
skips them unless JAX's first device is a GPU; run them on the card with
``LBM_TESTS_ON_GPU=1 python -m pytest -m gpu tests/``, which leaves the
platform to JAX instead of forcing the CPU.
"""

import os

ON_GPU = bool(os.environ.get("LBM_TESTS_ON_GPU"))

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not ON_GPU:
    # the config API, not JAX_PLATFORMS: it also overrides a platform the
    # environment pinned before this file ran
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from advanced_hpc_lbm_tpu.params import LBMParams  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS_DIR = os.path.join(REPO, "decks")
GOLDENS_DIR = os.path.join(REPO, "goldens")


@pytest.fixture()
def gpu():
    """The first JAX device, when it is a GPU; otherwise skip the test."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX's device is {dev.platform!r})")
    return dev


@pytest.fixture(scope="session")
def small_params() -> LBMParams:
    return LBMParams(
        nx=32, ny=16, max_iters=50, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )


@pytest.fixture(scope="session")
def small_obstacles(small_params) -> np.ndarray:
    """A box with a lid opening plus an interior block — hits every
    boundary-interaction case (walls, corners, interior obstacle)."""
    rng = np.random.RandomState(0)
    mask = np.zeros((small_params.ny, small_params.nx), dtype=bool)
    mask[0, :] = True
    mask[-1, :] = True
    mask[:, 0] = True
    mask[5:8, 10:14] = True
    # a few random single-cell obstacles away from the forcing row
    for _ in range(5):
        mask[rng.randint(1, small_params.ny - 3), rng.randint(1, small_params.nx - 1)] = True
    return mask
