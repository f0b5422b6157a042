"""Device-mesh construction helpers."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_y_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the y (row) axis of the grid.

    The LBM stencil is 1-hop, so a 1-D ring decomposition along y gives each
    device two neighbors for the halo exchange — the device-mesh form of
    the MPI row decomposition the reference left as a stub
    (d2q9-bgk.c:208).
    """
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"requested {n} devices, only {len(devs)} available")
    return Mesh(np.array(devs[:n]), axis_names=("y",))


def make_yx_mesh(my: int, mx: int) -> Mesh:
    """2-D mesh: rows sharded over ``my`` devices, columns over ``mx``.

    Used when a 1-D split would leave slabs too thin or too wide — the
    2-D torus decomposition SURVEY.md section 5 anticipates.  Corner data
    for the diagonal speeds rides the two-phase
    halo exchange (rows first, then columns of the row-extended array), so
    no diagonal sends are needed.
    """
    devs = jax.devices()
    if my * mx > len(devs):
        raise ValueError(
            f"requested {my}x{mx} devices, only {len(devs)} available"
        )
    grid = np.array(devs[: my * mx]).reshape(my, mx)
    return Mesh(grid, axis_names=("y", "x"))
