"""Composable D2Q9-BGK ops — the differential-test oracle.

These mirror, op-for-op, the reference's *pre-fusion* pipeline
(``timestep`` at d2q9-bgk.c:1815-1822: accelerate_flow -> propagate ->
rebound -> collision), each as a pure jittable function over a
``(9, ny, nx)`` fp32 distribution array.  The production path
(:mod:`advanced_hpc_lbm_tpu.ops.fused`) composes the same math in a single
pass; unit tests assert the two agree, which is this engine's form of
the reference keeping all its legacy kernels around as cross-checks.

All functions are pure: they take and return arrays, never mutate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from advanced_hpc_lbm_tpu.ops import lattice
from advanced_hpc_lbm_tpu.params import LBMParams


def initial_state(params: LBMParams) -> jax.Array:
    """Equilibrium-at-rest initial condition (d2q9-bgk.c:2802-2823).

    Every cell gets f0 = 4*rho/9, axis speeds rho/9, diagonals rho/36.
    Returns a ``(9, ny, nx)`` fp32 array.
    """
    d = params.density_f32
    per_speed = np.array(
        [d * np.float32(4.0 / 9.0)]
        + [d / np.float32(9.0)] * 4
        + [d / np.float32(36.0)] * 4,
        dtype=np.float32,
    )
    return jnp.broadcast_to(
        jnp.asarray(per_speed)[:, None, None],
        (lattice.NSPEEDS, params.ny, params.nx),
    )


def accelerate_flow(
    f: jax.Array, obstacles: jax.Array, w1: jnp.float32, w2: jnp.float32
) -> jax.Array:
    """Row forcing on ``jj = ny - 2`` (d2q9-bgk.c:1888-1918).

    Adds w1 to E and w2 to NE/SE, subtracts from W/NW/SW, only on fluid
    cells where all three decremented speeds stay strictly positive
    (the per-cell positivity guard at d2q9-bgk.c:246-249).

    Args:
      f: (9, ny, nx) distributions.
      obstacles: (ny, nx) bool mask, True = blocked.
      w1, w2: forcing increments (params.accel_w1 / accel_w2).
    """
    jj = f.shape[1] - 2
    row = f[:, jj, :]  # (9, nx)
    ok = (
        (~obstacles[jj, :])
        & (row[3] - w1 > 0.0)
        & (row[6] - w2 > 0.0)
        & (row[7] - w2 > 0.0)
    )
    delta = jnp.zeros_like(row)
    delta = delta.at[1].set(w1).at[5].set(w2).at[8].set(w2)
    delta = delta.at[3].set(-w1).at[6].set(-w2).at[7].set(-w2)
    new_row = jnp.where(ok[None, :], row + delta, row)
    return f.at[:, jj, :].set(new_row)


def stream_pull(f: jax.Array) -> jax.Array:
    """Pull-scheme periodic streaming (d2q9-bgk.c:2123-2152).

    out[k, jj, ii] = f[k, jj - CY[k], ii - CX[k]] with wrap-around — each
    cell gathers the value that travelled into it.  Implemented as one
    ``jnp.roll`` per speed plane; periodic wrap (which cost the reference
    ~1500 lines of loop peeling, d2q9-bgk.c:262-1810) is free here.
    """
    planes = [
        jnp.roll(f[k], shift=(int(lattice.CY[k]), int(lattice.CX[k])), axis=(0, 1))
        for k in range(lattice.NSPEEDS)
    ]
    return jnp.stack(planes)


def apply_bounce_back(
    f_streamed: jax.Array, obstacles: jax.Array
) -> jax.Array:
    """On obstacle cells replace each speed with its opposite
    (``rebound``, d2q9-bgk.c:2199-2228).  Fluid cells pass through.

    Equivalent to the fused pull-reflected gather in timestep_new2
    (d2q9-bgk.c:971-981): stream-then-swap == reflected pull.
    """
    reflected = f_streamed[jnp.asarray(lattice.OPP)]
    return jnp.where(obstacles[None, :, :], reflected, f_streamed)


def macroscopic(f: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Density and velocity moments (d2q9-bgk.c:988-1016).

    Returns (rho, u_x, u_y), each (ny, nx).
    """
    rho = jnp.sum(f, axis=0)
    u_x = (f[1] + f[5] + f[8] - (f[3] + f[6] + f[7])) / rho
    u_y = (f[2] + f[5] + f[6] - (f[4] + f[7] + f[8])) / rho
    return rho, u_x, u_y


def equilibrium(rho: jax.Array, u_x: jax.Array, u_y: jax.Array) -> jax.Array:
    """Second-order BGK equilibrium (d2q9-bgk.c:1033-1062).

    feq_k = w_k * rho * (1 + cu/c_s^2 + cu^2/(2 c_s^4) - u^2/(2 c_s^2))
    with cu = c_k . u.  Returns (9, ny, nx).
    """
    c_sq = lattice.C_SQ
    u_sq = u_x * u_x + u_y * u_y
    cx = jnp.asarray(lattice.CX, dtype=rho.dtype)[:, None, None]
    cy = jnp.asarray(lattice.CY, dtype=rho.dtype)[:, None, None]
    w = jnp.asarray(lattice.W)[:, None, None]
    cu = cx * u_x[None] + cy * u_y[None]
    return (
        w
        * rho[None]
        * (
            1.0
            + cu / c_sq
            + (cu * cu) / (2.0 * c_sq * c_sq)
            - u_sq[None] / (2.0 * c_sq)
        )
    )


def bgk_collide(
    f: jax.Array, obstacles: jax.Array, omega: jnp.float32
) -> jax.Array:
    """BGK relaxation toward equilibrium on fluid cells
    (``collision``, d2q9-bgk.c:2554-2663): f += omega * (feq - f).
    Obstacle cells are left untouched.
    """
    rho, u_x, u_y = macroscopic(f)
    feq = equilibrium(rho, u_x, u_y)
    relaxed = f + omega * (feq - f)
    return jnp.where(obstacles[None, :, :], f, relaxed)


def av_velocity(f: jax.Array, obstacles: jax.Array) -> jax.Array:
    """Mean velocity norm over fluid cells (d2q9-bgk.c:2665-2714)."""
    _, u_x, u_y = macroscopic(f)
    norm = jnp.sqrt(u_x * u_x + u_y * u_y)
    fluid = ~obstacles
    tot_u = jnp.sum(jnp.where(fluid, norm, 0.0))
    return tot_u / jnp.sum(fluid).astype(f.dtype)


def total_density(f: jax.Array) -> jax.Array:
    """Mass-conservation invariant (d2q9-bgk.c:2900-2916)."""
    return jnp.sum(f)


def timestep_pipeline(
    f: jax.Array, obstacles: jax.Array, params: LBMParams
) -> tuple[jax.Array, jax.Array]:
    """One timestep as the 4-op legacy pipeline (d2q9-bgk.c:1815-1822):
    accelerate -> stream -> bounce-back -> collide, plus the av-velocity
    reduction of the *post-collision* state (collision_and_vel,
    d2q9-bgk.c:2434-2551).

    Returns (f_next, av_vel).  Used as the oracle for the fused step.
    """
    f = accelerate_flow(f, obstacles, params.accel_w1, params.accel_w2)
    f = stream_pull(f)
    f = apply_bounce_back(f, obstacles)
    f = bgk_collide(f, obstacles, params.omega_f32)
    return f, av_velocity(f, obstacles)
