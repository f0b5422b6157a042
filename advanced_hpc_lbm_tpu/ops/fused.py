"""The production fused timestep — the equivalent of ``timestep_new2``.

The reference hand-fused accelerate + pull-stream + bounce-back + BGK
collide + the velocity-norm reduction into one 1585-line loop nest
(d2q9-bgk.c:228-1813).  Here the same fusion is expressed once in ~60 lines
of jnp and handed to XLA, which fuses it into device kernels; the whole
``max_iters`` loop runs on-device under ``lax.scan`` with double-buffered
carry (the analogue of the reference's pointer swap, d2q9-bgk.c:136-140,
:190) and streams one av-velocity scalar per step into the scan output
(the ``av_vels`` history, d2q9-bgk.c:182).

It must agree with
:func:`advanced_hpc_lbm_tpu.ops.reference.timestep_pipeline` on every deck.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from advanced_hpc_lbm_tpu.ops import lattice, reference
from advanced_hpc_lbm_tpu.params import LBMParams


def fused_step(
    f: jax.Array,
    obstacles: jax.Array,
    n_fluid: jax.Array,
    params: LBMParams,
) -> tuple[jax.Array, jax.Array]:
    """One fused collide-and-stream step.

    Semantics (verified against d2q9-bgk.c:228-1813):
      1. forcing on row ny-2 of the *pre-stream* state (:239-260);
      2. pull-stream with periodic wrap (:971-998 gather pattern);
      3. obstacle cells take the reflected pull (:971-981), fluid cells
         relax toward the equilibrium of the streamed moments (:1033-1100);
      4. av-velocity is the mean ||u|| of the *post-collision* state over
         fluid cells (:1103-1130).

    Args:
      f: (9, ny, nx) fp32 distributions.
      obstacles: (ny, nx) bool.
      n_fluid: scalar fp32 — count of fluid cells (loop-invariant).
      params: static run parameters (closed over at trace time).

    Returns:
      (f_next, av_vel) — av_vel is a fp32 scalar.
    """
    f = reference.accelerate_flow(f, obstacles, params.accel_w1, params.accel_w2)
    streamed = reference.stream_pull(f)

    rho, u_x, u_y = reference.macroscopic(streamed)
    feq = reference.equilibrium(rho, u_x, u_y)
    relaxed = streamed + params.omega_f32 * (feq - streamed)

    reflected = streamed[jnp.asarray(lattice.OPP)]
    f_next = jnp.where(obstacles[None, :, :], reflected, relaxed)

    # Post-collision reduction (obstacle cells masked out).  Recomputing the
    # moments from f_next mirrors the reference exactly (:1103-1126).
    _, v_x, v_y = reference.macroscopic(f_next)
    norm = jnp.sqrt(v_x * v_x + v_y * v_y)
    tot_u = jnp.sum(jnp.where(obstacles, 0.0, norm))
    return f_next, tot_u / n_fluid


def pipeline_step(
    f: jax.Array,
    obstacles: jax.Array,
    n_fluid: jax.Array,
    params: LBMParams,
) -> tuple[jax.Array, jax.Array]:
    """The 4-op reference pipeline (reference.timestep_pipeline) with the
    fused step's signature, for ``run_simulation(step_fn=...)``."""
    del n_fluid
    return reference.timestep_pipeline(f, obstacles, params)


def make_step_fn(
    params: LBMParams, obstacles: jax.Array
) -> Callable[[jax.Array], tuple[jax.Array, jax.Array]]:
    """Jitted single-step function with the input buffer donated (the
    double-buffer swap of d2q9-bgk.c:190, expressed as XLA aliasing)."""
    n_fluid = jnp.sum(~obstacles).astype(jnp.float32)

    @partial(jax.jit, donate_argnums=0)
    def step(f: jax.Array) -> tuple[jax.Array, jax.Array]:
        return fused_step(f, obstacles, n_fluid, params)

    return step


def run_simulation(
    f0: jax.Array,
    obstacles: jax.Array,
    params: LBMParams,
    *,
    n_iters: int | None = None,
    step_fn=fused_step,
    collect_density: bool = False,
) -> tuple[jax.Array, jax.Array] | tuple[jax.Array, jax.Array, jax.Array]:
    """Run the whole main loop on-device (d2q9-bgk.c:180-201).

    Returns (f_final, av_vels[(n_iters,)]) — plus per-step total densities
    when ``collect_density`` (the #ifdef DEBUG stream, d2q9-bgk.c:196-200).
    Not jitted itself; wrap in jax.jit (see Simulation.run) so the scan
    compiles once per deck shape.
    """
    iters = params.max_iters if n_iters is None else n_iters
    n_fluid = jnp.sum(obstacles == 0).astype(jnp.float32)

    def body(f, _):
        f_next, av = step_fn(f, obstacles, n_fluid, params)
        out = (av, reference.total_density(f_next)) if collect_density else av
        return f_next, out

    f_final, outs = jax.lax.scan(body, f0, None, length=iters)
    if collect_density:
        return f_final, outs[0], outs[1]
    return f_final, outs
