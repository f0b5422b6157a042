"""Batched independent runs — the data-parallel axis.

The reference replicates whole runs at the cluster level: its array job
(job_submit_array:11, ``--array=1-5``) launches five independent executions
of the same deck as separate Slurm tasks.  SURVEY.md section 2 identifies
that embarrassing parallelism as the workload's data-parallel analogue, and
the JAX expression is a leading batch axis, not a job scheduler:

* one device — ``jax.vmap`` the whole-run ``lax.scan`` over ``(B, 9, ny,
  nx)`` states and ``(B, ny, nx)`` obstacle masks, so one compiled program
  integrates all B decks (XLA fuses the batch axis into the step);
* several devices — shard that batch axis over a device mesh
  (``NamedSharding(mesh, P("batch"))``): each device integrates its own
  decks with ZERO collectives — the ideal-scaling end of the parallelism
  spectrum, vs the halo-exchange domain decomposition in
  :mod:`advanced_hpc_lbm_tpu.parallel.halo` which splits one big grid.

All decks in a batch must share ``params`` (shapes and iteration count are
compile-time static); they differ by obstacle geometry and/or initial
state.  That matches the reference's array job exactly — same binary, same
params file, independent trajectories.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from advanced_hpc_lbm_tpu.ops import fused, reference
from advanced_hpc_lbm_tpu.params import LBMParams

__all__ = ["batch_initial_state", "batch_run", "replicate"]


@functools.lru_cache(maxsize=16)
def _jitted(params: LBMParams, n_iters, step_fn, mesh, axis):
    """One jitted B-deck runner per configuration — compiles are seconds
    to minutes on this hardware, so re-tracing per batch_run call (a fresh
    closure defeats jax.jit's cache) must not happen."""

    def one(f, obst):
        return fused.run_simulation(
            f, obst, params, n_iters=n_iters, step_fn=step_fn
        )

    vrun = jax.vmap(one)
    if mesh is None:
        return jax.jit(vrun)
    return jax.jit(
        vrun,
        out_shardings=(
            NamedSharding(mesh, P(axis, None, None, None)),
            NamedSharding(mesh, P(axis, None)),
        ),
    )


def batch_initial_state(params: LBMParams, batch: int) -> jax.Array:
    """(B, 9, ny, nx) equilibrium-at-rest states (d2q9-bgk.c:2802-2823,
    broadcast over the batch axis — every reference run starts identically)."""
    f0 = reference.initial_state(params)
    return jnp.broadcast_to(f0[None], (batch, *f0.shape))


def replicate(obstacles: jax.Array | np.ndarray, batch: int) -> jax.Array:
    """Stack one obstacle mask B times — the reference array job's
    five-identical-runs shape."""
    obst = jnp.asarray(obstacles)
    return jnp.broadcast_to(obst[None], (batch, *obst.shape))


def batch_run(
    f0: jax.Array,
    obstacles: jax.Array,
    params: LBMParams,
    *,
    n_iters: int | None = None,
    step_fn=fused.fused_step,
    mesh: Mesh | None = None,
    mesh_axis: str | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Integrate B independent decks in one compiled program.

    Args:
      f0: (B, 9, ny, nx) initial distributions (``batch_initial_state``).
      obstacles: (B, ny, nx) bool masks (``replicate`` or distinct decks).
      params: shared static run parameters.
      n_iters: steps (default ``params.max_iters``).
      step_fn: single-step function for the inner scan (the jnp
        ``fused_step`` by default — it vmaps and shards transparently).
      mesh / mesh_axis: optional data parallelism — shard the batch axis
        over ``mesh.axis_names[...] == mesh_axis`` (default: the mesh's
        first axis).  B must divide evenly over that axis's size.

    Returns:
      (f_finals (B, 9, ny, nx), av_vels (B, n_iters)) — per-deck results,
      batch order preserved.
    """
    if f0.ndim != 4 or obstacles.ndim != 3 or f0.shape[0] != obstacles.shape[0]:
        raise ValueError(
            f"expected batched (B,9,ny,nx) f0 and (B,ny,nx) obstacles, got "
            f"{f0.shape} and {obstacles.shape}"
        )
    if mesh is None:
        return _jitted(params, n_iters, step_fn, None, None)(f0, obstacles)

    axis = mesh_axis if mesh_axis is not None else mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    if f0.shape[0] % n_dev:
        raise ValueError(
            f"batch {f0.shape[0]} not divisible by mesh axis "
            f"{axis!r} ({n_dev} devices)"
        )
    f0 = jax.device_put(f0, NamedSharding(mesh, P(axis, None, None, None)))
    obstacles = jax.device_put(obstacles, NamedSharding(mesh, P(axis, None, None)))
    return _jitted(params, n_iters, step_fn, mesh, axis)(f0, obstacles)
