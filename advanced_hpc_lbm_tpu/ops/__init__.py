"""Compute ops for the D2Q9-BGK engine.

``lattice``   — D2Q9 constants (velocities, weights, opposite permutation).
``reference`` — composable single-purpose ops (accelerate / stream /
                bounce-back / collide / reductions), the differential-test
                oracle mirroring the reference's pre-fusion pipeline
                (d2q9-bgk.c:1815-1822).
``fused``     — the production single-pass step (accelerate + pull-stream +
                bounce-back + BGK collide + in-step reduction), the
                equivalent of ``timestep_new2`` (d2q9-bgk.c:228-1813),
                compiled by XLA for whichever device runs it.
"""

from advanced_hpc_lbm_tpu.ops import lattice
from advanced_hpc_lbm_tpu.ops.fused import fused_step, make_step_fn
from advanced_hpc_lbm_tpu.ops.reference import (
    accelerate_flow,
    apply_bounce_back,
    av_velocity,
    bgk_collide,
    equilibrium,
    macroscopic,
    stream_pull,
    timestep_pipeline,
    total_density,
)

__all__ = [
    "lattice",
    "fused_step",
    "make_step_fn",
    "accelerate_flow",
    "stream_pull",
    "apply_bounce_back",
    "bgk_collide",
    "equilibrium",
    "macroscopic",
    "av_velocity",
    "total_density",
    "timestep_pipeline",
]
