"""advanced_hpc_lbm_tpu — a D2Q9-BGK lattice-Boltzmann engine in JAX.

A from-scratch JAX / XLA re-design of the capabilities of the
``ChuyueL/advanced-hpc-lbm`` reference solver (serial C99,
``d2q9-bgk.c``).  The compute path is a fused collide-and-stream step over
a planes-of-speeds ``(9, ny, nx)`` fp32 array, iterated on-device under
``lax.scan``; large grids shard over a ``jax.sharding.Mesh`` with a
ring halo exchange (``parallel/``); file formats and the CLI contract are
byte-compatible with the reference (``utils/io.py``, ``cli.py``).

Layout:
  models/    — the simulation "model": state container + end-to-end run
  ops/       — lattice constants, composable ops (the oracle), fused step
  parallel/  — device-mesh sharding + halo exchange (shard_map/ppermute)
  utils/     — I/O codecs, validation checker, timers, viz, profiling
"""

from advanced_hpc_lbm_tpu.params import LBMParams
from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation, SimulationResult

__version__ = "0.1.0"

__all__ = ["LBMParams", "Simulation", "SimulationResult", "__version__"]
