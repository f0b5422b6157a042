#!/usr/bin/env python
"""Library quickstart: run a deck, inspect results, write outputs.

    python examples/quickstart.py [paramfile obstaclefile]

Defaults to the repo's 64x64 smoke deck (decks/mini_64x64.*).
"""

import os
import sys

import numpy as np

from advanced_hpc_lbm_tpu import Simulation

DECKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "decks")
paramfile = sys.argv[1] if len(sys.argv) > 2 else f"{DECKS}/mini_64x64.params"
obstfile = sys.argv[2] if len(sys.argv) > 2 else f"{DECKS}/mini_64x64.obstacles.dat"

# backend="auto" is the XLA-fused step on whatever device JAX finds
sim = Simulation.from_decks(paramfile, obstfile, backend="auto")
print(f"grid {sim.params.nx}x{sim.params.ny}, {sim.params.max_iters} steps, "
      f"backend={sim.backend}")

result = sim.run(check_finite=True)

print(f"Reynolds number: {result.reynolds:.6E}")
print(f"final mean |u|:  {result.av_vels[-1]:.6E}")
print(f"av_vels history: {result.av_vels.shape}, "
      f"monotone spin-up: {bool(np.all(np.diff(result.av_vels[:50]) > 0))}")

fs, av = result.write(".")
print(f"wrote {fs} and {av}")

# programmatic access to the macroscopic fields
f = result.f_final  # (9, ny, nx) distributions
rho = f.sum(axis=0)
print(f"density range: [{rho.min():.6f}, {rho.max():.6f}]")
