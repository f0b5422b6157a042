#!/usr/bin/env python
"""Multi-device domain decomposition, runnable on a laptop.

Runs the same deck three ways on an 8-device mesh (virtual CPU devices
here; GPUs in production — the code is identical):

  1-D ring         — row slabs, one halo row exchanged per step
  1-D ring, CA     — K=4 rows exchanged every 4 steps (comm-avoiding)
  2-D torus        — rows AND columns sharded, two-phase corner-free exchange

    python examples/multichip.py
"""

import os

# 8 virtual devices BEFORE jax initializes (real GPUs: delete these lines)
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from advanced_hpc_lbm_tpu import LBMParams
from advanced_hpc_lbm_tpu.ops import reference
from advanced_hpc_lbm_tpu.parallel import halo

params = LBMParams(
    nx=256, ny=128, max_iters=200, reynolds_dim=16,
    density=0.1, accel=0.005, omega=1.9,
)
mask = np.zeros((params.ny, params.nx), dtype=bool)
mask[0, :] = mask[-1, :] = True
mask[48:80, 48:80] = True
obstacles = jnp.asarray(mask)

runs = {
    "1-D ring (8 devices)": dict(n_devices=8),
    "1-D ring, comm-avoiding K=4": dict(n_devices=8, ca_steps=4),
}
results = {}
for name, kw in runs.items():
    f, av = halo.run_sharded(
        reference.initial_state(params), obstacles, params, **kw
    )
    results[name] = np.asarray(av)
    print(f"{name:32} av[last] = {results[name][-1]:.9E}")

f2, av2 = halo.run_sharded_2d(
    reference.initial_state(params), obstacles, params, (4, 2)
)
results["2-D torus 4x2"] = np.asarray(av2)
print(f"{'2-D torus 4x2':32} av[last] = {np.asarray(av2)[-1]:.9E}")

# every decomposition runs the fused step's arithmetic on its own block;
# only the psum'd partial sums differ from one layout to the next
base = results["1-D ring (8 devices)"]
for name, av in results.items():
    assert np.allclose(av, base, rtol=1e-5), name
print("all decompositions agree ✓")
