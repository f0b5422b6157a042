#!/usr/bin/env python
"""Data-parallel deck batching, runnable on a laptop.

The reference's array job (job_submit_array:11, ``--array=1-5``) runs five
independent copies of a deck as separate Slurm tasks.  Here the batch is a
leading array axis: one vmapped program integrates every deck, and on a
multi-chip mesh the batch axis shards over devices with zero collectives
(each chip owns its decks outright).

    python examples/batch_decks.py
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
from jax.sharding import Mesh

from advanced_hpc_lbm_tpu import LBMParams
from advanced_hpc_lbm_tpu.parallel import batch

params = LBMParams(
    nx=128, ny=64, max_iters=100, reynolds_dim=16,
    density=0.1, accel=0.005, omega=1.9,
)

# 8 decks: same params, different obstacle geometry (a sweep over
# barrier heights — the kind of parameter study the array job exists for;
# note an x-translation sweep would give identical means, since the
# domain is periodic in x)
masks = []
for b in range(8):
    mask = np.zeros((params.ny, params.nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[16 : 24 + 4 * b, 60:64] = True
    masks.append(mask)
obstacles = jnp.asarray(np.stack(masks))

f0 = batch.batch_initial_state(params, 8)

# single-device vmap: one compiled program, all 8 trajectories
fs, avs = batch.batch_run(f0, obstacles, params)
print("vmap batch:     av[final] per deck:", np.asarray(avs[:, -1]).round(6))

# data-parallel over the mesh: one deck per device, zero collectives
mesh = Mesh(np.array(jax.devices()), axis_names=("batch",))
fs_m, avs_m = batch.batch_run(
    batch.batch_initial_state(params, 8), obstacles, params, mesh=mesh
)
assert np.array_equal(np.asarray(avs_m), np.asarray(avs))
print("mesh batch:     identical trajectories, sharded", fs_m.sharding.spec)
