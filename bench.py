"""Headline benchmark: GLUPS at 1024x1024 on the attached accelerator.

Prints ONE JSON line:
  {"metric": "GLUPS_1024x1024", "value": N, "unit": "GLUPS",
   "vs_baseline": N, "best": N, "median": N, "repeats": N, "device": ...}

Baseline: the reference's best published 1024x1024 number — fused
timestep_new2, -Ofast, single Broadwell core: 20000 iters in 574.370 s
= 36.5 MLUPS (d2q9-bgk_1.out; BASELINE.md).  vs_baseline = ours / 0.0365.

It measures the device only: on a host with no accelerator it exits
nonzero instead of timing the CPU.

Usage: python bench.py [--iters N] [--size NxN] [--backend fused|pipeline]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BASELINE_GLUPS = 0.0365  # reference optimized serial, 1024^2 (BASELINE.md)


def build_deck(nx: int, ny: int, max_iters: int):
    """The reference 1024x1024 geometry at any size: closed box + a
    full-height interior wall at x = nx // 3 (decks/1024x1024.obstacles.dat)."""
    from advanced_hpc_lbm_tpu.params import LBMParams

    params = LBMParams(
        nx=nx, ny=ny, max_iters=max_iters, reynolds_dim=10,
        density=0.1, accel=0.01, omega=1.85,
    )
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[:, 0] = mask[:, -1] = True
    mask[:, min(nx - 1, nx // 3)] = True
    return params, mask


def _device():
    """The accelerator to time; raises when JAX finds none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise RuntimeError("no accelerator found: bench.py times devices only")
    return dev


def measure(size: str, iters: int, backend: str, repeats: int):
    """Compile + time one (size, iters, backend) config in this process.
    Returns (glups_best, glups_median, times)."""
    import jax.numpy as jnp

    from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation

    nx, ny = (int(v) for v in size.split("x"))
    params, mask = build_deck(nx, ny, iters)
    sim = Simulation(params, mask, backend=backend)
    runner = sim._device_runner(iters, False)
    obstacles = jnp.asarray(mask)

    def run():
        """One full run from a fresh initial state, completed on device
        and with the av history on the host — what a real simulation
        does (the reference keeps av_vels on the host, d2q9-bgk.c:182)."""
        f_final, av = runner(sim.initial_state(), obstacles)
        f_final.block_until_ready()
        return np.asarray(av)

    run()  # first execution outside the timed window
    times = []
    for _ in range(repeats):
        tic = time.perf_counter()
        av_host = run()
        times.append(time.perf_counter() - tic)
    if not (np.all(np.isfinite(av_host)) and av_host.shape[0] == iters):
        raise FloatingPointError("non-finite or short av_vels during bench")
    best = min(times)
    median = sorted(times)[len(times) // 2]
    cells = nx * ny
    return cells * iters / best / 1e9, cells * iters / median / 1e9, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    # full reference deck length (decks/1024x1024.params)
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--size", default="1024x1024")
    ap.add_argument("--backend", default="fused", choices=["fused", "pipeline"])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    from advanced_hpc_lbm_tpu.utils import cache

    cache.enable()
    dev = _device()
    glups, glups_med, times = measure(
        args.size, args.iters, args.backend, args.repeats
    )
    print(
        json.dumps(
            {
                "metric": f"GLUPS_{args.size}",
                "value": round(glups, 4),
                "unit": "GLUPS",
                "vs_baseline": round(glups / BASELINE_GLUPS, 1),
                "best": round(glups, 4),
                "median": round(glups_med, 4),
                "repeats": len(times),
                "device": {"platform": dev.platform, "kind": dev.device_kind},
            }
        )
    )
    print(
        f"# backend={args.backend} iters={args.iters} best={min(times):.3f}s "
        f"median={sorted(times)[len(times) // 2]:.3f}s",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
