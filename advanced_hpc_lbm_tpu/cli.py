"""CLI driver — same contract as the reference binary.

``python -m advanced_hpc_lbm_tpu <paramfile> <obstaclefile>`` mirrors
``./d2q9-bgk <paramfile> <obstaclefile>`` (usage at d2q9-bgk.c:3009-3013):
runs the deck, prints the ``==done==`` / Reynolds / four-timer block
(:216-221), and writes final_state.dat + av_vels.dat in the cwd.

Extensions beyond the reference (all optional flags):
  --backend   auto (default, = fused) | fused | pipeline | sharded
  --debug     per-step av-velocity + total-density prints (the reference's
              #ifdef DEBUG build, d2q9-bgk.c:196-200)
  --profile   capture a jax.profiler trace of the compute phase
  --out-dir   where to write outputs (default: cwd)
  --iters     override maxIters from the deck
  --devices   shard over N devices (1-D y mesh) when backend=sharded
"""

from __future__ import annotations

import argparse
import sys

from advanced_hpc_lbm_tpu.models.d2q9_bgk import BACKENDS, Simulation
from advanced_hpc_lbm_tpu.utils.io import DeckError
from advanced_hpc_lbm_tpu.utils.timers import PhaseTimers


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="advanced_hpc_lbm_tpu",
        description="D2Q9-BGK lattice Boltzmann solver (JAX/XLA)",
    )
    p.add_argument("paramfile")
    p.add_argument("obstaclefile")
    p.add_argument(
        "--backend",
        default="auto",
        choices=BACKENDS,
        help="auto is fused: the XLA-fused single-pass step on one device; "
             "pipeline runs the 4-op reference pipeline; sharded splits the "
             "grid over --devices N or --mesh MYxMX",
    )
    p.add_argument("--debug", action="store_true")
    p.add_argument("--profile", metavar="TRACE_DIR", default=None)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--devices", type=int, default=None)
    p.add_argument(
        "--checkpoint-every", type=int, default=None, metavar="N",
        help="snapshot the distribution array every N steps",
    )
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument(
        "--resume", action="store_true",
        help="resume from the latest snapshot in --checkpoint-dir",
    )
    p.add_argument(
        "--check-finite", action="store_true",
        help="fail loudly if the run produced NaN/Inf (numerical sanitizer)",
    )
    p.add_argument(
        "--mesh", default=None, metavar="MYxMX",
        help="2-D torus decomposition for --backend sharded, e.g. 2x4 "
             "(rows x columns of devices)",
    )
    p.add_argument(
        "--ca-steps", type=int, default=1, metavar="K",
        help="steps per halo exchange on the sharded mesh "
             "(communication-avoiding ghost zones; 1-D ring or 2-D torus)",
    )
    p.add_argument(
        "--multihost", action="store_true",
        help="force jax.distributed.initialize() (multi-host process "
             "group).  Normally auto-detected from the environment "
             "(JAX_COORDINATOR_ADDRESS, Slurm multi-task envs — "
             "parallel/multihost.py); outputs are written by process 0 "
             "only",
    )
    return p


def _parse_mesh(args):
    if not args.mesh:
        return None
    my, mx = (int(v) for v in args.mesh.lower().split("x"))
    return (my, mx)


def _run_sim(sim: Simulation, args):
    mesh = _parse_mesh(args)
    return sim.run(
        n_iters=args.iters,
        debug=args.debug,
        devices=args.devices,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        check_finite=args.check_finite,
        mesh=mesh,
        ca_steps=args.ca_steps,
        # leave results on device: the CLI times the device->host transfer
        # as the Collate phase (the reference's compute/collate split,
        # d2q9-bgk.c:177-213)
        fetch=False,
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from advanced_hpc_lbm_tpu.parallel import multihost
    from advanced_hpc_lbm_tpu.utils import cache

    # must precede the first device query of the process: on a Slurm
    # multi-rank (or explicit-coordinator) launch this forms the jax.distributed process
    # group, after which jax.devices() is the GLOBAL device list and the
    # mesh builders/shard_map runners work unchanged.  Single-process
    # environments: a no-op.
    multihost.maybe_initialize(force=args.multihost)
    primary = multihost.is_primary()

    cache.enable()
    timers = PhaseTimers()

    with timers.phase("init"):
        try:
            sim = Simulation.from_decks(
                args.paramfile, args.obstaclefile, backend=args.backend
            )
        except (OSError, DeckError) as e:
            # clean hard-exit on bad inputs, like die() (d2q9-bgk.c:3001-3007)
            print(f"Error: {e}", file=sys.stderr)
            return 1
        # AOT-compile the exact executable the main loop will dispatch, so
        # the Compute timer measures compute the way the reference's does
        # (d2q9-bgk.c:177-206) instead of swallowing the XLA compile.  The sharded path warms its own (cached)
        # runner the same way; checkpointed runs warm their first
        # segment's executable (the segment loop reuses it by length).
        try:
            sim.warmup(
                n_iters=args.iters, debug=args.debug,
                devices=args.devices, mesh=_parse_mesh(args), ca_steps=args.ca_steps,
                checkpoint_every=args.checkpoint_every,
                checkpoint_dir=args.checkpoint_dir,
                resume=args.resume,
            )
        except ValueError as e:
            # bad decomposition (indivisible mesh, thin slabs, ...) —
            # clean die()-style exit, same as a bad deck
            print(f"Error: {e}", file=sys.stderr)
            return 1

    profiler_cm = None
    if args.profile:
        import jax.profiler

        profiler_cm = jax.profiler.trace(args.profile)
        profiler_cm.__enter__()

    with timers.phase("compute"):
        try:
            result = _run_sim(sim, args)
        except (FloatingPointError, ValueError) as e:
            # ValueError: flag-composition errors on paths that skip the
            # Init warmup (checkpoint/resume) — same clean die() contract
            print(f"Error: {e}", file=sys.stderr)
            return 1

    if profiler_cm is not None:
        profiler_cm.__exit__(None, None, None)

    with timers.phase("collate"):
        # "Collate data from ranks here" (d2q9-bgk.c:208): pull the
        # device-resident results to host.
        # A deferred --check-finite runs on the collated arrays.
        try:
            result.collate()
        except FloatingPointError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    if args.debug and primary:
        if result.densities is None:
            # defensive: every backend (incl. sharded, which psums the
            # per-step density through the scan) streams densities in
            # debug mode; print the av history alone if one ever doesn't
            for tt, av in enumerate(result.av_vels):
                print(f"==timestep: {tt}==")
                print(f"av velocity: {av:.12E}")
        else:
            for tt, (av, dens) in enumerate(
                zip(result.av_vels, result.densities)
            ):
                print(f"==timestep: {tt}==")
                print(f"av velocity: {av:.12E}")
                print(f"tot density: {dens:.12E}")

    # the reference computes Reynolds after the total timer stops
    # (d2q9-bgk.c:213-217), so this stays untimed
    reynolds = result.reynolds

    # one process speaks and writes — the reference's rank-0 collate+write
    # intent (d2q9-bgk.c:208-222) on a multi-host launch; single-process
    # runs are always primary
    if primary:
        print("==done==")
        print(f"Reynolds number:\t\t{reynolds:.12E}")
        for line in timers.report_lines():
            print(line)
        result.write(args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
