"""Multi-host bootstrap: `jax.distributed` process-group initialization.

The reference's Slurm scripts reserve multi-rank nodes
(job_submit_d2q9-bgk:5 `--ntasks-per-node 14`, job_submit_array:5 `28`) —
its MPI growth path.  Here that is one JAX PROCESS per host, with
``jax.distributed.initialize`` forming the process group; after that,
``jax.devices()`` returns the GLOBAL device list, so the existing mesh
builders (parallel/mesh.py) and shard_map runners (parallel/halo.py) work
unchanged — XLA routes the ring ppermutes over NVLink within a host and
the network across hosts.

Detection ladder (first hit wins), mirroring how JAX's own launch
integrations resolve the coordinator:

1. ``JAX_COORDINATOR_ADDRESS`` (+ ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
   or their Slurm fallbacks) — the explicit form, works on any cluster.
2. Slurm multi-task envs (``SLURM_NTASKS`` > 1): coordinator = first host
   of ``SLURM_STEP_NODELIST`` (via scontrol when available, else the
   literal first entry), process id = ``SLURM_PROCID``.

Single-process runs (the common case, and every test in this repo) never
touch ``jax.distributed``: :func:`maybe_initialize` is a no-op unless the
environment says multi-process, so nothing changes for one host.

Output discipline: exactly one process writes files / prints the results
block — :func:`is_primary` (process_index 0), used by the CLI.
"""

from __future__ import annotations

import os
import re
import subprocess

_initialized = False


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a Slurm nodelist.  Prefers `scontrol show
    hostnames` (handles every bracket syntax); falls back to expanding
    the leading entry of simple ``prefix[a-b,c]`` lists textually."""
    try:
        out = subprocess.run(
            ["scontrol", "show", "hostnames", nodelist],
            capture_output=True, text=True, timeout=10,
        )
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.split()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    m = re.match(r"([^\[,]+)\[([^\]]+)\]", nodelist)
    if m:
        prefix, ranges = m.groups()
        first = ranges.split(",")[0].split("-")[0]
        return prefix + first
    return nodelist.split(",")[0]


def detect(env=None) -> dict | None:
    """Inspect the environment for a multi-process launch.  Returns the
    kwargs for ``jax.distributed.initialize``, or None for a
    single-process run."""
    env = os.environ if env is None else env

    coord = env.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        n = env.get("JAX_NUM_PROCESSES") or env.get("SLURM_NTASKS")
        pid = env.get("JAX_PROCESS_ID") or env.get("SLURM_PROCID")
        kw: dict = {"coordinator_address": coord}
        if n is not None:
            kw["num_processes"] = int(n)
        if pid is not None:
            kw["process_id"] = int(pid)
        return kw

    ntasks = env.get("SLURM_NTASKS")
    if ntasks and int(ntasks) > 1:
        nodelist = env.get("SLURM_STEP_NODELIST") or env.get(
            "SLURM_JOB_NODELIST", ""
        )
        port = env.get("JAX_COORDINATOR_PORT", "12321")
        return {
            "coordinator_address": f"{_first_slurm_host(nodelist)}:{port}",
            "num_processes": int(ntasks),
            "process_id": int(env.get("SLURM_PROCID", "0")),
        }

    return None


def maybe_initialize(env=None, *, force: bool = False) -> bool:
    """Call ``jax.distributed.initialize`` iff the environment is a
    multi-process launch (or ``force``).  Idempotent; returns True when
    the process group is (now) initialized.  MUST run before the first
    jax device query of the process — the CLI calls it first thing."""
    global _initialized
    if _initialized:
        return True
    kw = detect(env)
    if kw is None and not force:
        return False
    import jax

    jax.distributed.initialize(**(kw or {}))
    _initialized = True
    return True


def is_primary() -> bool:
    """True on the one process that writes outputs / prints results
    (matches the reference's rank-0 collate+write intent,
    d2q9-bgk.c:208-222).  Safe single-process: process_index is 0."""
    import jax

    return jax.process_index() == 0


def process_count() -> int:
    import jax

    return jax.process_count()
