"""The D2Q9-BGK simulation model: state + end-to-end run.

This is the "model family" of the framework — the layer a user touches.  It
owns deck loading, backend selection (fused / pipeline / sharded), the
on-device main loop, diagnostics (Reynolds number, d2q9-bgk.c:2893-2898),
and output writing.  The reference equivalent is ``main``
(d2q9-bgk.c:146-226) minus the argv/timing scaffolding, which lives in
:mod:`advanced_hpc_lbm_tpu.cli`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

from advanced_hpc_lbm_tpu.ops import fused, reference
from advanced_hpc_lbm_tpu.params import LBMParams
from advanced_hpc_lbm_tpu.utils import io as lbm_io

Backend = Literal["auto", "fused", "pipeline", "sharded"]
BACKENDS: tuple[str, ...] = ("auto", "fused", "pipeline", "sharded")


def _to_host(x) -> np.ndarray:
    """Host materialization that also works on a multi-host launch: a
    global array some of whose shards live on other hosts' devices cannot
    be device_get directly — every process allgathers it instead
    (parallel/multihost.py; single-process arrays take the direct path)."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(jax.device_get(x))


@dataclasses.dataclass
class SimulationResult:
    """Host-side results of one run."""

    params: LBMParams
    f_final: np.ndarray  # (9, ny, nx) fp32
    av_vels: np.ndarray  # (max_iters,) fp32
    densities: np.ndarray | None = None  # per-step total density (debug mode)

    @property
    def reynolds(self) -> float:
        """av_velocity(final state) * reynolds_dim / viscosity
        (calc_reynolds, d2q9-bgk.c:2893-2898).  Computed host-side from the
        final state, like the reference does at exit (d2q9-bgk.c:217)."""
        f = self.f_final.astype(np.float32)
        rho = f.sum(axis=0)
        u_x = (f[1] + f[5] + f[8] - (f[3] + f[6] + f[7])) / rho
        u_y = (f[2] + f[5] + f[6] - (f[4] + f[7] + f[8])) / rho
        fluid = ~self._obstacles_cache
        norm = np.sqrt(u_x * u_x + u_y * u_y, dtype=np.float32)
        av = np.float32(norm[fluid].sum(dtype=np.float32)) / np.float32(
            fluid.sum()
        )
        return float(av * np.float32(self.params.reynolds_dim) / np.float32(
            self.params.viscosity
        ))

    # filled in by Simulation.run; kept out of the dataclass signature
    _obstacles_cache: np.ndarray = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # set by run(fetch=False, check_finite=True): the finiteness gate is
    # deferred to collate() because the arrays are still on device
    _check_finite_pending: bool = dataclasses.field(
        default=False, repr=False, compare=False
    )

    def write(
        self,
        out_dir: str | os.PathLike = ".",
        *,
        final_state_name: str = lbm_io.FINAL_STATE_FILE,
        av_vels_name: str = lbm_io.AV_VELS_FILE,
    ) -> tuple[str, str]:
        """Write final_state.dat + av_vels.dat (write_values,
        d2q9-bgk.c:2918-2999)."""
        fs = os.path.join(out_dir, final_state_name)
        av = os.path.join(out_dir, av_vels_name)
        lbm_io.write_final_state(fs, self.f_final, self._obstacles_cache, self.params)
        lbm_io.write_av_vels(av, self.av_vels)
        return fs, av

    def collate(self) -> "SimulationResult":
        """Materialize device results to host — the reference's Collate
        phase (d2q9-bgk.c:203-213; the MPI stub at :208).  The
        device->host transfer IS the collation, and it is NOT part of
        compute: ``Simulation.run(fetch=False)`` leaves results on device
        so the CLI can time this separately, like the reference's timer
        split.  Idempotent; applies a deferred ``check_finite``."""
        self.f_final = _to_host(self.f_final)
        self.av_vels = _to_host(self.av_vels)
        if self.densities is not None:
            self.densities = _to_host(self.densities)
        if self._check_finite_pending:
            self._check_finite_pending = False
            Simulation._assert_finite(self)
        return self


def _device_hbm_bytes(device=None) -> int | None:
    """Bytes the device's allocator may hand out
    (``memory_stats()["bytes_limit"]``), or None on the CPU, whose host
    memory has no fixed limit to gate on.  An accelerator that reports no
    limit is an error: the fit gates never guess a size."""
    d = jax.devices()[0] if device is None else device
    if d.platform == "cpu":
        return None
    stats = d.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"device {d.device_kind!r} reports no memory limit "
            "(memory_stats()['bytes_limit']); cannot gate the grid size"
        )
    return int(limit)


def executable_peak_bytes(compiled) -> int:
    """Device bytes a compiled executable holds at once (per device, for a
    sharded one): its arguments, outputs and temporaries, less the outputs
    that reuse donated inputs.  The fused whole run measures ~105 B/cell
    on the H100 — 26 fp32 planes and the mask (PERF.md)."""
    m = compiled.memory_analysis()
    return (
        m.argument_size_in_bytes + m.output_size_in_bytes
        + m.temp_size_in_bytes - m.alias_size_in_bytes
    )


class Simulation:
    """One configured D2Q9-BGK run: params + obstacle mask + backend."""

    def __init__(
        self,
        params: LBMParams,
        obstacles: np.ndarray,
        *,
        backend: Backend = "auto",
        precision: Literal["fp32"] = "fp32",
    ) -> None:
        if obstacles.shape != (params.ny, params.nx):
            raise ValueError(
                f"obstacle mask {obstacles.shape} != grid ({params.ny}, {params.nx})"
            )
        self.params = params
        self.obstacles = np.asarray(obstacles, dtype=bool)
        self.backend = backend
        self._step_fn = self._resolve_backend(backend)
        # (iters, debug) -> AOT-compiled whole-run executable (see warmup)
        self._compiled: dict[tuple[int, bool], object] = {}

    @classmethod
    def from_decks(
        cls,
        paramfile: str | os.PathLike,
        obstaclefile: str | os.PathLike,
        **kwargs,
    ) -> "Simulation":
        params = lbm_io.load_params(paramfile)
        obstacles = lbm_io.load_obstacles(obstaclefile, params)
        return cls(params, obstacles, **kwargs)

    def _resolve_backend(self, backend: Backend):
        """The single-device step function.  ``auto`` is ``fused`` on every
        platform: XLA fuses the jnp step for whichever device runs it."""
        if backend == "auto":
            self.backend = backend = "fused"
        if backend in ("fused", "sharded"):
            # sharded execution wraps the whole scan (parallel/halo.py)
            return fused.fused_step
        if backend == "pipeline":
            return fused.pipeline_step
        raise ValueError(
            f"unknown backend: {backend!r} (choose from {', '.join(BACKENDS)})"
        )

    def initial_state(self) -> jax.Array:
        return reference.initial_state(self.params)

    def _make_device_runner(self, iters: int, debug: bool):
        """The jitted whole-run callable (f0, obstacles) -> outputs.
        Output arity: 3 with debug (f, av, densities), else 2 (f, av)."""
        return jax.jit(
            lambda f, o: fused.run_simulation(
                f,
                o,
                self.params,
                n_iters=iters,
                step_fn=self._step_fn,
                collect_density=debug,
            ),
            donate_argnums=0,
        )

    def _device_runner(self, iters: int, debug: bool):
        """The AOT-compiled whole-run executable for (iters, debug), built
        once and cached so warmup() and run() dispatch the same one."""
        key = (iters, debug)
        compiled = self._compiled.get(key)
        if compiled is None:
            f_s = jax.ShapeDtypeStruct(
                (9, self.params.ny, self.params.nx), jnp.float32
            )
            o_s = jax.ShapeDtypeStruct(
                (self.params.ny, self.params.nx), jnp.bool_
            )
            runner = self._make_device_runner(iters, debug)
            compiled = runner.lower(f_s, o_s).compile()
            self._check_fits(compiled)
            self._compiled[key] = compiled
        return compiled

    def _check_fits(self, compiled) -> None:
        """Fail loudly with an actionable message when a compiled run needs
        more memory per device than the device's limit, instead of a raw
        out-of-memory error mid-run.  The need is the executable's own
        memory analysis; compiling allocates nothing on the device."""
        limit = _device_hbm_bytes()
        if limit is None:
            return
        need = executable_peak_bytes(compiled)
        if need > limit:
            raise ValueError(
                f"grid {self.params.ny}x{self.params.nx} needs "
                f"~{need / 2**30:.1f} GiB per device, exceeding the "
                f"device's {limit / 2**30:.1f} GiB; shard it over more "
                "devices with --devices N or --mesh MYxMX "
                "(parallel/halo.py)"
            )

    def _is_sharded(
        self, devices: int | None, mesh: tuple[int, int] | None
    ) -> bool:
        """One definition of 'this run is sharded' for warmup(), run() and
        _run_checkpointed — diverging copies here would make warmup warm a
        different path than run dispatches."""
        return (
            self.backend == "sharded"
            or (devices is not None and devices > 1)
            or mesh is not None
        )

    def _validate_flags(
        self, sharded: bool, *, debug: bool, ca_steps: int
    ) -> None:
        """Flag-composition errors, raised from BOTH warmup() and run() so
        a bad combination dies before warmup compiles anything."""
        if ca_steps > 1 and not sharded:
            raise ValueError(
                "ca_steps > 1 is a property of the halo exchange and needs "
                "the sharded backend (--devices N or --mesh MYxMX)"
            )

    def _sharded_runner(
        self,
        iters: int,
        devices: int | None,
        mesh: tuple[int, int] | None,
        ca_steps: int,
        debug: bool = False,
    ):
        """The cached (compiled runner, shardings) pair for a sharded
        configuration, AOT-compiled once so warmup() and run() dispatch the
        same executable.  ``debug`` streams per-step total densities
        through the sharded scan (one extra psum'd scalar — the reference's
        #ifdef DEBUG output mode, d2q9-bgk.c:196-200, on the distributed
        path)."""
        from advanced_hpc_lbm_tpu.parallel import halo

        key = ("sharded", iters, devices, mesh, ca_steps, debug)
        cached = self._compiled.get(key)
        if cached is not None:
            return cached

        if mesh is not None:
            runner, sh = halo.prepare_sharded_2d(
                self.params, iters, mesh, ca_steps=ca_steps,
                collect_density=debug,
            )
        else:
            runner, sh = halo.prepare_sharded(
                self.params, iters, n_devices=devices, ca_steps=ca_steps,
                collect_density=debug,
            )
        compiled = halo.compile_sharded(runner, sh, self.params)
        self._check_fits(compiled)
        pair = (compiled, sh)
        self._compiled[key] = pair
        return pair

    def warmup(
        self,
        *,
        n_iters: int | None = None,
        debug: bool = False,
        devices: int | None = None,
        mesh: tuple[int, int] | None = None,
        ca_steps: int = 1,
        checkpoint_every: int | None = None,
        checkpoint_dir: str | os.PathLike = "checkpoints",
        resume: bool = False,
    ) -> None:
        """AOT-compile the exact executable ``run`` will dispatch.

        The reference's Compute timer measures pure compute
        (d2q9-bgk.c:177-206); calling this during the Init phase keeps that
        contract here too — the XLA compile lands in Init, and ``run`` then
        invokes the stored compiled executable.  Pass the same
        ``devices``/``mesh``/``ca_steps`` the run will use to warm the
        sharded path.  With ``checkpoint_every``/``resume``, warms the
        FIRST segment's executable (keyed by segment length, which the
        segment loop looks up) — a different-length tail segment still
        compiles mid-run."""
        iters = self.params.max_iters if n_iters is None else n_iters
        sharded = self._is_sharded(devices, mesh)
        self._validate_flags(sharded, debug=debug, ca_steps=ca_steps)
        if checkpoint_every or resume:
            start = 0
            if resume:
                from advanced_hpc_lbm_tpu.utils.checkpoint import (
                    CheckpointManager,
                )

                # latest_step (not steps()[-1]): _run_checkpointed skips
                # unreadable newest snapshots, and warming a segment the
                # run won't execute would land the real compile in Compute
                start = CheckpointManager(checkpoint_dir).latest_step()
            if start >= iters:
                return  # resume is already at/past the target: no compute
            iters = min(checkpoint_every or iters, iters - start)
        if sharded:
            self._sharded_runner(iters, devices, mesh, ca_steps, debug)
            return
        self._device_runner(iters, debug)

    def run(
        self,
        *,
        n_iters: int | None = None,
        debug: bool = False,
        devices: int | None = None,
        checkpoint_every: int | None = None,
        checkpoint_dir: str | os.PathLike = "checkpoints",
        resume: bool = False,
        check_finite: bool = False,
        mesh: tuple[int, int] | None = None,
        ca_steps: int = 1,
        fetch: bool = True,
    ) -> SimulationResult:
        """Execute the main loop fully on-device and fetch results.

        ``debug`` also collects per-step total densities (the reference's
        #ifdef DEBUG stream, d2q9-bgk.c:196-200).  ``devices`` > 1 selects
        the sharded path over a 1-D y mesh (parallel/halo.py); ``mesh`` =
        (my, mx) selects the 2-D torus; ``ca_steps`` = K exchanges halos
        every K steps (communication-avoiding ghost zones).  The sharded
        initial state is built in place, one block per device.
        ``checkpoint_every`` snapshots the distribution array every N steps
        (utils/checkpoint.py); ``resume`` restarts from the latest snapshot.
        ``fetch=False`` waits for the computation but leaves the result
        arrays on device — call ``result.collate()`` to bring them to host
        (the CLI times that as the Collate phase, mirroring the reference's
        compute/collate timer split; a deferred ``check_finite`` then runs
        at collate time).  Exception: checkpointed runs fetch per segment
        regardless (snapshots are host-side), so there ``collate()`` is a
        no-op and ``check_finite`` applies during the run.
        """
        iters = self.params.max_iters if n_iters is None else n_iters
        sharded = self._is_sharded(devices, mesh)
        self._validate_flags(sharded, debug=debug, ca_steps=ca_steps)
        if checkpoint_every or resume:
            result = self._run_checkpointed(
                iters, checkpoint_every or iters, checkpoint_dir, resume,
                debug=debug, devices=devices, mesh=mesh, ca_steps=ca_steps,
            )
            if check_finite:
                self._assert_finite(result)
            return result

        if sharded:
            from advanced_hpc_lbm_tpu.parallel import halo

            runner, sh = self._sharded_runner(
                iters, devices, mesh, ca_steps, debug
            )
            out = halo.execute_sharded(
                runner, sh, None, self.obstacles, self.params
            )
        else:
            runner = self._device_runner(iters, debug)
            out = runner(self.initial_state(), jnp.asarray(self.obstacles))
        if debug:
            f_final, av_vels, densities = out
        else:
            f_final, av_vels = out
            densities = None

        if fetch:
            f_final = _to_host(f_final)
            av_vels = _to_host(av_vels)
            densities = None if densities is None else _to_host(densities)
        else:
            # computation must FINISH inside the caller's compute window
            # (dispatch is async); only the bulk transfer is deferred to
            # collate()
            jax.block_until_ready(out)
        result = SimulationResult(
            params=self.params,
            f_final=f_final,
            av_vels=av_vels,
            densities=densities,
        )
        result._obstacles_cache = self.obstacles
        if check_finite:
            if fetch:
                self._assert_finite(result)
            else:
                result._check_finite_pending = True
        return result

    @staticmethod
    def _assert_finite(result: SimulationResult) -> None:
        """Numerical-health gate (the sanitizer tier the reference lacks,
        SURVEY.md section 5): a blown-up run fails loudly with the first
        bad step instead of writing NaN output files."""
        if not np.all(np.isfinite(result.f_final)):
            raise FloatingPointError("non-finite values in final state")
        bad = np.flatnonzero(~np.isfinite(result.av_vels))
        if bad.size:
            raise FloatingPointError(
                f"non-finite av_velocity first at step {int(bad[0])}"
            )

    def _run_checkpointed(
        self,
        iters: int,
        every: int,
        checkpoint_dir: str | os.PathLike,
        resume: bool,
        *,
        debug: bool = False,
        devices: int | None = None,
        mesh: tuple[int, int] | None = None,
        ca_steps: int = 1,
    ) -> SimulationResult:
        """Host-level segment loop with snapshots at segment boundaries.

        Segments of ``every`` steps run fully on-device (a fixed segment
        length compiles once); the distribution array + av history are
        snapshotted between segments (utils/checkpoint.py).  Honors the same
        execution configuration as a straight run: ``devices``/``sharded``
        runs each segment through the halo-exchanged mesh path, ``debug``
        collects per-step densities per segment.
        """
        from advanced_hpc_lbm_tpu.utils.checkpoint import CheckpointManager

        mgr = CheckpointManager(checkpoint_dir)
        start = 0
        av_parts: list[np.ndarray] = []
        # None = "the deterministic initial condition", built by the first
        # segment's runner (in place, per device, on the sharded path)
        f: np.ndarray | jax.Array | None = None
        density_parts: list[np.ndarray] = []
        if resume:
            latest = mgr.latest()
            if latest is not None:
                start, f_np, av_prev, dens_prev = latest
                f = f_np
                if start > iters:
                    raise ValueError(
                        f"checkpoint at step {start} is beyond requested {iters}"
                    )
                av_parts.append(np.asarray(av_prev)[:start])
                if debug:
                    # keep result.densities step-aligned with av_vels: a
                    # snapshot written without --debug has no density
                    # history, so those steps report NaN rather than
                    # silently shifting later segments' values earlier
                    density_parts.append(
                        np.asarray(dens_prev)[:start]
                        if dens_prev is not None
                        else np.full((start,), np.nan, np.float32)
                    )

        # segments use the same backend configuration a straight run would
        if self._is_sharded(devices, mesh):
            from advanced_hpc_lbm_tpu.parallel import halo

            def run_segment(seg, f_in):
                runner, sh = self._sharded_runner(
                    seg, devices, mesh, ca_steps, debug
                )
                return halo.execute_sharded(
                    runner, sh, f_in, self.obstacles, self.params
                )
        else:
            obstacles = jnp.asarray(self.obstacles)

            def run_segment(seg, f_in):
                f_in = self.initial_state() if f_in is None else jnp.asarray(f_in)
                return self._device_runner(seg, debug)(f_in, obstacles)

        done = start
        while done < iters:
            seg = min(every, iters - done)
            out = run_segment(seg, f)
            if debug:
                f, av_seg, dens_seg = out
                density_parts.append(_to_host(dens_seg))
            else:
                f, av_seg = out
            av_parts.append(_to_host(av_seg))
            done += seg
            mgr.save(
                done,
                _to_host(f),
                np.concatenate(av_parts),
                densities=(
                    np.concatenate(density_parts) if debug else None
                ),
            )

        if f is None:  # zero-iteration run: nothing executed
            f = self.initial_state()
        result = SimulationResult(
            params=self.params,
            f_final=_to_host(f),
            av_vels=(
                np.concatenate(av_parts)
                if av_parts
                else np.zeros((0,), np.float32)
            ),
            densities=(
                np.concatenate(density_parts) if density_parts else None
            ),
        )
        result._obstacles_cache = self.obstacles
        return result
