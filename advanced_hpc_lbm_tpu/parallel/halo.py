"""Halo-exchanged domain decomposition of the fused step.

Spatial sharding along y over a 1-D device mesh: each device owns a slab of
rows; per step it exchanges one boundary row in each direction with its ring
neighbors via ``lax.ppermute`` (NVLink between the cards of one host) and
reduces the average-velocity scalar with ``lax.psum``.  Global periodicity
falls out of the ring permutation — the wrap rows that cost the reference
its 1500 lines of peeling (d2q9-bgk.c:262-1810) are just the ring edge
between device n-1 and device 0.

This communicates 6 of the 9 planes' worth of data per edge per step
(N-moving {2,5,6} pulled from the south halo, S-moving {4,7,8} from the
north halo) but ships all 9 in one contiguous row slab — simpler, and the
slab is tiny (9*nx*4 B) next to the slab's own traffic.

The whole ``max_iters`` loop runs inside one ``shard_map`` + ``lax.scan``,
so there is exactly one compiled program and zero host round-trips.

Variants: ``ca_steps=K`` exchanges K halo rows at once and advances K
steps per exchange (communication-avoiding ghost zones — K× fewer ring
latencies); ``overlap=True`` issues the 1-step exchange before the
halo-independent interior compute; ``run_sharded_2d`` shards rows AND
columns over a (my, mx) torus with a two-phase exchange that carries the
diagonal-speed corners for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from advanced_hpc_lbm_tpu.ops import lattice, reference
from advanced_hpc_lbm_tpu.params import LBMParams
from advanced_hpc_lbm_tpu.parallel.mesh import make_y_mesh, make_yx_mesh


def _masked_accelerate(f, obstacles, row_mask, w1, w2):
    """Forcing as a whole-window masked update (row_mask selects global
    row ny-2, which lives on exactly one shard, or on a ghost row of a
    window).  Same math as ops.reference.accelerate_flow, phrased
    mask-globally/apply-locally so every device runs identical code
    (SURVEY.md section 7 step 4)."""
    ok = (
        row_mask[None, :, None]
        & ~obstacles[None]
        & (f[3:4] - w1 > 0.0)
        & (f[6:7] - w2 > 0.0)
        & (f[7:8] - w2 > 0.0)
    )  # (1, local_ny, nx)
    delta = jnp.zeros((lattice.NSPEEDS, 1, 1), f.dtype)
    delta = delta.at[1].set(w1).at[5].set(w2).at[8].set(w2)
    delta = delta.at[3].set(-w1).at[6].set(-w2).at[7].set(-w2)
    return f + jnp.where(ok, delta, 0.0)


def _collide(streamed, obst, params: LBMParams):
    """BGK relax + bounce-back select of a (9, ...) streamed window — the
    fused step's own formulation (reference.macroscopic / equilibrium),
    so every sharded schedule rounds like the single-device run."""
    rho, u_x, u_y = reference.macroscopic(streamed)
    feq = reference.equilibrium(rho, u_x, u_y)
    relaxed = streamed + params.omega_f32 * (feq - streamed)
    reflected = streamed[jnp.asarray(lattice.OPP)]
    return jnp.where(obst[None], reflected, relaxed)


def _stream_collide_rows(f_ext, obstacles_rows, params, m: int):
    """Pull-stream + BGK collide the middle ``m`` output rows of a
    (9, m+2, nx) window (one ghost/context row each side).  Elementwise
    per row, so computing a slab in bands is bitwise-identical to
    computing it whole — the property the overlapped step relies on."""
    planes = []
    for k in range(lattice.NSPEEDS):
        cy, cx = int(lattice.CY[k]), int(lattice.CX[k])
        rows = jax.lax.slice_in_dim(f_ext[k], 1 - cy, 1 - cy + m, axis=0)
        planes.append(jnp.roll(rows, cx, axis=1))
    return _collide(jnp.stack(planes), obstacles_rows, params)


def _av_reduce(f_next, obstacles, n_fluid, axes):
    """Post-collision ||u|| sum over local fluid cells, psum'd over the
    mesh axes — the reference's reduction (d2q9-bgk.c:1103-1130) on every
    sharded schedule.  (The pre-collision moments are equal in exact
    arithmetic, but in fp32 a cell at rest has |u| exactly 0 before the
    collision and ~1e-8 after it; summed over 10^7-10^9 cells that noise
    is comparable to the early-step av signal, so only the post-collision
    form matches the single-device run.)"""
    _, v_x, v_y = reference.macroscopic(f_next)
    norm = jnp.sqrt(v_x * v_x + v_y * v_y)
    tot = jnp.sum(jnp.where(obstacles, 0.0, norm))
    for ax in axes:
        tot = jax.lax.psum(tot, ax)
    return tot / n_fluid


def _local_fused_step(f, obstacles, row_mask, n_fluid, params, axis: str):
    """One fused step on a local row slab, halo rows exchanged via ring
    ppermute over ``axis``."""
    f = _masked_accelerate(f, obstacles, row_mask, params.accel_w1, params.accel_w2)

    # south halo = my south neighbor's top edge is wrong way around:
    # pull at local row 0 for north-moving speeds needs the neighbor
    # *below* (smaller y), i.e. its LAST row, delivered forward round the
    # ring; pull at the last local row for south-moving speeds needs the
    # neighbor above's FIRST row, delivered backward (_extend_rows).
    f_ext = _extend_rows(f, axis, 1, row_axis=1)

    f_next = _stream_collide_rows(f_ext, obstacles, params, f.shape[1])
    av = _av_reduce(f_next, obstacles, n_fluid, (axis,))
    return f_next, av


def _local_fused_step_overlap(
    f, obstacles, row_mask, n_fluid, params, axis: str
):
    """The comm/compute-overlapped form of :func:`_local_fused_step`
    (VERDICT round-4 item 8, the other half of the ring-attention
    pattern SURVEY §5 invokes): the halo ppermutes are issued FIRST and
    the interior rows — whose stencil needs no ghost data — are computed
    before anything consumes them, so XLA's latency-hiding scheduler can
    fly the asynchronous collective-permutes behind the interior compute; only the two 1-row edge bands wait on the wire.  Per-row
    math is elementwise-identical to the unoverlapped step, so the two
    forms are BITWISE equal (tests/test_overlap.py) — pure schedule, no
    numerics.  Needs local_ny >= 3 (a 2-row slab has no interior)."""
    f = _masked_accelerate(f, obstacles, row_mask, params.accel_w1, params.accel_w2)
    n = jax.lax.psum(1, axis)
    fwd = [(j, (j + 1) % n) for j in range(n)]
    bwd = [(j, (j - 1) % n) for j in range(n)]
    ly = f.shape[1]

    # wire first: ghost above my row 0 (neighbor below's last row) and
    # ghost below my last row (neighbor above's first row)
    top = jax.lax.ppermute(f[:, -1:, :], axis, fwd)
    bot = jax.lax.ppermute(f[:, :1, :], axis, bwd)

    # interior output rows [1, ly-1): window = my own rows [0, ly) —
    # independent of both permutes
    interior = _stream_collide_rows(f, obstacles[1 : ly - 1], params, ly - 2)
    # edge bands: 1-row outputs, each consuming one ghost
    row0 = _stream_collide_rows(
        jnp.concatenate([top, f[:, :2, :]], axis=1),
        obstacles[0:1], params, 1,
    )
    row_last = _stream_collide_rows(
        jnp.concatenate([f[:, -2:, :], bot], axis=1),
        obstacles[ly - 1 : ly], params, 1,
    )
    f_next = jnp.concatenate([row0, interior, row_last], axis=1)
    av = _av_reduce(f_next, obstacles, n_fluid, (axis,))
    return f_next, av


def _extend_rows(x, axis_name: str, k: int, row_axis: int = 0):
    """±K ghost-extend ``x`` along its row axis via ring ppermute over
    ``axis_name``: K rows from the neighbor below land on top, K from the
    neighbor above below (ring wrap = global periodicity).  Shared by the
    CA f-window assembly and the loop-invariant mask extension."""
    n = jax.lax.psum(1, axis_name)
    fwd = [(j, (j + 1) % n) for j in range(n)]
    bwd = [(j, (j - 1) % n) for j in range(n)]
    rows = x.shape[row_axis]
    top = jax.lax.ppermute(
        jax.lax.slice_in_dim(x, rows - k, rows, axis=row_axis), axis_name, fwd
    )
    bot = jax.lax.ppermute(
        jax.lax.slice_in_dim(x, 0, k, axis=row_axis), axis_name, bwd
    )
    return jnp.concatenate([top, x, bot], axis=row_axis)


def _local_fused_ca_steps(
    f, obst_ext, row_is_accel_ext, n_fluid, params, axis: str, k: int,
    collect_density: bool = False,
):
    """K steps per halo exchange — communication-avoiding ghost zones.

    One ring exchange ships K boundary rows each way; the shard then
    advances K steps on the ±K-extended window, shrinking it one row per
    side per step (time tiling across devices: seam rows are recomputed
    by both neighbors, 2K/ly extra compute, in exchange for K× fewer
    `ppermute` latencies on the wire).

    ``obst_ext`` / ``row_is_accel_ext`` are the (ly+2K,)-extended mask and
    forcing-row mask, precomputed once per run (masks are loop-invariant,
    so their halos never need re-exchanging).
    """
    ly = f.shape[1]
    w = _extend_rows(f, axis, k, row_axis=1)  # (9, ly+2K, nx)

    avs = []
    densities = []
    for s in range(k):
        depth = k - s
        rows = ly + 2 * depth
        off = k - depth  # current window starts at extended row `off`
        obst_w = jax.lax.slice_in_dim(obst_ext, off, off + rows, axis=0)
        accel_w = jax.lax.slice_in_dim(
            row_is_accel_ext, off, off + rows, axis=0
        )
        w = _masked_accelerate(
            w, obst_w, accel_w, params.accel_w1, params.accel_w2
        )
        streamed = []
        for kk in range(lattice.NSPEEDS):
            cy, cx = int(lattice.CY[kk]), int(lattice.CX[kk])
            plane = jax.lax.slice_in_dim(
                w[kk], 1 - cy, 1 - cy + rows - 2, axis=0
            )
            if cx:
                plane = jnp.roll(plane, cx, axis=1)
            streamed.append(plane)
        obst_in = jax.lax.slice_in_dim(obst_ext, off + 1, off + rows - 1, axis=0)
        w = _collide(jnp.stack(streamed), obst_in, params)
        # reduction over the shard's own rows (offset depth-1 in the
        # post-step window)
        own_f = jax.lax.slice_in_dim(w, depth - 1, depth - 1 + ly, axis=1)
        own_obst = jax.lax.slice_in_dim(obst_ext, k, k + ly, axis=0)
        avs.append(_av_reduce(own_f, own_obst, n_fluid, (axis,)))
        if collect_density:
            # per-step total density over the shard's OWN rows (the
            # #ifdef DEBUG stream, d2q9-bgk.c:196-200): one extra psum'd
            # scalar
            densities.append(jax.lax.psum(jnp.sum(own_f), axis))
    if collect_density:
        return w, jnp.stack(avs), jnp.stack(densities)
    return w, jnp.stack(avs)


def _local_fused_ca_steps_2d(
    f, obst_ext, row_is_accel_ext, n_fluid, params, ay, ax, k: int,
    collect_density: bool = False,
):
    """K steps per exchange on a 2-D (rows x columns) shard.

    The 1-D CA machinery (_local_fused_ca_steps) generalized to a torus:
    the two-phase ±K extension (K rows over the y ring, then K columns OF
    THE ROW-EXTENDED array over the x ring) fills the corner blocks the
    diagonal speeds need, exactly like the 1-row exchange in
    _local_fused_step_2d.  Each of the K steps then shrinks the window by
    one row AND one column per side; streaming is pure static slicing (no
    rolls — x periodicity arrives via the ring wrap).

    ``obst_ext`` is the (ly+2K, lx+2K) two-phase-extended obstacle mask;
    ``row_is_accel_ext`` the (ly+2K,) y-extended forcing-row mask (the
    forcing row is uniform in x, so its x-extension is a broadcast).
    Both are loop-invariant, built once by make_sharded_runner_2d.
    """
    ly, lx = f.shape[1], f.shape[2]
    w = _extend_rows(f, ay, k, row_axis=1)  # (9, ly+2K, lx)
    w = _extend_rows(w, ax, k, row_axis=2)  # (9, ly+2K, lx+2K)

    avs = []
    densities = []
    for s in range(k):
        depth = k - s
        rows = ly + 2 * depth
        cols = lx + 2 * depth
        off = k - depth  # current window starts at extended row/col `off`
        obst_w = jax.lax.slice(
            obst_ext, (off, off), (off + rows, off + cols)
        )
        accel_w = jax.lax.slice_in_dim(
            row_is_accel_ext, off, off + rows, axis=0
        )
        w = _masked_accelerate(
            w, obst_w, accel_w, params.accel_w1, params.accel_w2
        )
        streamed = [
            jax.lax.slice(
                w[kk],
                (1 - int(lattice.CY[kk]), 1 - int(lattice.CX[kk])),
                (1 - int(lattice.CY[kk]) + rows - 2,
                 1 - int(lattice.CX[kk]) + cols - 2),
            )
            for kk in range(lattice.NSPEEDS)
        ]
        obst_in = jax.lax.slice(
            obst_ext, (off + 1, off + 1), (off + rows - 1, off + cols - 1)
        )
        w = _collide(jnp.stack(streamed), obst_in, params)
        # reduction over the shard's own cells (offset depth-1 in the
        # post-step window)
        own_f = jax.lax.slice(
            w, (0, depth - 1, depth - 1), (9, depth - 1 + ly, depth - 1 + lx)
        )
        own_obst = jax.lax.slice(obst_ext, (k, k), (k + ly, k + lx))
        avs.append(_av_reduce(own_f, own_obst, n_fluid, (ay, ax)))
        if collect_density:
            densities.append(
                jax.lax.psum(jax.lax.psum(jnp.sum(own_f), ay), ax)
            )
    if collect_density:
        return w, jnp.stack(avs), jnp.stack(densities)
    return w, jnp.stack(avs)


def _shardings(mesh: Mesh, f_spec, grid_spec, row_spec) -> dict:
    return {
        "f": NamedSharding(mesh, f_spec),
        "grid": NamedSharding(mesh, grid_spec),
        "row": NamedSharding(mesh, row_spec),
        "scalar": NamedSharding(mesh, P()),
    }


def make_sharded_runner(
    mesh: Mesh,
    params: LBMParams,
    n_iters: int,
    axis: str = "y",
    ca_steps: int = 1,
    collect_density: bool = False,
    overlap: bool = False,
):
    """Build the jitted sharded main loop for a given mesh + deck shape.

    ``ca_steps`` > 1 runs K steps per halo exchange via communication-
    avoiding ghost zones — K× fewer ring latencies for 2K/ly extra seam
    compute (_local_fused_ca_steps).
    ``collect_density`` also streams the per-step total density — a
    psum'd scalar per step — through the scan (the reference's #ifdef
    DEBUG output, d2q9-bgk.c:196-200).
    ``overlap`` uses the comm/compute-overlapped local step
    (:func:`_local_fused_step_overlap` — issue the halo ppermutes first,
    compute the halo-independent interior rows while they fly); 1-step
    schedule only (the CA schedule already amortizes the exchange
    K-fold).  Bitwise-equal outputs to the default schedule.
    Returns (runner, shardings) where runner(f0, obstacles,
    row_mask, n_fluid) -> (f_final, av_vels[, densities])."""
    if overlap and ca_steps > 1:
        raise ValueError(
            "overlap=True is the 1-step jnp local schedule; the CA"
            " schedule already amortizes the exchange (use ca_steps)"
        )
    if overlap and params.ny // mesh.devices.size < 3:
        raise ValueError(
            "overlap=True needs local slabs >= 3 rows (a 2-row slab has "
            "no halo-independent interior)"
        )

    f_spec = P(None, axis, None)
    grid_spec = P(axis, None)
    row_spec = P(axis)

    def whole_run(f, obstacles, row_mask, n_fluid):
        def dens_of(f_local):
            return jax.lax.psum(jnp.sum(f_local), axis)

        if ca_steps > 1:
            k = ca_steps
            # masks are loop-invariant: extend them by K halo rows ONCE
            obst_ext = _extend_rows(obstacles, axis, k)
            row_ext = _extend_rows(row_mask, axis, k)

            def body_ca(carry_f, _):
                out = _local_fused_ca_steps(
                    carry_f, obst_ext, row_ext, n_fluid, params, axis, k,
                    collect_density=collect_density,
                )
                if collect_density:
                    return out[0], (out[1], out[2])
                return out

            f, outs = jax.lax.scan(body_ca, f, None, length=n_iters // k)
            if collect_density:
                avs, denss = outs[0].reshape(-1), outs[1].reshape(-1)
            else:
                avs = outs.reshape(-1)
            for _ in range(n_iters % k):
                f, av_last = _local_fused_step(
                    f, obstacles, row_mask, n_fluid, params, axis
                )
                avs = jnp.concatenate([avs, av_last[None]])
                if collect_density:
                    denss = jnp.concatenate([denss, dens_of(f)[None]])
            if collect_density:
                return f, avs, denss
            return f, avs

        step = _local_fused_step_overlap if overlap else _local_fused_step

        def body(carry_f, _):
            f1, av = step(
                carry_f, obstacles, row_mask, n_fluid, params, axis
            )
            if collect_density:
                return f1, (av, dens_of(f1))
            return f1, av

        f, outs = jax.lax.scan(body, f, None, length=n_iters)
        if collect_density:
            return f, outs[0], outs[1]
        return f, outs

    mapped = jax.shard_map(
        whole_run,
        mesh=mesh,
        in_specs=(f_spec, grid_spec, row_spec, P()),
        out_specs=(f_spec, P(), P()) if collect_density else (f_spec, P()),
    )
    runner = jax.jit(mapped, donate_argnums=0)
    return runner, _shardings(mesh, f_spec, grid_spec, row_spec)


def _local_fused_step_2d(f, obstacles, row_mask, n_fluid, params, ay, ax):
    """One fused step on a 2-D (row x column) shard.

    Two-phase halo exchange: rows over the y ring first, then COLUMNS OF
    THE ROW-EXTENDED ARRAY over the x ring — the second phase carries the
    corner cells the diagonal speeds need, so no diagonal sends occur.
    Streaming is then pure static slicing of the (ly+2, lx+2) window (even
    the x-wrap needs no roll: it arrives via the ring)."""
    ny_dev = jax.lax.psum(1, ay)
    nx_dev = jax.lax.psum(1, ax)
    fwd_y = [(j, (j + 1) % ny_dev) for j in range(ny_dev)]
    bwd_y = [(j, (j - 1) % ny_dev) for j in range(ny_dev)]
    fwd_x = [(j, (j + 1) % nx_dev) for j in range(nx_dev)]
    bwd_x = [(j, (j - 1) % nx_dev) for j in range(nx_dev)]

    f = _masked_accelerate(f, obstacles, row_mask, params.accel_w1, params.accel_w2)

    top = jax.lax.ppermute(f[:, -1:, :], ay, fwd_y)
    bot = jax.lax.ppermute(f[:, :1, :], ay, bwd_y)
    f_y = jnp.concatenate([top, f, bot], axis=1)  # (9, ly+2, lx)
    left = jax.lax.ppermute(f_y[:, :, -1:], ax, fwd_x)
    right = jax.lax.ppermute(f_y[:, :, :1], ax, bwd_x)
    f_ext = jnp.concatenate([left, f_y, right], axis=2)  # (9, ly+2, lx+2)

    ly, lx = f.shape[1], f.shape[2]
    streamed = [
        jax.lax.slice(
            f_ext[k],
            (1 - int(lattice.CY[k]), 1 - int(lattice.CX[k])),
            (1 - int(lattice.CY[k]) + ly, 1 - int(lattice.CX[k]) + lx),
        )
        for k in range(lattice.NSPEEDS)
    ]

    f_next = _collide(jnp.stack(streamed), obstacles, params)
    return f_next, _av_reduce(f_next, obstacles, n_fluid, (ay, ax))


def make_sharded_runner_2d(
    mesh: Mesh,
    params: LBMParams,
    n_iters: int,
    *,
    ca_steps: int = 1,
    collect_density: bool = False,
):
    """Build the jitted (my, mx)-torus main loop (rows AND columns sharded).

    ``ca_steps`` > 1 runs K steps per two-phase halo exchange
    (communication-avoiding ghost zones on the torus,
    _local_fused_ca_steps_2d).
    ``collect_density`` streams the per-step total density (double-psum'd
    scalar) like make_sharded_runner.
    Returns (runner, shardings) like make_sharded_runner."""
    f_spec = P(None, "y", "x")
    grid_spec = P("y", "x")
    row_spec = P("y")

    def whole_run(f, obst, rmask, nf):
        def dens_of(f_local):
            return jax.lax.psum(jax.lax.psum(jnp.sum(f_local), "y"), "x")

        if ca_steps > 1:
            k = ca_steps
            # masks are loop-invariant: two-phase-extend them ONCE
            obst_ext = _extend_rows(obst, "y", k, row_axis=0)
            obst_ext = _extend_rows(obst_ext, "x", k, row_axis=1)
            row_ext = _extend_rows(rmask, "y", k, row_axis=0)

            def body_ca(carry_f, _):
                out = _local_fused_ca_steps_2d(
                    carry_f, obst_ext, row_ext, nf, params, "y", "x", k,
                    collect_density=collect_density,
                )
                if collect_density:
                    return out[0], (out[1], out[2])
                return out

            f, outs = jax.lax.scan(body_ca, f, None, length=n_iters // k)
            if collect_density:
                avs, denss = outs[0].reshape(-1), outs[1].reshape(-1)
            else:
                avs = outs.reshape(-1)
            for _ in range(n_iters % k):
                f, av_last = _local_fused_step_2d(
                    f, obst, rmask, nf, params, "y", "x"
                )
                avs = jnp.concatenate([avs, av_last[None]])
                if collect_density:
                    denss = jnp.concatenate([denss, dens_of(f)[None]])
            if collect_density:
                return f, avs, denss
            return f, avs

        def body(carry_f, _):
            f1, av = _local_fused_step_2d(
                carry_f, obst, rmask, nf, params, "y", "x"
            )
            if collect_density:
                return f1, (av, dens_of(f1))
            return f1, av

        f, outs = jax.lax.scan(body, f, None, length=n_iters)
        if collect_density:
            return f, outs[0], outs[1]
        return f, outs

    mapped = jax.shard_map(
        whole_run,
        mesh=mesh,
        in_specs=(f_spec, grid_spec, row_spec, P()),
        out_specs=(f_spec, P(), P()) if collect_density else (f_spec, P()),
    )
    runner = jax.jit(mapped, donate_argnums=0)
    return runner, _shardings(mesh, f_spec, grid_spec, row_spec)


def prepare_sharded_2d(
    params: LBMParams,
    n_iters: int,
    mesh_shape: tuple[int, int],
    *,
    ca_steps: int = 1,
    collect_density: bool = False,
):
    """Validate the (my, mx) torus decomposition and build its runner.
    Returns (runner, shardings).  Split from run_sharded_2d so callers
    (Simulation.warmup) can AOT-build and reuse the exact runner."""
    my, mx = mesh_shape
    if params.ny % my or params.nx % mx:
        raise ValueError(
            f"grid {params.ny}x{params.nx} not divisible by mesh {my}x{mx}"
        )
    if ca_steps > 1 and (
        params.ny // my < 2 * ca_steps or params.nx // mx < 2 * ca_steps
    ):
        raise ValueError(
            f"local block {params.ny // my}x{params.nx // mx} too thin for "
            f"ca_steps={ca_steps} ghost zones"
        )
    mesh = make_yx_mesh(my, mx)
    return make_sharded_runner_2d(
        mesh, params, n_iters, ca_steps=ca_steps,
        collect_density=collect_density,
    )


def _put(x, sharding):
    """device_put that also works on a multi-host launch: a sharding
    spanning other hosts' devices needs the global array assembled from
    each process's (replicated, host-side) copy via the callback form
    (parallel/multihost.py).  Single-process: plain device_put."""
    if jax.process_count() > 1:
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: x[idx]
        )
    return jax.device_put(x, sharding)


def initial_state_sharded(params: LBMParams, sharding) -> jax.Array:
    """The equilibrium-at-rest state (reference.initial_state) built
    directly in ``sharding``: each device writes only its own block, so no
    device ever holds the whole grid (at 32768² one state is 38.7 GB)."""
    return jax.jit(
        lambda: reference.initial_state(params), out_shardings=sharding
    )()


def compile_sharded(runner, shardings, params: LBMParams):
    """AOT-compile ``runner`` for its sharded inputs (what
    Simulation.warmup does during the Init phase)."""
    ny, nx = params.ny, params.nx
    return runner.lower(
        jax.ShapeDtypeStruct((9, ny, nx), jnp.float32, sharding=shardings["f"]),
        jax.ShapeDtypeStruct((ny, nx), jnp.bool_, sharding=shardings["grid"]),
        jax.ShapeDtypeStruct((ny,), jnp.bool_, sharding=shardings["row"]),
        jax.ShapeDtypeStruct((), jnp.float32, sharding=shardings["scalar"]),
    ).compile()


def execute_sharded(runner, shardings, f0, obstacles, params: LBMParams):
    """Put the inputs per the runner's shardings and invoke it.  ``f0``
    None starts from :func:`initial_state_sharded`; the mask, forcing-row
    mask and fluid count are built on the host and put shard by shard."""
    obstacles = np.asarray(obstacles, dtype=bool)
    row_mask = np.zeros(params.ny, bool)
    row_mask[params.ny - 2] = True
    n_fluid = np.float32(np.count_nonzero(~obstacles))
    f0 = (
        initial_state_sharded(params, shardings["f"])
        if f0 is None
        else _put(f0, shardings["f"])
    )
    return runner(
        f0,
        _put(obstacles, shardings["grid"]),
        _put(row_mask, shardings["row"]),
        _put(n_fluid, shardings["scalar"]),
    )


def run_sharded_2d(
    f0: jax.Array | None,
    obstacles: jax.Array,
    params: LBMParams,
    mesh_shape: tuple[int, int],
    *,
    n_iters: int | None = None,
    ca_steps: int = 1,
    collect_density: bool = False,
) -> tuple[jax.Array, ...]:
    """Full loop on a (my, mx) torus: rows AND columns sharded.

    See make_sharded_runner_2d for the ca_steps semantics."""
    iters = params.max_iters if n_iters is None else n_iters
    runner, sh = prepare_sharded_2d(
        params, iters, mesh_shape, ca_steps=ca_steps,
        collect_density=collect_density,
    )
    return execute_sharded(runner, sh, f0, obstacles, params)


def prepare_sharded(
    params: LBMParams,
    n_iters: int,
    *,
    n_devices: int | None = None,
    ca_steps: int = 1,
    collect_density: bool = False,
    overlap: bool = False,
):
    """Validate the 1-D y decomposition and build its runner.
    Returns (runner, shardings).  Split from run_sharded so callers
    (Simulation.warmup) can AOT-build and reuse the exact runner."""
    mesh = make_y_mesh(n_devices)
    n = mesh.devices.size
    if params.ny % n:
        raise ValueError(f"ny={params.ny} not divisible by {n} devices")
    if ca_steps > 1 and params.ny // n < 2 * ca_steps:
        raise ValueError(
            f"local slab ny/n={params.ny // n} too thin for "
            f"ca_steps={ca_steps} ghost zones"
        )
    return make_sharded_runner(
        mesh, params, n_iters, ca_steps=ca_steps,
        collect_density=collect_density, overlap=overlap,
    )


def run_sharded(
    f0: jax.Array | None,
    obstacles: jax.Array,
    params: LBMParams,
    *,
    n_iters: int | None = None,
    n_devices: int | None = None,
    ca_steps: int = 1,
    collect_density: bool = False,
    overlap: bool = False,
) -> tuple[jax.Array, ...]:
    """Execute the full loop sharded along y. Drop-in replacement for
    ops.fused.run_simulation (same outputs, same numerics up to fp
    reduction order).  ``f0`` None starts from the equilibrium built in
    place (initial_state_sharded).  ca_steps=K > 1 exchanges halos every
    K steps (communication-avoiding ghost zones); overlap=True issues
    halos before the interior compute (see make_sharded_runner)."""
    iters = params.max_iters if n_iters is None else n_iters
    runner, sh = prepare_sharded(
        params, iters, n_devices=n_devices, ca_steps=ca_steps,
        collect_density=collect_density, overlap=overlap,
    )
    return execute_sharded(runner, sh, f0, obstacles, params)
