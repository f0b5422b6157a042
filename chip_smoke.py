#!/usr/bin/env python
"""Smoke run of the solver on NVIDIA GPUs: the quickest proof that the
system still starts, computes the right answer and fits on the card.

    python chip_smoke.py          # one GPU, phases 1-5
    python chip_smoke.py --four   # four GPUs: the sharded path only

One GPU, one process, one line per phase; the first failure exits nonzero
and prints no result:

  1 device   JAX must find a GPU (never the CPU); prints the device kind,
             count, JAX version, XLA_FLAGS, the compile-cache directory and
             ``nvidia-smi --query-gpu=name,power.limit`` (read by a child
             process that stays off JAX);
  2 decks    decks/1024x1024 (20 000 steps) and decks/256x256 (80 000 steps)
             through ``cli.main``, checked against goldens/ at the reference
             checker's 1 % and the reference's Reynolds number;
  3 oracle   the fused whole run against a scan of the reference pipeline
             (ops/reference.timestep_pipeline) at 1024², 300 steps;
  4 memory   ``compiled.memory_analysis()`` of the 1024² and 8192² whole-run
             executables (what the model's fit gate compares with the
             device's limit), and the device's ``peak_bytes_in_use``;
  5 step     µs/step, GLUPS and the implied bytes/s at 73 B/cell-step beside
             a large on-device copy, and the fusions in the scan body (a
             first look, not a gate).

``--four`` runs the sharded path and what it is compared with, nothing
else: the 1-D ring (4 devices) and the 2x2 torus, each with ca_steps 1 and
4, against single-GPU fused at 8192² for 200 steps; then 32768² (38.7 GB
per state, more than one card holds) on four cards for a few steps, checked
for finite values and conserved total density, with each card's peak
memory.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Tolerances: the GPU sums in another order than the CPU and the reference,
and the fused step and the pipeline round differently, so agreement is
to fp32 rounding accumulated over the steps run, never bitwise.  No
matrix product runs (TF32 cannot enter) and no fast-math XLA flag is set.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

from advanced_hpc_lbm_tpu.models.d2q9_bgk import (
    Simulation,
    _device_hbm_bytes,
    executable_peak_bytes,
)
from advanced_hpc_lbm_tpu.ops import fused, reference
from advanced_hpc_lbm_tpu.params import LBMParams
from advanced_hpc_lbm_tpu.utils import cache
from advanced_hpc_lbm_tpu.utils import io as lbm_io
from advanced_hpc_lbm_tpu.utils.profiling import BYTES_PER_CELL_STEP
import bench
from scripts import validate_all

# oracle tolerances (phase 3): fused vs the reference pipeline on the card
ORACLE_F_ATOL = 1e-5
ORACLE_AV_RTOL = 1e-4
# sharded vs single-GPU fused (--four): the same physics grouped otherwise
# (pairwise collide form in the ghost-zone and 2-D steps, psum'd partial
# sums), so agreement is to fp32 rounding over the steps run
SHARDED_F_ATOL = 1e-5
SHARDED_AV_RTOL = 1e-4
# total density over a few steps of a 32768² run, summed per row in fp32
# and across rows in fp64
DENSITY_RTOL = 1e-5


class PhaseError(RuntimeError):
    pass


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform, "kind": d.device_kind,
            "count": len(devices),
        },
    })


# -- phase 1 ---------------------------------------------------------------

def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_phase(need: int):
    devices = jax.devices()
    d = devices[0]
    require(
        d.platform == "gpu",
        f"JAX found no GPU (platform {d.platform!r}); this smoke run "
        "measures the card and never falls back to the CPU",
    )
    require(len(devices) >= need, f"need {need} GPUs, found {len(devices)}")
    say("1 device", (
        f"kind={d.device_kind!r} count={len(devices)} "
        f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={cache.cache_dir()}"
    ))
    for line in nvidia_smi().splitlines():
        say("1 device", f"nvidia-smi: {line}")
    return devices


# -- phase 2 ---------------------------------------------------------------

def decks_phase(decks=("1024x1024", "256x256")) -> None:
    for deck in decks:
        with tempfile.TemporaryDirectory() as td:
            row = validate_all.run_deck(deck, td)
        t = row["timers"]
        say("2 decks", (
            f"{deck}: final_state max diff "
            f"{row['final_state_max_diff_pct']:.4f}% (limit 1%), Reynolds "
            f"{row['reynolds']:.6f} (reference {row['reynolds_expected']}), "
            f"Init {t['init']:.3f} s, Compute {t['compute']:.3f} s, "
            f"Collate {t['collate']:.3f} s, Total {t['total']:.3f} s"
        ))
        require(row["passed"], f"{deck} failed the golden check: {row}")


# -- phase 3 ---------------------------------------------------------------

def oracle_phase(deck: str = "1024x1024", steps: int = 300) -> dict:
    params_path, obst_path = validate_all.deck_paths(deck)
    params = lbm_io.load_params(params_path)
    mask = jnp.asarray(lbm_io.load_obstacles(obst_path, params))

    outs = {}
    for name, step_fn in (("fused", fused.fused_step),
                          ("pipeline", fused.pipeline_step)):
        f, av = jax.jit(
            lambda f0, o, s=step_fn: fused.run_simulation(
                f0, o, params, n_iters=steps, step_fn=s
            )
        )(reference.initial_state(params), mask)
        outs[name] = (np.asarray(f), np.asarray(av))
    (f_a, av_a), (f_b, av_b) = outs["fused"], outs["pipeline"]
    f_abs = float(np.max(np.abs(f_a - f_b)))
    av_rel = float(np.max(np.abs(av_a - av_b) / np.abs(av_b)))
    say("3 oracle", (
        f"{deck} {steps} steps fused vs pipeline: f max abs diff "
        f"{f_abs:.3e} (atol {ORACLE_F_ATOL:g}), av_vels max rel diff "
        f"{av_rel:.3e} (rtol {ORACLE_AV_RTOL:g})"
    ))
    require(
        np.all(np.isfinite(f_a)) and f_abs <= ORACLE_F_ATOL
        and av_rel <= ORACLE_AV_RTOL,
        "fused does not match the reference pipeline",
    )
    return {"f_abs": f_abs, "av_rel": av_rel}


# -- phase 4 ---------------------------------------------------------------

def memory_phase(sizes=((1024, 2000), (8192, 200))) -> dict:
    """Compile the whole-run executable at each (size, steps) and print
    its memory analysis — the need the model's fit gate compares with the
    device's limit.  Returns the compiled runners, for phase 5."""
    runners = {}
    for n, iters in sizes:
        params, mask = bench.build_deck(n, n, iters)
        sim = Simulation(params, mask)
        compiled = sim._device_runner(iters, False)
        m = compiled.memory_analysis()
        peak = executable_peak_bytes(compiled)
        say("4 memory", (
            f"{n}² whole run ({iters} steps): argument "
            f"{m.argument_size_in_bytes} B, output {m.output_size_in_bytes} B, "
            f"temp {m.temp_size_in_bytes} B, alias {m.alias_size_in_bytes} B "
            f"-> peak {peak} B = {peak / (n * n):.2f} B/cell = "
            f"{peak / (36 * n * n):.3f} states"
        ))
        runners[n] = (sim, compiled)
    stats = jax.devices()[0].memory_stats() or {}
    say("4 memory", (
        f"device peak_bytes_in_use {stats.get('peak_bytes_in_use')} B of "
        f"bytes_limit {_device_hbm_bytes()} B"
    ))
    return runners


# -- phase 5 ---------------------------------------------------------------

_HEADER = re.compile(r"^(?:ENTRY\s+)?%([^\s(]+)\s*\(.*\{\s*$")
_OPCODE = re.compile(r"[\]})]\s+([a-z][a-z0-9_\-]*)\(")
_NOT_KERNELS = {
    "parameter", "get-tuple-element", "tuple", "constant", "bitcast",
}


def scan_body_ops(hlo_text: str) -> collections.Counter:
    """Opcodes of the instructions in the while-loop bodies of an
    optimized HLO module (following ``call`` into its computation, e.g. a
    command buffer), without the ones that launch nothing."""
    comps: dict[str, list[str]] = {}
    current = None
    for line in hlo_text.splitlines():
        m = _HEADER.match(line)
        if m:
            current = m.group(1)
            comps[current] = []
        elif line.startswith("}"):
            current = None
        elif current is not None:
            comps[current].append(line)

    ops: collections.Counter = collections.Counter()

    def visit(name: str) -> None:
        for line in comps.get(name, []):
            m = _OPCODE.search(line.split("=", 1)[-1])
            if not m:
                continue
            op = m.group(1)
            if op == "call":
                target = re.search(r"to_apply=%([\w.\-]+)", line)
                if target:
                    visit(target.group(1))
                    continue
            if op not in _NOT_KERNELS:
                ops[op] += 1

    for body in set(re.findall(r"body=%([\w.\-]+)", hlo_text)):
        visit(body)
    return ops


def copy_gbps(n_bytes: int = 2**31, repeats: int = 5) -> float:
    """Bytes/s of a large on-device elementwise pass (read + write)."""
    x = jnp.zeros((n_bytes // 4,), jnp.float32)
    f = jax.jit(lambda v: v + 1.0, donate_argnums=0)
    x = f(x).block_until_ready()
    best = float("inf")
    for _ in range(repeats):
        tic = time.perf_counter()
        x = f(x).block_until_ready()
        best = min(best, time.perf_counter() - tic)
    return 2 * n_bytes / best / 1e9


def step_phase(runners: dict, repeats: int = 3, copy_bytes: int = 2**31):
    copy = copy_gbps(copy_bytes)
    rows = {}
    for n, (sim, compiled) in runners.items():
        iters = sim.params.max_iters
        obstacles = jnp.asarray(sim.obstacles)

        def run():
            f, av = compiled(sim.initial_state(), obstacles)
            f.block_until_ready()
            return np.asarray(av)

        run()
        times = []
        for _ in range(repeats):
            tic = time.perf_counter()
            av = run()
            times.append(time.perf_counter() - tic)
        require(bool(np.all(np.isfinite(av))), f"{n}²: non-finite av_vels")
        best = min(times)
        us_step = best / iters * 1e6
        glups = n * n * iters / best / 1e9
        gbps = glups * BYTES_PER_CELL_STEP
        ops = scan_body_ops(compiled.as_text())
        rows[n] = {"us_step": us_step, "glups": glups, "gbps": gbps,
                   "fusions": ops.get("fusion", 0), "ops": dict(ops)}
        say("5 step", (
            f"{n}² {iters} steps: {us_step:.2f} µs/step, {glups:.3f} GLUPS, "
            f"{gbps:.0f} GB/s at {BYTES_PER_CELL_STEP} B/cell-step vs "
            f"on-device copy {copy:.0f} GB/s ({gbps / copy:.1%}); scan body "
            f"{ops.get('fusion', 0)} fusions, ops {dict(ops)}"
        ))
    return rows


# -- --four ------------------------------------------------------------------

def sharded_phase(n: int = 8192, steps: int = 200) -> None:
    """Simulation.run on the 1-D ring (4 devices) and the 2x2 torus,
    ca_steps 1 and 4, against the single-device fused run; compared on
    the host."""
    params, mask = bench.build_deck(n, n, steps)
    ref = Simulation(params, mask).run()
    for layout in ("1d", "2x2"):
        for k in (1, 4):
            where = (
                {"devices": 4} if layout == "1d" else {"mesh": (2, 2)}
            )
            res = Simulation(params, mask, backend="sharded").run(
                ca_steps=k, **where
            )
            f_abs = float(np.max(np.abs(res.f_final - ref.f_final)))
            av_rel = float(np.max(
                np.abs(res.av_vels - ref.av_vels) / np.abs(ref.av_vels)
            ))
            say("sharded", (
                f"{n}² {steps} steps {layout} ca_steps={k} vs single-device "
                f"fused: f max abs diff {f_abs:.3e} (atol {SHARDED_F_ATOL:g}),"
                f" av_vels max rel diff {av_rel:.3e} "
                f"(rtol {SHARDED_AV_RTOL:g})"
            ))
            require(
                f_abs <= SHARDED_F_ATOL and av_rel <= SHARDED_AV_RTOL,
                f"sharded {layout} ca_steps={k} does not match single-device",
            )


def huge_phase(n: int = 32768, steps: int = 8) -> None:
    """A grid whose state outgrows one card, on four, through
    Simulation.run: built sharded, run a few steps, checked on the devices
    for finite values and conserved total density."""
    params, mask = bench.build_deck(n, n, steps)
    state = 9 * 4 * n * n
    res = Simulation(params, mask, backend="sharded").run(
        devices=4, fetch=False
    )
    f = res.f_final
    finite = bool(jnp.all(jnp.isfinite(f))) and bool(
        np.all(np.isfinite(np.asarray(res.av_vels)))
    )
    # per-row fp32 sums on the devices, summed across rows in fp64
    total = float(np.sum(np.asarray(jnp.sum(f, axis=(0, 2)), np.float64)))
    per_cell = float(np.sum(np.asarray(reference.initial_state(
        LBMParams(1, 1, 0, 10, params.density, params.accel, params.omega)
    ), np.float64)))
    expect = per_cell * n * n
    rel = abs(total - expect) / expect
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", -1)
             for d in jax.devices()[:4]]
    say("huge", (
        f"{n}² ({state} B per state) {steps} steps on 4 devices: finite "
        f"{finite}, total density {total:.6e} vs {expect:.6e} (rel "
        f"{rel:.2e}, rtol {DENSITY_RTOL:g}); per-device peak_bytes_in_use "
        f"{peaks}"
    ))
    require(finite, f"non-finite values at {n}²")
    require(rel <= DENSITY_RTOL, "total density not conserved")
    require(all(0 <= p < state for p in peaks),
            "a device held a whole state's worth of memory")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the sharded path (and its single-device reference) "
             "on four GPUs",
    )
    args = ap.parse_args(argv)
    try:
        cache.enable()
        devices = device_phase(4 if args.four else 1)
        if args.four:
            sharded_phase()
            huge_phase()
            devices = devices[:4]
        else:
            decks_phase()
            oracle_phase()
            step_phase(memory_phase())
            devices = devices[:1]
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
