"""Performance instrumentation — the counterpart of the reference's
gprof/Intel-Advisor methodology (profile.txt, e000/ roofline project).

Provides:
* ``lups`` / ``roofline_report`` — throughput and HBM-roofline numbers for
  a measured run (the reference's measured single-core ceiling was
  13.09 GB/s DRAM, e000/hs000/metrics.advisum:13-15);
* ``device_peak`` — published peaks by ``device_kind``; a device missing
  from the table is an error, never a default;
* ``trace`` — context manager around jax.profiler for capturing a device
  trace viewable in TensorBoard/Perfetto (wired to the CLI --profile flag).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

# one step moves 9 fp32 planes in + out plus a 1-byte bool mask read
BYTES_PER_CELL_STEP = 9 * 4 * 2 + 1


@dataclasses.dataclass(frozen=True)
class DevicePeak:
    hbm_gbps: float  # published HBM bandwidth, GB/s
    hbm_bytes: int  # device memory, bytes
    source: str


# Keyed by jax's ``device.device_kind``.
PEAKS: dict[str, DevicePeak] = {
    "NVIDIA H100 80GB HBM3": DevicePeak(
        hbm_gbps=3350.0,
        hbm_bytes=80 * 10**9,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 (700 W)",
    ),
}


def device_peak(device_kind: str) -> DevicePeak:
    """The published peaks of ``device_kind``; raises for a device that is
    not in :data:`PEAKS`."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; add it to "
            "utils/profiling.PEAKS with its source"
        ) from None


@dataclasses.dataclass
class BenchResult:
    nx: int
    ny: int
    iters: int
    elapsed_s: float

    @property
    def mlups(self) -> float:
        return self.nx * self.ny * self.iters / self.elapsed_s / 1e6

    @property
    def glups(self) -> float:
        return self.mlups / 1e3

    @property
    def effective_gbps(self) -> float:
        """Achieved HBM traffic assuming the single-pass roofline."""
        return self.nx * self.ny * self.iters * BYTES_PER_CELL_STEP / self.elapsed_s / 1e9


def roofline_report(result: BenchResult, device_kind: str) -> str:
    """Throughput of ``result`` against the HBM roofline of the device
    that measured it."""
    peak = device_peak(device_kind)
    ceiling = peak.hbm_gbps / BYTES_PER_CELL_STEP  # GLUPS
    return "\n".join([
        f"grid {result.nx}x{result.ny}, {result.iters} iters in "
        f"{result.elapsed_s:.3f} s on {device_kind}",
        f"throughput: {result.glups:.3f} GLUPS ({result.mlups:.0f} MLUPS)",
        f"effective HBM traffic (single-pass model, "
        f"{BYTES_PER_CELL_STEP} B/cell-step): {result.effective_gbps:.0f} GB/s",
        f"HBM roofline: {peak.hbm_gbps:.0f} GB/s ({peak.source}) -> "
        f"{ceiling:.1f} GLUPS ceiling; achieved "
        f"{100 * result.glups / ceiling:.0f}% of roofline",
    ])


def measure(run_fn, nx: int, ny: int, iters: int) -> BenchResult:
    """Time run_fn() (which must block until done) and wrap the numbers."""
    tic = time.perf_counter()
    run_fn()
    return BenchResult(nx=nx, ny=ny, iters=iters, elapsed_s=time.perf_counter() - tic)


@contextlib.contextmanager
def trace(trace_dir: str):
    """jax.profiler trace of the enclosed block (TensorBoard/Perfetto)."""
    import jax.profiler

    with jax.profiler.trace(trace_dir):
        yield
