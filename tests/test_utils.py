"""Tests for the aux utilities: viz, profiling, timers."""

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.utils import profiling, timers, viz


class TestViz:
    def test_velocity_field_roundtrip(self, tmp_path):
        # write a small final_state.dat-shaped file and reload it
        ny, nx = 4, 8
        rng = np.random.RandomState(0)
        vals = rng.rand(ny, nx)
        path = tmp_path / "fs.dat"
        with open(path, "w") as fh:
            for jj in range(ny):
                for ii in range(nx):
                    fh.write(
                        f"{ii} {jj} 0.0E+00 0.0E+00 {vals[jj, ii]:.12E} "
                        f"3.3E-02 0\n"
                    )
        grid = viz.velocity_field_from_dat(path)
        np.testing.assert_allclose(grid, vals, rtol=1e-12)

    def test_plot_writes_file(self, tmp_path):
        ny, nx = 4, 8
        path = tmp_path / "fs.dat"
        with open(path, "w") as fh:
            for jj in range(ny):
                for ii in range(nx):
                    fh.write(f"{ii} {jj} 0 0 {ii * jj} 0.03 0\n")
        out = viz.plot_final_state(path, tmp_path / "fs.png")
        import os

        assert os.path.exists(out)
        assert os.path.getsize(out) > 0


class TestProfiling:
    def test_bench_result_math(self):
        r = profiling.BenchResult(nx=1024, ny=1024, iters=1000, elapsed_s=0.1)
        assert abs(r.glups - 10.48576) < 1e-5
        assert abs(r.mlups - r.glups * 1e3) < 1e-6
        assert (
            abs(r.effective_gbps - r.glups * profiling.BYTES_PER_CELL_STEP)
            < 1e-6
        )

    def test_roofline_report_strings(self):
        r = profiling.BenchResult(nx=128, ny=128, iters=100, elapsed_s=0.01)
        text = profiling.roofline_report(r, "NVIDIA H100 80GB HBM3")
        assert "GLUPS" in text and "HBM" in text
        assert "3350 GB/s" in text and "data sheet" in text


class TestPeaks:
    def test_h100_sxm_entry(self):
        peak = profiling.device_peak("NVIDIA H100 80GB HBM3")
        assert peak.hbm_gbps == 3350.0
        assert peak.hbm_bytes == 80 * 10**9
        assert "H100" in peak.source

    def test_roofline_ceiling_is_bandwidth_over_bytes(self):
        r = profiling.BenchResult(nx=1024, ny=1024, iters=1, elapsed_s=1.0)
        text = profiling.roofline_report(r, "NVIDIA H100 80GB HBM3")
        ceiling = 3350.0 / profiling.BYTES_PER_CELL_STEP
        assert f"{ceiling:.1f} GLUPS ceiling" in text

    @pytest.mark.parametrize(
        "kind", ["cpu", "Tesla V100-SXM2-16GB", "NVIDIA A100-SXM4-80GB", ""]
    )
    def test_unknown_device_raises(self, kind):
        with pytest.raises(ValueError, match="no published peaks"):
            profiling.device_peak(kind)
        r = profiling.BenchResult(nx=8, ny=8, iters=1, elapsed_s=1.0)
        with pytest.raises(ValueError):
            profiling.roofline_report(r, kind)


class TestTimers:
    def test_report_block_format(self):
        t = timers.PhaseTimers()
        with t.phase("init"):
            pass
        with t.phase("compute"):
            pass
        lines = t.report_lines()
        assert len(lines) == 4
        assert lines[0].startswith("Elapsed Init time:\t\t\t")
        assert lines[3].startswith("Elapsed Total time:\t\t\t")
        for ln in lines:
            assert ln.endswith("(s)")

    def test_accumulates(self):
        t = timers.PhaseTimers()
        for _ in range(3):
            with t.phase("compute"):
                pass
        assert t.elapsed["compute"] >= 0
