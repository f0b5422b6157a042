"""The checker CLI (a port of the reference's check/check.py): verdicts,
numeric report lines and exit codes on synthetic outputs, and @argfile
invocation (fromfile_prefix_chars, check/check.py:13)."""

import subprocess
import sys

import numpy as np
import pytest


def write_outputs(tmp_path, av, fs_pressure, prefix):
    av_path = tmp_path / f"{prefix}_av.dat"
    fs_path = tmp_path / f"{prefix}_fs.dat"
    with open(av_path, "w") as fh:
        for i, v in enumerate(av):
            fh.write(f"{i}:\t{v:.12E}\n")
    with open(fs_path, "w") as fh:
        n = len(fs_pressure)
        for i, p in enumerate(fs_pressure):
            fh.write(f"{i % n} 0 0.0E+00 0.0E+00 0.0E+00 {p:.12E} 0\n")
    return av_path, fs_path


def run_checker(args):
    proc = subprocess.run(
        [sys.executable, "-m", "advanced_hpc_lbm_tpu.utils.check", *args],
        capture_output=True,
        text=True,
    )
    return proc.returncode, proc.stdout


def flags(ref_av, ref_fs, av, fs):
    return [
        f"--ref-av-vels-file={ref_av}",
        f"--ref-final-state-file={ref_fs}",
        f"--av-vels-file={av}",
        f"--final-state-file={fs}",
    ]


@pytest.mark.parametrize("scale,expect_pass", [(1.0 + 1e-6, True), (1.05, False)])
def test_same_verdict_and_exit_code(tmp_path, scale, expect_pass):
    rng = np.random.RandomState(0)
    av = rng.uniform(1e-5, 1e-2, 50)
    fs = rng.uniform(0.03, 0.04, 64)
    ref_av, ref_fs = write_outputs(tmp_path, av, fs, "ref")
    sim_av, sim_fs = write_outputs(tmp_path, av * scale, fs * scale, "sim")

    rc, out = run_checker(flags(ref_av, ref_fs, sim_av, sim_fs))
    assert rc == (0 if expect_pass else 1)
    lines = out.splitlines()
    assert lines[0].startswith("Total difference in av_vels : ")
    assert lines[4].startswith("Total difference in final_state : ")
    assert lines[5].startswith("Biggest difference (at coord (")
    if expect_pass:
        assert lines[-1] == "Both tests passed!"
    else:
        assert "final state failed check" in lines
        assert "av_vels failed check" in lines
    # the relative difference is printed with %.2g, as check.py does
    # 100 * (ref - sim) / sim, check/check.py:83-99
    pct = (1.0 - scale) / scale * 100.0
    assert lines[2].endswith(f"= {pct:.2g}%")


def test_argfile_invocation_matches_original(tmp_path):
    """@argfile expansion: the whole argv from a file gives the same
    report and exit code as the flags on the command line."""
    rng = np.random.RandomState(1)
    av = rng.uniform(1e-5, 1e-2, 20)
    fs = rng.uniform(0.03, 0.04, 32)
    ref_av, ref_fs = write_outputs(tmp_path, av, fs, "ref")
    sim_av, sim_fs = write_outputs(tmp_path, av, fs, "sim")
    argfile = tmp_path / "args.txt"
    argfile.write_text("\n".join(flags(ref_av, ref_fs, sim_av, sim_fs)) + "\n")

    rc_file, out_file = run_checker([f"@{argfile}"])
    rc_flags, out_flags = run_checker(flags(ref_av, ref_fs, sim_av, sim_fs))
    assert rc_file == rc_flags == 0
    assert out_file == out_flags
