#!/usr/bin/env python
"""Run the in-repo reference decks end to end through the CLI and check
each against its golden final state (goldens/*.xz) at the reference
checker's 1% tolerance (check/check.py), plus the reference's Reynolds
number.  Prints one table row per deck and exits nonzero on any failure.

Usage: python scripts/validate_all.py [--decks 256x256 1024x1024]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import lzma
import re
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
DECKS = ("256x256", "1024x1024")
# expected Reynolds numbers from the reference README (serial base build)
EXPECTED_RE = {"256x256": 10.051412, "1024x1024": 3.375851}
TOLERANCE = 1.0  # percent, check/check.py:19-24


def deck_paths(deck: str) -> tuple[str, str]:
    return (
        str(REPO / "decks" / f"{deck}.params"),
        str(REPO / "decks" / f"{deck}.obstacles.dat"),
    )


def unpack_golden(deck: str, out_dir: str) -> str:
    """Decompress goldens/<deck>.final_state.dat.xz into ``out_dir``."""
    out = str(Path(out_dir) / f"{deck}.golden_final_state.dat")
    packed = REPO / "goldens" / f"{deck}.final_state.dat.xz"
    with lzma.open(packed, "rb") as src, open(out, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return out


def run_deck(deck: str, out_dir: str, extra: tuple[str, ...] = ()) -> dict:
    """One deck through ``cli.main`` (in this process), checked against its
    golden.  Returns the Reynolds number, the four timers, the final-state
    max difference in percent and the verdict."""
    from advanced_hpc_lbm_tpu import cli
    from advanced_hpc_lbm_tpu.utils import check as lbm_check

    params, obstacles = deck_paths(deck)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([params, obstacles, "--out-dir", out_dir, *extra])
    out = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"{deck}: the CLI exited {rc}\n{out}")
    reynolds = float(re.search(r"Reynolds number:\s+(\S+)", out).group(1))
    timers = {
        name.lower(): float(sec)
        for name, sec in re.findall(r"Elapsed (\w+) time:\s+(\S+)", out)
    }
    fs = lbm_check.check_final_state_only(
        unpack_golden(deck, out_dir), str(Path(out_dir) / "final_state.dat")
    )
    re_err = abs(reynolds - EXPECTED_RE[deck]) / EXPECTED_RE[deck]
    return {
        "deck": deck,
        "reynolds": reynolds,
        "reynolds_expected": EXPECTED_RE[deck],
        "final_state_max_diff_pct": abs(fs.max_diff_pcnt),
        "timers": timers,
        "passed": fs.passed(TOLERANCE) and re_err < TOLERANCE / 100,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--decks", nargs="*", default=list(DECKS))
    args = ap.parse_args(argv)

    failures = 0
    print(f"{'deck':>10} {'compute_s':>10} {'Re':>14} {'fs max%':>9} "
          f"{'verdict':>8}")
    for deck in args.decks:
        with tempfile.TemporaryDirectory() as td:
            row = run_deck(deck, td)
        failures += not row["passed"]
        print(
            f"{deck:>10} {row['timers']['compute']:10.3f} "
            f"{row['reynolds']:14.6E} {row['final_state_max_diff_pct']:9.4f} "
            f"{'PASS' if row['passed'] else 'FAIL':>8}"
        )
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
