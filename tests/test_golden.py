"""Golden-output tests against the in-repo reference goldens.

The reference validates exclusively end-to-end (SURVEY.md section 4); the
repo keeps the reference solver's final states for the 256x256 (80 000
steps) and 1024x1024 (20 000 steps) decks (goldens/, decks/).  The full
256x256 run is the exact `make check` contract on its final state — slow
on a CPU, so marked slow; the card runs both decks in chip_smoke.py.
"""

import lzma
import shutil

import pytest

from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation
from advanced_hpc_lbm_tpu.utils import check as lbm_check

from conftest import DECKS_DIR, GOLDENS_DIR

# the reference README's Reynolds number for the 256x256 deck
RE_256 = 10.051412


def _golden(tmp_path, deck):
    out = tmp_path / f"{deck}.golden.dat"
    with lzma.open(f"{GOLDENS_DIR}/{deck}.final_state.dat.xz", "rb") as src:
        with open(out, "wb") as dst:
            shutil.copyfileobj(src, dst)
    return str(out)


@pytest.mark.slow
class TestGoldenFull:
    @pytest.mark.parametrize("devices", [None, 8])
    def test_256x256_full_check(self, tmp_path, devices):
        """The final-state `make check` contract on the 256x256 deck, on
        one device and on the 8-device halo-exchanged decomposition (the
        psum'd reduction's drift must stay inside the 1% contract too)."""
        sim = Simulation.from_decks(
            f"{DECKS_DIR}/256x256.params",
            f"{DECKS_DIR}/256x256.obstacles.dat",
        )
        res = sim.run(devices=devices)
        fs, _ = res.write(tmp_path)
        stats = lbm_check.check_final_state_only(_golden(tmp_path, "256x256"), fs)
        assert stats.passed(1.0), stats
        assert abs(res.reynolds - RE_256) / RE_256 < 0.01


class TestChecker:
    def test_identical_files_pass(self, tmp_path):
        av = tmp_path / "av.dat"
        fs = tmp_path / "fs.dat"
        av.write_text("0:\t1.000000000000E-05\n1:\t2.000000000000E-05\n")
        fs.write_text(
            "0 0 0.0E+00 0.0E+00 0.0E+00 3.3E-02 1\n"
            "1 0 0.0E+00 0.0E+00 0.0E+00 3.3E-02 0\n"
        )
        res = lbm_check.check_files(str(av), str(fs), str(av), str(fs))
        assert res.passed
        assert res.av_vels.total == 0.0

    def test_tolerance_violation_fails(self, tmp_path):
        av1 = tmp_path / "a1.dat"
        av2 = tmp_path / "a2.dat"
        fs = tmp_path / "fs.dat"
        av1.write_text("0:\t1.000000000000E-05\n")
        av2.write_text("0:\t1.050000000000E-05\n")  # 5% off
        fs.write_text("0 0 0.0E+00 0.0E+00 0.0E+00 3.3E-02 1\n")
        res = lbm_check.check_files(str(av1), str(fs), str(av2), str(fs))
        assert not res.passed
        assert not res.av_vels.passed(1.0)
        assert res.final_state.passed(1.0)

    def test_coordinate_mismatch_raises(self, tmp_path):
        av = tmp_path / "av.dat"
        fs1 = tmp_path / "fs1.dat"
        fs2 = tmp_path / "fs2.dat"
        av.write_text("0:\t1.0E-05\n")
        fs1.write_text("0 0 0.0 0.0 0.0 3.3E-02 1\n")
        fs2.write_text("0 1 0.0 0.0 0.0 3.3E-02 1\n")
        with pytest.raises(ValueError, match="coordinates"):
            lbm_check.check_files(str(av), str(fs1), str(av), str(fs2))
