"""I/O codec tests: format parity with the reference writers/loaders."""

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.ops import reference
from advanced_hpc_lbm_tpu.params import LBMParams
from advanced_hpc_lbm_tpu.utils import io as lbm_io
from advanced_hpc_lbm_tpu.utils import native

from conftest import DECKS_DIR, GOLDENS_DIR


class TestParams:
    def test_load_reference_deck(self):
        p = lbm_io.load_params(f"{DECKS_DIR}/256x256.params")
        assert (p.nx, p.ny, p.max_iters, p.reynolds_dim) == (256, 256, 80000, 10)
        assert (p.density, p.accel, p.omega) == (0.1, 0.005, 1.85)

    def test_bad_deck(self, tmp_path):
        deck = tmp_path / "bad.params"
        deck.write_text("128\n128\n")
        with pytest.raises(lbm_io.DeckError):
            lbm_io.load_params(deck)

    def test_accel_weights_fp32(self):
        p = LBMParams(8, 8, 1, 10, 0.1, 0.005, 1.85)
        # identical to the C float expression density*accel/9.f
        assert p.accel_w1 == np.float32(np.float32(0.1) * np.float32(0.005) / np.float32(9))
        assert p.accel_w2 == np.float32(np.float32(0.1) * np.float32(0.005) / np.float32(36))


class TestObstacles:
    def test_load_reference_obstacles(self):
        p = lbm_io.load_params(f"{DECKS_DIR}/256x256.params")
        mask = lbm_io.load_obstacles(f"{DECKS_DIR}/256x256.obstacles.dat", p)
        # 256x256 deck is a closed box: full top/bottom rows + side columns
        assert mask[0].all() and mask[-1].all()
        assert mask[:, 0].all() and mask[:, -1].all()
        assert not mask[1:-1, 1:-1].any()

    def test_validation(self, tmp_path):
        p = LBMParams(8, 8, 1, 10, 0.1, 0.005, 1.85)
        for content, msg in [
            ("1 2\n", "3 values"),
            ("9 0 1\n", "x-coord"),
            ("0 9 1\n", "y-coord"),
            ("0 0 2\n", "blocked"),
        ]:
            deck = tmp_path / "obs.dat"
            deck.write_text(content)
            with pytest.raises(lbm_io.DeckError, match=msg):
                lbm_io.load_obstacles(deck, p)


class TestWriters:
    def _tiny_run(self):
        p = LBMParams(8, 8, 4, 10, 0.1, 0.005, 1.85)
        mask = np.zeros((8, 8), dtype=bool)
        mask[0] = mask[-1] = True
        f = np.asarray(reference.initial_state(p))
        return p, mask, f

    def test_final_state_format(self, tmp_path):
        p, mask, f = self._tiny_run()
        path = tmp_path / "final_state.dat"
        lbm_io.write_final_state(path, f, mask, p)
        lines = path.read_text().splitlines()
        assert len(lines) == 64
        # raster order: jj outer, ii inner (d2q9-bgk.c:2935-2937)
        assert lines[0].startswith("0 0 ")
        assert lines[1].startswith("1 0 ")
        assert lines[8].startswith("0 1 ")
        fields = lines[0].split()
        assert len(fields) == 7
        # obstacle row: u = 0, pressure = density*c_s^2 in fp32
        # (d2q9-bgk.c:2940-2944; the value the reference binary itself would
        # print — the shipped golden came from a double-precision build and
        # differs at the 8th digit, well inside the 1% check tolerance)
        blocked_p = np.float32(np.float32(0.1) * np.float32(1.0 / 3.0))
        assert fields[2] == "0.000000000000E+00"
        assert fields[5] == f"{float(blocked_p):.12E}"
        assert fields[6] == "1"
        # fluid row at rest: u = 0, pressure = (sum of 9 fp32 weights)*c_s^2
        rho = f[:, 3, 3].sum(dtype=np.float32)
        fluid_p = np.float32(rho * np.float32(1.0 / 3.0))
        mid = lines[3 * 8 + 3].split()
        assert mid[5] == f"{float(fluid_p):.12E}"

    def test_av_vels_format(self, tmp_path):
        path = tmp_path / "av_vels.dat"
        vals = np.float32([1.094269153342e-05, 2.5e-3])
        lbm_io.write_av_vels(path, vals)
        lines = path.read_text().splitlines()
        # fp32 history widened to double for printing, exactly like the
        # reference's float av_vels[] under %.12E (d2q9-bgk.c:2993)
        assert lines[0] == f"0:\t{float(vals[0]):.12E}"
        assert lines[1] == f"1:\t{float(vals[1]):.12E}"
        assert "\t" in lines[0] and lines[0].split(":")[0] == "0"

    def test_obstacle_column_quirk_square(self, tmp_path):
        """For square grids the quirk column is the transposed mask
        (d2q9-bgk.c:2978 prints obstacles[ii*nx + jj])."""
        p, mask, f = self._tiny_run()
        mask[:] = False
        mask[2, 5] = True  # y=2, x=5
        _, _, obs_col = lbm_io.final_state_table(f, mask, p)
        grid = obs_col.reshape(8, 8)  # [jj, ii]
        assert grid[5, 2] == 1  # transposed position
        assert grid[2, 5] == 0
        _, _, correct = lbm_io.final_state_table(
            f, mask, p, emulate_obstacle_column_quirk=False
        )
        assert correct.reshape(8, 8)[2, 5] == 1

    def test_python_and_native_writers_identical(self, tmp_path):
        if not native.available() and not native.build():
            pytest.skip("no C toolchain for libfastio")
        p, mask, f = self._tiny_run()
        f = f * np.random.RandomState(3).uniform(0.5, 1.5, f.shape).astype(np.float32)
        coords, fields, obs = lbm_io.final_state_table(f, mask, p)
        py_path = tmp_path / "py.dat"
        with open(py_path, "w") as fh:
            for (ii, jj), (ux, uy, u, pr), ob in zip(coords, fields, obs):
                fh.write(f"{ii} {jj} {ux:.12E} {uy:.12E} {u:.12E} {pr:.12E} {ob}\n")
        c_path = tmp_path / "c.dat"
        native.write_final_state(c_path, coords, fields, obs)
        assert py_path.read_text() == c_path.read_text()

        av = np.random.RandomState(4).uniform(0, 1, 100)
        py_av = tmp_path / "py_av.dat"
        with open(py_av, "w") as fh:
            for i, v in enumerate(av):
                fh.write(f"{i}:\t{v:.12E}\n")
        c_av = tmp_path / "c_av.dat"
        native.write_av_vels(c_av, av)
        assert py_av.read_text() == c_av.read_text()

    def test_header_matches_golden_format(self, tmp_path):
        """Our initial-state writer output must be parseable by the same
        loadtxt contract as the goldens and line up coordinate-wise —
        obstacle-column quirk included."""
        import lzma

        p = lbm_io.load_params(f"{DECKS_DIR}/256x256.params")
        mask = lbm_io.load_obstacles(f"{DECKS_DIR}/256x256.obstacles.dat", p)
        f = np.asarray(reference.initial_state(p))
        path = tmp_path / "final_state.dat"
        lbm_io.write_final_state(path, f, mask, p)
        ours = np.loadtxt(path, usecols=[0, 1, 6])
        with lzma.open(f"{GOLDENS_DIR}/256x256.final_state.dat.xz", "rt") as fh:
            golden = np.loadtxt(fh, usecols=[0, 1, 6])
        np.testing.assert_array_equal(ours, golden)
