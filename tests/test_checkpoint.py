"""Checkpoint/resume: snapshots are exact and resume reproduces the
uninterrupted trajectory bit-for-bit (same compiled segments)."""

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation
from advanced_hpc_lbm_tpu.params import LBMParams
from advanced_hpc_lbm_tpu.utils.checkpoint import CheckpointManager


@pytest.fixture()
def sim():
    params = LBMParams(
        nx=32, ny=16, max_iters=12, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((16, 32), dtype=bool)
    mask[0] = mask[-1] = True
    return Simulation(params, mask, backend="fused")


class TestManager:
    def test_save_load_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        f = np.random.RandomState(0).rand(9, 4, 8).astype(np.float32)
        av = np.float32([1e-5, 2e-5])
        mgr.save(2, f, av)
        step, f2, av2, dens = mgr.latest()
        assert step == 2
        np.testing.assert_array_equal(f2, f)
        np.testing.assert_array_equal(av2, av)
        assert dens is None  # non-debug snapshot carries no densities

    def test_save_load_densities(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        f = np.zeros((9, 2, 2), np.float32)
        dens = np.float32([0.4, 0.4, 0.4])
        mgr.save(3, f, np.zeros(3, np.float32), densities=dens)
        step, _, _, dens2 = mgr.latest()
        assert step == 3
        np.testing.assert_array_equal(dens2, dens)
        assert mgr.latest_step() == 3

    def test_prune_keeps_newest(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        f = np.zeros((9, 2, 2), np.float32)
        for s in (1, 2, 3, 4):
            mgr.save(s, f, np.zeros(s, np.float32))
        assert mgr.steps() == [3, 4]

    def test_empty_dir(self, tmp_path):
        assert CheckpointManager(tmp_path).latest() is None

    def test_corrupt_latest_falls_back(self, tmp_path):
        """A damaged newest snapshot must not kill the resume — fall back
        to the previous good one with a warning."""
        mgr = CheckpointManager(tmp_path, keep=3)
        f = np.arange(9 * 2 * 2, dtype=np.float32).reshape(9, 2, 2)
        mgr.save(2, f, np.zeros(2, np.float32))
        mgr.save(4, f * 2, np.zeros(4, np.float32))
        # truncate the newest file
        newest = tmp_path / "step_00000004.npz"
        newest.write_bytes(newest.read_bytes()[:40])
        with pytest.warns(UserWarning, match="unreadable checkpoint"):
            step, f2, av2, _ = mgr.latest()
        assert step == 2
        np.testing.assert_array_equal(f2, f)
        with pytest.warns(UserWarning, match="unreadable checkpoint"):
            assert mgr.latest_step() == 2  # agrees with latest(), not steps()[-1]

    def test_all_corrupt_returns_none(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        (tmp_path / "step_00000003.npz").write_bytes(b"garbage")
        with pytest.warns(UserWarning):
            assert mgr.latest() is None


class TestResume:
    def test_checkpointed_equals_straight(self, sim, tmp_path):
        straight = sim.run()
        ck = sim.run(checkpoint_every=5, checkpoint_dir=tmp_path / "ck")
        np.testing.assert_array_equal(ck.f_final, straight.f_final)
        np.testing.assert_array_equal(ck.av_vels, straight.av_vels)

    def test_resume_continues_exactly(self, sim, tmp_path):
        ckdir = tmp_path / "ck"
        # run only 8 of 12 steps, checkpointing every 4
        sim.run(n_iters=8, checkpoint_every=4, checkpoint_dir=ckdir)
        mgr = CheckpointManager(ckdir)
        assert mgr.steps()[-1] == 8
        # resume to 12
        resumed = sim.run(
            n_iters=12, checkpoint_every=4, checkpoint_dir=ckdir, resume=True
        )
        straight = sim.run(n_iters=12)
        np.testing.assert_array_equal(resumed.f_final, straight.f_final)
        np.testing.assert_array_equal(resumed.av_vels, straight.av_vels)

    def test_resume_beyond_target_raises(self, sim, tmp_path):
        ckdir = tmp_path / "ck"
        sim.run(n_iters=8, checkpoint_every=4, checkpoint_dir=ckdir)
        with pytest.raises(ValueError, match="beyond"):
            sim.run(n_iters=4, checkpoint_every=4, checkpoint_dir=ckdir, resume=True)

    def test_debug_resume_densities_stay_aligned(self, sim, tmp_path):
        """result.densities must be step-aligned with av_vels across a
        resume: a debug snapshot stores the density history, and a
        resumed debug run restores it (round-4 review finding — the
        density stream used to start at the resume point, shifting every
        printed '==timestep: N==' density to the wrong step)."""
        ckdir = tmp_path / "ck"
        sim.run(n_iters=8, checkpoint_every=4, checkpoint_dir=ckdir, debug=True)
        resumed = sim.run(
            n_iters=12, checkpoint_every=4, checkpoint_dir=ckdir,
            resume=True, debug=True,
        )
        straight = sim.run(n_iters=12, debug=True)
        assert resumed.densities.shape == resumed.av_vels.shape == (12,)
        np.testing.assert_array_equal(resumed.densities, straight.densities)
        np.testing.assert_array_equal(resumed.av_vels, straight.av_vels)

    def test_debug_resume_from_nondebug_snapshot_pads_nan(self, sim, tmp_path):
        """Resuming with --debug from a snapshot written WITHOUT --debug
        can't recover the earlier densities — they must read NaN (honest
        'not recorded'), never shift later segments' values earlier."""
        ckdir = tmp_path / "ck"
        sim.run(n_iters=8, checkpoint_every=4, checkpoint_dir=ckdir)
        resumed = sim.run(
            n_iters=12, checkpoint_every=4, checkpoint_dir=ckdir,
            resume=True, debug=True,
        )
        straight = sim.run(n_iters=12, debug=True)
        assert resumed.densities.shape == (12,)
        assert np.isnan(resumed.densities[:8]).all()
        np.testing.assert_array_equal(
            resumed.densities[8:], straight.densities[8:]
        )


class TestCheckpointedSharded:
    def test_checkpointed_sharded_equals_straight_sharded(self, sim, tmp_path):
        """The checkpointed segment loop must honor devices=4 (round-1
        advisor finding: it used to silently fall back to single-device)."""
        straight = sim.run(n_iters=12, devices=4)
        ck = sim.run(
            n_iters=12, devices=4, checkpoint_every=4,
            checkpoint_dir=tmp_path / "ck",
        )
        np.testing.assert_allclose(
            ck.f_final, straight.f_final, rtol=1e-6, atol=1e-8
        )
        np.testing.assert_allclose(ck.av_vels, straight.av_vels, rtol=1e-6)

    def test_checkpointed_mesh_equals_straight_mesh(self, sim, tmp_path):
        straight = sim.run(n_iters=12, mesh=(2, 2))
        ck = sim.run(
            n_iters=12, mesh=(2, 2), checkpoint_every=6,
            checkpoint_dir=tmp_path / "ck2",
        )
        np.testing.assert_allclose(
            ck.f_final, straight.f_final, rtol=1e-6, atol=1e-8
        )
        np.testing.assert_allclose(ck.av_vels, straight.av_vels, rtol=1e-6)


class TestCheckpointWarmup:
    def test_warmup_compiles_first_segment(self, sim):
        """warmup(checkpoint_every=N) must pre-build the N-step segment
        executable so the segment loop's Compute time stays pure compute
        (VERDICT round-3 item 7)."""
        sim.warmup(n_iters=12, checkpoint_every=5)
        assert (5, False) in sim._compiled

    def test_run_reuses_warmed_segment(self, sim, tmp_path, monkeypatch):
        sim.warmup(n_iters=12, checkpoint_every=4)
        assert (4, False) in sim._compiled
        calls = []
        orig = sim._make_device_runner

        def counting(seg, debug):
            calls.append((seg, debug))
            return orig(seg, debug)

        monkeypatch.setattr(sim, "_make_device_runner", counting)
        ck = sim.run(
            n_iters=12, checkpoint_every=4, checkpoint_dir=tmp_path / "ck"
        )
        # all three segments are length 4: the warmed executable covers
        # every one — no mid-run compile
        assert calls == []
        straight = sim.run(n_iters=12)
        np.testing.assert_array_equal(ck.f_final, straight.f_final)

    def test_warmup_resume_at_target_is_noop(self, sim, tmp_path):
        ckdir = tmp_path / "ck"
        sim.run(n_iters=8, checkpoint_every=8, checkpoint_dir=ckdir)
        before = dict(sim._compiled)
        sim.warmup(n_iters=8, checkpoint_dir=ckdir, resume=True)
        assert sim._compiled == before  # nothing left to run -> no compile

    def test_warmup_resume_skips_corrupt_newest(self, sim, tmp_path):
        """warmup must resolve the resume point the way the run will
        (latest readable snapshot), not via steps()[-1]: with a corrupt
        newest snapshot the two disagree and warmup would pre-compile a
        segment length the run never executes, landing the real compile
        in the Compute phase (round-4 review finding)."""
        ckdir = tmp_path / "ck"
        mgr = CheckpointManager(ckdir)
        f = np.zeros((9, 16, 32), np.float32)
        mgr.save(2, f, np.zeros(2, np.float32))
        mgr.save(10, f, np.zeros(10, np.float32))
        bad = ckdir / "step_00000010.npz"
        bad.write_bytes(bad.read_bytes()[:40])
        with pytest.warns(UserWarning, match="unreadable checkpoint"):
            sim.warmup(
                n_iters=12, checkpoint_every=6, checkpoint_dir=ckdir,
                resume=True,
            )
        # resume point is 2 (the readable snapshot): first segment is
        # min(6, 12-2) = 6.  steps()[-1]=10 would have warmed a 2-step
        # segment instead.
        assert (6, False) in sim._compiled
        assert (2, False) not in sim._compiled
