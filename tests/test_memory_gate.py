"""The device-memory fit gate: the limit comes from the device's
``memory_stats()["bytes_limit"]`` (never a guess), and a run whose
compiled executable needs more than that fails with an actionable
message before it allocates anything.  The device is stubbed here."""

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.models import d2q9_bgk
from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation
from advanced_hpc_lbm_tpu.params import LBMParams


class _FakeDevice:
    def __init__(self, platform, stats, kind="NVIDIA H100 80GB HBM3"):
        self.platform = platform
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("limit", [1, 2**30, 63_763_120_128])
def test_gpu_limit_is_bytes_limit(limit):
    dev = _FakeDevice("gpu", {"bytes_limit": limit, "bytes_in_use": 0})
    assert d2q9_bgk._device_hbm_bytes(dev) == limit


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}, {"bytes_limit": 0}])
def test_gpu_without_a_limit_is_an_error(stats):
    with pytest.raises(RuntimeError, match="no memory limit"):
        d2q9_bgk._device_hbm_bytes(_FakeDevice("gpu", stats))


def test_cpu_has_no_gate():
    assert d2q9_bgk._device_hbm_bytes(_FakeDevice("cpu", None)) is None
    assert d2q9_bgk._device_hbm_bytes() is None  # the suite's CPU device


@pytest.fixture()
def sim():
    params = LBMParams(
        nx=32, ny=16, max_iters=6, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((16, 32), dtype=bool)
    mask[0] = mask[-1] = True
    return Simulation(params, mask)


def test_fits_runs(sim, monkeypatch):
    monkeypatch.setattr(d2q9_bgk, "_device_hbm_bytes", lambda: 2**40)
    res = sim.run()
    assert res.av_vels.shape == (6,)


@pytest.mark.parametrize("kwargs", [{}, {"debug": True}, {"devices": 4},
                                    {"mesh": (2, 2)}])
def test_does_not_fit_fails_before_running(sim, monkeypatch, kwargs):
    monkeypatch.setattr(d2q9_bgk, "_device_hbm_bytes", lambda: 1024)
    with pytest.raises(ValueError, match="needs ~.* per device.*--devices N"):
        sim.run(**kwargs)
    with pytest.raises(ValueError, match="exceeding the device's"):
        sim.warmup(**kwargs)


def test_need_is_the_executables_memory_analysis(sim):
    compiled = sim._device_runner(6, False)
    m = compiled.memory_analysis()
    need = d2q9_bgk.executable_peak_bytes(compiled)
    assert need == (
        m.argument_size_in_bytes + m.output_size_in_bytes
        + m.temp_size_in_bytes - m.alias_size_in_bytes
    )
    # at least the state in and out plus the mask
    assert need >= 9 * 4 * 16 * 32 + 16 * 32
