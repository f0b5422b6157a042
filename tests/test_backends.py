"""The backend choices after the retired kernel tiers: auto | fused |
pipeline | sharded.  Removed names are rejected by the CLI, the model
and bench.py; auto is fused on every platform."""

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.cli import build_parser, main
from advanced_hpc_lbm_tpu.models.d2q9_bgk import BACKENDS, Simulation
from advanced_hpc_lbm_tpu.ops import fused
from advanced_hpc_lbm_tpu.params import LBMParams

REMOVED = ["pallas", "pallas2", "pallask", "resident", "stream"]


def _sim(backend):
    params = LBMParams(8, 8, 2, 10, 0.1, 0.005, 1.85)
    return Simulation(params, np.zeros((8, 8), bool), backend=backend)


def test_choices():
    assert BACKENDS == ("auto", "fused", "pipeline", "sharded")


@pytest.mark.parametrize("name", REMOVED)
def test_cli_rejects_removed_backend(name, capsys):
    with pytest.raises(SystemExit) as e:
        build_parser().parse_args(["a", "b", "--backend", name])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("name", REMOVED)
def test_model_rejects_removed_backend(name):
    with pytest.raises(ValueError, match="unknown backend"):
        _sim(name)


@pytest.mark.parametrize("flag", [["--shard-kernel", "jnp"],
                                  ["--shard-kernel", "pallas"]])
def test_cli_has_no_shard_kernel(flag):
    with pytest.raises(SystemExit):
        main(["a", "b", *flag])


def test_auto_is_fused():
    sim = _sim("auto")
    assert sim.backend == "fused"
    assert sim._step_fn is fused.fused_step


@pytest.mark.parametrize("backend", ["fused", "pipeline", "sharded"])
def test_each_backend_runs(backend):
    res = _sim(backend).run()
    assert res.av_vels.shape == (2,)
    assert np.all(np.isfinite(res.f_final))
