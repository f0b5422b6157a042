"""bench.py: the headline JSON contract, the deck it times, and that it
times devices only (no CPU fallback)."""

import json
import sys

import numpy as np
import pytest

sys.path.insert(0, ".")  # repo root: bench.py is not part of the package
import bench  # noqa: E402

from advanced_hpc_lbm_tpu.utils import io as lbm_io  # noqa: E402


def test_headline_json_carries_stability_fields(monkeypatch, capsys):
    """The headline line keeps `value` (the driver's contract) and adds
    best/median/repeats so run-over-run drift is attributable, plus the
    device it ran on."""

    class _FakeDev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(bench, "_device", lambda: _FakeDev())
    monkeypatch.setattr(
        bench, "measure",
        lambda size, iters, backend, repeats: (28.0, 27.5, [0.75, 0.76, 0.77]),
    )
    rc = bench.main(["--iters", "8"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1  # stdout stays one JSON line
    line = json.loads(out[0])
    assert line["value"] == line["best"] == 28.0
    assert line["median"] == 27.5
    assert line["repeats"] == 3
    assert line["unit"] == "GLUPS"
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"}


def test_bench_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no accelerator"):
        bench._device()


def test_build_deck_is_the_1024_reference_geometry():
    params, mask = bench.build_deck(1024, 1024, 20000)
    deck = lbm_io.load_params("decks/1024x1024.params")
    assert (params.accel, params.omega, params.density) == (
        deck.accel, deck.omega, deck.density
    )
    np.testing.assert_array_equal(
        mask, lbm_io.load_obstacles("decks/1024x1024.obstacles.dat", deck)
    )


@pytest.mark.parametrize("backend", ["pallas", "resident", "best"])
def test_removed_backends_are_rejected(backend):
    with pytest.raises(SystemExit):
        bench.main(["--backend", backend])
