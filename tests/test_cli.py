"""CLI contract tests (in-process, CPU): output block shape, files
written, debug stream, error handling."""

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.cli import build_parser, main


@pytest.fixture()
def tiny_deck(tmp_path):
    params = tmp_path / "tiny.params"
    params.write_text("32\n16\n8\n10\n0.1\n0.005\n1.85\n")
    obst = tmp_path / "obst.dat"
    lines = [f"{x} 0 1" for x in range(32)] + [f"{x} 15 1" for x in range(32)]
    obst.write_text("\n".join(lines) + "\n")
    return params, obst


def run_cli(args, capsys):
    rc = main([str(a) for a in args])
    return rc, capsys.readouterr().out


class TestCLI:
    def test_output_contract(self, tiny_deck, tmp_path, capsys):
        params, obst = tiny_deck
        rc, out = run_cli(
            [params, obst, "--backend", "fused", "--out-dir", tmp_path], capsys
        )
        assert rc == 0
        lines = out.splitlines()
        assert lines[0] == "==done=="
        assert lines[1].startswith("Reynolds number:\t\t")
        float(lines[1].split("\t")[-1])  # parseable %.12E
        for i, phase in enumerate(["Init", "Compute", "Collate", "Total"]):
            assert lines[2 + i].startswith(f"Elapsed {phase} time:")
            assert lines[2 + i].endswith("(s)")
        assert (tmp_path / "final_state.dat").exists()
        av = np.loadtxt(tmp_path / "av_vels.dat", usecols=[1])
        assert av.shape == (8,)

    def test_debug_stream(self, tiny_deck, tmp_path, capsys):
        params, obst = tiny_deck
        rc, out = run_cli(
            [params, obst, "--backend", "fused", "--debug", "--iters", "3",
             "--out-dir", tmp_path],
            capsys,
        )
        assert rc == 0
        assert out.count("==timestep:") == 3
        assert out.count("av velocity:") == 3
        assert out.count("tot density:") == 3
        # density stream is constant (mass conservation)
        dens = [float(l.split()[-1]) for l in out.splitlines() if "tot density" in l]
        np.testing.assert_allclose(dens, dens[0], rtol=1e-5)

    def test_bad_deck_exits_cleanly(self, tmp_path, capsys):
        params = tmp_path / "bad.params"
        params.write_text("not a number\n")
        obst = tmp_path / "o.dat"
        obst.write_text("0 0 1\n")
        rc = main([str(params), str(obst)])
        assert rc == 1

    def test_parser_defaults(self):
        args = build_parser().parse_args(["a", "b"])
        assert args.backend == "auto"
        assert args.checkpoint_every is None
        assert not args.resume


def test_cli_mesh_and_ca_steps(tmp_path):
    """--mesh 2x2 (2-D torus) and --ca-steps 2 (communication-avoiding
    ring) both produce checker-equivalent av histories to the plain run."""
    import numpy as np

    from advanced_hpc_lbm_tpu import cli

    deck = "decks/mini_64x64"
    outs = {}
    for name, extra in (
        ("plain", []),
        ("mesh", ["--mesh", "2x2"]),
        ("ca", ["--devices", "4", "--ca-steps", "2"]),
    ):
        d = tmp_path / name
        d.mkdir()
        rc = cli.main([
            f"{deck}.params", f"{deck}.obstacles.dat",
            "--iters", "20", "--out-dir", str(d), *extra,
        ])
        assert rc == 0
        outs[name] = np.loadtxt(d / "av_vels.dat", usecols=[1])
    np.testing.assert_allclose(outs["mesh"], outs["plain"], rtol=5e-4)
    np.testing.assert_allclose(outs["ca"], outs["plain"], rtol=5e-4)
