"""The CPU-side pieces of chip_smoke.py: it refuses to run without a GPU
(exit nonzero, no result line), its last line has the exact format, its
HLO reduction counts the scan body's kernels, and its phases run at tiny
sizes on the CPU mesh."""

import json
import sys

import jax
import pytest

sys.path.insert(0, ".")  # repo root: chip_smoke.py is not in the package
import chip_smoke  # noqa: E402

from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation  # noqa: E402


class _Dev:
    def __init__(self, platform="gpu", kind="NVIDIA H100 80GB HBM3"):
        self.platform = platform
        self.device_kind = kind


def test_no_gpu_exits_nonzero_without_a_result(capsys):
    rc = chip_smoke.main([])
    out = capsys.readouterr()
    assert rc != 0
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_four_without_gpus_exits_nonzero(capsys):
    assert chip_smoke.main(["--four"]) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_is_exact(count):
    line = chip_smoke.result_line([_Dev()] * count)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        f'"kind": "NVIDIA H100 80GB HBM3", "count": {count}}}}}'
    )
    assert json.loads(line)["device"]["count"] == count


def test_scan_body_ops_counts_fusions_of_the_compiled_run():
    params, mask = chip_smoke.bench.build_deck(16, 16, 4)
    compiled = Simulation(params, mask)._device_runner(4, False)
    ops = chip_smoke.scan_body_ops(compiled.as_text())
    assert ops["fusion"] >= 1
    assert "parameter" not in ops and "get-tuple-element" not in ops


def test_scan_body_ops_follows_calls():
    hlo = "\n".join([
        "%body.1 (p: (s32[], f32[4])) -> (s32[], f32[4]) {",
        "  %p = (s32[], f32[4]{0}) parameter(0)",
        "  %c = f32[4]{0} call(%p), to_apply=%command_buffer.2",
        "  ROOT %t = (s32[], f32[4]{0}) tuple(%p, %c)",
        "}",
        "%command_buffer.2 (q: f32[4]) -> f32[4] {",
        "  %f1 = f32[4]{0} fusion(%q), kind=kLoop, calls=%fused.3",
        "  %f2 = f32[4]{0} fusion(%f1), kind=kLoop, calls=%fused.4",
        "  ROOT %cc = f32[4]{0} custom-call(%f2), custom_call_target=\"x\"",
        "}",
        "ENTRY %main (a: f32[4]) -> f32[4] {",
        "  %w = (s32[], f32[4]{0}) while(%a), condition=%cond, body=%body.1",
        "}",
    ])
    ops = chip_smoke.scan_body_ops(hlo)
    assert ops == {"fusion": 2, "custom-call": 1}


def test_oracle_phase_on_the_mini_deck(capsys):
    out = chip_smoke.oracle_phase("mini_64x64", 20)
    assert out["f_abs"] <= chip_smoke.ORACLE_F_ATOL
    assert "[3 oracle]" in capsys.readouterr().out


def test_sharded_phase_on_the_cpu_mesh(capsys):
    assert len(jax.devices()) >= 4
    chip_smoke.sharded_phase(n=48, steps=9)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[sharded]")]
    assert len(lines) == 4  # 1-D and 2x2, ca_steps 1 and 4
