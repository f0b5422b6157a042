#!/bin/bash
# Clean-environment build check — parity with the reference's
# check_submission.sh:1-60 (module purge -> make -B -> assert executable).
# Here: fresh venv-less install check + import check + fast test suite.

set -e

cd "$(dirname "$0")/.."

echo "== build (editable install + native codec) =="
python -m pip install -e . --no-deps --no-build-isolation -q
python -m advanced_hpc_lbm_tpu.utils.native || echo "WARN: native codec unavailable (pure-Python fallback active)"

echo "== import check =="
python -c "import advanced_hpc_lbm_tpu as m; print('advanced_hpc_lbm_tpu', m.__version__)"

echo "== CLI check =="
python -m advanced_hpc_lbm_tpu --help > /dev/null

echo "== fast tests =="
python -m pytest tests/ -x -q -m "not slow"

echo "OK: submission checks passed"
echo "NOTE: on a GPU host also run the smoke run and the GPU tests:"
echo "  python chip_smoke.py"
echo "  LBM_TESTS_ON_GPU=1 python -m pytest -m gpu tests/"
