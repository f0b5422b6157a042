# Workflow parity with the reference Makefile (targets: all / check / clean,
# check-file selection via variables — reference Makefile:1-25), adapted to
# the Python/JAX engine.  "Building" here = editable install + native codec.

PY ?= python

# deck selection (override like: make run DECK=256x256); decks/ holds
# 256x256, 1024x1024 (with goldens/) and mini_64x64
DECK ?= 1024x1024
PARAMS = decks/$(DECK).params
OBSTACLES = decks/$(DECK).obstacles.dat

.PHONY: all native test multichip run check bench validate smoke clean

all: native
	$(PY) -m pip install -e . --no-deps --no-build-isolation -q

native:
	$(PY) -m advanced_hpc_lbm_tpu.utils.native

test: multichip
	$(PY) -m pytest tests/ -x -q -m "not slow"

# the multi-device dry run must pass in a fresh process
multichip:
	$(PY) -c "from __graft_entry__ import dryrun_multichip; \
	dryrun_multichip(8); print('multichip dryrun OK')"

run:
	$(PY) -m advanced_hpc_lbm_tpu $(PARAMS) $(OBSTACLES)

# the reference's `make check` contract on the decks with goldens (256x256,
# 1024x1024): run the deck through the CLI, check its final state against
# goldens/ at 1% and its Reynolds number
check:
	$(PY) scripts/validate_all.py --decks $(DECK)

validate:
	$(PY) scripts/validate_all.py

# headline single-size JSON line (needs a GPU)
bench:
	$(PY) bench.py

# the quickest proof that the solver runs on the GPU (one card)
smoke:
	$(PY) chip_smoke.py

clean:
	rm -f final_state.dat av_vels.dat final_state.png final_state.pgm
	rm -f native/libfastio.so
