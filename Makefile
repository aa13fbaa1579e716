# Test/benchmark orchestration, mirroring the reference's presubmit
# tiers (reference Makefile:6 -- test / test_gpu / test_examples /
# regtest). Device tiers run on whatever backend JAX selects (a GPU
# where there is one); the unit tier forces the virtual CPU mesh via
# tests/conftest.py.

PY ?= python

presubmit: test examples regtest

# tier 1+2+3 FAST: unit + BC physics + sharded equivalence
# (CPU, virtual 8-device mesh; < 5 min -- run this on every change)
test:
	$(PY) -m pytest tests/ -q -m "not slow"

# the whole suite, slow physics tests included; identical coverage to
# plain `pytest tests/ -q`
test_slow:
	$(PY) -m pytest tests/ -q

# tier 4a: fixed-seed golden reproduction over every example scene
examples:
	$(PY) tests/examples_harness.py

# tier 4b: physics validation against analytic/literature results
# (slow; runs on the device backend -- minutes on a GPU)
regtest:
	$(PY) regtest/channel_loglaw_live.py
	$(PY) regtest/poiseuille.py
	$(PY) regtest/ldc_2d.py
	$(PY) regtest/ldc_3d.py
	$(PY) regtest/sc_phase_sep.py
	$(PY) regtest/drag_coefficient.py
	$(PY) regtest/channel_loglaw.py

# the main path on one GPU (chip_smoke.py --four: four cards)
smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

.PHONY: presubmit test test_slow examples regtest smoke bench
