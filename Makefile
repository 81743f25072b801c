# Convenience targets mirroring the reference's make UX (reference
# Makefile:16-24: run-release piped a PPM to /tmp; watch-* live-reloaded).
.PHONY: test test-fast lint bench render render-mesh verify inventory floor watch dryrun smoke

# pytest-xdist, whole files per worker (loadfile keeps module-scoped
# fixtures whole).  A crashed worker fails the run.
test: lint
	python -m pytest tests/ -q -n 4 --dist loadfile

test-fast:  ## everything but the two-process distributed test
	python -m pytest tests/ -q -m "not slow" -n 4 --dist loadfile

dryrun:  ## the multi-device dry run on 8 virtual CPU devices
	timeout 2400 python tools/run_dryrun.py 8

lint:  ## enforced lint gate (the reference enforces clang-tidy, .clang-tidy:2)
	python tools/lint.py

bench:
	python bench.py

render:  ## cover scene -> cover.ppm
	python -m rtow_tpu -w 1200 -s 128 --static-spheres -o cover.ppm

render-mesh:  ## the vendored knot OBJ -> knot.ppm
	python -m rtow_tpu -l samples/knot_small.obj -w 400 -s 64 -o knot.ppm

verify:  ## golden parity vs the C++ reference algorithm
	python tools/golden_compare.py

inventory:  ## SURVEY §2 component coverage gate
	python tools/inventory_check.py

floor:  ## re-measure the CPU reference floor on this machine
	python tools/measure_cpu_floor.py

smoke:  ## the GPU smoke test (one card; --cards 4 for the sharded paths)
	python chip_smoke.py

watch:  ## live-reload dev loop (reference Makefile:16-18 entr+feh analogue)
	python tools/watch.py
