"""Golden parity vs the C++ reference algorithm, in-suite.

tools/golden_compare.py renders the SAME generated cover scene through
tools/cpu_floor.cpp (independent C++ implementation of the reference
algorithm, reference src/render.cpp:112-190) and through this
framework, and compares converged block means.  The full north-star
config runs via `make verify`; this small-config run keeps parity
enforced by every test run so it cannot rot silently.
"""
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))


def test_golden_parity_small():
    if shutil.which("g++") is None:  # pragma: no cover
        pytest.skip("no C++ toolchain for the golden oracle")
    import golden_compare

    # 240x135 @ 32spp: ~1M rays through each implementation — small
    # enough for the CPU suite, converged enough for block means.
    assert golden_compare.main(["240", "32", "10"]) == 0


def test_mesh_golden_parity_small():
    """BVH mesh path (through render_auto) vs the C++ floor's BVH render
    of the SAME knot OBJ (small knot)."""
    if shutil.which("g++") is None:  # pragma: no cover
        pytest.skip("no C++ toolchain for the golden oracle")
    import golden_compare

    # 64px @ 16spp on a 768-tri knot: ~65k rays each side.
    assert golden_compare.main(["--mesh", "64", "16", "5", "32", "12"]) == 0
