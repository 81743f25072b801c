"""``chip_smoke.py``: refuses to run without a GPU, and its phases work at
tiny sizes on the CPU (the four-card phases on four virtual devices)."""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_outside_the_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_device_phase_rejects_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.phase_device(1)


def test_cover_phase():
    out = chip_smoke.phase_cover(width=48, spp=2, depth=3)
    assert out["size"] == "48x27"


def test_parity_phase():
    assert chip_smoke.phase_parity(width=96, spp=16, depth=8)["ok"]


def test_mesh_phase():
    out = chip_smoke.phase_mesh(width=16, spp=2, depth=3, segments=16,
                                rings=12, parity=(48, 16, 5))
    assert out["triangles"] == 384


def test_gather_phase():
    out = chip_smoke.phase_gather(lanes=2048, cover_width=48, segments=16,
                                  rings=12, image_widths=(32, 16))
    assert out["cover"]["fields_differing"] == []
    assert out["knot"]["fields_differing"] == []
    assert out["knot"]["image_identical"]


def test_train_phase():
    out = chip_smoke.phase_train(width=16, height=8, spp=4, depth=2, steps=2)
    assert len(out["losses"]) == 2


def test_sweep_phase_interpret():
    out = chip_smoke.phase_sweep(lanes=1000, cover_width=48, repeats=1,
                                 interpret=True)
    assert out["index_agreement"] > 0.999


def test_sharded_cover_phase_four_devices():
    out = chip_smoke.phase_sharded_cover(cards=4, width=96, spp=8, depth=4)
    assert out["mesh"] == {"tile": 2, "spp": 2}


def test_sharded_train_phase_four_devices():
    out = chip_smoke.phase_sharded_train(cards=4, width=16, height=8, spp=8,
                                         depth=2)
    assert out["loss"] == pytest.approx(out["loss_overlap"], rel=1e-6)
