"""End-to-end CLI tests (CPU backend via conftest)."""
import os

import numpy as np

from rtow_tpu import cli
from rtow_tpu.utils.ppm import decode_ppm, read_ppm


def test_dry_run(capsys):
    assert cli.main(["--dry-run", "-w", "77"]) == 0
    out = capsys.readouterr().out
    assert "image_width: 77" in out
    assert "Config {" in out


def test_render_cover_to_file(tmp_path):
    out = tmp_path / "c.ppm"
    rc = cli.main([
        "-w", "32", "-s", "2", "-c", "3", "-n", "2", "--static-spheres",
        "-o", str(out),
    ])
    assert rc == 0
    img = read_ppm(open(out))
    assert img.shape == (21, 32, 3)  # 32/1.5 = 21
    lin = decode_ppm(img)
    assert 0.05 < lin.mean() < 1.0
    # Sky at the top should be bright-ish.
    assert lin[0].mean() > 0.3


KNOT_OBJ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "samples", "knot_small.obj")


def test_render_mesh_to_file(tmp_path):
    out = tmp_path / "s.ppm"
    rc = cli.main([
        "-w", "24", "-s", "2", "-c", "2", "-l", KNOT_OBJ,
        "-o", str(out),
    ])
    assert rc == 0
    img = read_ppm(open(out))
    assert img.shape == (16, 24, 3)
    assert np.isfinite(decode_ppm(img)).all()


def test_render_demo_scenes(tmp_path):
    """--lights / --cornell / --checker render end-to-end (jnp, tiny)."""
    for flag, check in [
        # black background somewhere + a bright light somewhere
        ("--lights", lambda lin: lin.min() < 1e-3 and lin.max() > 0.5),
        ("--cornell", lambda lin: lin.max() > 0.5),       # lit interior
        ("--checker", lambda lin: lin[0].mean() > 0.3),   # normal sky
        ("--textures", lambda lin: lin[0].mean() > 0.3),  # normal sky
        ("--smoke", lambda lin: lin.max() > 0.3),         # lit interior
    ]:
        out = tmp_path / f"{flag[2:]}.ppm"
        rc = cli.main([
            flag, "-w", "24", "-s", "2", "-c", "3", "-n", "1",
            "--static-spheres", "-o", str(out),
        ])
        assert rc == 0, flag
        lin = decode_ppm(read_ppm(open(out)))
        assert np.isfinite(lin).all(), flag
        assert check(lin), flag


def test_render_png_output(tmp_path):
    out = tmp_path / "c.png"
    rc = cli.main([
        "-w", "24", "-s", "1", "-c", "2", "-n", "1", "--static-spheres",
        "-o", str(out),
    ])
    assert rc == 0
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (16, 24, 3)
