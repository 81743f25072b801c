"""Two-process jax.distributed bring-up test.

The multi-host claim must rest on the actual init code path, not
just single-process virtual devices: spawn two local CPU processes that
initialize the distributed runtime through parallel.distributed, build
the global (tile, spp) mesh, render a sharded image with a cross-host
psum, and agree bit-exactly on the result (deterministic keys).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.environ["RTOW_ROOT"])

from rtow_tpu.parallel import distributed

rank = int(os.environ["RTOW_RANK"])
distributed.initialize(
    coordinator_address=os.environ["RTOW_COORD"],
    num_processes=2,
    process_id=rank,
)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 2, jax.device_count()
assert distributed.is_primary() == (rank == 0)

import numpy as np
from rtow_tpu.config import Config
from rtow_tpu.models.builders import three_sphere_scene
from rtow_tpu.parallel.mesh import make_mesh
from rtow_tpu.parallel.sharded import render_sharded

scene, cam = three_sphere_scene(aspect_ratio=1.0)
cfg = Config(image_width=16, aspect_ratio=1.0, samples_per_pixel=8,
             max_child_rays=3, n_devices=2)
mesh = make_mesh(2, cfg.samples_per_pixel)
img = render_sharded(scene, cam, cfg, mesh=mesh)
assert np.isfinite(img).all()
# Every process holds the full frame (replicated out_specs psum); the
# result must not depend on which process computes it.
np.save(os.environ["RTOW_OUT"] + f".{rank}.npy", img)
print("WORKER_OK", rank, float(img.mean()))
"""


@pytest.mark.slow
def test_two_process_distributed(tmp_path):
    # One retry: the coordinator handshake can flake when the machine
    # is loaded (worker interpreter boot contends with concurrent
    # device jobs), and a distributed bring-up is inherently racy on a
    # shared CI box.  A persistent failure still fails the test.
    last = None
    for attempt in range(2):
        try:
            _run_two_process(tmp_path, attempt)
            return
        except AssertionError as e:  # pragma: no cover - retry path
            last = e
    raise last


def _run_two_process(tmp_path, attempt):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    out_base = str(tmp_path / f"img{attempt}")
    procs = []
    for rank in range(2):
        env = dict(
            os.environ,
            RTOW_ROOT=ROOT,
            RTOW_RANK=str(rank),
            RTOW_COORD=addr,
            RTOW_OUT=out_base,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=1",
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired as e:  # pragma: no cover
            p.kill()
            raise AssertionError(f"worker timed out: {e}") from e
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
        assert "WORKER_OK" in out
    img0 = np.load(out_base + ".0.npy")
    img1 = np.load(out_base + ".1.npy")
    np.testing.assert_array_equal(img0, img1)
