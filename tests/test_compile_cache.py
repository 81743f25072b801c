"""Where the persistent compilation cache goes: JAX's own
``JAX_COMPILATION_CACHE_DIR`` when it is set, else one fixed directory
inside the checkout — never the home directory or a temporary name."""
import os
import subprocess
import sys

import pytest

import rtow_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_dir_is_inside_the_checkout():
    assert rtow_tpu.DEFAULT_COMPILE_CACHE_DIR == os.path.join(ROOT,
                                                              ".jax_cache")


@pytest.mark.parametrize("env_dir", [None, "cache-from-env"])
def test_configured_at_import(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = ROOT
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, rtow_tpu; print(jax.config.jax_compilation_cache_dir)"],
        cwd=tmp_path, env=env, capture_output=True, text=True, check=True,
        timeout=120,
    ).stdout.strip()
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(ROOT, ".jax_cache"))
    assert out == want
