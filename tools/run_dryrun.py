#!/usr/bin/env python
"""Run the multi-device dry run: ``dryrun_multichip(N)`` on an
N-virtual-device CPU mesh (default 8).

Usage: python tools/run_dryrun.py [N]   (``make dryrun``)
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={n}"
)

import __graft_entry__  # noqa: E402

__graft_entry__.dryrun_multichip(n)
print(f"dryrun ok at {n} virtual devices")
