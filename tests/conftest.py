"""Test configuration.

Tests run on CPU with 8 virtual XLA devices — the analogue of the
reference's "mpirun -np 8 on one box" testing strategy (SURVEY.md §4).
Must run before jax is imported anywhere.
"""

import os
import sys

if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from foamtpu.core import compile_cache  # noqa: E402

compile_cache.configure()
