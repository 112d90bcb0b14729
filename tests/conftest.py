"""Test config: run JAX on CPU with 8 virtual devices so sharding tests
exercise a multi-device mesh without accelerator hardware (SURVEY.md §4
strategy).  The GPU path is exercised by ``python chip_smoke.py``."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
