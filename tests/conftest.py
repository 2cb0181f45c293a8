"""Test configuration: force an 8-device virtual CPU mesh so every
sharding/collective path is exercised without an accelerator. Must run
before JAX initializes its backends, which conftest import order
guarantees."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# an explicit JAX_PLATFORMS (e.g. "cuda,cpu" for the gpu-marked tests on
# a card) is honoured; otherwise the tests get the virtual CPU mesh
os.environ.setdefault("JAX_PLATFORMS", "cpu")
