"""Test configuration: force the CPU backend with 8 virtual devices.

The tests run hermetically on the CPU, with enough virtual devices to
exercise multi-device sharding. Both the env vars and the in-process config
update are set so that an installed GPU plugin is never picked up. Tests
that need the card carry the `gpu` marker and skip here (see README).
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end renders")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips elsewhere")
