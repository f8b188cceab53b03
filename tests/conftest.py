"""Test configuration: run everything on a virtual 8-device CPU mesh.

Correctness / parity tests are CPU per BASELINE.json:7; sharding tests use
the 8 virtual host devices (SURVEY.md §4, multi-node note).  The platform
is forced to CPU even on a machine with a GPU, so the suite is the same
everywhere; tests marked ``gpu`` (tests/test_gpu.py) reach the card from a
child process of their own.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

assert jax.default_backend() == "cpu", jax.default_backend()
assert jax.device_count() == 8, jax.devices()
