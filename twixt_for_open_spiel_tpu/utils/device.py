"""What a measurement ran on: JAX's devices and the card's power limit.

Every number the benchmark and the smoke check print names its device, so a
CPU run can never be read as a GPU number.
"""

from __future__ import annotations

import os
import subprocess

import jax


def describe(devices=None) -> dict:
    """``{"platform", "kind", "count"}`` of ``devices`` (default: JAX's)."""
    devices = jax.devices() if devices is None else list(devices)
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def nvidia_smi() -> list:
    """``name, power.limit`` of every card, one string each, as
    ``nvidia-smi`` reports them (a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def cpu_rehearsal() -> bool:
    """True when ``JAX_PLATFORMS=cpu`` was set explicitly."""
    return os.environ.get("JAX_PLATFORMS", "").strip() == "cpu"


def require_gpu(devices=None) -> dict:
    """``describe(devices)`` when every device is a GPU, else SystemExit(1)
    (default: JAX's devices)."""
    devices = jax.devices() if devices is None else list(devices)
    if not devices or any(d.platform != "gpu" for d in devices):
        raise SystemExit(f"no GPU: JAX found {[str(d) for d in devices]}")
    return describe(devices)
