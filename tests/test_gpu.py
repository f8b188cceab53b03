"""Checks that need an NVIDIA GPU: ``python -m pytest -m gpu tests/``.

The test process stays on the CPU (tests/conftest.py), so each check runs
in a child process that reaches the card, and compares it there with the
CPU through chip_smoke.py's checks.  Where ``nvidia-smi`` finds no card
the tests skip.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def gpu_env():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no GPU: nvidia-smi finds no card")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    return env


def _run_on_card(env, code):
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, chip_smoke as cs\n"
         "gpu, cpu = jax.devices()[0], jax.devices('cpu')[0]\n"
         "assert gpu.platform == 'gpu', gpu\n" + code],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.gpu
def test_engine_bit_exact_on_gpu(gpu_env):
    _run_on_card(gpu_env,
                 "out = cs.check_rollout_exact(12, 1024, 128, gpu, cpu)\n"
                 "cs.replay_canonical(12, 1024, 128, gpu, out)\n"
                 "cs.check_wire_exact(24, 1024, 8, gpu, cpu)\n")


@pytest.mark.gpu
def test_net_and_search_on_gpu(gpu_env):
    _run_on_card(gpu_env,
                 "cs.check_net(8, 64, 2, 128, gpu, cpu)\n"
                 "cs.check_search(8, 128, 32, gpu, cpu)\n")
