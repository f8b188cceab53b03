"""Multi-host launch entry point.

The reference is strictly single-process (SURVEY.md §1: "no process/thread/
device boundary anywhere"); scaling to N>=2 hosts is this framework's own
mandate (BASELINE.md north star).  The runtime is JAX's multi-controller
model: every host runs THE SAME program, joins the cluster via
``jax.distributed.initialize``, and from then on single-program code over a
global ``Mesh`` (parallel/mesh.py) runs SPMD across all hosts' cards, with
XLA's collectives (NCCL on the GPU) riding NVLink inside a host and the
network across hosts.

Usage, one command per host (the multi-host front door is
examples/selfplay_train.py, which wires these flags through):

    python -m twixt_for_open_spiel_tpu.examples.selfplay_train \
        --coordinator=10.0.0.1:8476 --num_processes=4 --process_id=$SLURM_PROCID

Nothing is auto-detected: without a coordinator the run is single-process.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

_INITIALIZED = False


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> tuple:
    """Join (or create) the multi-host JAX runtime; idempotent.

    With no arguments this is a no-op for single-process runs unless the
    environment provides a cluster spec in the
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
    variables, which mirror the flags.  Returns
    ``(process_index, process_count)``.
    """
    global _INITIALIZED
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if not _INITIALIZED and coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _INITIALIZED = True
    return jax.process_index(), jax.process_count()
