"""Device-mesh construction helpers.

The distributed-communication backend of this framework is XLA's
collectives expressed through ``jax.sharding`` (SURVEY.md §5, "Distributed
communication backend"); on the GPU XLA hands them to NCCL.  Nothing like
NCCL/MPI is hand-written: the mesh is the entire transport configuration.

Axis convention:
  * ``env``  — data parallelism over environment batch (and training batch).
The cards of one host are joined all to all by NVLink, so no ordering of
them is better than another.  Across hosts the env axis is laid out
hosts-major, so each host's shard is contiguous over its own cards and only
the per-host partials of an all-reduce cross the network.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


ENV_AXIS = "env"


def hosts_major_order(devices: Sequence) -> list:
    """Order devices hosts-major: each host's cards contiguous, hosts in
    process order, cards in id order within a host.

    For a 1-D env mesh this is the hybrid layout
    (``mesh_utils.create_hybrid_device_mesh`` collapsed to one axis): a
    batch shard's big per-host segment is contiguous over the host's own
    cards, so the env-axis collectives do their large combines over NVLink
    and only the per-host partials cross the network.  Pure function of the
    device list's ``(process_index, id)`` attributes so the multi-host path
    is unit-testable without a cluster (tests/test_sharding.py).
    """
    return sorted(
        devices, key=lambda d: (d.process_index, d.id)
    )


def make_env_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D data mesh over all (or the given) devices (hosts-major when the
    runtime spans multiple processes — see :func:`hosts_major_order`)."""
    devices = list(devices) if devices is not None else jax.devices()
    if jax.process_count() > 1 and len(devices) == jax.device_count():
        return Mesh(np.asarray(hosts_major_order(devices)), (ENV_AXIS,))
    return Mesh(np.asarray(devices), (ENV_AXIS,))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (batch) axis sharded over the env axis."""
    return NamedSharding(mesh, P(ENV_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def trailing_env_spec(ndim: int) -> P:
    """PartitionSpec sharding the trailing axis of an ndim-rank array."""
    return P(*([None] * (ndim - 1) + [ENV_AXIS]))


def trailing_env_specs(batched_tree):
    """Per-leaf PartitionSpecs sharding every leaf's trailing axis — the
    layout used by the batched env state (ops/rollout.py BATCH_AXIS)."""
    return jax.tree_util.tree_map(
        lambda x: trailing_env_spec(jnp_ndim(x)), batched_tree
    )


def jnp_ndim(x) -> int:
    return getattr(x, "ndim", np.ndim(x))


def shard_env_pytree(tree, mesh: Mesh):
    """Place a trailing-axis-batched pytree with the env axis sharded."""
    shardings = jax.tree_util.tree_map(
        lambda x: NamedSharding(mesh, trailing_env_spec(jnp_ndim(x))), tree
    )
    return jax.device_put(tree, shardings)
