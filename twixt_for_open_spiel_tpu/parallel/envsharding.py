"""Sharded batched environments: ``shard_map`` of the rollout over the mesh.

Each device steps its local env shard completely independently (environments
never communicate — the batch axis is embarrassingly parallel), so the only
collectives are ``psum`` reductions of episode statistics over the env axis.
This is the multi-host scaling component mandated by BASELINE.json:5,11;
per-device work is constant in the mesh size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from twixt_for_open_spiel_tpu.ops.bitboard import (
    bit_random_rollout,
    bit_reset,
)
from twixt_for_open_spiel_tpu.ops.rollout import batch_reset, random_rollout
from twixt_for_open_spiel_tpu.parallel.mesh import (
    ENV_AXIS,
    make_env_mesh,
    shard_env_pytree,
    trailing_env_specs,
)


def sharded_batch_reset(board_size: int, global_batch: int, mesh=None):
    """Batched initial state with the trailing env axis laid out over the
    mesh."""
    mesh = mesh or make_env_mesh()
    state = batch_reset(board_size, global_batch)
    return shard_env_pytree(state, mesh)


def make_sharded_rollout(board_size: int, num_steps: int, mesh=None):
    """jitted (key, state) -> (state, stats) with env-sharded state.

    Per-device: the plain single-chip rollout on the local shard with a
    device-distinct RNG stream (fold_in on the mesh position); cross-device:
    one psum of the scalar episode counters.
    """
    mesh = mesh or make_env_mesh()
    state_spec = trailing_env_specs(batch_reset(board_size, 1))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), state_spec),
        out_specs=(state_spec, P()),
        check_vma=False,
    )
    def rollout_shard(key, state):
        idx = jax.lax.axis_index(ENV_AXIS)
        key = jax.random.fold_in(key, idx)
        state, stats = random_rollout(key, board_size, num_steps, state)
        stats = {
            "episodes": jax.lax.psum(stats["episodes"], ENV_AXIS),
            "results": jax.lax.psum(stats["results"], ENV_AXIS),
        }
        return state, stats

    return jax.jit(rollout_shard), mesh


def sharded_bit_reset(board_size: int, global_batch: int, mesh=None):
    """Batched initial BitState, env axis laid out over the mesh."""
    mesh = mesh or make_env_mesh()
    return shard_env_pytree(bit_reset(board_size, global_batch), mesh)


def make_sharded_bit_rollout(board_size: int, num_steps: int, mesh=None):
    """jitted (seed, bitstate) -> (bitstate, stats) on the bitboard engine.

    The production throughput path; per-shard RNG streams are decorrelated
    by mixing the mesh position into the u32 counter seed.
    """
    mesh = mesh or make_env_mesh()
    state_spec = trailing_env_specs(bit_reset(board_size, 1))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), state_spec),
        out_specs=(state_spec, P()),
        check_vma=False,
    )
    def rollout_shard(seed, bs):
        idx = jax.lax.axis_index(ENV_AXIS).astype(jnp.uint32)
        seed = jnp.asarray(seed, jnp.uint32) + idx * jnp.uint32(0x01000193)
        bs, stats = bit_random_rollout(seed, board_size, num_steps, bs)
        stats = {
            "episodes": jax.lax.psum(stats["episodes"], ENV_AXIS),
            "results": jax.lax.psum(stats["results"], ENV_AXIS),
        }
        return bs, stats

    return jax.jit(rollout_shard), mesh
