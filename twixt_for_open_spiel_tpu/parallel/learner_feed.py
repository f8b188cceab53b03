"""Sharded self-play -> sharded learner, glued by XLA collectives.

The "env shards feed a sharded learner" path of BASELINE.json:5,11: the
self-play chunk runs env- and search-batched on each device's shard; the
training step runs data-parallel on the same mesh with gradients psum-ed
over the env axis.  All communication is XLA's collectives, which XLA hands
to NCCL on the GPU; nothing is hand-rolled.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from twixt_for_open_spiel_tpu.models.selfplay import (
    Sample,
    accumulate_grads,
    selfplay_chunk,
)
from twixt_for_open_spiel_tpu.ops.bitboard import bit_reset
from twixt_for_open_spiel_tpu.parallel.mesh import (
    ENV_AXIS,
    make_env_mesh,
    trailing_env_specs,
)


def make_distributed_train_step(net_apply, optimizer, mesh=None,
                                microbatch: int = 1):
    """(params, opt_state, sample) -> (params, opt_state, metrics).

    params/opt_state are replicated; sample is sharded on its batch axis
    (dim 1, time-major [T, B, ...]).  Gradient averaging is an explicit
    ``psum`` over the env axis inside shard_map.  ``microbatch`` splits
    each shard's chunk into K equal time-slices with exact gradient
    accumulation (models/selfplay.accumulate_grads) — the big-board
    memory valve; the shard x slice surrogate denominator
    ``max(global_frames, 1) / (nshards * K)`` telescopes through both
    the slice mean and the shard pmean to the exact global gradient.
    """
    mesh = mesh or make_env_mesh()
    sample_spec = Sample(
        obs=P(None, ENV_AXIS),
        policy=P(None, ENV_AXIS),
        value=P(None, ENV_AXIS),
        weight=P(None, ENV_AXIS),
    )

    nshards = mesh.shape[ENV_AXIS]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), sample_spec),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def dist_train_step(params, opt_state, sample):
        # The global objective is
        #   mean_frames(pol_ce) + sum(val_mse * w) / max(sum(w), 1)
        # over the WHOLE batch.  The policy term is a plain mean over
        # equal-sized shards, so pmean of per-shard policy gradients is
        # exact.  The value term is normalised by the GLOBAL finished-
        # frame count (w.sum() varies by shard), so each shard minimises
        # the surrogate  val_num_s / (max(total, 1) / nshards);  pmean of
        # those gradients telescopes to sum_s(grad val_num_s)/max(total,1)
        # — the exact global gradient.  (A per-shard denominator + pmean
        # would weight a shard with one finished episode like a full
        # shard.)  Pinned numerically identical to the local train_step
        # by tests/test_sharding.py::test_dist_train_step_matches_local.
        total = jax.lax.psum(sample.weight.sum(), ENV_AXIS)
        val_denom = jnp.maximum(total, 1.0) / nshards
        grads, metrics = accumulate_grads(
            params, net_apply, sample, val_denom=val_denom,
            microbatch=microbatch,
        )
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.pmean(g, ENV_AXIS), grads
        )
        # with the surrogate denominator the pmean of every metric IS the
        # global value: value_loss pmean = sum_s(val_num_s)/max(total,1)
        metrics = jax.tree_util.tree_map(
            lambda m: jax.lax.pmean(m, ENV_AXIS), metrics
        )
        metrics["train_frames"] = total
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, metrics

    return jax.jit(dist_train_step), mesh


def make_distributed_selfplay(
    net_apply, board_size, num_steps, num_simulations, mesh=None,
    search="puct", temp_moves=10 ** 9,
    dirichlet_alpha=None, dirichlet_frac=0.25,
    value_bootstrap=0.0,
):
    """(params, bitstate, key) -> (bitstate, sample) with env-sharded
    state/sample.  The env state is the bitboard representation throughout
    (ops/bitboard.BitState, env axis trailing on every leaf)."""
    mesh = mesh or make_env_mesh()
    state_spec = trailing_env_specs(bit_reset(board_size, 1))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), state_spec, P()),
        out_specs=(state_spec, Sample(
            obs=P(None, ENV_AXIS),
            policy=P(None, ENV_AXIS),
            value=P(None, ENV_AXIS),
            weight=P(None, ENV_AXIS),
        )),
        check_vma=False,
    )
    def dist_selfplay(params, state, key):
        idx = jax.lax.axis_index(ENV_AXIS)
        key = jax.random.fold_in(key, idx)
        return selfplay_chunk(
            params,
            state,
            key,
            net_apply=net_apply,
            board_size=board_size,
            num_steps=num_steps,
            num_simulations=num_simulations,
            search=search,
            temp_moves=temp_moves,
            dirichlet_alpha=dirichlet_alpha,
            dirichlet_frac=dirichlet_frac,
            value_bootstrap=value_bootstrap,
        )

    return jax.jit(dist_selfplay), mesh
