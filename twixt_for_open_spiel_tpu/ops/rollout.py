"""Batched lockstep environments: natively-batched ``step`` + auto-reset +
masked random policies.

This is the framework component the reference does not have (SURVEY.md §2,
"Batched env vectorization"): thousands of games stepping in lockstep on one
device, the unit that `parallel/` shards across a device mesh.  The reference's
random-sim driver loop (RandomSimTest, twixt_test.cc:28) becomes a
``lax.fori_loop`` over the batch-polymorphic transition.

Layout: the env batch is the TRAILING axis of every board-shaped leaf
(``[P, P, B]``; scalar fields are ``[B]``) and ``ops/step.py`` consumes that
layout natively — deliberately NOT via ``vmap``, which moves the mapped axis
to the front of every intermediate and makes the P(=11..30)-sized board dims
minor.  With batch minor, neighbouring envs of one board cell sit next to
each other in memory, so every whole-board op reads and writes contiguous
runs of the batch whatever the board size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.state import (
    State,
    legal_mask_flat,
    reset,
)
from twixt_for_open_spiel_tpu.ops.step import step

# Kept for API clarity: the env batch axis of every State leaf.
BATCH_AXIS = -1


def batch_size(state: State) -> int:
    return state.current_player.shape[-1]


def batch_reset(board_size: int, batch: int) -> State:
    """Batched initial state, env axis trailing on every leaf."""
    s = reset(board_size)
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[..., None], x.shape + (batch,)), s
    )


def env_slice(state: State, e: int) -> State:
    """Extract env ``e`` as an unbatched State (host-side convenience)."""
    return jax.tree_util.tree_map(lambda x: x[..., e], state)


def sample_legal_action(state: State, key, board_size: int) -> jnp.ndarray:
    """Uniform random legal action(s) for the current player(s).

    Batch-polymorphic Gumbel-max over the legal mask: one [A, *B] uniform
    draw, illegal entries masked to -inf, argmax over the action axis.
    """
    p = jnp.clip(state.current_player, 0, 1)
    mask = legal_mask_flat(state, p, board_size)  # [A, *B]
    g = -jnp.log(-jnp.log(
        jax.random.uniform(key, mask.shape, jnp.float32, 1e-7, 1.0)
    ))
    scores = jnp.where(mask, g, -jnp.inf)
    return jnp.argmax(scores, axis=0).astype(jnp.int32)


def step_auto_reset(state: State, action, board_size: int):
    """step(); terminal next-states are replaced by fresh initial states.

    Returns (next_state, terminated, result) where ``terminated``/``result``
    describe the pre-reset transition (for episode accounting).
    """
    nxt = step(state, board_size, action)
    done = nxt.result != geo.RESULT_OPEN
    init = reset(board_size)
    # broadcast the unbatched initial leaves against the (possibly batched)
    # next-state leaves; done is [*B] and aligns on the trailing axes.
    nxt_or_init = jax.tree_util.tree_map(
        lambda a, b: jnp.where(
            done, a.reshape(a.shape + (1,) * (b.ndim - a.ndim)), b
        ),
        init,
        nxt,
    )
    return nxt_or_init, done, nxt.result


def _rollout_body(board_size, state, key, i):
    key_i = jax.random.fold_in(key, i)
    actions = sample_legal_action(state, key_i, board_size)
    return step_auto_reset(state, actions, board_size)


@functools.partial(jax.jit, static_argnums=(1, 2))
def random_rollout(key, board_size: int, num_steps: int, state: State):
    """Run ``num_steps`` lockstep random-policy env steps over the batch.

    Returns (final_state, stats) with episode/result counters — the batched
    equivalent of the reference's 100-game RandomSimTest loop, and the
    workload benchmarked by ``bench.py`` (BASELINE.json configs 2-4).
    """

    def body(i, carry):
        state, episodes, results = carry
        nxt, done, result = _rollout_body(board_size, state, key, i)
        episodes = episodes + jnp.sum(done, dtype=jnp.int32)
        # per-result histogram via one-hot accumulation (vector add, no
        # scatter): results[r] += sum(done & result == r)
        results = results + jnp.stack(
            [
                jnp.sum(done & (result == r), dtype=jnp.int32)
                for r in range(4)
            ]
        )
        return nxt, episodes, results

    episodes0 = jnp.int32(0)
    results0 = jnp.zeros((4,), jnp.int32)
    state, episodes, results = jax.lax.fori_loop(
        0, num_steps, body, (state, episodes0, results0)
    )
    return state, {"episodes": episodes, "results": results}
