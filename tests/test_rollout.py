"""Batched rollout invariants: lockstep stepping, auto-reset, legality."""

import jax
import jax.numpy as jnp
import numpy as np

from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.rollout import (
    batch_reset,
    env_slice,
    random_rollout,
    sample_legal_action,
    step_auto_reset,
)
from twixt_for_open_spiel_tpu.ops.state import legal_mask_flat


def test_batch_reset_shapes():
    s = batch_reset(5, 16)
    # trailing env axis on every leaf
    assert s.color.shape == (11, 11, 16)
    assert s.legal.shape == (2, 11, 11, 16)
    assert s.current_player.shape == (16,)


def test_sampled_actions_always_legal():
    n, b = 5, 32
    s = batch_reset(n, b)
    key = jax.random.PRNGKey(0)
    for i in range(30):
        keys = jax.random.split(jax.random.fold_in(key, i), b)
        actions = sample_legal_action(s, jax.random.fold_in(key, i), n)
        # every sampled action must be legal for its env's current player
        for e in range(b):
            p = int(s.current_player[e])
            mask = np.asarray(
                legal_mask_flat(
                    env_slice(s, e), p, n
                )
            )
            assert mask[int(actions[e])], (i, e)
        s, done, result = step_auto_reset(s, actions, n)
        # auto-reset: no env is ever left terminal
        assert not np.any(np.asarray(s.result) != geo.RESULT_OPEN)


def test_random_rollout_completes_episodes():
    n, b, steps = 5, 64, 64
    s = batch_reset(n, b)
    final, stats = random_rollout(jax.random.PRNGKey(7), n, steps, s)
    episodes = int(stats["episodes"])
    results = np.asarray(stats["results"])
    assert episodes > 0
    # every finished episode is a win or a draw, never RESULT_OPEN
    assert results[geo.RESULT_OPEN] == 0
    assert results[1:].sum() == episodes
    # post-rollout states remain well-formed
    assert final.color.shape == (11, 11, b)
    assert np.all(np.asarray(final.result) == geo.RESULT_OPEN)


def test_rollout_deterministic_under_seed():
    n, b, steps = 5, 16, 32
    s = batch_reset(n, b)
    f1, st1 = random_rollout(jax.random.PRNGKey(3), n, steps, s)
    f2, st2 = random_rollout(jax.random.PRNGKey(3), n, steps, s)
    assert int(st1["episodes"]) == int(st2["episodes"])
    assert np.array_equal(np.asarray(f1.color), np.asarray(f2.color))
    f3, st3 = random_rollout(jax.random.PRNGKey(4), n, steps, s)
    assert not np.array_equal(np.asarray(f1.color), np.asarray(f3.color))
