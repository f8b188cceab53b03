#!/usr/bin/env python
"""Ablate the batched MCTS search cost: net vs tree ops vs engine step.

Times on the current backend:
  1. net-only: the policy/value net applied sims+1 times on the full batch
  2. search with the real net evaluator (+ sel/backup iteration counters)
  3. search with a free (zeros) evaluator — tree ops + engine step only
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

from twixt_for_open_spiel_tpu.models import create_net, init_params
from twixt_for_open_spiel_tpu.models.mcts import net_evaluator, search_batch
from twixt_for_open_spiel_tpu.ops.bitboard import bit_reset


def timeit(fn, reps=3):
    out = fn()
    np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]
    return (time.perf_counter() - t0) / reps


def main():
    n, batch, sims = 12, 512, 64
    ch, blocks = 64, 4
    print(f"backend={jax.default_backend()} n={n} batch={batch} sims={sims}")

    net = create_net(n, channels=ch, blocks=blocks)
    params = init_params(net, jax.random.PRNGKey(0))
    bs = bit_reset(n, batch)
    key = jax.random.PRNGKey(1)

    obs = jnp.zeros((batch, 12, n, n - 2), jnp.float32)

    @jax.jit
    def net_only(params, obs):
        def body(i, acc):
            logits, v = net.apply(params, obs)
            return acc + v.sum() + logits.sum()

        return jax.lax.fori_loop(0, sims + 1, body, jnp.float32(0))

    dt = timeit(lambda: net_only(params, obs))
    print(f"net-only ({sims+1} applies):      {dt*1e3:8.1f} ms")

    ev = net_evaluator(net.apply, n)
    p, v, stats = search_batch(
        params, bs, key, evaluator=ev, board_size=n,
        num_simulations=sims, return_stats=True,
    )
    print(
        f"iteration counts: sel={int(stats['sel_iters'])} "
        f"backup={int(stats['backup_iters'])} over {sims} sims"
    )
    dt = timeit(
        lambda: search_batch(
            params, bs, key, evaluator=ev, board_size=n,
            num_simulations=sims,
        )
    )
    print(f"search w/ net evaluator:         {dt*1e3:8.1f} ms")

    def free_evaluator(params, s, key):
        del params, key
        b = s.current_player.shape[-1]
        return (
            jnp.zeros((b, n * n), jnp.float32),
            jnp.zeros((b,), jnp.float32),
        )

    dt = timeit(
        lambda: search_batch(
            params, bs, key, evaluator=free_evaluator, board_size=n,
            num_simulations=sims,
        )
    )
    print(f"search w/ free evaluator:        {dt*1e3:8.1f} ms")


if __name__ == "__main__":
    main()
