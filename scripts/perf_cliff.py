#!/usr/bin/env python
"""Diagnose the B>512 self-play batch-scaling cliff at the op level.

Round-3 measured per-sim cost jumping 574 -> 1526 us from B=512 -> 1024
(2.7x for 2x batch) and attributed it to "the chip is saturated" with no
profile behind it (round-3 verdict, weak #2).  This script replaces the
assertion with numbers: it times

  * the whole search per-sim cost (slope over TWO simulation budgets of
    the SAME compiled shape family, cancelling fixed costs),
  * each phase of the simulate body in isolation (best-edge pass, node
    state gather, engine step, backup, uprior bookkeeping),
  * the network apply alone across batch sizes (this row also decides
    whether K-leaf evaluation batching can pay: if us/obs does not drop
    with batch, a bigger fused leaf batch cannot amortise anything),

at B=512 and B=1024 (board 12, 64-sim tree shapes), with the two-trip
slope method (docs/PERF.md "Measurement methodology").
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

N = 12
A = N * N
SIMS = 64
K = SIMS + 1
P = N + 6


def force(o):
    return np.asarray(jax.tree_util.tree_leaves(o)[0]).ravel()[0]


def slope(make, lo=200, hi=1000):
    f1, f2 = make(lo), make(hi)
    force(f1())
    force(f2())
    t0 = time.perf_counter(); force(f1()); t1 = time.perf_counter() - t0
    t0 = time.perf_counter(); force(f2()); t2 = time.perf_counter() - t0
    return (t2 - t1) / (hi - lo) * 1e6


def search_per_sim(B, evaluator_kind):
    """Per-sim cost of the real search via the slope over sim budgets."""
    from twixt_for_open_spiel_tpu.models import create_net, init_params
    from twixt_for_open_spiel_tpu.models.mcts import (
        net_evaluator,
        search_batch,
    )
    from twixt_for_open_spiel_tpu.ops.bitboard import bit_reset

    bs = bit_reset(N, B)
    if evaluator_kind == "net":
        net = create_net(N, channels=64, blocks=4)
        params = init_params(net, jax.random.PRNGKey(0))
        ev = net_evaluator(net.apply, N)
    else:
        params = None

        def _uniform(params, obs):
            b = obs.shape[0]
            return (
                jnp.zeros((b, A), jnp.float32),
                jnp.zeros((b,), jnp.float32),
            )

        ev = net_evaluator(_uniform, N)

    def run(sims):
        def f():
            p, q = search_batch(
                params, bs, jax.random.PRNGKey(1),
                evaluator=ev, board_size=N, num_simulations=sims,
            )
            return q.sum()
        return jax.jit(f)

    f1, f2 = run(64), run(192)
    force(f1()); force(f2())
    t0 = time.perf_counter(); force(f1()); t1 = time.perf_counter() - t0
    t0 = time.perf_counter(); force(f2()); t2 = time.perf_counter() - t0
    return (t2 - t1) / 128 * 1e6


def phase_rows(B):
    """Isolated simulate-body phases at tree shapes (board 12, 64 sims)."""
    from twixt_for_open_spiel_tpu.models import mcts
    from twixt_for_open_spiel_tpu.ops.bitboard import (
        bit_reset,
        step_bits,
    )

    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 8)
    bs = bit_reset(N, B)
    tree = mcts._init_tree(
        bs, B, K, A,
        jnp.zeros((B,), jnp.float32),
        jax.random.uniform(ks[0], (B, A)),
        use_amask=True,
    )
    # make a busier tree: random parents/links so passes do real work
    tree = tree._replace(
        parent=jax.random.randint(ks[1], (B, K), -1, K, jnp.int32),
        linked=jax.random.uniform(ks[2], (B, K)) > 0.3,
        visit=jax.random.randint(ks[3], (B, K), 0, 50, jnp.int32),
        value_sum=jax.random.normal(ks[4], (B, K)),
        e_prior=jax.random.uniform(ks[5], (B, K)),
    )
    rows = {}

    def mk_best_edge(trips):
        @jax.jit
        def f():
            def body(i, node):
                a, kid, _ = mcts._best_edge(tree, node, 1.4)
                return jnp.clip(jnp.abs(kid), 0, K - 1)
            return jax.lax.fori_loop(
                0, trips, body, jnp.zeros((B,), jnp.int32)
            ).sum()
        return f

    rows["best_edge pass"] = slope(mk_best_edge)

    def mk_gather_state(trips):
        @jax.jit
        def f():
            def body(i, node):
                st = mcts._gather_node_state(tree, node)
                return jnp.clip(
                    st.move_counter + i, 0, K - 1
                ).astype(jnp.int32)
            return jax.lax.fori_loop(
                0, trips, body, jnp.zeros((B,), jnp.int32)
            ).sum()
        return f

    rows["node state gather (one-hot sum)"] = slope(mk_gather_state)

    def mk_step(trips):
        @jax.jit
        def f():
            # data-dependent action keeps the loop body live (no DCE)
            def body(i, acc):
                a = (acc % (A - 1)).astype(jnp.int32) * 0 + 3 * N + 3
                nxt = step_bits(bs, N, a)
                return acc + nxt.move_counter
            return jax.lax.fori_loop(
                0, trips, body, jnp.zeros((B,), jnp.int32)
            ).sum()
        return f

    rows["engine step_bits"] = slope(mk_step)

    def mk_backup_amask(trips):
        @jax.jit
        def f():
            def body(i, carry):
                visit, vsum = carry
                path = mcts._rows(tree.amask, jnp.full((B,), 5, jnp.int32))
                visit = visit + path.astype(jnp.int32)
                vsum = vsum + jnp.where(path, 0.25, 0.0)
                return visit, vsum
            v, s = jax.lax.fori_loop(
                0, trips, body, (tree.visit, tree.value_sum)
            )
            return s.sum()
        return f

    rows["backup (amask dense)"] = slope(mk_backup_amask)

    def mk_uprior(trips):
        up = tree.uprior

        @jax.jit
        def f():
            def body(i, up):
                flat = up.reshape(B, K * A)
                idx = (jnp.arange(B) % K) * A + (i % A)
                flat = jnp.put_along_axis(
                    flat, idx[:, None], -1.0, axis=1, inplace=False
                )
                return flat.reshape(B, K, A)
            return jax.lax.fori_loop(0, trips, body, up).sum()
        return f

    rows["uprior retire scatter"] = slope(mk_uprior)
    return rows


def net_batch_rows():
    from twixt_for_open_spiel_tpu.models import create_net, init_params

    net = create_net(N, channels=64, blocks=4)
    params = init_params(net, jax.random.PRNGKey(0))
    out = {}
    for B in (512, 1024, 2048, 4096):
        obs = jax.random.bernoulli(
            jax.random.PRNGKey(1), 0.1, (B, 12, N, N - 2)
        ).astype(jnp.float32)

        def mk(trips):
            @jax.jit
            def f():
                def body(i, acc):
                    logits, v = net.apply(params, obs + acc * 0.0)
                    return acc + v.mean()
                return jax.lax.fori_loop(0, trips, body, jnp.float32(0.0))
            return f

        us = slope(mk, 50, 250)
        out[B] = (us, us / B * 1000)
    return out


def main():
    print(f"backend={jax.default_backend()} board={N} sims={SIMS}")
    print("\n== net.apply batch scaling (64ch x 4 blocks, board 12) ==")
    for B, (us, ns_per_obs) in net_batch_rows().items():
        print(f"  B={B:<5d} {us:9.1f} us/apply  {ns_per_obs:8.2f} us/1k-obs")
    for B in (512, 1024):
        print(f"\n== phases at B={B} ==")
        for name, us in phase_rows(B).items():
            print(f"  {name:<38s} {us:9.1f} us/iter")
        print(f"  search per-sim (uniform eval): "
              f"{search_per_sim(B, 'uniform'):9.1f} us")
        print(f"  search per-sim (net eval):     "
              f"{search_per_sim(B, 'net'):9.1f} us")


if __name__ == "__main__":
    main()
