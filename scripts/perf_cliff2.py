#!/usr/bin/env python
"""Cliff diagnosis round 2: name the superlinear ops inside the per-sim
eval block, and race candidate fixes for the uprior retire scatter.

perf_cliff.py attributed the B=512 -> 1024 per-sim cost jump to (a) the
eval block around the net (3.15x for 2x batch while net.apply itself is
exactly linear) and (b) the uprior retire scatter (3.6x).  This script
times the eval block's pieces and three retire-scatter forms at
B = 512 / 1024 / 2048 (board 12, 64-sim tree shapes).
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
K = 65


def force(o):
    return np.asarray(jax.tree_util.tree_leaves(o)[0]).ravel()[0]


def slope(make, lo=200, hi=1000):
    f1, f2 = make(lo), make(hi)
    force(f1())
    force(f2())
    t0 = time.perf_counter(); force(f1()); t1 = time.perf_counter() - t0
    t0 = time.perf_counter(); force(f2()); t2 = time.perf_counter() - t0
    return (t2 - t1) / (hi - lo) * 1e6


def rows_for(B):
    from twixt_for_open_spiel_tpu.ops.bitboard import (
        bit_legal_mask_flat,
        bit_reset,
    )
    from twixt_for_open_spiel_tpu.ops.observe import bit_observation_nchw

    bs = bit_reset(N, B)
    key = jax.random.PRNGKey(0)
    out = {}

    def mk_obs(trips):
        @jax.jit
        def f():
            def body(i, acc):
                obs = bit_observation_nchw(bs, N, jnp.float32)
                return acc + obs[:, 0, 0, 0] + i * 0.0
            return jax.lax.fori_loop(
                0, trips, body, jnp.zeros((B,), jnp.float32)
            ).sum()
        return f

    out["bit_observation_nchw"] = slope(mk_obs)

    logits = jax.random.normal(key, (B, A))
    legal_b = jax.random.uniform(jax.random.PRNGKey(1), (B, A)) > 0.4

    def mk_softmax(trips):
        @jax.jit
        def f():
            def body(i, acc):
                pr = jax.nn.softmax(
                    jnp.where(legal_b, logits + acc[:, None] * 0.0, -1e9),
                    axis=-1,
                )
                return acc + pr[:, 0]
            return jax.lax.fori_loop(
                0, trips, body, jnp.zeros((B,), jnp.float32)
            ).sum()
        return f

    out["prior softmax (where+softmax)"] = slope(mk_softmax)

    def mk_legal(trips):
        @jax.jit
        def f():
            def body(i, acc):
                lg = jnp.moveaxis(bit_legal_mask_flat(bs, acc, N), 0, -1)
                return (acc + lg[:, 0]).astype(jnp.int32) % 2
            return jax.lax.fori_loop(
                0, trips, body, jnp.zeros((B,), jnp.int32)
            ).sum()
        return f

    out["legal mask + moveaxis"] = slope(mk_legal)

    up = jax.random.uniform(jax.random.PRNGKey(2), (B, K, A))
    parent = jax.random.randint(jax.random.PRNGKey(3), (B,), 0, K)
    action = jax.random.randint(jax.random.PRNGKey(4), (B,), 0, A)

    def mk_retire_flat(trips):
        @jax.jit
        def f():
            def body(i, up):
                flat = up.reshape(B, K * A)
                flat = jnp.put_along_axis(
                    flat, (parent * A + action)[:, None] + i * 0, -1.0,
                    axis=1, inplace=False,
                )
                return flat.reshape(B, K, A)
            return jax.lax.fori_loop(0, trips, body, up).sum()
        return f

    out["retire: flat put_along_axis (current)"] = slope(mk_retire_flat)

    def mk_retire_3d(trips):
        env = jnp.arange(B)

        @jax.jit
        def f():
            def body(i, up):
                return up.at[env, parent, action + i * 0].set(-1.0)
            return jax.lax.fori_loop(0, trips, body, up).sum()
        return f

    out["retire: direct 3-D scatter"] = slope(mk_retire_3d)

    def mk_retire_mask(trips):
        iota_k = jnp.arange(K, dtype=jnp.int32)[None, :, None]
        iota_a = jnp.arange(A, dtype=jnp.int32)[None, None, :]

        @jax.jit
        def f():
            def body(i, up):
                hit = (iota_k == parent[:, None, None]) & (
                    iota_a == (action + i * 0)[:, None, None]
                )
                return jnp.where(hit, -1.0, up)
            return jax.lax.fori_loop(0, trips, body, up).sum()
        return f

    out["retire: dense where-mask"] = slope(mk_retire_mask)
    return out


def main():
    print(f"backend={jax.default_backend()} board={N} nodes={K}")
    for B in (512, 1024, 2048):
        print(f"\n== B={B} ==")
        for name, us in rows_for(B).items():
            print(f"  {name:<42s} {us:9.1f} us/iter", flush=True)


if __name__ == "__main__":
    main()
