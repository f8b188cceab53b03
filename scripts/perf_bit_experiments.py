#!/usr/bin/env python
"""Perf experiments on the bitboard rollout (real chip, one process).

Locates the per-step cost of the production path (ops/bitboard.py) at the
headline config by timing semantically-degraded variants:

  full        the production bit_random_rollout
  unroll{K}   same with fori_loop unroll=K (launch-overhead bound?)
  nocomp      union-find merge + flag stamp replaced by a no-op (NOT a valid
              game — perf signal only: bounds the cost of the [P,P,B] compid
              traffic, the only unpacked board in the bit engine)
  nosample    fixed action stream (bounds sampling cost)
  batch*      batch scaling at n=12

Everything compiles in one process to amortise remote compiles.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import functools

import jax
import jax.numpy as jnp
import numpy as np

from twixt_for_open_spiel_tpu.ops import bitboard as bb
from twixt_for_open_spiel_tpu.ops import geometry as geo

_U32 = jnp.uint32


def _readback(out):
    leaves = jax.tree_util.tree_leaves(out)
    return np.asarray(leaves[-1]).ravel()[0]


def timeit(fn, *args, reps=3):
    out = fn(*args)
    _readback(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _readback(out)
    return (time.perf_counter() - t0) / reps


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def rollout_unroll(seed, board_size, num_steps, unroll, bs):
    batch_shape = bs.current_player.shape
    nenv = 1
    for d in batch_shape:
        nenv *= int(d)
    env = jnp.arange(nenv, dtype=_U32).reshape(batch_shape or ())
    seed = jnp.asarray(seed, _U32)

    def body(i, carry):
        bs, episodes = carry
        noise = bb._hash_u32(
            seed + _U32(2654435761) * (i.astype(_U32) + _U32(1))
        ) + env * _U32(0x9E3779B9)
        actions = bb.sample_bits(bs, board_size, noise)
        nxt, done, _ = bb.bit_step_auto_reset(bs, actions, board_size)
        return nxt, episodes + jnp.sum(done, dtype=jnp.int32)

    bs, episodes = jax.lax.fori_loop(
        0, num_steps, body, (bs, jnp.int32(0)), unroll=unroll
    )
    return bs, episodes


@functools.partial(jax.jit, static_argnums=(1, 2))
def rollout_nocomp(seed, board_size, num_steps, bs):
    """Rollout skipping the union-find: compid/flags carried unchanged."""
    batch_shape = bs.current_player.shape
    nenv = 1
    for d in batch_shape:
        nenv *= int(d)
    env = jnp.arange(nenv, dtype=_U32).reshape(batch_shape or ())
    seed = jnp.asarray(seed, _U32)

    def body(i, carry):
        bs, episodes = carry
        noise = bb._hash_u32(
            seed + _U32(2654435761) * (i.astype(_U32) + _U32(1))
        ) + env * _U32(0x9E3779B9)
        actions = bb.sample_bits(bs, board_size, noise)
        nxt = bb.step_bits(bs, board_size, actions)
        # drop the relabelled compid/flags: carry the old ones (invalid!)
        nxt = nxt._replace(compid=bs.compid, flags=bs.flags)
        done = nxt.result != geo.RESULT_OPEN
        init = bb.bit_reset(board_size)
        nxt = jax.tree_util.tree_map(
            lambda a, b: jnp.where(
                done, a.reshape(a.shape + (1,) * (b.ndim - a.ndim)), b
            ),
            init,
            nxt,
        )
        return nxt, episodes + jnp.sum(done, dtype=jnp.int32)

    bs, episodes = jax.lax.fori_loop(0, num_steps, body, (bs, jnp.int32(0)))
    return bs, episodes


@functools.partial(jax.jit, static_argnums=(1, 2))
def rollout_nosample(seed, board_size, num_steps, bs):
    """Fixed (step-dependent, env-independent) action stream."""
    seed = jnp.asarray(seed, _U32)
    A = board_size * board_size

    def body(i, carry):
        bs, episodes = carry
        a = (bb._hash_u32(seed + i.astype(_U32)) % _U32(A)).astype(jnp.int32)
        actions = jnp.broadcast_to(a, bs.current_player.shape)
        nxt, done, _ = bb.bit_step_auto_reset(bs, actions, board_size)
        return nxt, episodes + jnp.sum(done, dtype=jnp.int32)

    bs, episodes = jax.lax.fori_loop(0, num_steps, body, (bs, jnp.int32(0)))
    return bs, episodes


def main():
    print(f"backend={jax.default_backend()}", file=sys.stderr)
    n, batch = 12, 4096
    steps = 20 if jax.default_backend() == "cpu" else 1000
    bs = bb.bit_reset(n, batch)

    def report(name, dt, b=batch):
        rate = b * steps / dt
        print(f"{name:>16}: {rate/1e6:8.1f}M env-steps/s  ({dt*1e3:.1f}ms)")

    dt = timeit(lambda: bb.bit_random_rollout(0, n, steps, bs))
    report("full", dt)
    for unroll in (2, 4):
        dtu = timeit(lambda u=unroll: rollout_unroll(0, n, steps, u, bs))
        report(f"unroll{unroll}", dtu)
    dtn = timeit(lambda: rollout_nocomp(0, n, steps, bs))
    report("nocomp", dtn)
    dts = timeit(lambda: rollout_nosample(0, n, steps, bs))
    report("nosample", dts)
    for b in (8192, 16384, 32768):
        bsb = bb.bit_reset(n, b)
        dtb = timeit(lambda s=bsb: bb.bit_random_rollout(0, n, steps, s))
        report(f"batch{b}", dtb, b)


if __name__ == "__main__":
    main()
