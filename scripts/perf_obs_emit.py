#!/usr/bin/env python
"""Config-4 emission-layout experiment (round-3).

The round-2 bf16 row sat at ~31% of its HBM write floor because XLA pads
the [.., 24, 22] bf16 minor dims onto (16, 128) physical tiles; the first
round-3 packed row ([T, B, 12, P] u32) was SLOWER still — minor dim P=30
occupies 30 of 128 lanes, so the scan's per-step writes are ~4x padded
AND pay a cross-lane transpose.  This script measures every candidate
layout at the config-4 shape (board 24, batch 8192, 16-step chunks) plus
the no-obs XLA step ceiling:

  none        no observation (the transition's own ceiling)
  lanes       [T, 12, P, B] u32  — engine lane-major, no transpose, minor
                                   dim = env batch (zero lane padding)
  batchmajor  [T, B, 12, P] u32  — round-3's first attempt
  flat        [T, B, 12*P]   u32 — batch-major, minor dim coalesced
  bf16        [T, B, 12, n, n-2] bf16 — round-2's row

Run: python scripts/perf_obs_emit.py
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

from twixt_for_open_spiel_tpu.ops.bitboard import (
    _hash_u32,
    bit_reset,
    bit_step_auto_reset,
    sample_bits,
)
from twixt_for_open_spiel_tpu.ops.observe import (
    bit_observation_nchw,
    bit_observation_packed,
    bit_observation_packed_lanes,
)

N = 24
BATCH = 8192
CHUNK = 16
_U32 = jnp.uint32


def make_run(variant):
    def body(carry, i):
        bs, episodes, seed = carry
        if variant == "none":
            obs = jnp.int32(0)
        elif variant == "lanes":
            obs = bit_observation_packed_lanes(bs, N)
        elif variant == "batchmajor":
            obs = bit_observation_packed(bs, N)
        elif variant == "flat":
            pk = bit_observation_packed(bs, N)
            obs = pk.reshape(pk.shape[0], -1)
        elif variant == "lanesflat":
            pk = bit_observation_packed_lanes(bs, N)
            obs = pk.reshape(-1, pk.shape[-1])  # [12*P, B], no transpose
        elif variant == "bf16":
            obs = bit_observation_nchw(bs, N, jnp.bfloat16)
        env = jnp.arange(BATCH, dtype=_U32)
        noise = _hash_u32(
            seed + _U32(2654435761) * (i.astype(_U32) + _U32(1))
        ) + env * _U32(0x9E3779B9)
        actions = sample_bits(bs, N, noise)
        nxt, done, _ = bit_step_auto_reset(bs, actions, N)
        return (nxt, episodes + jnp.sum(done, dtype=jnp.int32), seed), obs

    @jax.jit
    def run(seed, bs):
        (bs, episodes, _), obs = jax.lax.scan(
            body,
            (bs, jnp.int32(0), jnp.asarray(seed, _U32)),
            jnp.arange(CHUNK),
        )
        return bs, episodes, obs

    return run


def main():
    print(f"backend={jax.default_backend()}", file=sys.stderr)
    state0 = bit_reset(N, BATCH)
    for variant in ("none", "lanesflat", "flat"):
        run = make_run(variant)
        st, ep, obs = run(0, state0)
        shape = getattr(obs, "shape", ())
        np.asarray(ep)
        launches = 256 if variant in ("none", "lanes") else 64
        st = state0
        t0 = time.perf_counter()
        for i in range(launches):
            st, ep, obs = run(i + 1, st)
            del obs
        np.asarray(ep)
        dt = time.perf_counter() - t0
        rate = BATCH * CHUNK * launches / dt
        print(
            f"[obs-emit {variant:10s}] {rate:,.0f} env-steps/s "
            f"({dt:.2f}s, out shape {shape})",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
