#!/usr/bin/env python
"""A/B the 13-plane obs+legal wire emission forms at the config-4 shape.

The round-4 Sample wire appends the mover's legal plane to the packed obs
words.  The first implementation transposed the obs stack and the legal
plane SEPARATELY and concatenated batch-leading inside the scan; this
script races it against a single-transpose form (stack 13 lane-major
planes, one [13,P,B] -> [B,13,P] transpose) and the round-3 12-plane
baseline, to locate the emission regression seen in perf_obs_dma.py's
XLA row.
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
    bit_observation_packed,
    bit_observation_packed_lanes,
)

N, BATCH, CHUNK = 24, 8192, 16
_U32 = jnp.uint32


def make_run(form):
    def body(carry, i):
        bs, seed = carry
        player = jnp.clip(bs.current_player, 0, 1)
        if form == "none":
            obs = bs.move_counter[:, None].astype(_U32)
        elif form == "12":
            pk = bit_observation_packed(bs, N)
            obs = pk.reshape(pk.shape[0], -1)
        elif form == "13-two-transpose":
            pk = bit_observation_packed(bs, N)
            legal_words = jnp.where(
                player[None, :] == 0, bs.legal[0], bs.legal[1]
            ).T
            obs = jnp.concatenate(
                [pk.reshape(pk.shape[0], -1), legal_words], axis=-1
            )
        elif form == "13-one-transpose":
            stack = bit_observation_packed_lanes(bs, N)  # [12, P, B]
            legal_words = jnp.where(
                player[None, :] == 0, bs.legal[0], bs.legal[1]
            )
            full = jnp.concatenate([stack, legal_words[None]], axis=0)
            obs = jnp.transpose(full, (2, 0, 1)).reshape(
                full.shape[2], -1
            )  # [B, 13*P]
        elif form == "13-lane-major":
            stack = bit_observation_packed_lanes(bs, N)  # [12, P, B]
            legal_words = jnp.where(
                player[None, :] == 0, bs.legal[0], bs.legal[1]
            )
            full = jnp.concatenate([stack, legal_words[None]], axis=0)
            obs = full.reshape(-1, full.shape[2])  # [13*P, B]: B minor
        elif form == "12+legal-2out":
            pk = bit_observation_packed(bs, N)
            legal_words = jnp.where(
                player[None, :] == 0, bs.legal[0], bs.legal[1]
            ).T
            obs = (pk.reshape(pk.shape[0], -1), legal_words)
        elif form == "12+legal-lane-2out":
            pk = bit_observation_packed(bs, N)
            legal_words = jnp.where(
                player[None, :] == 0, bs.legal[0], bs.legal[1]
            )  # [P, B]: env lanes minor, dense
            obs = (pk.reshape(pk.shape[0], -1), legal_words)
        elif form == "12+stowaway":
            # the round-5 wire: legal plane riding in the obs words'
            # free low bits — ONE dense [B, 12*P] output
            from twixt_for_open_spiel_tpu.ops.observe import (
                bit_observation_packed_with_legal,
            )

            obs = bit_observation_packed_with_legal(bs, N)
        env = jnp.arange(BATCH, dtype=_U32)
        noise = _hash_u32(
            seed + _U32(2654435761) * (i.astype(_U32) + _U32(1))
        ) + env * _U32(0x9E3779B9)
        a = sample_bits(bs, N, noise)
        nxt, done, _ = bit_step_auto_reset(bs, a, N)
        return (nxt, seed), obs

    @jax.jit
    def run(seed, bs):
        (bs, _), obs = jax.lax.scan(
            body, (bs, jnp.asarray(seed, _U32)), jnp.arange(CHUNK)
        )
        return bs, obs

    return run


def main():
    print(f"backend={jax.default_backend()} n={N} batch={BATCH} "
          f"chunk={CHUNK}")
    bs0 = bit_reset(N, BATCH)
    for form in (
        "none", "12", "12+stowaway", "13-two-transpose",
        "13-one-transpose", "13-lane-major", "12+legal-2out",
        "12+legal-lane-2out",
    ):
        run = make_run(form)
        bs, obs = run(0, bs0)
        np.asarray(bs.move_counter)[0]
        for launches in (40, 150):
            st = bs0
            t0 = time.perf_counter()
            for i in range(launches):
                st, obs = run(i + 1, st)
                del obs
            np.asarray(st.move_counter)[0]
            dt = time.perf_counter() - t0
            rate = BATCH * CHUNK * launches / dt
            print(f"  {form:<20s} launches={launches:<4d} "
                  f"{rate/1e6:7.1f}M env-steps/s", flush=True)


if __name__ == "__main__":
    main()
