#!/usr/bin/env python
"""Split the self-play bench iteration into its two programs.

Round 4 attributed the 12,484 -> 11,703 moves/s self-play regression to
the legal-plane EMISSION; round 5 removed that emission cost entirely
(the stowaway wire measures bit-for-bit as fast as obs-only at config 4)
yet the bench stayed ~11.6k — so the attribution was wrong.  This script
times selfplay_chunk and train_step SEPARATELY at the bench config to
locate the residual: the legal-set CE + legal decode live in train_step
(the price of the board-12 correctness fix), not in the emission.

Run on the real chip: python scripts/perf_train_split.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import numpy as np


def main():
    from twixt_for_open_spiel_tpu.models import (
        create_net, init_params, make_optimizer, selfplay_chunk, train_step,
    )
    from twixt_for_open_spiel_tpu.ops.bitboard import bit_reset

    n, batch, chunk, sims = 12, 512, 16, 64
    net = create_net(n, channels=64, blocks=4)
    params = init_params(net, jax.random.PRNGKey(0))
    opt = make_optimizer(1e-3)
    opt_state = opt.init(params)
    bs = bit_reset(n, batch)
    key = jax.random.PRNGKey(1)
    print(f"backend={jax.default_backend()} n={n} B={batch} chunk={chunk} "
          f"sims={sims}", flush=True)

    def sp(state, k):
        return selfplay_chunk(
            params, state, k, net_apply=net.apply, board_size=n,
            num_steps=chunk, num_simulations=sims,
        )

    # warm + a fixed sample for the trainer timing
    state, sample = sp(bs, key)
    p2, o2, m = train_step(
        params, opt_state, sample, net_apply=net.apply, optimizer=opt
    )
    np.asarray(m["loss"])

    reps = 6
    t0 = time.perf_counter()
    st = state
    for i in range(reps):
        st, smp = sp(st, jax.random.fold_in(key, i))
    np.asarray(smp.weight[-1, :1])
    dt_sp = (time.perf_counter() - t0) / reps

    t0 = time.perf_counter()
    p_, o_ = params, opt_state
    for i in range(reps):
        p_, o_, m = train_step(
            p_, o_, sample, net_apply=net.apply, optimizer=opt
        )
    np.asarray(m["loss"])
    dt_tr = (time.perf_counter() - t0) / reps

    tot = dt_sp + dt_tr
    print(f"selfplay_chunk: {dt_sp*1e3:7.1f} ms/iter "
          f"({batch*chunk/dt_sp:,.0f} moves/s alone)", flush=True)
    print(f"train_step:     {dt_tr*1e3:7.1f} ms/iter "
          f"({100*dt_tr/tot:.1f}% of the pair)", flush=True)
    print(f"pair:           {tot*1e3:7.1f} ms/iter "
          f"-> {batch*chunk/tot:,.0f} moves/s", flush=True)


if __name__ == "__main__":
    main()
