#!/usr/bin/env python
"""Config-5 scaling study: simulation budget and env batch (round-3
verdict items 4+5).

Measures, on the visible device (intended: the one real chip):

  * the SIMS axis — board 12, batch 512, sims in {64, 128, 256, 512}:
    where the search's memory ceiling sits now that backup is a
    parent-chain walk and the tree carries no O(sims^2) state;
  * the BATCH axis — board 12, sims 64, batch in {512, 1024, 2048, 4096}:
    amortising the evaluator floor (net apply was ~330 us at B=512 — 48%
    of per-sim cost in round 2).

Each config times (a) the self-play chunk alone and (b) the full
selfplay->train iteration, with the measurement discipline of
docs/PERF.md §Measurement (warm-up with trainer feedback, several launches
per readback).  Also reports the analytic tree-buffer footprint and the
device's live/peak HBM if the backend exposes memory_stats.

Results land in docs/PERF.md; run manually:
    python scripts/bench_search_scaling.py [--quick]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import numpy as np


def tree_bytes(board_size, batch, sims):
    """Analytic footprint of models/mcts.Tree at these statics."""
    from twixt_for_open_spiel_tpu.ops.state import padded_size

    a = board_size * board_size
    nodes = sims + 1
    p = padded_size(board_size)
    per_node_b = 4 + 4 + 4 + 4 + 4 + 1 + 4 + 1  # visit..linked etc (B,nodes)
    from twixt_for_open_spiel_tpu.models import mcts as _mcts

    total = (
        batch * nodes * a * 4          # uprior f32
        + batch * nodes * per_node_b   # per-node stats
        + batch * a * 4                # root_child
        + nodes * 16 * p * batch * 4   # planes u32
        + nodes * p * p * batch * 2    # compid i16
        + nodes * 5 * batch * 4        # scalars
    )
    if nodes <= _mcts._AMASK_MAX_NODES:  # auto backup allocates the amask
        total += batch * nodes * nodes   # amask bool [B, nodes, nodes]
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--board_size", type=int, default=12)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="tiny CPU config to validate the harness")
    ap.add_argument("--configs", default=None,
                    help="subset as batch:sims pairs, e.g. 512:64,1024:64")
    args = ap.parse_args()

    if args.quick:
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        try:
            jax.extend.backend.clear_backends()
        except Exception:
            pass

    from twixt_for_open_spiel_tpu.models import (
        create_net,
        init_params,
        make_optimizer,
        selfplay_chunk,
        train_step,
    )
    from twixt_for_open_spiel_tpu.ops.bitboard import bit_reset

    n = args.board_size
    chunk = args.chunk
    if args.quick:
        n, chunk = 5, 4
        configs = [(16, 4), (16, 8), (32, 4)]
        channels, blocks = 16, 1
    else:
        configs = [
            (512, 64), (512, 128), (512, 256), (512, 512),
            (1024, 64), (2048, 64), (4096, 64),
        ]
        if args.configs:
            configs = [
                tuple(int(v) for v in c.split(":"))
                for c in args.configs.split(",") if c
            ]
        channels, blocks = args.channels, args.blocks

    print(
        f"[scaling] backend={jax.default_backend()} n={n} chunk={chunk} "
        f"net={channels}x{blocks}",
        file=sys.stderr,
    )
    net = create_net(n, channels=channels, blocks=blocks)
    opt = make_optimizer(1e-3)
    dev = jax.devices()[0]

    for batch, sims in configs:
        params = init_params(net, jax.random.PRNGKey(0))
        opt_state = opt.init(params)
        key = jax.random.PRNGKey(1)
        state = bit_reset(n, batch)

        def sp(params, state, k):
            return selfplay_chunk(
                params, state, k, net_apply=net.apply, board_size=n,
                num_steps=chunk, num_simulations=sims,
            )

        t_c0 = time.perf_counter()
        # warm up with trainer feedback (recompile hazard; docs/PERF.md)
        for i in range(2):
            state, sample = sp(params, state, jax.random.fold_in(key, 90 + i))
            params, opt_state, metrics = train_step(
                params, opt_state, sample, net_apply=net.apply, optimizer=opt
            )
        np.asarray(metrics["loss"])
        compile_s = time.perf_counter() - t_c0

        # (a) selfplay-only
        t0 = time.perf_counter()
        for i in range(args.reps):
            state, sample = sp(params, state, jax.random.fold_in(key, i))
        np.asarray(sample.weight).ravel()[0]
        dt_sp = (time.perf_counter() - t0) / args.reps

        # (b) full selfplay -> train iteration
        t0 = time.perf_counter()
        for i in range(args.reps):
            state, sample = sp(params, state, jax.random.fold_in(key, 50 + i))
            params, opt_state, metrics = train_step(
                params, opt_state, sample, net_apply=net.apply, optimizer=opt
            )
        np.asarray(metrics["loss"])
        dt_full = (time.perf_counter() - t0) / args.reps

        moves = batch * chunk
        mem = ""
        try:
            ms = dev.memory_stats()
            mem = (
                f" hbm_peak={ms.get('peak_bytes_in_use', 0)/2**30:.2f}GiB"
            )
        except Exception:
            pass
        print(
            f"[scaling n={n} batch={batch} sims={sims} chunk={chunk}] "
            f"selfplay {dt_sp*1e3:.0f} ms -> {moves/dt_sp:,.0f} moves/s, "
            f"{moves*sims/dt_sp:,.0f} sims/s | full iter {dt_full*1e3:.0f} ms"
            f" -> {moves/dt_full:,.0f} moves/s | per-sim "
            f"{dt_sp/(chunk*sims)*1e6:.0f} us | tree "
            f"{tree_bytes(n, batch, sims)/2**30:.2f} GiB{mem}"
            f" (warmup+compile {compile_s:.0f}s)",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
