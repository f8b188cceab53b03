#!/usr/bin/env python
"""Op-level attribution of the sims-axis cost growth (round-4 verdict #3).

Round 3/4 measured per-sim self-play cost growing 574 -> 2300 us over
64 -> 512 sims (4x over an 8x budget) with only an unprofiled narrative
("deeper walks, wider dense passes").  This script names the dominant
term and closes the loop on one mitigation, both IN SITU:

  1. isolates ``_gather_node_state`` — the per-simulation leaf-state
     fetch — in both forms (dense one-hot select-and-reduce, whose cost
     is LINEAR in nodes because it reads every slot's buffers; and the
     per-element take_along_axis gather, constant in nodes) at each tree
     size, two-trip-count slope methodology (docs/PERF.md §Measurement);
  2. runs the FULL self-play chunk at each sims budget with the
     crossover forced each way (mcts._DENSE_GATHER_MAX_NODES flipped
     before trace), so the winner is decided by the end metric — the
     discipline the round-4 uprior-retire episode established.

Analytic check: at board 12, B=512, the node-state buffers are
(16 planes x P=18 u32 + P^2 i16 + 5 i32) x B per node ~= 0.94 MB/node,
so a 513-node dense fetch streams ~480 MB/sim vs ~0.94 MB fetched by the
gather — the dense form's read IS the superlinear term if the in-situ
rows move accordingly.

Usage (real chip): python scripts/perf_sims_axis.py [--quick]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np


def time_launches(fn, args, launches, sync):
    """Median of 3 trials; each trial = ``launches`` dependent launches,
    ONE readback at the end."""
    out = fn(*args)
    sync(out)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        o = out
        for _ in range(launches):
            o = fn(*args)
        sync(o)
        ts.append((time.perf_counter() - t0) / launches)
    return float(np.median(ts))


def bench_gather_isolated(n, batch, sims_list, quick):
    """_gather_node_state alone, dense vs gather, per tree size."""
    from twixt_for_open_spiel_tpu.models import mcts
    from twixt_for_open_spiel_tpu.ops.bitboard import bit_reset

    print("### _gather_node_state isolated (us/call)", flush=True)
    print(f"{'nodes':>6} {'dense':>8} {'gather':>8}")
    bs = bit_reset(n, batch)
    for sims in sims_list:
        nodes = sims + 1
        tree = mcts._init_tree(
            bs, batch, nodes, n * n,
            jnp.zeros((batch,)), jnp.zeros((batch, n * n)),
            use_amask=False,
        )
        node = (
            (jnp.arange(batch, dtype=jnp.uint32) * jnp.uint32(2654435761))
            % jnp.uint32(nodes)
        ).astype(jnp.int32)
        rows = {}
        for label, maxn in (("dense", 10 ** 9), ("gather", 0)):
            orig = mcts._DENSE_GATHER_MAX_NODES
            mcts._DENSE_GATHER_MAX_NODES = maxn
            try:
                jax.clear_caches()

                @jax.jit
                def fetch(tree, node):
                    st = mcts._gather_node_state(tree, node)
                    # reduce to a scalar so nothing dead-codes away
                    return st.red.astype(jnp.uint32).sum() + node.sum().astype(jnp.uint32)

                t = time_launches(
                    fetch, (tree, node), 8 if quick else 60,
                    lambda o: np.asarray(o),
                )
                rows[label] = t * 1e6
            finally:
                mcts._DENSE_GATHER_MAX_NODES = orig
        print(f"{nodes:>6} {rows['dense']:>8.1f} {rows['gather']:>8.1f}",
              flush=True)
    jax.clear_caches()


def bench_in_situ(n, batch, sims_list, chunk, channels, blocks, quick):
    """Full selfplay_chunk us/sim with the crossover forced each way."""
    from twixt_for_open_spiel_tpu.models import (
        create_net, init_params, selfplay_chunk,
    )
    from twixt_for_open_spiel_tpu.models import mcts
    from twixt_for_open_spiel_tpu.ops.bitboard import bit_reset

    net = create_net(n, channels=channels, blocks=blocks)
    params = init_params(net, jax.random.PRNGKey(0))
    bs0 = bit_reset(n, batch)
    key = jax.random.PRNGKey(1)
    print(f"### selfplay_chunk in situ (board {n}, B={batch}, "
          f"chunk {chunk}; us/sim = t / (chunk*sims))", flush=True)
    print(f"{'sims':>5} {'dense us/sim':>13} {'gather us/sim':>14}")
    for sims in sims_list:
        rows = {}
        for label, maxn in (("dense", 10 ** 9), ("gather", 0)):
            orig = mcts._DENSE_GATHER_MAX_NODES
            mcts._DENSE_GATHER_MAX_NODES = maxn
            try:
                jax.clear_caches()

                def run(state, k):
                    return selfplay_chunk(
                        params, state, k,
                        net_apply=net.apply, board_size=n,
                        num_steps=chunk, num_simulations=sims,
                    )

                def sync(out):
                    st, sample = out
                    np.asarray(sample.weight[-1, :1])

                t = time_launches(
                    run, (bs0, key), 2 if quick else 6, sync
                )
                rows[label] = t / (chunk * sims) * 1e6
            finally:
                mcts._DENSE_GATHER_MAX_NODES = orig
        print(f"{sims:>5} {rows['dense']:>13.0f} {rows['gather']:>14.0f}",
              flush=True)
    jax.clear_caches()


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--board_size", type=int, default=12)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--sims", default="64,128,256,512")
    ap.add_argument("--quick", action="store_true",
                    help="tiny CPU config to validate the harness")
    ap.add_argument("--skip_isolated", action="store_true")
    args = ap.parse_args()

    if args.quick:
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        try:
            jax.extend.backend.clear_backends()
        except Exception:
            pass
        args.board_size, args.batch, args.chunk = 5, 16, 2
        args.channels, args.blocks = 16, 1
        args.sims = "8,16"

    sims_list = [int(s) for s in args.sims.split(",")]
    print(f"backend={jax.default_backend()} n={args.board_size} "
          f"B={args.batch}", flush=True)
    if not args.skip_isolated:
        bench_gather_isolated(
            args.board_size, args.batch, sims_list, args.quick
        )
    bench_in_situ(
        args.board_size, args.batch, sims_list, args.chunk,
        args.channels, args.blocks, args.quick,
    )


if __name__ == "__main__":
    main()
