#!/usr/bin/env python
"""Validate the CHEAP GATE: does a gumbel@16 arena verdict agree with the
puct@64 verdict on real trained checkpoints?

Round 4 measured (docs/PERF.md "Gumbel vs PUCT") that on a STRONG net
Gumbel@16 matches PUCT@64 playing strength — but every training gate still
burned 64-sim PUCT searches.  Before a big-board run leans on
``--arena_search=gumbel`` for its gates, this script replays the gate
matchups of the round-4 board-12/16 training runs (best checkpoint vs its
init params, and best vs uniform-random) with BOTH gate settings and
prints the agreement rows for docs/PERF.md.

Usage (real chip):
    python scripts/arena_gate_agreement.py \
        --ckpt=/tmp/twixt_b12_r4 --board_size=12
    python scripts/arena_gate_agreement.py \
        --ckpt=/tmp/twixt_b16 --board_size=16
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True,
                    help="train_arena_gate checkpoint dir (best/ inside)")
    ap.add_argument("--board_size", type=int, required=True)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0,
                    help="the training run's seed (for the init params)")
    ap.add_argument("--settings", default="gumbel:16,puct:64",
                    help="comma-separated search:sims gate settings")
    args = ap.parse_args()

    from twixt_for_open_spiel_tpu.models import (
        arena_match,
        create_net,
        init_params,
        make_optimizer,
    )
    from twixt_for_open_spiel_tpu.utils import serialization

    n = args.board_size
    net = create_net(n, channels=args.channels, blocks=args.blocks)
    params0 = init_params(net, jax.random.PRNGKey(args.seed))
    opt_like = make_optimizer(1e-3).init(params0)
    best_dir = os.path.join(args.ckpt, "best")
    restored = serialization.restore_training(best_dir, params0, opt_like)
    assert restored is not None, f"no checkpoint at {best_dir}"
    best_params, _, best_it = restored
    print(f"[agree] backend={jax.default_backend()} n={n} "
          f"best_iteration={best_it}", file=sys.stderr)

    key = jax.random.PRNGKey(args.seed + 777)
    for setting in args.settings.split(","):
        search, sims = setting.split(":")
        sims = int(sims)
        for label, random_b in (("vs_init", False), ("vs_random", True)):
            key, k = jax.random.split(key)
            t0 = time.perf_counter()
            tally = arena_match(
                best_params,
                best_params if random_b else params0,
                k,
                net_apply=net.apply,
                board_size=n,
                batch=args.batch,
                num_simulations=sims,
                random_b=random_b,
                search=search,
            )
            tally = {kk: float(np.asarray(v)) for kk, v in tally.items()}
            print(json.dumps({
                "board": n, "gate": label, "search": search, "sims": sims,
                "a_score": tally["a_score"], "a_wins": tally["a_wins"],
                "b_wins": tally["b_wins"], "draws": tally["draws"],
                "games": tally["games"],
                "secs": round(time.perf_counter() - t0, 1),
            }))


if __name__ == "__main__":
    main()
