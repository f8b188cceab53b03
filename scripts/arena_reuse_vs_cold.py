#!/usr/bin/env python
"""Does tree reuse buy playing strength at equal per-move budgets? Measure.

arena_match(reuse_a=True): side A's searches inherit the game tree's
surviving subtree (re-rooted on each played action), side B cold-starts
every move; both spend the same simulations per move, colors alternate by
env.  A trained checkpoint drives both sides (reuse matters most when the
tree is sharp); run per budget.

Usage:
    python scripts/arena_reuse_vs_cold.py --checkpoint=/tmp/twixt_b12_r4/best \
        --board_size=12 --batch=256 --sims=16,64
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
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--board_size", type=int, default=12)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sims", default="16,64")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--temp_moves", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
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
    params_like = init_params(net, jax.random.PRNGKey(0))
    opt_like = make_optimizer(1e-3).init(params_like)
    restored = serialization.restore_training(
        args.checkpoint, params_like, opt_like
    )
    assert restored is not None, f"no checkpoint at {args.checkpoint}"
    params, _, it = restored
    print(f"[reuse-arena] n={n} batch={args.batch} checkpoint_iter={it}",
          file=sys.stderr)

    for sims in (int(s) for s in args.sims.split(",") if s):
        t0 = time.perf_counter()
        out = arena_match(
            params,
            params,
            jax.random.PRNGKey(args.seed),
            net_apply=net.apply,
            board_size=n,
            batch=args.batch,
            num_simulations=sims,
            temp_moves=args.temp_moves,
            reuse_a=True,
        )
        out = {k: float(np.asarray(v)) for k, v in out.items()}
        print(json.dumps({
            "kind": "reuse_vs_cold",
            "sims": sims,
            "a_score": out["a_score"],
            "a_wins": out["a_wins"],
            "b_wins": out["b_wins"],
            "draws": out["draws"],
            "games": out["games"],
            "secs": round(time.perf_counter() - t0, 1),
        }))


if __name__ == "__main__":
    main()
