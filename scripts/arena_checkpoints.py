#!/usr/bin/env python
"""Head-to-head arena between two saved checkpoints (same net shape).

The cross-gate of training A/Bs (e.g. PUCT-trained vs Gumbel-trained, or
reuse-trained vs baseline): both sides search with the standard PUCT
arena search at the same budget, colors alternating.

    python scripts/arena_checkpoints.py --a=/tmp/a/best --b=/tmp/b/best \
        --board_size=8 --batch=256 --sims=64
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
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", required=True)
    ap.add_argument("--board_size", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sims", type=int, default=64)
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

    def load(path):
        r = serialization.restore_training(path, params_like, opt_like)
        assert r is not None, f"no checkpoint at {path}"
        return r[0], r[2]

    pa, ita = load(args.a)
    pb, itb = load(args.b)
    print(f"[xarena] n={n} A@{ita} ({args.a}) vs B@{itb} ({args.b})",
          file=sys.stderr)
    t0 = time.perf_counter()
    out = arena_match(
        pa, pb, jax.random.PRNGKey(args.seed),
        net_apply=net.apply, board_size=n, batch=args.batch,
        num_simulations=args.sims, temp_moves=args.temp_moves,
    )
    out = {k: float(np.asarray(v)) for k, v in out.items()}
    print(json.dumps({
        "kind": "cross_arena", "a": args.a, "b": args.b,
        "sims": args.sims,
        "a_score": out["a_score"], "a_wins": out["a_wins"],
        "b_wins": out["b_wins"], "draws": out["draws"],
        "games": out["games"],
        "secs": round(time.perf_counter() - t0, 1),
    }))


if __name__ == "__main__":
    main()
