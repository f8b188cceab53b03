#!/usr/bin/env python
"""Equal-strength-per-simulation test: Gumbel sequential halving vs PUCT
(round-3 verdict item 3).

models/mcts.py's Gumbel docstring cites the literature's "fewer
simulations at equal playing strength"; this script MEASURES it for this
engine/net: a batched asymmetric arena (models/arena.arena_match_asym)
pits the SAME network searching with Gumbel at ``--sims_a`` simulations
against PUCT (no Dirichlet) at ``--sims_b``.  a_score ~= 0.5 at
sims_a < sims_b supports the claim at that ratio; results land in
docs/PERF.md.

Usage (real chip, with the train_arena_gate checkpoint):
    python scripts/arena_gumbel_vs_puct.py --ckpt=/tmp/twixt_az_gate \
        --sims_a=16 --sims_b=64 [--batch=256]
Smoke: python scripts/arena_gumbel_vs_puct.py --quick
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


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--board_size", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sims_a", type=int, default=16,
                    help="Gumbel side's simulation budget")
    ap.add_argument("--sims_b", type=int, default=64,
                    help="PUCT side's simulation budget")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--max_considered", type=int, default=16,
                    help="Gumbel candidate count m")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    if args.quick:
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        try:
            jax.extend.backend.clear_backends()
        except Exception:
            pass
        args.board_size, args.batch = 5, 16
        args.sims_a, args.sims_b = 4, 8
        args.channels, args.blocks = 16, 1

    import numpy as np

    from twixt_for_open_spiel_tpu.models import (
        arena_match_asym,
        create_net,
        init_params,
        make_optimizer,
    )
    from twixt_for_open_spiel_tpu.utils import serialization

    n = args.board_size
    net = create_net(n, channels=args.channels, blocks=args.blocks)
    params = init_params(net, jax.random.PRNGKey(args.seed))
    if args.ckpt:
        opt_state = make_optimizer().init(params)
        restored = serialization.restore_training(
            args.ckpt, params, opt_state
        )
        assert restored is not None, f"no checkpoint at {args.ckpt}"
        params = restored[0]
        print(f"[asym] restored {args.ckpt} @ iter {restored[2]}",
              file=sys.stderr)

    t0 = time.perf_counter()
    tally = arena_match_asym(
        params,
        jax.random.PRNGKey(args.seed + 1),
        net_apply=net.apply,
        board_size=n,
        batch=args.batch,
        sims_a=args.sims_a,
        sims_b=args.sims_b,
        max_considered_a=args.max_considered,
    )
    tally = {k: float(np.asarray(v)) for k, v in tally.items()}
    tally.update(
        kind="gumbel_vs_puct",
        board_size=n,
        sims_gumbel=args.sims_a,
        max_considered=args.max_considered,
        sims_puct=args.sims_b,
        secs=round(time.perf_counter() - t0, 1),
    )
    print(json.dumps(tally))


if __name__ == "__main__":
    main()
