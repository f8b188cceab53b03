"""Arena CLI: pit two checkpoints (or a checkpoint vs random) head to head.

Batched analogue of evaluating OpenSpiel bots by playing matches
(reference README.md:38-40's mcts_example two-bot loop): a whole batch of
games runs in lockstep on the bitboard engine, one batched MCTS per move
serving both sides (models/arena.py).

Usage:
    python -m twixt_for_open_spiel_tpu.examples.arena \
        --board_size=12 --batch=128 --simulations=64 \
        --ckpt_a=checkpoints/twixt_az [--ckpt_b=checkpoints/twixt_az_old | --random_b] \
        --channels=64 --blocks=4
"""

from __future__ import annotations

import argparse
import sys
import time

import jax

from twixt_for_open_spiel_tpu.models import (
    arena_match,
    create_net,
    init_params,
    make_optimizer,
)
from twixt_for_open_spiel_tpu.utils import serialization
from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--board_size", type=int, default=12)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--simulations", type=int, default=64)
    ap.add_argument("--temp_moves", type=int, default=6)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--ckpt_a", default=None,
                    help="checkpoint dir for side A (fresh init if absent)")
    ap.add_argument("--ckpt_b", default=None,
                    help="checkpoint dir for side B (fresh init if absent)")
    ap.add_argument("--random_b", action="store_true",
                    help="side B plays uniform random legal moves")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    net = create_net(
        args.board_size, channels=args.channels, blocks=args.blocks
    )
    params_a = init_params(net, jax.random.PRNGKey(args.seed))
    params_b = init_params(net, jax.random.PRNGKey(args.seed + 1))
    opt = make_optimizer(1e-3)
    for name, ckpt in (("a", args.ckpt_a), ("b", args.ckpt_b)):
        if not ckpt:
            continue
        params = params_a if name == "a" else params_b
        restored = serialization.restore_training(
            ckpt, params, opt.init(params)
        )
        if restored is None:
            print(f"no checkpoint in {ckpt} for side {name}",
                  file=sys.stderr)
        else:
            p, _, it = restored
            print(f"side {name}: restored {ckpt} @ iteration {it}",
                  file=sys.stderr)
            if name == "a":
                params_a = p
            else:
                params_b = p

    t0 = time.perf_counter()
    out = arena_match(
        params_a,
        params_b,
        jax.random.PRNGKey(args.seed + 2),
        net_apply=net.apply,
        board_size=args.board_size,
        batch=args.batch,
        num_simulations=args.simulations,
        temp_moves=args.temp_moves,
        random_b=args.random_b,
    )
    out = {k: float(v) for k, v in out.items()}
    dt = time.perf_counter() - t0
    print(
        f"A {int(out['a_wins'])} - B {int(out['b_wins'])} "
        f"(draws {int(out['draws'])}) over {int(out['games'])} games, "
        f"{int(out['moves'])} plies -> A score {out['a_score']:.3f} "
        f"[{dt:.1f}s]"
    )


if __name__ == "__main__":
    enable_compile_cache()
    main()
