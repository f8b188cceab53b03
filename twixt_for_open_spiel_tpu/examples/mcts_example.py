"""MCTS example runner.

Mirror of OpenSpiel's ``mcts_example`` invocations (reference
README.md:38-40):

    python -m twixt_for_open_spiel_tpu.examples.mcts_example \
        --game="twixt(board_size=12)"
    python -m twixt_for_open_spiel_tpu.examples.mcts_example --game=twixt \
        --player1=mcts --player2=mcts --max_simulations=200 \
        --rollout_count=4 --verbose=true

Players: "mcts" (jitted batched-tree MCTS with the random-rollout leaf
evaluator — the vanilla-MCTS mode matching OpenSpiel's example) or
"random".  The search itself is the device-resident models/mcts.py engine run
at batch 1.
"""

from __future__ import annotations

import argparse
import random

import jax
import numpy as np

from twixt_for_open_spiel_tpu.game import load_game
from twixt_for_open_spiel_tpu.models import mcts
from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache


def make_mcts_player(board_size, max_simulations, rollout_count, seed):
    evaluator = mcts.rollout_evaluator(board_size, rollout_count)
    key_holder = {"key": jax.random.PRNGKey(seed)}

    def play(state):
        key_holder["key"], k = jax.random.split(key_holder["key"])
        states = jax.tree_util.tree_map(
            lambda x: x[..., None], state.tensor_state
        )
        probs, root_q = mcts.batched_search(
            None,
            states,
            k,
            evaluator=evaluator,
            board_size=board_size,
            num_simulations=max_simulations,
        )
        return int(np.asarray(probs)[0].argmax()), float(root_q[0])

    return play


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--game", default="twixt")
    ap.add_argument("--player1", default="mcts", choices=["mcts", "random"])
    ap.add_argument("--player2", default="random", choices=["mcts", "random"])
    ap.add_argument("--max_simulations", type=int, default=100)
    ap.add_argument("--rollout_count", type=int, default=1)
    ap.add_argument("--verbose", default="false")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    verbose = str(args.verbose).lower() in ("1", "true", "yes")

    game = load_game(args.game)
    n = game.board_size
    rng = random.Random(args.seed)
    bots = []
    for i, kind in enumerate((args.player1, args.player2)):
        if kind == "mcts":
            bots.append(
                make_mcts_player(
                    n, args.max_simulations, args.rollout_count,
                    args.seed + i,
                )
            )
        else:
            bots.append(
                lambda state: (rng.choice(state.legal_actions()), 0.0)
            )

    state = game.new_initial_state()
    while not state.is_terminal():
        p = state.current_player()
        action, q = bots[p](state)
        print(
            f"Player {p} -> {state.action_to_string(p, action)}"
            + (f"  (q={q:+.2f})" if verbose else "")
        )
        state.apply_action(action)
        if verbose:
            print(state.to_string())
    print(state.to_string())
    print(f"Returns: {state.returns()}")


if __name__ == "__main__":
    enable_compile_cache()
    main()
