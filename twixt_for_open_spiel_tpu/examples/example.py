"""Random-game example runner.

Mirror of OpenSpiel's ``example --game=twixt`` invocation (reference
README.md:36, 42): plays one uniformly random game, printing every action
and board state.

Usage:
    python -m twixt_for_open_spiel_tpu.examples.example \
        --game="twixt(board_size=12,ansi_color_output=False)" --seed=0
"""

from __future__ import annotations

import argparse
import random

from twixt_for_open_spiel_tpu.game import load_game
from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--game", default="twixt")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    rng = random.Random(args.seed)
    game = load_game(args.game)
    state = game.new_initial_state()
    print(f"Loaded game: {game}\n")
    while not state.is_terminal():
        player = state.current_player()
        action = rng.choice(state.legal_actions())
        print(
            f"Player {player} sampled action: "
            f"{state.action_to_string(player, action)}"
        )
        state.apply_action(action)
        print(state.to_string())
    returns = state.returns()
    for p in range(game.num_players()):
        print(f"Utility for player {p} is {returns[p]}")


if __name__ == "__main__":
    enable_compile_cache()
    main()
