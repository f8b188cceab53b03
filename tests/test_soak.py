"""Wide parity soak (VERDICT round-1 item 4).

Two layers, mirroring the reference's RandomSimTest breadth
(twixt_test.cc:25-29) at framework scale:

1. ``test_bit_replay_matches_native_engine_soak`` — EVERY board size 5-24,
   256 games per size in one batched replay: the native C engine
   (native/engine.c, independently written) generates full uniform-random
   games; the bitboard engine batch-replays them (ops/replay.bit_replay)
   and every final surface (colors, links, blocked bits, border flags,
   result, move counter, swap flag) must agree exactly.
2. ``test_twixtstate_random_sim`` — the OpenSpiel ``RandomSimTest(game,
   100)`` analogue at the TwixTState API level: 100 full random games across
   sizes, asserting State invariants every step (legal list non-empty and
   ascending until terminal, move numbers, zero-sum returns) plus
   clone/serialize round-trips.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from twixt_for_open_spiel_tpu.game.openspiel import load_game
from twixt_for_open_spiel_tpu.native.engine import (
    NativeEngine,
    load_engine,
    random_game,
)
from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.bitboard import to_state
from twixt_for_open_spiel_tpu.ops.replay import bit_replay
from twixt_for_open_spiel_tpu.utils.serialization import deserialize_state

needs_engine = pytest.mark.skipif(
    load_engine() is None, reason="no C compiler available"
)


def _core_flat(arr, n, b):
    """[P, P, B] board array -> flat [n*n] core of env b (x-major, the C
    engine's layout)."""
    return np.asarray(arr)[
        geo.PAD : geo.PAD + n, geo.PAD : geo.PAD + n, b
    ].reshape(n * n)


@needs_engine
@pytest.mark.parametrize("n", list(range(5, 25)))
def test_bit_replay_matches_native_engine_soak(n):
    # 256 full random games per size, replayed in ONE batched bit_replay
    # call (the generator does ~68k games/s and the replay is batched, so
    # breadth is nearly free — round-2 verdict item 7).
    games = 256
    histories, final = [], []
    for gi in range(games):
        acts, res = random_game(n, seed=97 * n + gi)
        eng = NativeEngine(n)
        for a in acts:
            eng.apply(a)
        assert eng.result == res
        histories.append(acts)
        final.append(
            eng.snapshot()
            + (res, eng.move_counter, eng.swapped, eng.current)
        )

    t_max = max(len(h) for h in histories)
    padded = np.full((t_max, games), -1, np.int32)
    for b, h in enumerate(histories):
        padded[: len(h), b] = h
    bs = bit_replay(n, jnp.asarray(padded))
    s = to_state(bs, n)

    result = np.asarray(bs.result)
    move_counter = np.asarray(bs.move_counter)
    swapped = np.asarray(bs.swapped)
    for b in range(games):
        color, links, blocked, flags, res, mc, sw, _cur = final[b]
        np.testing.assert_array_equal(
            _core_flat(s.color, n, b), color, err_msg=f"color game {b}"
        )
        np.testing.assert_array_equal(
            _core_flat(s.links, n, b).astype(np.uint8), links,
            err_msg=f"links game {b}",
        )
        np.testing.assert_array_equal(
            _core_flat(s.blocked, n, b).astype(np.uint8), blocked,
            err_msg=f"blocked game {b}",
        )
        np.testing.assert_array_equal(
            _core_flat(s.flags, n, b).astype(np.uint8), flags,
            err_msg=f"flags game {b}",
        )
        assert int(result[b]) == res
        assert int(move_counter[b]) == mc
        assert bool(swapped[b]) == sw


# 100 full random games at the State-API level (the reference runs
# RandomSimTest(game, 100) at the default size; we spread the same count
# over the size range).
_SIM_GAMES = [(5, 30), (8, 25), (12, 20), (17, 15), (24, 10)]


@pytest.mark.parametrize("n,games", _SIM_GAMES)
def test_twixtstate_random_sim(n, games):
    game = load_game(f"twixt(board_size={n},ansi_color_output=false)")
    rng = random.Random(7000 + n)
    for gi in range(games):
        state = game.new_initial_state()
        steps = 0
        roundtrip_at = rng.randint(2, 3 * n)
        while not state.is_terminal():
            la = state.legal_actions()
            assert la, "non-terminal state must have legal actions"
            assert la == sorted(la), "legal list must be ascending"
            assert state.returns() == [0.0, 0.0]
            # cheap invariants every step
            c = state.clone()
            assert c.history == state.history
            assert c.current_player() == state.current_player()
            # expensive serialize round-trip (full history replay): once
            # mid-game per game
            if steps == roundtrip_at:
                rt = deserialize_state(game, state.serialize())
                assert rt.history == state.history
                assert rt.current_player() == state.current_player()
                assert rt.legal_actions() == la
                assert rt.to_string() == state.to_string()
            state.apply_action(rng.choice(la))
            steps += 1
            assert state.move_number() == steps
        # terminal invariants
        assert state.legal_actions() == []
        assert state.current_player() == geo.TERMINAL_PLAYER_ID
        r = state.returns()
        assert r in ([1.0, -1.0], [-1.0, 1.0], [0.0, 0.0])
        assert sum(r) == 0.0
        rt = deserialize_state(game, state.serialize())
        assert rt.returns() == r and rt.is_terminal()
