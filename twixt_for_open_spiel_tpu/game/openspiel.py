"""OpenSpiel-flavoured host API: ``TwixTGame`` / ``TwixTState`` / ``load_game``.

Array-engine analogue of the reference's L3 game adapter and registration
(SURVEY.md C14/C15; reference twixt.h:31-146, twixt.cc:34-145): a thin host
layer over the jitted tensor core in ``ops/``.  State strings, parameter
parsing and the legality gate live here; every transition and observation is
computed by the compiled ``step`` / ``observation`` functions.

Validation failures raise :class:`SpielError` with the reference's exact
fatal-error messages (asserted by reference twixt_test.cc:69,80,88-89,
156-161).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.state import reset, legal_mask_flat
from twixt_for_open_spiel_tpu.ops.step import step as _step
from twixt_for_open_spiel_tpu.ops.observe import observation as _observation
from twixt_for_open_spiel_tpu.game.render import render
from twixt_for_open_spiel_tpu.game.strings import action_to_string


class SpielError(RuntimeError):
    """Analogue of OpenSpiel's SpielFatalError (spiel_utils.h)."""


# --- game-type facts (reference twixt.cc:34-52)
GAME_TYPE = {
    "short_name": "twixt",
    "long_name": "TwixT",
    "dynamics": "SEQUENTIAL",
    "chance_mode": "DETERMINISTIC",
    "information": "PERFECT_INFORMATION",
    "utility": "ZERO_SUM",
    "reward_model": "TERMINAL",
    "max_num_players": 2,
    "min_num_players": 2,
    "provides_information_state_string": True,
    "provides_information_state_tensor": False,
    "provides_observation_string": True,
    "provides_observation_tensor": True,
    "provides_factored_observation_string": False,
    "parameter_specification": ["ansi_color_output", "board_size"],
}

_PARAM_DEFAULTS = {
    "ansi_color_output": geo.DEFAULT_ANSI_COLOR_OUTPUT,
    "board_size": geo.DEFAULT_BOARD_SIZE,
}


class TwixTGame:
    """Game metadata + config (reference TwixTGame, twixt.h:114-146)."""

    def __init__(self, params: Optional[Dict[str, object]] = None):
        params = dict(params or {})
        for key in params:
            if key not in _PARAM_DEFAULTS:
                # message format from OpenSpiel core, asserted by
                # reference twixt_test.cc:88-89
                raise SpielError(
                    f"Unknown parameter '{key}'. Available parameters "
                    "are: ansi_color_output, board_size"
                )
        self.params = {**_PARAM_DEFAULTS, **params}
        self.board_size = int(self.params["board_size"])
        self.ansi_color_output = bool(self.params["ansi_color_output"])
        if not (
            geo.MIN_BOARD_SIZE <= self.board_size <= geo.MAX_BOARD_SIZE
        ):
            # reference twixt.cc:139-144
            raise SpielError(
                f"board_size out of range [{geo.MIN_BOARD_SIZE}.."
                f"{geo.MAX_BOARD_SIZE}]: {self.board_size}"
            )

    # --- reference twixt.h:118-139
    def new_initial_state(self) -> "TwixTState":
        return TwixTState(self)

    def num_distinct_actions(self) -> int:
        return self.board_size * self.board_size

    def num_players(self) -> int:
        return geo.NUM_PLAYERS

    def min_utility(self) -> float:
        return -1.0

    def max_utility(self) -> float:
        return 1.0

    def utility_sum(self) -> float:
        return 0.0

    def observation_tensor_shape(self) -> List[int]:
        return [geo.NUM_PLANES, self.board_size, self.board_size - 2]

    def observation_tensor_size(self) -> int:
        s = self.observation_tensor_shape()
        return s[0] * s[1] * s[2]

    def max_game_length(self) -> int:
        # square - 4 corners + swap move (reference twixt.h:136-139)
        return self.board_size * self.board_size - 4 + 1

    def max_chance_outcomes(self) -> int:
        return 0

    def get_parameters(self) -> Dict[str, object]:
        return dict(self.params)

    def __str__(self) -> str:
        # OpenSpiel prints only non-default params; the golden playthrough
        # records "twixt()" for the default game.
        items = ",".join(
            f"{k}={_param_str(v)}"
            for k, v in sorted(self.params.items())
            if v != _PARAM_DEFAULTS[k]
        )
        return f"twixt({items})"


def _param_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


class TwixTState:
    """One sequential game (reference TwixTState, twixt.h:31-112).

    Thin host wrapper around the jitted tensor core; keeps the action
    history for serialization / replay (the canonical checkpoint-resume
    path, SURVEY.md §5).
    """

    def __init__(self, game: TwixTGame):
        self.game = game
        self._s = reset(game.board_size)
        self.history: List[int] = []

    # --- core accessors
    def current_player(self) -> int:
        return int(self._s.current_player)

    def is_terminal(self) -> bool:
        return int(self._s.result) != geo.RESULT_OPEN

    def legal_actions(self, player: Optional[int] = None) -> List[int]:
        # reference twixt.h:86-90: empty at terminal, else the player's
        # ascending action list.  With an explicit player, OpenSpiel core
        # sequential-game semantics apply (spiel.h LegalActions(Player)):
        # empty unless player == CurrentPlayer(), SPIEL_CHECK on range.
        if player is not None:
            if not 0 <= player < geo.NUM_PLAYERS:
                raise SpielError(
                    f"player >= 0 && player < num_players: {player}"
                )
            if player != self.current_player():
                return []
        if self.is_terminal():
            return []
        p = self.current_player() if player is None else player
        mask = np.asarray(legal_mask_flat(self._s, p, self.game.board_size))
        return [int(a) for a in np.nonzero(mask)[0]]

    def legal_actions_for_player(self, player: int) -> List[int]:
        """The named player's own legal set regardless of whose turn it is
        (the permissive helper the batched APIs use; reference
        Board::GetLegalActions, twixtboard.h:62-64)."""
        if not 0 <= player < geo.NUM_PLAYERS:
            raise SpielError(f"player >= 0 && player < num_players: {player}")
        if self.is_terminal():
            return []
        mask = np.asarray(
            legal_mask_flat(self._s, player, self.game.board_size)
        )
        return [int(a) for a in np.nonzero(mask)[0]]

    def legal_actions_mask(self, player: Optional[int] = None) -> List[int]:
        """0/1 mask over the ``size*size`` action space (OpenSpiel
        ``State::LegalActionsMask``); all-zero at terminal or when
        ``player`` is given and is not the player to move (core spiel.h
        semantics for sequential games)."""
        n = self.game.board_size
        mask = [0] * (n * n)
        for a in self.legal_actions(player):
            mask[a] = 1
        return mask

    def is_chance_node(self) -> bool:
        """Always False: TwixT is deterministic (reference twixt.cc:40,
        ``ChanceMode::kDeterministic``)."""
        return False

    def move_number(self) -> int:
        return len(self.history)

    def num_players(self) -> int:
        return geo.NUM_PLAYERS

    def apply_action(self, action: int) -> None:
        # legality gate (reference twixt.h:93-97)
        if action not in self.legal_actions():
            raise SpielError(f"Not a legal action: {action}")
        self._s = _step(self._s, self.game.board_size, action)
        self.history.append(int(action))

    def undo_action(self, player: int, action: int) -> None:
        """Deliberate no-op (reference twixt.h:84)."""

    def returns(self) -> List[float]:
        r = int(self._s.result)
        if r == geo.RESULT_RED_WIN:
            return [1.0, -1.0]
        if r == geo.RESULT_BLUE_WIN:
            return [-1.0, 1.0]
        return [0.0, 0.0]

    def rewards(self) -> List[float]:
        return self.returns()

    def player_return(self, player: int) -> float:
        return self.returns()[player]

    # --- strings
    def to_string(self) -> str:
        return render(
            self._s.color,
            self._s.links,
            self.game.board_size,
            bool(self._s.swapped),
            int(self._s.result),
            self.game.ansi_color_output,
        )

    def information_state_string(self, player: Optional[int] = None) -> str:
        p = self.current_player() if player is None else player
        if not 0 <= p < geo.NUM_PLAYERS:
            raise SpielError(f"player >= 0 && player < num_players: {p}")
        return self.to_string()

    def observation_string(self, player: Optional[int] = None) -> str:
        return self.information_state_string(player)

    def action_to_string(self, player: int, action: int) -> str:
        return action_to_string(player, action, self.game.board_size)

    def string_legal_actions(self) -> List[str]:
        p = self.current_player()
        return [self.action_to_string(p, a) for a in self.legal_actions()]

    def observation_tensor(self, player: Optional[int] = None) -> np.ndarray:
        p = self.current_player() if player is None else player
        if not 0 <= p < geo.NUM_PLAYERS:
            raise SpielError(f"player >= 0 && player < num_players: {p}")
        return np.asarray(_observation(self._s, self.game.board_size))

    def history_str(self) -> str:
        return ", ".join(str(a) for a in self.history)

    def clone(self) -> "TwixTState":
        c = TwixTState(self.game)
        c._s = self._s  # immutable pytree — structural sharing is a copy
        c.history = list(self.history)
        return c

    def serialize(self) -> str:
        """OpenSpiel ``State::Serialize``: the action history, one per line
        (any state is reconstructible from its action sequence — the
        canonical checkpoint/restore path, SURVEY.md §5)."""
        return "".join(f"{a}\n" for a in self.history)

    # raw tensor state, for the batched/env APIs
    @property
    def tensor_state(self):
        return self._s


_REGISTRY = {"twixt": TwixTGame}


def load_game(
    name: str, params: Optional[Dict[str, object]] = None
) -> TwixTGame:
    """OpenSpiel-style loader; accepts "twixt" or "twixt(board_size=8)"."""
    inline: Dict[str, object] = {}
    if "(" in name:
        if not name.endswith(")"):
            raise SpielError(f"Badly formatted game string: {name}")
        name, _, arg_str = name.partition("(")
        for part in filter(None, arg_str[:-1].split(",")):
            k, _, v = part.partition("=")
            inline[k.strip()] = _parse_param(v.strip())
    if name not in _REGISTRY:
        raise SpielError(f"Unknown game '{name}'")
    merged = {**inline, **(params or {})}
    return _REGISTRY[name](merged)


def _parse_param(v: str):
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(v)
    except ValueError:
        return v


# --- game+state serialization (OpenSpiel SerializeGameAndState /
# DeserializeGameAndState text format)

_SER_HEADER = "# Automatically generated by OpenSpiel SerializeGameAndState"


def serialize_game_and_state(game: TwixTGame, state: TwixTState) -> str:
    """Self-contained text round-trip of a game config + state history."""
    return (
        f"{_SER_HEADER}\n[Game]\n{game}\n[State]\n{state.serialize()}"
    )


def deserialize_game_and_state(data: str):
    """Inverse of :func:`serialize_game_and_state`; returns (game, state)."""
    lines = data.split("\n")
    try:
        g_at = lines.index("[Game]")
        s_at = lines.index("[State]")
    except ValueError:
        raise SpielError(f"Expected a game and state section: {data!r}")
    game = load_game("\n".join(lines[g_at + 1 : s_at]).strip())
    state = game.new_initial_state()
    for line in lines[s_at + 1 :]:
        if line.strip():
            state.apply_action(int(line))
    return game, state
