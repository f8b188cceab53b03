"""TwixT game state as a fixed-shape JAX pytree + ``reset``.

Array-program equivalent of the reference's ``Cell`` grid and ``Board``
construction (C3/C6 in SURVEY.md §2; reference twixtcell.h:70-109,
twixtboard.cc:168-276).  Struct-of-arrays instead of array-of-structs: each
per-cell field of the C++ ``Cell`` becomes one board-shaped tensor, so the
whole game state is a small pytree of integer arrays that vmaps over a batch
axis and shards over a device mesh.

All board arrays are padded with a ``PAD``-cell halo of off-board cells so
every knight-move / crossing-link offset used by ``step`` stays in bounds:
shifted whole-board reads replace the reference's per-cell bounds checks
(``PositionIsOffBoard``, twixtboard.cc:625-631).

``board_size`` is a static (trace-time) argument — one compiled executable
per board size, exactly like the reference compiles per-game C++.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from twixt_for_open_spiel_tpu.ops import geometry as geo


class State(NamedTuple):
    """Complete TwixT game state (single env; add leading/trailing batch axes
    via ``jax.vmap``).

    Board arrays have shape [P, P] with P = board_size + 2*PAD, indexed
    [x + PAD, y + PAD] (x = column, y = row pointing up, reference
    twixtboard.h:153-213).

    Fields (reference counterparts in parentheses):
      color          int8  [P,P]  COLOR_* per cell (Cell::color_)
      links          uint8 [P,P]  bit d set => link in compass dir d
                                  (Cell::links_; always set symmetrically on
                                  both endpoints, twixtboard.cc:532-533)
      blocked        uint8 [P,P]  bit d set => same-color neighbor in dir d
                                  could not be linked due to a crossing link
                                  (Cell::blocked_neighbors_)
      compid         int16 [P,P]  connected-component id of the cell's link
                                  component; ids are action indices of peg
                                  cells, -1 on the halo/corners.  Replaces
                                  the reference's recursive DFS
                                  (ExploreLocalGraph) with O(1)-merge
                                  batched union-find (see ops/step.py).
      flags          uint8 [P,P]  border-connectivity bits of the cell's
                                  component, bit (player*2+border)
                                  (Cell::linked_to_border_); invariant:
                                  every peg holds its component's full flag
                                  byte, empty cells their initial border
                                  flags
      legal          bool  [2,P,P] per-player legal-action masks
                                  (Board::legal_actions_, kept as masks; the
                                  ascending-action-id list order of the
                                  reference is recovered by a column-major
                                  scan of the mask)
      current_player int32 []    player to move, or TERMINAL_PLAYER_ID
      move_counter   int32 []    number of moves applied (Board::move_counter_)
      move_one       int32 []    action id of the first move (Board::move_one_)
      swapped        bool  []    swap rule invoked (Board::swapped_)
      result         int32 []    RESULT_* (Board::result_)
    """

    color: jnp.ndarray
    links: jnp.ndarray
    blocked: jnp.ndarray
    compid: jnp.ndarray
    flags: jnp.ndarray
    legal: jnp.ndarray
    current_player: jnp.ndarray
    move_counter: jnp.ndarray
    move_one: jnp.ndarray
    swapped: jnp.ndarray
    result: jnp.ndarray


def padded_size(board_size: int) -> int:
    return board_size + 2 * geo.PAD


def board_consts(board_size: int):
    """The per-size constant boards, built from iotas in jnp.

    Semantically identical to :func:`geometry.board_masks` (which stays the
    numpy reference, cross-checked in tests); under jit XLA constant-folds
    it all.

    Returns dict with [P, P] arrays: init_color (i32), init_compid (i32),
    init_flags (i32) and legal (bool [2, P, P]).
    """
    n = board_size
    p = padded_size(n)
    xs = jnp.arange(p, dtype=jnp.int32)[:, None] - geo.PAD
    ys = jnp.arange(p, dtype=jnp.int32)[None, :] - geo.PAD
    in_bounds = (xs >= 0) & (xs < n) & (ys >= 0) & (ys < n)
    x_edge = (xs == 0) | (xs == n - 1)
    y_edge = (ys == 0) | (ys == n - 1)
    on_board = in_bounds & ~(x_edge & y_edge)

    flags = jnp.zeros((p, p), jnp.int32)
    for cond, player, border in (
        (xs == 0, geo.BLUE, geo.BORDER_START),
        (xs == n - 1, geo.BLUE, geo.BORDER_END),
        (ys == 0, geo.RED, geo.BORDER_START),
        (ys == n - 1, geo.RED, geo.BORDER_END),
    ):
        flags = flags | jnp.where(
            on_board & cond, geo.flag_bit(player, border), 0
        )

    # plane 0 forbids the x borders, plane 1 the y borders
    legal = jnp.stack([on_board & ~x_edge, on_board & ~y_edge])

    return {
        "legal": legal,
        "init_color": jnp.where(
            on_board, geo.COLOR_EMPTY, geo.COLOR_OFFBOARD
        ),
        "init_compid": jnp.where(on_board, xs * n + ys, -1),
        "init_flags": flags,
    }


def reset(board_size: int) -> State:
    """Start-of-game state (reference Board ctor, twixtboard.cc:168-174).

    Pure function of the static board size; the expensive per-cell init loops
    of the reference (InitializeCells / InitializeNeighbors /
    InitializeBlockerMap, twixtboard.cc:209-276) collapse into trace-time
    constant-table construction.
    """
    consts = board_consts(board_size)
    p = padded_size(board_size)
    return State(
        color=consts["init_color"].astype(jnp.int8),
        links=jnp.zeros((p, p), dtype=jnp.uint8),
        blocked=jnp.zeros((p, p), dtype=jnp.uint8),
        compid=consts["init_compid"].astype(jnp.int16),
        flags=consts["init_flags"].astype(jnp.uint8),
        legal=consts["legal"],
        current_player=jnp.asarray(geo.RED, jnp.int32),
        move_counter=jnp.asarray(0, jnp.int32),
        move_one=jnp.asarray(-1, jnp.int32),
        swapped=jnp.asarray(False),
        result=jnp.asarray(geo.RESULT_OPEN, jnp.int32),
    )


def action_to_xy(action, board_size: int):
    """Action id -> (x, y) board coords (reference twixtboard.cc:599-601)."""
    return action // board_size, action % board_size


def xy_to_action(x, y, board_size: int):
    """(x, y) -> action id (reference twixtboard.cc:603-605)."""
    return x * board_size + y


def swap_rotate_action(action, board_size: int):
    """90-degree clockwise rotation applied on swap
    (reference twixtboard.cc:470-473): (x, y) -> (y, size-1-x)."""
    x, y = action_to_xy(action, board_size)
    return xy_to_action(y, board_size - 1 - x, board_size)


def onehot_board(action, board_size: int) -> jnp.ndarray:
    """Bool [P,P,*B] mask, True exactly at each env's action cell.

    Batch-polymorphic: ``action`` may be a scalar (single env) or carry
    trailing batch dims — board ops keep the batch on the *minor* axes (see
    ops/rollout.py).
    """
    p = padded_size(board_size)
    x, y = action_to_xy(action, board_size)
    bshape = (1,) * jnp.ndim(x)
    xs = jnp.arange(p, dtype=jnp.int32).reshape((p, 1) + bshape)
    ys = jnp.arange(p, dtype=jnp.int32).reshape((1, p) + bshape)
    return (xs == x + geo.PAD) & (ys == y + geo.PAD)


def legal_mask_flat(state: State, player, board_size: int) -> jnp.ndarray:
    """Legal mask over the ``size*size`` action space, ascending action order.

    Row-major over (x, y) == ascending action id, matching the insertion
    order of the reference's legal-action vectors (twixtboard.cc:260-275).
    Batch-polymorphic: returns [size*size] or [size*size, *B].
    """
    pad = geo.PAD
    legal = state.legal
    if jnp.ndim(player) == 0 and not isinstance(player, jnp.ndarray):
        sel = legal[int(player)]
    else:
        sel = jnp.where(jnp.asarray(player) == 0, legal[0], legal[1])
    core = sel[pad : pad + board_size, pad : pad + board_size]
    return core.reshape((board_size * board_size,) + core.shape[2:])
