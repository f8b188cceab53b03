"""Branch-free TwixT state transition: ``step(state, action)``.

Array-program re-expression of the reference's hot path (SURVEY.md §3c):
``Board::ApplyAction`` / ``SetPegAndLinks`` / ``ExploreLocalGraph`` /
``UpdateResult`` (reference twixtboard.cc:457-588,192-207) plus the turn /
terminal logic of ``TwixTState::DoApplyAction`` (reference twixt.h:93-104).

Design: everything is whole-board elementwise tensor algebra over the padded
[P, P] arrays, with a fixed number of operations per step —

  * the action becomes a one-hot board mask;
  * neighbor / crossing-link probes become *static shifts* of whole boards
    (the 8+72 probe offsets are trace-time constants from geometry.CROSSERS),
    replacing the reference's BlockerMap hash probes with masked bit reads;
  * the recursive border DFS (ExploreLocalGraph, twixtboard.cc:573-588)
    becomes **batched union-find with O(1) merges**: each link component has
    an id (the action index of one of its pegs) and a flag byte in a
    [size*size] side table.  Placing a peg merges <= 8 neighbor components
    by comparing the whole compid board against <= 8 scalars — no
    data-dependent loop at all (a masked flood-fill under
    ``lax.while_loop`` needs a data-dependent number of iterations per
    step).
  * the swap rule is a ``where`` select, no Python branching.

All operations are batch-polymorphic with TRAILING env batch dims: board
leaves are [P, P, *B], scalars [*B], reductions run over axes (0, 1) and
broadcasts align on the trailing axes.  ``step`` is therefore called
directly on batched state — no ``vmap`` — so the env batch stays the
minor-most dimension of every intermediate (vmap would move the mapped axis
to the front internally and make the 11..30-wide board dims minor).

Correctness note on the merge: every live component id is the action index
of a peg currently in that component (ids start as cell indices, merges take
a min, and pegs are never removed mid-game — the swap undo removes a peg
that was never linked, whose singleton component dissolves untouched).
Hence an empty cell's compid can never collide with a live component id,
and the whole-board remap touches exactly the merged components.

``step`` assumes ``action`` is legal for ``state.current_player`` and that
the state is non-terminal (the reference raises SpielFatalError otherwise,
twixt.h:94-97; the host-side OpenSpiel adapter performs that gate, and
``rollout.step_auto_reset`` handles terminal states for batched rollouts).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.state import (
    State,
    onehot_board,
    swap_rotate_action,
)

_U8 = jnp.uint8
_BIG = 1 << 20  # sentinel larger than any component id


def _shift(arr: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """out[x, y] = arr[x + dx, y + dy] (static shift, wrap-around).

    Safe because every use is masked to cells whose shifted source index is
    within the PAD halo (|dx|, |dy| <= PAD), where wrap-around never occurs.
    Written as concat-of-slices (== jnp.roll for static shifts).
    """
    if dx:
        arr = jnp.concatenate([arr[dx:], arr[:dx]], axis=0)
    if dy:
        arr = jnp.concatenate([arr[:, dy:], arr[:, :dy]], axis=1)
    return arr


def _link_updates(color, links, me, player_c):
    """New link / blocked-neighbor bits created by placing a peg at ``me``.

    Vectorised SetPegAndLinks (reference twixtboard.cc:501-571): for each of
    the 8 compass directions, link iff the knight-move neighbor has the same
    color and none of the 9 geometrically crossing links is present.  Link and
    blocked bits are set symmetrically on both endpoints
    (twixtboard.cc:532-533, 550-551).  The 8 candidate links share the origin
    peg so they can never cross each other, making the direction loop
    order-independent — all probes read the pre-move ``links``.
    """
    # constants follow the array dtype of ``links``
    lt = links.dtype

    def bit(v):
        return jnp.asarray(v, lt)

    new_links = jnp.zeros_like(links)
    new_blocked = jnp.zeros_like(links)
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        # Same-color knight-move neighbor (halo/corner cells are OFFBOARD, so
        # the color test subsumes the reference's PositionIsOffBoard check).
        same = me & (_shift(color, dx, dy) == player_c)
        # Any of the 9 crossing links present?  One masked bit probe per
        # crossing link at its canonical east endpoint (links are symmetric).
        crossed = jnp.zeros_like(me)
        for ox, oy, d2 in geo.CROSSERS[d]:
            probe = (_shift(links, int(ox), int(oy)) >> int(d2)) & bit(1)
            crossed = crossed | (probe != 0)
        linked = same & ~crossed
        blocked = same & crossed
        od = geo.opp_dir(d)
        new_links = new_links | jnp.where(linked, bit(1 << d), bit(0))
        new_links = new_links | jnp.where(
            _shift(linked, -dx, -dy), bit(1 << od), bit(0)
        )
        new_blocked = new_blocked | jnp.where(blocked, bit(1 << d), bit(0))
        new_blocked = new_blocked | jnp.where(
            _shift(blocked, -dx, -dy), bit(1 << od), bit(0)
        )
    return new_links, new_blocked


def _merge_components(compid, flags, me, eff, new_links):
    """Union the <= 8 components newly linked to the placed peg.

    No gathers, no scatters, no loops: the per-env scalars (neighbor
    component ids, merged flag byte) are extracted with one-hot masked
    whole-board reductions, which stay elementwise code over the batch
    instead of per-env dynamic indexing.

    Returns (compid, flags, merged_flags) where ``merged_flags`` is the
    border-flag byte of the merged component — the exact value the reference
    reads off the placed cell for the win check (twixtboard.cc:192-199).
    """
    # Per-env scalar: merged flag byte = own flags (an empty cell still
    # holds its initial border flags) | flags of every newly linked
    # neighbor.  Computed in one masked reduction over the peg cell.
    zero_f = jnp.asarray(0, flags.dtype)
    acc = flags
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        has_new = (new_links >> int(d)) & 1
        acc = acc | jnp.where(has_new != 0, _shift(flags, dx, dy), zero_f)
    # reduce in int32, back to flags dtype
    nf = jnp.max(
        jnp.where(me, acc.astype(jnp.int32), 0), axis=(0, 1)
    ).astype(flags.dtype)

    # Per-env scalars: the <= 8 neighbor component ids (or -1).
    neighbor_ids = []
    compid32 = compid.astype(jnp.int32)
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        has_new = ((new_links >> int(d)) & 1) != 0
        cid_board = jnp.where(
            me & has_new, _shift(compid32, dx, dy), -1
        )
        neighbor_ids.append(jnp.max(cid_board, axis=(0, 1)))

    pos_idx = eff.astype(jnp.int32)  # action index == x*size+y
    # merged id: smallest peg index across the united components
    nid = pos_idx
    for cid in neighbor_ids:
        nid = jnp.minimum(nid, jnp.where(cid >= 0, cid, _BIG))

    # remap the united components to nid and stamp the merged flag byte on
    # every member (whole-board compare vs <= 8 scalars, one fused pass)
    hit = me
    for cid in neighbor_ids:
        # guard cid >= 0: unlinked dirs carry -1, which must not match the
        # halo/corner sentinel compid == -1
        hit = hit | ((compid32 == cid) & (cid >= 0))
    compid = jnp.where(hit, nid.astype(compid.dtype), compid)
    flags = jnp.where(hit, nf, flags)
    return compid, flags, nf


def step_impl(state: State, board_size: int, action) -> State:
    """Apply ``action`` for ``state.current_player``; returns the next state.

    Mirrors Board::ApplyAction + TwixTState::DoApplyAction exactly
    (reference twixtboard.cc:457-499, twixt.h:93-104), including:
      * the swap rule: on move 2, replaying move one undoes it and places the
        second player's peg at the 90-degree-clockwise-rotated position
        (twixtboard.cc:460-474);
      * move one staying legal for exactly one ply (twixtboard.cc:485-489);
      * win = placed peg connected to both of the mover's borders, draw = the
        opponent to move has no legal action left (twixtboard.cc:192-207).
    """
    player = state.current_player
    player_c = player.astype(state.color.dtype)
    mc = state.move_counter
    action = jnp.asarray(action, dtype=jnp.int32)

    is_swap = (mc == 1) & (action == state.move_one)

    # --- swap: undo move one (reference UndoFirstMove, twixtboard.cc:450-455).
    # The single first peg has no links/blocked bits, its singleton component
    # entry still holds its initial border flags, so clearing its color and
    # restoring the initial legal masks is a complete undo.
    m_one = onehot_board(state.move_one, board_size)
    color = jnp.where(
        is_swap & m_one,
        jnp.asarray(geo.COLOR_EMPTY, state.color.dtype),
        state.color,
    )
    # NOTE: the reference's UndoFirstMove re-initialises the legal lists
    # (twixtboard.cc:454), but at move 2 nothing has been removed from them
    # yet (move one deliberately stays legal, twixtboard.cc:485-489), so the
    # "restore" is a provable no-op and is omitted here.
    legal = state.legal

    # Effective position: rotated on swap (twixtboard.cc:470-473).
    eff = jnp.where(
        is_swap, swap_rotate_action(action, board_size), action
    )
    me = onehot_board(eff, board_size)

    # Move 2 without swap: move one leaves both players' legal sets
    # (twixtboard.cc:475-480).
    rm_one = ((mc == 1) & ~is_swap) & m_one
    legal = legal & ~rm_one[None]

    # --- place peg, create links / blocked bits.
    color = jnp.where(me, player_c, color)
    new_links, new_blocked = _link_updates(color, state.links, me, player_c)
    links = state.links | new_links
    blocked = state.blocked | new_blocked

    # --- connectivity: O(1)-merge batched union-find.
    compid, flags, nf = _merge_components(
        state.compid, state.flags, me, eff, new_links
    )

    # --- legal-action bookkeeping (twixtboard.cc:485-493): the first move is
    # remembered but stays legal; every later move is removed for both players.
    legal = jnp.where(mc == 0, legal, legal & ~me[None])
    move_one = jnp.where(mc == 0, eff, state.move_one)

    # --- result (UpdateResult, twixtboard.cc:192-207).
    shift_amt = player * 2
    nf32 = nf.astype(jnp.int32)
    connected_start = ((nf32 >> shift_amt) & 1) != 0
    connected_end = ((nf32 >> (shift_amt + 1)) & 1) != 0
    win = connected_start & connected_end
    opp = 1 - player
    # any legal move left for the opponent, per env
    opp_legal = jnp.where(opp == 0, legal[0], legal[1])
    opp_has_legal = jnp.max(opp_legal.astype(jnp.int32), axis=(0, 1)) != 0
    result = jnp.where(
        win,
        jnp.int32(geo.RESULT_RED_WIN) + player,
        jnp.where(
            opp_has_legal,
            jnp.int32(geo.RESULT_OPEN),
            jnp.int32(geo.RESULT_DRAW),
        ),
    )

    current_player = jnp.where(
        result == geo.RESULT_OPEN, opp, jnp.int32(geo.TERMINAL_PLAYER_ID)
    )

    return State(
        color=color,
        links=links,
        blocked=blocked,
        compid=compid,
        flags=flags,
        legal=legal,
        current_player=current_player,
        move_counter=mc + 1,
        move_one=move_one,
        swapped=state.swapped | is_swap,
        result=result,
    )


# jitted public entry point; ``step_impl`` is the raw traceable function.
step = functools.partial(jax.jit, static_argnums=1)(step_impl)


def returns(state: State) -> jnp.ndarray:
    """Terminal returns [2] (reference TwixTState::Returns, twixt.h:50-63)."""
    r = state.result
    red = jnp.where(
        r == geo.RESULT_RED_WIN,
        1.0,
        jnp.where(r == geo.RESULT_BLUE_WIN, -1.0, 0.0),
    )
    return jnp.stack([red, -red])


def is_terminal(state: State) -> jnp.ndarray:
    """Reference TwixTState::IsTerminal (twixt.h:45-48)."""
    return state.result != geo.RESULT_OPEN
