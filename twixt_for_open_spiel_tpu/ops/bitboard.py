"""Bitboard engine: the step/rollout hot path on bit-packed boards.

Semantically identical to ops/step.py (the canonical tensor engine, which
stays the parity/oracle-tested reference), but with every board-shaped
bool/bitmask field packed into uint32 *bitplanes*: ``plane[x]`` is a word
whose bit ``y`` is cell ``(x, y)`` of the padded board (P = size + 2*PAD
<= 30 bits, so one word per column).  Arrays are [P, *B] instead of
[P, P, *B] — the env batch stays the minor dimension and every
whole-board probe of the link-placement rule (8 same-color neighbor tests +
8x9 crossing-link probes, reference twixtboard.cc:501-571) processes P words
per env instead of P*P bytes: ~6x fewer elements and bytes per pass on the
headline board size.

What stays unpacked: the union-find component board ``compid`` (int16, as in
ops/step.py but restricted to the inner board-size region — the halo never
holds pegs) — component ids are 10-bit values, and bit-slicing them would
triple the compare cost of the O(1) merge.

Action sampling replaces the f32 Gumbel-max over [A, *B] with exact
popcount-rank selection on the legal bitplane: draw k uniform in
[0, popcount), walk the column cumsum, then binary-search the k-th set bit —
a handful of [P, *B]/[*B] integer ops, no transcendentals, no f32 boards.
RNG is a counter-based SplitMix hash (:func:`step_noise`), so a rollout is
the same bits on every backend.

Equivalence with the canonical engine is pinned by tests/test_bitboard.py:
random games stepped through both engines must match bit-for-bit on every
field after every move, and rollouts must sample only legal actions.

Reference semantics covered (same lines as ops/step.py): swap rule
twixtboard.cc:450-499, SetPegAndLinks twixtboard.cc:501-571, win/draw
twixtboard.cc:192-207, turn logic twixt.h:93-104.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.state import (
    State,
    padded_size,
    reset,
    swap_rotate_action,
)

_U32 = jnp.uint32
_BIG = 1 << 20


class BitState(NamedTuple):
    """Bit-packed TwixT state; same semantics as ops/state.State.

    Bitplanes are uint32 [P, *B], bit y of word [x] = cell (x, y):
      red, blue      peg of that color
      links          4-tuple of [P, *B]: CANONICAL east-direction planes —
                     each (symmetric) link is stored exactly once, at its
                     west endpoint, in one of the dirs NNE..SSE.  The
                     crossing rule only ever probes canonical planes
                     (geometry.CROSSERS is canonicalised), so the four west
                     planes of the earlier 8-plane layout were pure write
                     traffic; dropping them halves the link-update work and
                     the carried link state.  West bits are reconstructed by
                     shifting in ``to_state`` (conversion path only).
      blocked        4-tuple of [P, *B]: canonical blocked-pair planes, same
                     convention (blocked bits are recorded symmetrically on
                     both endpoints in the reference, twixtboard.cc:536-541,
                     so one canonical bit per pair is lossless)
      legal          2-tuple of [P, *B]: per-player legal-action masks
      flags          4-tuple of [P, *B]: border-connectivity bit
                     (player*2+border) of the cell's component (pegs) /
                     initial border flags (empty border cells) — bit-sliced
                     Cell::linked_to_border_
    Unpacked:
      compid         int16 [N, N, *B] — ops/state.State's component-id board
                     restricted to the inner N = board_size region (the halo
                     never holds pegs, so its ids never change; dropping it
                     cuts the dominant [*,*,B] traffic of the step ~2.25x)
      current_player / move_counter / move_one / swapped / result: [*B]

    The per-direction planes are TUPLES of 2-D-per-env arrays, not stacked
    [4, P, *B] tensors: stacked carries made XLA materialise ~10 layout
    copies + dynamic-update-slices per lockstep step (measured via
    scripts/hlo_bit_step.py; unstacking alone bought ~1.3x).
    """

    red: jnp.ndarray
    blue: jnp.ndarray
    links: tuple
    blocked: tuple
    legal: tuple
    flags: tuple
    compid: jnp.ndarray
    current_player: jnp.ndarray
    move_counter: jnp.ndarray
    move_one: jnp.ndarray
    swapped: jnp.ndarray
    result: jnp.ndarray


def _pack_bool(board: jnp.ndarray) -> jnp.ndarray:
    """[P, P, *B] bool -> [P, *B] u32 bitplane (bit y = board[x, y]).

    XLA constant-folds the bit weights.
    """
    p = board.shape[1]
    assert p <= 31, "bit index must fit a non-negative int32"
    # int32 accumulation (bit weights stay below 2^31)
    ybits = jnp.int32(1) << jax.lax.broadcasted_iota(
        jnp.int32, (1, p) + (1,) * (board.ndim - 2), 1
    )
    return jnp.sum(
        jnp.where(board, ybits, 0), axis=1, dtype=jnp.int32
    ).astype(_U32)


def _unpack_bool(plane: jnp.ndarray, p: int) -> jnp.ndarray:
    """[P, *B] u32 -> [P, P, *B] bool."""
    ys = jnp.arange(p, dtype=_U32).reshape((1, p) + (1,) * (plane.ndim - 1))
    return ((plane[:, None] >> ys) & _U32(1)) != 0


def from_state(state: State) -> BitState:
    """Pack a canonical State into bitplanes (conversion, not hot)."""
    color = state.color
    red = _pack_bool(color == jnp.asarray(geo.COLOR_RED, color.dtype))
    blue = _pack_bool(color == jnp.asarray(geo.COLOR_BLUE, color.dtype))
    links = tuple(
        _pack_bool(((state.links >> d) & 1) != 0) for d in range(4)
    )
    blocked = tuple(
        _pack_bool(((state.blocked >> d) & 1) != 0) for d in range(4)
    )
    legal = (_pack_bool(state.legal[0]), _pack_bool(state.legal[1]))
    flags = tuple(
        _pack_bool(((state.flags >> b) & 1) != 0) for b in range(4)
    )
    n = state.color.shape[0] - 2 * geo.PAD
    compid = state.compid[geo.PAD : geo.PAD + n, geo.PAD : geo.PAD + n]
    return BitState(
        red=red,
        blue=blue,
        links=links,
        blocked=blocked,
        legal=legal,
        flags=flags,
        compid=compid,
        current_player=state.current_player,
        move_counter=state.move_counter,
        move_one=state.move_one,
        swapped=state.swapped,
        result=state.result,
    )


def expand_planes(planes4: tuple) -> tuple:
    """4 canonical planes -> 8 symmetric per-direction planes.

    West bit d (d >= 4) at cell c == canonical bit d-4 at cell c + OFF[d]
    (links and blocked pairs are recorded symmetrically on both endpoints in
    the reference, so the expansion is exact)."""
    out = list(planes4)
    for d in range(4, geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        out.append(_shiftp(planes4[d - 4], dx, dy))
    return tuple(out)


def to_state(bs: BitState, board_size: int) -> State:
    """Unpack back to the canonical State (for obs/rendering/parity)."""
    p = padded_size(board_size)
    red = _unpack_bool(bs.red, p)
    blue = _unpack_bool(bs.blue, p)
    # halo/corner OFFBOARD reconstruction from the constant masks
    consts = reset(board_size)
    on_board = consts.color != geo.COLOR_OFFBOARD
    on_board = jnp.broadcast_to(
        on_board.reshape(on_board.shape + (1,) * (red.ndim - 2)), red.shape
    )
    color = jnp.where(
        red,
        jnp.int8(geo.COLOR_RED),
        jnp.where(
            blue,
            jnp.int8(geo.COLOR_BLUE),
            jnp.where(
                on_board,
                jnp.int8(geo.COLOR_EMPTY),
                jnp.int8(geo.COLOR_OFFBOARD),
            ),
        ),
    )

    def unpack_bits(planes):
        acc = jnp.zeros(color.shape, jnp.uint8)
        for d, plane in enumerate(planes):
            acc = acc | jnp.where(
                _unpack_bool(plane, p), jnp.uint8(1 << d), jnp.uint8(0)
            )
        return acc

    # paste the inner compid back into the constant halo (halo ids are -1
    # from reset and can never change: hits require a component id >= 0)
    n = board_size
    halo = jnp.broadcast_to(
        consts.compid.reshape(consts.compid.shape + (1,) * (bs.compid.ndim - 2)),
        (p, p) + bs.compid.shape[2:],
    )
    compid = halo.at[geo.PAD : geo.PAD + n, geo.PAD : geo.PAD + n].set(
        bs.compid
    )

    return State(
        color=color,
        links=unpack_bits(expand_planes(bs.links)),
        blocked=unpack_bits(expand_planes(bs.blocked)),
        compid=compid,
        flags=unpack_bits(bs.flags),
        legal=jnp.stack([_unpack_bool(bs.legal[0], p),
                         _unpack_bool(bs.legal[1], p)]),
        current_player=bs.current_player,
        move_counter=bs.move_counter,
        move_one=bs.move_one,
        swapped=bs.swapped,
        result=bs.result,
    )


def bit_reset(board_size: int, batch=None) -> BitState:
    """Initial BitState; ``batch`` appends a trailing env axis."""
    s = reset(board_size)
    if batch is not None:
        s = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[..., None], x.shape + (batch,)), s
        )
    return from_state(s)


def _shiftp(plane: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """out[x] bit y = plane[x + dx] bit (y + dy); zero-fill (halo is empty)."""
    if dx:
        plane = jnp.concatenate([plane[dx:], plane[:dx]], axis=0)
    if dy > 0:
        plane = plane >> _U32(dy)
    elif dy < 0:
        plane = plane << _U32(-dy)
    return plane


def _onehot_bits(action, board_size: int) -> jnp.ndarray:
    """u32 [P, *B] bitplane with exactly the action's cell bit set."""
    p = padded_size(board_size)
    x = action // board_size + geo.PAD
    y = action % board_size + geo.PAD
    bshape = (1,) * jnp.ndim(x)
    xs = jax.lax.broadcasted_iota(jnp.int32, (p,) + bshape, 0)
    word = _U32(1) << y.astype(_U32)
    return jnp.where(xs == x, word, _U32(0))


def _any_bits(plane: jnp.ndarray) -> jnp.ndarray:
    """[P, *B] -> [*B] bool: any bit set.

    Reduced as 0/1 int32; XLA fuses the compare into the reduce.
    """
    return jnp.max(jnp.where(plane != 0, 1, 0), axis=0) != 0


def step_bits(bs: BitState, board_size: int, action) -> BitState:
    """Bit-packed equivalent of ops/step.step_impl (same reference lines).

    The link-placement rule runs on SCALAR window probes: a handful of board
    rows around the new peg are extracted from the canonical planes with
    masked row reductions (the same trick as the compid window below), and
    the 8 same-color tests + 8x9 crossing probes + 9x4 flag probes become
    per-env bit tests on those words — replacing ~200 whole-plane shift/or
    ops per step of the earlier all-plane formulation (measured +13% on the
    XLA rollout, scripts/perf_bit_v4.py; bit-identical by the same script's
    CPU validation and tests/test_bitboard.py).
    """
    n = board_size
    p = bs.red.shape[0]
    player = bs.current_player
    mc = bs.move_counter
    action = jnp.asarray(action, jnp.int32)

    is_swap = (mc == 1) & (action == bs.move_one)

    # swap undo (twixtboard.cc:450-455): clear move-one's peg (it has no
    # links/blocked bits and a still-initial singleton component)
    m_one = _onehot_bits(bs.move_one, board_size)
    undo = jnp.where(is_swap, m_one, _U32(0))
    red = bs.red & ~undo
    blue = bs.blue & ~undo

    eff = jnp.where(is_swap, swap_rotate_action(action, board_size), action)
    me = _onehot_bits(eff, board_size)

    # move 2 without swap: move one finally leaves both legal sets
    # (twixtboard.cc:475-480)
    rm1 = jnp.where((mc == 1) & ~is_swap, m_one, _U32(0))
    legal = tuple(l & ~rm1 for l in bs.legal)

    # place the peg
    is_red = player == 0
    red = jnp.where(is_red, red | me, red)
    blue = jnp.where(is_red, blue, blue | me)
    mine = jnp.where(is_red, red, blue)

    px = eff // n  # inner coords (no halo)
    py = eff % n
    pxp = px + geo.PAD
    pyp = py + geo.PAD
    bdims = px.ndim
    xs_p = jax.lax.broadcasted_iota(jnp.int32, (p,) + (1,) * bdims, 0)

    def xrow(plane, row):
        """Word at board row ``row`` ([*B] int32) of a u32 plane — int32
        accumulation (bit weights < 2^31)."""
        return jnp.max(
            jnp.where(xs_p == row, plane.astype(jnp.int32), 0), axis=0
        ).astype(_U32)

    def probe(word, ybit):
        return ((word >> ybit.astype(_U32)) & _U32(1)) != 0

    # window rows needed per canonical plane (trace-time constants)
    need_rows = [set() for _ in range(4)]
    for d in range(geo.NUM_DIRS):
        for ox, oy, d2 in geo.CROSSERS[d]:
            need_rows[int(d2)].add(int(ox))
    link_rows = {
        (d2, ox): xrow(bs.links[d2], pxp + ox)
        for d2 in range(4)
        for ox in sorted(need_rows[d2])
    }
    mine_rows = {
        dx: xrow(mine, pxp + dx)
        for dx in sorted({int(v[0]) for v in geo.OFFSETS})
    }
    flag_rows = {
        (b, dx): xrow(bs.flags[b], pxp + dx)
        for b in range(4)
        for dx in sorted({0} | {int(v[0]) for v in geo.OFFSETS})
    }

    # --- links / blocked (SetPegAndLinks, twixtboard.cc:501-571): all 8
    # directions read the pre-move links (the 8 candidates share the new peg
    # and cannot cross each other); results land in the canonical plane of
    # each pair's west endpoint.
    links = list(bs.links)
    blocked = list(bs.blocked)
    linked_s = []  # per-dir scalar [*B]: new link from me in dir d
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        same = probe(mine_rows[dx], pyp + dy)
        crossed = jnp.zeros_like(same)
        for ox, oy, d2 in geo.CROSSERS[d]:
            crossed = crossed | probe(
                link_rows[(int(d2), int(ox))], pyp + int(oy)
            )
        linked = same & ~crossed
        blkd = same & crossed
        linked_s.append(linked)
        if d < 4:
            links[d] = links[d] | jnp.where(linked, me, _U32(0))
            blocked[d] = blocked[d] | jnp.where(blkd, me, _U32(0))
        else:
            tgt = _shiftp(me, -dx, -dy)
            links[d - 4] = links[d - 4] | jnp.where(linked, tgt, _U32(0))
            blocked[d - 4] = blocked[d - 4] | jnp.where(blkd, tgt, _U32(0))

    # --- merged flag byte (ExploreLocalGraph equivalent; see ops/step.py):
    # own cell's flags | flags of each newly linked neighbor, as scalars.
    nf = jnp.zeros(player.shape, jnp.int32)
    for b in range(4):
        got = probe(flag_rows[(b, 0)], pyp)
        for d in range(geo.NUM_DIRS):
            dx, dy = (int(v) for v in geo.OFFSETS[d])
            got = got | (linked_s[d] & probe(flag_rows[(b, dx)], pyp + dy))
        nf = nf | jnp.where(got, jnp.int32(1 << b), 0)

    # neighbor component ids from the unpacked inner-board compid (ids are
    # 10-bit; bit-slicing would triple the compare cost).  Extraction is
    # windowed: 5 masked row reduces over x, then each of the 8 neighbor
    # cids is a cheap [N, *B] reduce over y — instead of 8 independent
    # full-board masked reduces (measured 2.4x whole-rollout,
    # scripts/perf_bit_v2.py).  Compares run in the i16 storage dtype (no
    # whole-board i32 cast per step).
    compid = bs.compid
    sent = jnp.asarray(-20000, compid.dtype)  # below any live id (>= -1)
    xs = jax.lax.broadcasted_iota(jnp.int32, (n,) + (1,) * (bdims + 1), 0)
    ys = jax.lax.broadcasted_iota(jnp.int32, (n,) + (1,) * bdims, 0)
    # rows off the inner board (peg near an edge) match no x and yield the
    # sentinel; those directions never carry a new link anyway
    wins = [
        jnp.max(jnp.where(xs == px + (r - 2), compid, sent), axis=0)
        for r in range(5)
    ]
    nid = eff
    cids = []
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        raw = jnp.max(
            jnp.where(ys == py + dy, wins[dx + 2], sent), axis=0
        )  # [*B], compid dtype
        # sentinel -7 never equals a compid (ids are >= -1), so unlinked
        # directions can't match in the hit test below
        cid = jnp.where(linked_s[d], raw, jnp.asarray(-7, raw.dtype))
        cids.append(cid)
        nid = jnp.minimum(
            nid, jnp.where(cid >= 0, cid.astype(jnp.int32), _BIG)
        )

    ys_row = jax.lax.broadcasted_iota(
        jnp.int32, (1, n) + (1,) * bdims, 1
    )
    me_inner = (xs == px) & (ys_row == py)
    hit = me_inner
    for cid in cids:
        hit = hit | ((compid == cid) & (cid >= 0))
    compid = jnp.where(hit, nid.astype(bs.compid.dtype), bs.compid)

    # stamp the merged flag byte on the whole united component: pack the hit
    # board into a bitplane once, then or it into the set flag bits
    # pack the inner hit board into a full padded bitplane [P, *B]
    # (int32 accumulation: bit weights < 2^31)
    ybits = jnp.int32(1) << (
        jax.lax.broadcasted_iota(jnp.int32, (1, n) + (1,) * bdims, 1)
        + geo.PAD
    )
    inner_bits = jnp.sum(
        jnp.where(hit, ybits, 0), axis=1, dtype=jnp.int32
    ).astype(_U32)
    zpad = jnp.zeros((geo.PAD,) + inner_bits.shape[1:], _U32)
    hit_bits = jnp.concatenate([zpad, inner_bits, zpad], axis=0)
    flags = tuple(
        jnp.where(((nf >> b) & 1) != 0, bs.flags[b] | hit_bits, bs.flags[b])
        for b in range(4)
    )

    # --- legal bookkeeping: move one stays legal for one ply
    # (twixtboard.cc:485-493)
    rm = jnp.where(mc == 0, _U32(0), me)
    legal = tuple(l & ~rm for l in legal)
    move_one = jnp.where(mc == 0, eff, bs.move_one)

    # --- result (UpdateResult, twixtboard.cc:192-207)
    shift_amt = player * 2
    win = ((nf >> shift_amt) & 1 != 0) & ((nf >> (shift_amt + 1)) & 1 != 0)
    opp = 1 - player
    opp_legal = jnp.where(opp == 0, legal[0], legal[1])
    opp_has_legal = _any_bits(opp_legal)
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

    return BitState(
        red=red,
        blue=blue,
        links=tuple(links),
        blocked=tuple(blocked),
        legal=legal,
        flags=flags,
        compid=compid,
        current_player=current_player,
        move_counter=mc + 1,
        move_one=move_one,
        swapped=bs.swapped | is_swap,
        result=result,
    )


def bit_legal_mask_flat(bs: BitState, player, board_size: int) -> jnp.ndarray:
    """Legal mask over the ``size*size`` action space, ascending action order.

    Bit-domain equivalent of ops/state.legal_mask_flat (reference legal-list
    semantics, twixtboard.cc:260-275): unpack the player's legal bitplane's
    inner window.  Returns bool [size*size, *B] (batch trailing, like every
    board op).
    """
    n = board_size
    sel = jnp.where(
        jnp.asarray(player) == 0, bs.legal[0], bs.legal[1]
    )  # [P, *B]
    core = sel[geo.PAD : geo.PAD + n]  # [n, *B]
    ys = jnp.arange(geo.PAD, geo.PAD + n, dtype=_U32).reshape(
        (1, n) + (1,) * (core.ndim - 1)
    )
    bits = ((core[:, None] >> ys) & _U32(1)) != 0  # [n, n, *B]
    return bits.reshape((n * n,) + core.shape[1:])


# --- sampling: exact popcount-rank selection on the legal bitplane ---------


def _hash_u32(x: jnp.ndarray) -> jnp.ndarray:
    x = x ^ (x >> _U32(16))
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> _U32(15))
    x = x * _U32(0x846CA68B)
    x = x ^ (x >> _U32(16))
    return x


def step_noise(seed, i, env) -> jnp.ndarray:
    """u32 sampling noise of step ``i`` for env ids ``env``: a counter-based
    hash of (seed, step), decorrelated across envs; the same bits on every
    backend."""
    return _hash_u32(
        seed + _U32(2654435761) * (i.astype(_U32) + _U32(1))
    ) + env * _U32(0x9E3779B9)


def _select_kth_bit(w: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Position of the (k+1)-th lowest set bit of u32 ``w`` (vectorised)."""
    pos = jnp.zeros_like(k)
    kk = k
    for width in (16, 8, 4, 2, 1):
        mask = _U32((1 << width) - 1)
        low = (w >> pos.astype(_U32)) & mask
        cnt = jax.lax.population_count(low).astype(jnp.int32)
        go_high = kk >= cnt
        kk = jnp.where(go_high, kk - cnt, kk)
        pos = jnp.where(go_high, pos + width, pos)
    return pos


def sample_bits(bs: BitState, board_size: int, noise) -> jnp.ndarray:
    """Uniform random legal action per env (int32 [*B]).

    Exact rank selection: k ~ U[0, popcount(legal)), then the k-th set bit in
    ascending (x, y) == ascending action-id order.  ``noise`` is a u32 [*B]
    counter/hash value (varies per step); sampling is deterministic in it.
    """
    p = jnp.clip(bs.current_player, 0, 1)
    legal = jnp.where(p == 0, bs.legal[0], bs.legal[1])  # [P, *B]
    cnt = jax.lax.population_count(legal).astype(jnp.int32)  # per column
    cum = jnp.cumsum(cnt, axis=0)  # [P, *B]
    total = cum[-1]  # [*B]

    bits = _hash_u32(noise)
    u = (bits >> _U32(8)).astype(jnp.int32).astype(jnp.float32) * (
        1.0 / 16777216.0
    )
    k = jnp.minimum(
        (u * total.astype(jnp.float32)).astype(jnp.int32), total - 1
    )
    k = jnp.maximum(k, 0)

    # column = first row where cum > k; k_in_col = k - cum[prev]
    cum_prev = cum - cnt
    sel = (cum > k) & (cum_prev <= k)  # one-hot over columns
    xs = jax.lax.broadcasted_iota(
        jnp.int32, legal.shape, 0
    )
    col = jnp.min(jnp.where(sel, xs, _BIG), axis=0)
    word = jnp.max(jnp.where(sel, legal, _U32(0)), axis=0)
    k_in_col = k - jnp.max(jnp.where(sel, cum_prev, 0), axis=0)
    y = _select_kth_bit(word, k_in_col)
    return (col - geo.PAD) * board_size + (y - geo.PAD)


# --- rollout driver ---------------------------------------------------------


def bit_step_auto_reset(bs: BitState, action, board_size: int):
    """step_bits(); terminal next-states are replaced by fresh initial states."""
    nxt = step_bits(bs, board_size, action)
    done = nxt.result != geo.RESULT_OPEN
    init = bit_reset(board_size)
    nxt_or_init = jax.tree_util.tree_map(
        lambda a, b: jnp.where(
            done, a.reshape(a.shape + (1,) * (b.ndim - a.ndim)), b
        ),
        init,
        nxt,
    )
    return nxt_or_init, done, nxt.result


@functools.partial(jax.jit, static_argnums=(1, 2))
def bit_random_rollout(seed, board_size: int, num_steps: int, bs: BitState):
    """Lockstep random rollout on the bitboard engine (cf. ops/rollout.py).

    ``seed`` is a u32/int scalar; per-(step, env) randomness comes from the
    counter-based hash (:func:`step_noise`), bit-identical on the GPU and
    the CPU (chip_smoke.py phase b).
    """
    batch_shape = bs.current_player.shape
    nenv = 1
    for d in batch_shape:
        nenv *= int(d)
    env = jnp.arange(nenv, dtype=_U32).reshape(batch_shape or ())
    seed = jnp.asarray(seed, _U32)

    def body(i, carry):
        bs, episodes, results = carry
        noise = step_noise(seed, i, env)
        actions = sample_bits(bs, board_size, noise)
        nxt, done, result = bit_step_auto_reset(bs, actions, board_size)
        episodes = episodes + jnp.sum(done, dtype=jnp.int32)
        results = results + jnp.stack(
            [
                jnp.sum(done & (result == r), dtype=jnp.int32)
                for r in range(4)
            ]
        )
        return nxt, episodes, results

    bs, episodes, results = jax.lax.fori_loop(
        0, num_steps, body, (bs, jnp.int32(0), jnp.zeros((4,), jnp.int32))
    )
    return bs, {"episodes": episodes, "results": results}


@functools.partial(jax.jit, static_argnums=(1, 2), static_argnames=("packed",))
def bit_rollout_emit_obs(
    seed, board_size: int, num_steps: int, bs: BitState, packed: bool = False
):
    """Lockstep random rollout emitting the observation tensor at EVERY step
    — the learner-feed workload (BASELINE config 4): each step's observation
    is materialised to device memory exactly as a learner consumer would
    read it,
    batch-leading, in bfloat16 (the learner's input dtype; planes are
    binary so bf16 is exact — models/network.py casts to bf16 regardless).

    Same transition/RNG as :func:`bit_random_rollout` (reference semantics
    twixt.cc:101-132 for the tensor, twixtboard.cc:457-499 for the step).
    Returns (final_state, stats, obs[T, B, 12, n, n-2] bf16).  ``bs`` must
    carry a 1-D trailing env batch.

    With ``packed=True`` ``obs`` is the exact-but-compressed packed
    encoding instead — ONE array ``[T, B, 12*P]`` of u32 column words
    (~1 bit/cell, 16-32x fewer bytes than bf16): the observation
    planes with the mover's packed LEGAL plane riding in the words' free
    low bits (ops/observe.bit_observation_packed_with_legal) — the full
    self-play wire (models/selfplay.Sample), one scan output with no
    extra bytes for the legal plane (scripts/perf_obs_wire.py compares
    the alternatives).  The learner decodes the obs words with
    ``reshape(T, B, 12, P)`` + ``ops.observe.unpack_observation_nchw``
    fused into its input transpose and the legal mask with
    ``ops.observe.legal_words_from_obs`` +
    ``ops.observe.unpack_legal_words_flat``.  Both decodes are pinned
    bit-exact (tests/test_bitboard.py, tests/test_models.py).  The
    trailing dims are COALESCED into one, so each step writes one dense
    [B, 12*P] block (scripts/perf_obs_emit.py compares the 3-D form).
    """
    from twixt_for_open_spiel_tpu.ops.observe import (
        bit_observation_nchw,
        bit_observation_packed_with_legal,
    )

    nenv = bs.current_player.shape[-1]
    env = jnp.arange(nenv, dtype=_U32)
    seed = jnp.asarray(seed, _U32)

    def body(carry, i):
        bs, episodes = carry
        if packed:
            # one [B, 12*P] wire: obs planes + stowaway legal plane in
            # the free low bits (models/selfplay.Sample wire format)
            obs = bit_observation_packed_with_legal(bs, board_size)
        else:
            obs = bit_observation_nchw(bs, board_size, jnp.bfloat16)
        noise = step_noise(seed, i, env)
        actions = sample_bits(bs, board_size, noise)
        nxt, done, _ = bit_step_auto_reset(bs, actions, board_size)
        return (nxt, episodes + jnp.sum(done, dtype=jnp.int32)), obs

    (bs, episodes), obs = jax.lax.scan(
        body, (bs, jnp.int32(0)), jnp.arange(num_steps)
    )
    return bs, {"episodes": episodes}, obs
