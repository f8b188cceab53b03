#!/usr/bin/env python
"""Prototype bitboard step v2: unstacked planes + windowed cid extraction.

Two changes vs ops/bitboard.py, motivated by the HLO dump
(scripts/hlo_bit_step.py):
  1. links/blocked/legal/flags carried as TUPLES of [P, *B] planes instead
     of stacked [8|4|2, P, *B] arrays — the stacked carries cost ~10 layout
     copies + 9 dynamic-update-slices of [8,18,4096] u32 per step.
  2. neighbor component-ids extracted via a 5-row window (one multi-output
     reduce over x, then 8 cheap [P,*B] reduces over y) instead of 8
     independent full-board masked reduces over [P,P,*B].

Validates v2 against the production rollout (same seed => same actions =>
identical episode counters and final popcounts), then times both.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from twixt_for_open_spiel_tpu.ops import bitboard as bb
from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.state import (
    onehot_board,
    padded_size,
    swap_rotate_action,
)

_U32 = jnp.uint32
_BIG = 1 << 20


class BitState2(NamedTuple):
    red: jnp.ndarray
    blue: jnp.ndarray
    links: tuple  # 8 x [P, *B] u32
    blocked: tuple  # 8 x
    legal: tuple  # 2 x
    flags: tuple  # 4 x
    compid: jnp.ndarray
    current_player: jnp.ndarray
    move_counter: jnp.ndarray
    move_one: jnp.ndarray
    swapped: jnp.ndarray
    result: jnp.ndarray


def to2(bs: bb.BitState) -> BitState2:
    return BitState2(
        red=bs.red,
        blue=bs.blue,
        links=tuple(bs.links[d] for d in range(8)),
        blocked=tuple(bs.blocked[d] for d in range(8)),
        legal=(bs.legal[0], bs.legal[1]),
        flags=tuple(bs.flags[b] for b in range(4)),
        compid=bs.compid,
        current_player=bs.current_player,
        move_counter=bs.move_counter,
        move_one=bs.move_one,
        swapped=bs.swapped,
        result=bs.result,
    )


def to1(bs: BitState2) -> bb.BitState:
    return bb.BitState(
        red=bs.red,
        blue=bs.blue,
        links=jnp.stack(bs.links),
        blocked=jnp.stack(bs.blocked),
        legal=jnp.stack(bs.legal),
        flags=jnp.stack(bs.flags),
        compid=bs.compid,
        current_player=bs.current_player,
        move_counter=bs.move_counter,
        move_one=bs.move_one,
        swapped=bs.swapped,
        result=bs.result,
    )


def step_bits2(bs: BitState2, board_size: int, action) -> BitState2:
    player = bs.current_player
    mc = bs.move_counter
    action = jnp.asarray(action, jnp.int32)

    is_swap = (mc == 1) & (action == bs.move_one)

    m_one = bb._onehot_bits(bs.move_one, board_size)
    undo = jnp.where(is_swap, m_one, _U32(0))
    red = bs.red & ~undo
    blue = bs.blue & ~undo

    eff = jnp.where(is_swap, swap_rotate_action(action, board_size), action)
    me = bb._onehot_bits(eff, board_size)

    rm1 = jnp.where((mc == 1) & ~is_swap, m_one, _U32(0))
    legal = tuple(l & ~rm1 for l in bs.legal)

    is_red = player == 0
    red = jnp.where(is_red, red | me, red)
    blue = jnp.where(is_red, blue, blue | me)
    mine = jnp.where(is_red, red, blue)

    links = list(bs.links)
    blocked = list(bs.blocked)
    nl_board = []
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        same = me & bb._shiftp(mine, dx, dy)
        cross = jnp.zeros_like(me)
        for ox, oy, d2 in geo.CROSSERS[d]:
            cross = cross | bb._shiftp(bs.links[int(d2)], int(ox), int(oy))
        linked = same & ~cross
        blkd = same & cross
        od = geo.opp_dir(d)
        links[d] = links[d] | linked
        links[od] = links[od] | bb._shiftp(linked, -dx, -dy)
        blocked[d] = blocked[d] | blkd
        blocked[od] = blocked[od] | bb._shiftp(blkd, -dx, -dy)
        nl_board.append(linked)

    nb_mask = me
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        nb_mask = nb_mask | bb._shiftp(nl_board[d], -dx, -dy)
    nf = jnp.zeros(player.shape, jnp.int32)
    for b in range(4):
        nf = nf | jnp.where(
            bb._any_bits(bs.flags[b] & nb_mask), jnp.int32(1 << b), 0
        )

    # --- windowed neighbor-cid extraction -------------------------------
    p = padded_size(board_size)
    px = eff // board_size + geo.PAD  # [*B]
    py = eff % board_size + geo.PAD
    compid32 = bs.compid.astype(jnp.int32)  # [P, P, *B]
    bdims = compid32.ndim - 2
    xs = jax.lax.broadcasted_iota(jnp.int32, (p,) + (1,) * (bdims + 1), 0)
    ys = jax.lax.broadcasted_iota(jnp.int32, (p,) + (1,) * bdims, 0)
    # 5 window rows x = px-2 .. px+2, each [P(y), *B]; one traversal of
    # compid (multi-output reduce over x)
    wins = [
        jnp.max(
            jnp.where(xs == px + (r - 2), compid32, -_BIG), axis=0
        )
        for r in range(5)
    ]
    nl_any = [bb._any_bits(nl) for nl in nl_board]
    nid = eff
    cids = []
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        raw = jnp.max(
            jnp.where(ys == py + dy, wins[dx + 2], -_BIG), axis=0
        )  # [*B]
        cid = jnp.where(nl_any[d], raw, jnp.int32(-7))
        cids.append(cid)
        nid = jnp.minimum(nid, jnp.where(cid >= 0, cid, _BIG))

    me_board = onehot_board(eff, board_size)
    hit = me_board
    for cid in cids:
        hit = hit | ((compid32 == cid) & (cid >= 0))
    compid = jnp.where(hit, nid.astype(bs.compid.dtype), bs.compid)

    hit_bits = bb._pack_bool(hit)
    flags = tuple(
        jnp.where(((nf >> b) & 1) != 0, bs.flags[b] | hit_bits, bs.flags[b])
        for b in range(4)
    )

    rm = jnp.where(mc == 0, _U32(0), me)
    legal = tuple(l & ~rm for l in legal)
    move_one = jnp.where(mc == 0, eff, bs.move_one)

    shift_amt = player * 2
    win = ((nf >> shift_amt) & 1 != 0) & ((nf >> (shift_amt + 1)) & 1 != 0)
    opp = 1 - player
    opp_legal = jnp.where(opp == 0, legal[0], legal[1])
    opp_has_legal = bb._any_bits(opp_legal)
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

    return BitState2(
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


def sample_bits2(bs: BitState2, board_size: int, noise):
    p = jnp.clip(bs.current_player, 0, 1)
    legal = jnp.where(p == 0, bs.legal[0], bs.legal[1])
    cnt = jax.lax.population_count(legal).astype(jnp.int32)
    cum = jnp.cumsum(cnt, axis=0)
    total = cum[-1]
    bits = bb._hash_u32(noise)
    u = (bits >> _U32(8)).astype(jnp.int32).astype(jnp.float32) * (
        1.0 / 16777216.0
    )
    k = jnp.minimum(
        (u * total.astype(jnp.float32)).astype(jnp.int32), total - 1
    )
    k = jnp.maximum(k, 0)
    cum_prev = cum - cnt
    sel = (cum > k) & (cum_prev <= k)
    xs = jax.lax.broadcasted_iota(jnp.int32, legal.shape, 0)
    col = jnp.min(jnp.where(sel, xs, _BIG), axis=0)
    word = jnp.max(jnp.where(sel, legal, _U32(0)), axis=0)
    k_in_col = k - jnp.max(jnp.where(sel, cum_prev, 0), axis=0)
    y = bb._select_kth_bit(word, k_in_col)
    return (col - geo.PAD) * board_size + (y - geo.PAD)


@functools.partial(jax.jit, static_argnums=(1, 2))
def bit_random_rollout2(seed, board_size: int, num_steps: int, bs: BitState2):
    batch_shape = bs.current_player.shape
    nenv = 1
    for d in batch_shape:
        nenv *= int(d)
    env = jnp.arange(nenv, dtype=_U32).reshape(batch_shape or ())
    seed = jnp.asarray(seed, _U32)
    init = to2(bb.bit_reset(board_size))

    def body(i, carry):
        bs, episodes, results = carry
        noise = bb._hash_u32(
            seed + _U32(2654435761) * (i.astype(_U32) + _U32(1))
        ) + env * _U32(0x9E3779B9)
        actions = sample_bits2(bs, board_size, noise)
        nxt = step_bits2(bs, board_size, actions)
        result = nxt.result
        done = result != geo.RESULT_OPEN
        nxt = jax.tree_util.tree_map(
            lambda a, b: jnp.where(
                done, a.reshape(a.shape + (1,) * (b.ndim - a.ndim)), b
            ),
            init,
            nxt,
        )
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


# --- v3: compid restricted to the inner n x n board -------------------------


def to3(bs):
    """v2/v1 BitState -> v3 (compid sliced to the inner board)."""
    n = bs.compid.shape[0] - 2 * geo.PAD
    inner = bs.compid[
        geo.PAD : geo.PAD + n, geo.PAD : geo.PAD + n
    ]
    return bs._replace(compid=inner)


def step_bits3(bs, board_size: int, action):
    """step_bits2 with compid [n, n, *B] (halo cells never hold pegs)."""
    player = bs.current_player
    mc = bs.move_counter
    action = jnp.asarray(action, jnp.int32)

    is_swap = (mc == 1) & (action == bs.move_one)
    m_one = bb._onehot_bits(bs.move_one, board_size)
    undo = jnp.where(is_swap, m_one, _U32(0))
    red = bs.red & ~undo
    blue = bs.blue & ~undo

    eff = jnp.where(is_swap, swap_rotate_action(action, board_size), action)
    me = bb._onehot_bits(eff, board_size)

    rm1 = jnp.where((mc == 1) & ~is_swap, m_one, _U32(0))
    legal = tuple(l & ~rm1 for l in bs.legal)

    is_red = player == 0
    red = jnp.where(is_red, red | me, red)
    blue = jnp.where(is_red, blue, blue | me)
    mine = jnp.where(is_red, red, blue)

    links = list(bs.links)
    blocked = list(bs.blocked)
    nl_board = []
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        same = me & bb._shiftp(mine, dx, dy)
        cross = jnp.zeros_like(me)
        for ox, oy, d2 in geo.CROSSERS[d]:
            cross = cross | bb._shiftp(bs.links[int(d2)], int(ox), int(oy))
        linked = same & ~cross
        blkd = same & cross
        od = geo.opp_dir(d)
        links[d] = links[d] | linked
        links[od] = links[od] | bb._shiftp(linked, -dx, -dy)
        blocked[d] = blocked[d] | blkd
        blocked[od] = blocked[od] | bb._shiftp(blkd, -dx, -dy)
        nl_board.append(linked)

    nb_mask = me
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        nb_mask = nb_mask | bb._shiftp(nl_board[d], -dx, -dy)
    nf = jnp.zeros(player.shape, jnp.int32)
    for b in range(4):
        nf = nf | jnp.where(
            bb._any_bits(bs.flags[b] & nb_mask), jnp.int32(1 << b), 0
        )

    n = board_size
    px = eff // n  # inner coords, no PAD
    py = eff % n
    compid32 = bs.compid.astype(jnp.int32)  # [n, n, *B]
    bdims = compid32.ndim - 2
    xs = jax.lax.broadcasted_iota(jnp.int32, (n,) + (1,) * (bdims + 1), 0)
    ys = jax.lax.broadcasted_iota(jnp.int32, (n,) + (1,) * bdims, 0)
    wins = [
        jnp.max(jnp.where(xs == px + (r - 2), compid32, -_BIG), axis=0)
        for r in range(5)
    ]
    nl_any = [bb._any_bits(nl) for nl in nl_board]
    nid = eff
    cids = []
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        raw = jnp.max(
            jnp.where(ys == py + dy, wins[dx + 2], -_BIG), axis=0
        )
        cid = jnp.where(nl_any[d], raw, jnp.int32(-7))
        cids.append(cid)
        nid = jnp.minimum(nid, jnp.where(cid >= 0, cid, _BIG))

    me_inner = (xs == px) & jnp.expand_dims(ys == py, 0)
    hit = me_inner
    for cid in cids:
        hit = hit | ((compid32 == cid) & (cid >= 0))
    compid = jnp.where(hit, nid.astype(bs.compid.dtype), bs.compid)

    # pack hit [n, n, *B] -> full padded bitplane [P, *B]
    ybits = _U32(1) << (
        jnp.arange(n, dtype=_U32).reshape((1, n) + (1,) * bdims) + geo.PAD
    )
    inner_bits = jnp.sum(
        jnp.where(hit, ybits, _U32(0)), axis=1, dtype=_U32
    )  # [n, *B]
    zpad = jnp.zeros((geo.PAD,) + inner_bits.shape[1:], _U32)
    hit_bits = jnp.concatenate([zpad, inner_bits, zpad], axis=0)

    flags = tuple(
        jnp.where(((nf >> b) & 1) != 0, bs.flags[b] | hit_bits, bs.flags[b])
        for b in range(4)
    )

    rm = jnp.where(mc == 0, _U32(0), me)
    legal = tuple(l & ~rm for l in legal)
    move_one = jnp.where(mc == 0, eff, bs.move_one)

    shift_amt = player * 2
    win = ((nf >> shift_amt) & 1 != 0) & ((nf >> (shift_amt + 1)) & 1 != 0)
    opp = 1 - player
    opp_legal = jnp.where(opp == 0, legal[0], legal[1])
    opp_has_legal = bb._any_bits(opp_legal)
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

    return bs._replace(
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


@functools.partial(jax.jit, static_argnums=(1, 2))
def bit_random_rollout3(seed, board_size: int, num_steps: int, bs):
    batch_shape = bs.current_player.shape
    nenv = 1
    for d in batch_shape:
        nenv *= int(d)
    env = jnp.arange(nenv, dtype=_U32).reshape(batch_shape or ())
    seed = jnp.asarray(seed, _U32)
    init = to3(bb.bit_reset(board_size))

    def body(i, carry):
        bs, episodes, results = carry
        noise = bb._hash_u32(
            seed + _U32(2654435761) * (i.astype(_U32) + _U32(1))
        ) + env * _U32(0x9E3779B9)
        actions = sample_bits2(bs, board_size, noise)
        nxt = step_bits3(bs, board_size, actions)
        result = nxt.result
        done = result != geo.RESULT_OPEN
        nxt = jax.tree_util.tree_map(
            lambda a, b: jnp.where(
                done, a.reshape(a.shape + (1,) * (b.ndim - a.ndim)), b
            ),
            init,
            nxt,
        )
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


def _readback(out):
    leaves = jax.tree_util.tree_leaves(out)
    return np.asarray(leaves[-1]).ravel()[0]


def timeit(fn, reps=3):
    out = fn()
    _readback(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _readback(out)
    return (time.perf_counter() - t0) / reps, out


def main():
    print(f"backend={jax.default_backend()}", file=sys.stderr)
    n, batch = 12, 4096
    steps = 20 if jax.default_backend() == "cpu" else 1000
    bs1 = bb.bit_reset(n, batch)  # production engine (== v2 after landing)
    bs3 = to3(bs1)

    dt1, out1 = timeit(lambda: bb.bit_random_rollout(7, n, steps, bs1))
    dt3, out3 = timeit(lambda: bit_random_rollout3(7, n, steps, bs3))
    r1 = batch * steps / dt1
    r3 = batch * steps / dt3
    print(f"prod: {r1/1e6:8.1f}M env-steps/s ({dt1*1e3:.1f}ms)")
    print(f"  v3: {r3/1e6:8.1f}M env-steps/s ({dt3*1e3:.1f}ms)")

    # same seed => identical trajectories => identical final state
    f1, s1 = out1
    f3, s3 = out3
    f1i = to3(f1)  # compare on the inner compid
    ok = True
    l1 = jax.tree_util.tree_leaves(f1i)
    l3 = jax.tree_util.tree_leaves(f3)
    for a, b in zip(l1, l3):
        a, b = np.asarray(a), np.asarray(b)
        if not np.array_equal(a, b):
            ok = False
            print(f"MISMATCH {a.shape}: {np.sum(a != b)} cells differ")
    print(
        f"episodes prod={int(s1['episodes'])} v3={int(s3['episodes'])} "
        f"results prod={np.asarray(s1['results']).tolist()} "
        f"v3={np.asarray(s3['results']).tolist()} "
        f"state_equal={ok}"
    )


if __name__ == "__main__":
    main()
