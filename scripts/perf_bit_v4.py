#!/usr/bin/env python
"""Prototype bitboard step v4: canonical link planes + scalar window probes.

Three changes vs the production ops/bitboard.py step:
  1. links/blocked carried as 4 CANONICAL east-direction planes (each link /
     blocked pair stored once, at its west endpoint) instead of 8 symmetric
     planes — the crossing rule only ever probes canonical planes, so the
     west planes were pure write traffic (halves the link-update plane ops
     and shrinks the carried state by 8 [P,*B] planes).
  2. the 8x9 crossing probes + 8 same-color probes + 9x4 flag probes become
     SCALAR bit tests against a handful of window rows extracted from the
     planes with masked row reductions (the trick that already paid 2.4x for
     compid) — replacing ~200 whole-plane shift/or ops per step with ~50 row
     reductions + cheap [*B] scalar ops.
  3. compid compares run in int16 (the storage dtype) instead of casting the
     whole [N,N,*B] board to int32 every step.

Validates v4 against the production rollout (same seed / same RNG => must
produce identical trajectories: equal episode counters, results, and
converted final states), then times both on the current backend.
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
from twixt_for_open_spiel_tpu.ops.state import swap_rotate_action

_U32 = jnp.uint32
_BIG = 1 << 20
_I16_SENTINEL = jnp.int16(-20000)


class BitState4(NamedTuple):
    red: jnp.ndarray
    blue: jnp.ndarray
    links: tuple  # 4 canonical planes [P, *B]
    blocked: tuple  # 4 canonical planes
    legal: tuple  # 2
    flags: tuple  # 4
    compid: jnp.ndarray  # [N, N, *B] i16
    current_player: jnp.ndarray
    move_counter: jnp.ndarray
    move_one: jnp.ndarray
    swapped: jnp.ndarray
    result: jnp.ndarray


def to4(bs: bb.BitState) -> BitState4:
    return BitState4(
        red=bs.red,
        blue=bs.blue,
        links=tuple(bs.links[:4]),
        blocked=tuple(bs.blocked[:4]),
        legal=bs.legal,
        flags=bs.flags,
        compid=bs.compid,
        current_player=bs.current_player,
        move_counter=bs.move_counter,
        move_one=bs.move_one,
        swapped=bs.swapped,
        result=bs.result,
    )


def to1(bs: BitState4) -> bb.BitState:
    """Reconstruct the 8-plane state: west bit d at cell c == canonical bit
    d-4 at cell c+OFF[d] (links and blocked are recorded symmetrically)."""

    def west(planes, d):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        return bb._shiftp(planes[d - 4], dx, dy)

    links = tuple(bs.links) + tuple(west(bs.links, d) for d in range(4, 8))
    blocked = tuple(bs.blocked) + tuple(
        west(bs.blocked, d) for d in range(4, 8)
    )
    return bb.BitState(
        red=bs.red,
        blue=bs.blue,
        links=links,
        blocked=blocked,
        legal=bs.legal,
        flags=bs.flags,
        compid=bs.compid,
        current_player=bs.current_player,
        move_counter=bs.move_counter,
        move_one=bs.move_one,
        swapped=bs.swapped,
        result=bs.result,
    )


def step_bits4(bs: BitState4, board_size: int, action) -> BitState4:
    n = board_size
    p = bs.red.shape[0]
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

    px = eff // n  # inner coords
    py = eff % n
    pxp = px + geo.PAD
    pyp = py + geo.PAD
    bdims = px.ndim
    xs_p = jax.lax.broadcasted_iota(jnp.int32, (p,) + (1,) * bdims, 0)

    def xrow(plane, row):
        """Word at board row ``row`` ([*B] int32 coords) of a u32 plane."""
        m = xs_p == row
        return jnp.max(
            jnp.where(m, plane.astype(jnp.int32), 0), axis=0
        ).astype(_U32)

    def probe(word, ybit):
        return ((word >> ybit.astype(_U32)) & _U32(1)) != 0

    # window rows actually needed, per canonical plane (trace-time sets)
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

    # --- links / blocked via scalar probes (SetPegAndLinks,
    # twixtboard.cc:501-571)
    links = list(bs.links)
    blocked = list(bs.blocked)
    linked_s = []
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
            tgt = bb._shiftp(me, -dx, -dy)
            links[d - 4] = links[d - 4] | jnp.where(linked, tgt, _U32(0))
            blocked[d - 4] = blocked[d - 4] | jnp.where(blkd, tgt, _U32(0))

    # --- merged flag byte: own cell | each newly linked neighbor (scalars)
    nf = jnp.zeros(player.shape, jnp.int32)
    for b in range(4):
        got = probe(flag_rows[(b, 0)], pyp)
        for d in range(geo.NUM_DIRS):
            dx, dy = (int(v) for v in geo.OFFSETS[d])
            got = got | (
                linked_s[d] & probe(flag_rows[(b, dx)], pyp + dy)
            )
        nf = nf | jnp.where(got, jnp.int32(1 << b), 0)

    # --- union-find merge; compares in the i16 storage dtype
    compid = bs.compid
    xs = jax.lax.broadcasted_iota(jnp.int32, (n,) + (1,) * (bdims + 1), 0)
    ys = jax.lax.broadcasted_iota(jnp.int32, (n,) + (1,) * bdims, 0)
    wins = [
        jnp.max(jnp.where(xs == px + (r - 2), compid, _I16_SENTINEL), axis=0)
        for r in range(5)
    ]
    nid = eff
    cids = []
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        raw = jnp.max(
            jnp.where(ys == py + dy, wins[dx + 2], _I16_SENTINEL), axis=0
        )  # [*B] i16
        cid = jnp.where(linked_s[d], raw, jnp.int16(-7))
        cids.append(cid)
        nid = jnp.minimum(
            nid, jnp.where(cid >= 0, cid.astype(jnp.int32), _BIG)
        )

    ys_row = jax.lax.broadcasted_iota(jnp.int32, (1, n) + (1,) * bdims, 1)
    me_inner = (xs == px) & (ys_row == py)
    hit = me_inner
    for cid in cids:
        hit = hit | ((compid == cid) & (cid >= 0))
    compid = jnp.where(hit, nid.astype(compid.dtype), compid)

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

    return BitState4(
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
def bit_random_rollout4(seed, board_size: int, num_steps: int, bs: BitState4):
    batch_shape = bs.current_player.shape
    nenv = 1
    for d in batch_shape:
        nenv *= int(d)
    env = jnp.arange(nenv, dtype=_U32).reshape(batch_shape or ())
    seed = jnp.asarray(seed, _U32)
    init4 = to4(bb.bit_reset(board_size))

    def body2(i, carry):
        bs, episodes, results = carry
        noise = bb._hash_u32(
            seed + _U32(2654435761) * (i.astype(_U32) + _U32(1))
        ) + env * _U32(0x9E3779B9)
        actions = bb.sample_bits(bs, board_size, noise)
        nxt = step_bits4(bs, board_size, actions)
        result = nxt.result
        done = result != geo.RESULT_OPEN
        nxt = jax.tree_util.tree_map(
            lambda a, b: jnp.where(
                done, a.reshape(a.shape + (1,) * (b.ndim - a.ndim)), b
            ),
            init4,
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
        0, num_steps, body2, (bs, jnp.int32(0), jnp.zeros((4,), jnp.int32))
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


def validate(n, batch, steps, seed=5):
    bs0 = bb.bit_reset(n, batch)
    f1, s1 = bb.bit_random_rollout(seed, n, steps, bs0)
    f4, s4 = bit_random_rollout4(seed, n, steps, to4(bs0))
    f4c = to1(f4)
    ok = True
    for a, b in zip(
        jax.tree_util.tree_leaves(f1), jax.tree_util.tree_leaves(f4c)
    ):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            ok = False
    same_stats = int(s1["episodes"]) == int(s4["episodes"]) and np.array_equal(
        np.asarray(s1["results"]), np.asarray(s4["results"])
    )
    print(
        f"validate n={n} batch={batch} steps={steps}: state_equal={ok} "
        f"stats_equal={same_stats} episodes={int(s1['episodes'])}"
    )
    return ok and same_stats


def main():
    backend = jax.default_backend()
    print(f"backend={backend}", file=sys.stderr)
    if backend == "cpu":
        assert validate(5, 64, 60)
        assert validate(8, 32, 90)
        assert validate(12, 16, 40)
        assert validate(24, 8, 30)
        print("CPU validation passed")
        return

    n, batch, steps = 12, 4096, 1000
    bs0 = bb.bit_reset(n, batch)
    bs4 = to4(bs0)
    dt1, o1 = timeit(lambda: bb.bit_random_rollout(7, n, steps, bs0))
    dt4, o4 = timeit(lambda: bit_random_rollout4(7, n, steps, bs4))
    print(f"xla v3 : {batch*steps/dt1/1e6:8.1f}M env-steps/s ({dt1*1e3:.1f}ms)")
    print(f"xla v4 : {batch*steps/dt4/1e6:8.1f}M env-steps/s ({dt4*1e3:.1f}ms)")
    print(
        f"episodes v3={int(o1[1]['episodes'])} v4={int(o4[1]['episodes'])}"
    )
    # large board too
    n2, b2, s2 = 24, 8192, 250
    bs0 = bb.bit_reset(n2, b2)
    dt1, _ = timeit(lambda: bb.bit_random_rollout(7, n2, s2, bs0))
    dt4, _ = timeit(lambda: bit_random_rollout4(7, n2, s2, to4(bs0)))
    print(f"n=24 v3: {b2*s2/dt1/1e6:8.1f}M  v4: {b2*s2/dt4/1e6:8.1f}M")


if __name__ == "__main__":
    main()
