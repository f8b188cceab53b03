"""Observation-tensor emission: 12 planes x size x (size-2), CHW.

Array-program equivalent of TwixTState::ObservationTensor /
SetPegAndLinksOnTensor (reference twixt.cc:76-132) and GetTensorPosition
(reference twixtboard.cc:590-597).  The reference's per-cell scatter loop
becomes pure bit-unpacking + flips/slices: the coordinate remaps are static
permutations, so the whole observation is a fused elementwise+transpose XLA
program with no gather/scatter.

Batch-polymorphic like ops/step.py: board leaves may carry trailing env
batch dims, giving [12, size, size-2, *B] outputs with the env batch still
the minor ("lane-major") dimension.  ``observation_nchw`` converts to the
batch-leading layout the network consumes.

Plane semantics (identical for both observing players):
  plane 0 / 6   peg of that color with NO links (twixt.cc:90-93)
  plane 1+d / 7+d  (d in NNE,ENE,ESE,SSE)  peg has a link in east direction d
                (east-side dedup: every link is recorded once, from its west
                endpoint; twixt.cc:84-89)
  plane 5 / 11  peg has blocked east-side neighbors (mask 15 over dirs 0-3,
                reference twixtcell.h:82-84, twixt.cc:96-98)

Coordinate remaps (reference twixtboard.cc:590-597) drop the opponent's
endline columns:
  red  block (planes 0-5):  out[row, col] = cell[x = col+1, y = size-1-row]
  blue block (planes 6-11): out[row, col] = cell[x = size-1-row, y = size-2-col]
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.state import State

_U8 = jnp.uint8


def _red_view(arr: jnp.ndarray, size: int) -> jnp.ndarray:
    """[P,P,*B] board array -> [size, size-2, *B] red-block coords."""
    core = arr[geo.PAD : geo.PAD + size, geo.PAD : geo.PAD + size]
    # out[r, c] = core[c + 1, size - 1 - r]
    return jnp.flip(jnp.swapaxes(core, 0, 1), axis=0)[:, 1 : size - 1]


def _blue_view(arr: jnp.ndarray, size: int) -> jnp.ndarray:
    """[P,P,*B] board array -> [size, size-2, *B] blue-block coords."""
    core = arr[geo.PAD : geo.PAD + size, geo.PAD : geo.PAD + size]
    # out[r, c] = core[size - 1 - r, size - 2 - c]
    return jnp.flip(core, axis=(0, 1))[:, 1 : size - 1]


@functools.partial(jax.jit, static_argnums=1)
def observation(state: State, board_size: int) -> jnp.ndarray:
    """float32 [12, size, size-2, *B] observation tensor.

    Identical for both observing players (reference twixt.cc:101-132 emits
    the same planes regardless of ``player``).
    """
    planes = []
    for color_val, view in (
        (geo.COLOR_RED, _red_view),
        (geo.COLOR_BLUE, _blue_view),
    ):
        is_color = view(state.color == jnp.int8(color_val), board_size)
        links = view(state.links, board_size)
        blocked = view(state.blocked, board_size)
        has_links = links != 0
        planes.append(is_color & ~has_links)  # plane 0 / 6
        for d in range(4):  # planes 1-4 / 7-10: NNE, ENE, ESE, SSE
            planes.append(is_color & (((links >> _U8(d)) & _U8(1)) != 0))
        planes.append(is_color & ((blocked & _U8(15)) != 0))  # plane 5 / 11
    return jnp.stack(planes).astype(jnp.float32)


@functools.partial(jax.jit, static_argnums=1)
def observation_nchw(state: State, board_size: int) -> jnp.ndarray:
    """Batched observation in the network's layout: [B, 12, size, size-2].

    One transpose at the boundary between the lane-batched env world and the
    batch-leading learner world.
    """
    obs = observation(state, board_size)  # [12, n, n-2, B]
    return jnp.moveaxis(obs, -1, 0)


@functools.partial(jax.jit, static_argnums=(1, 2))
def bit_observation(bs, board_size: int, dtype=jnp.float32) -> jnp.ndarray:
    """Observation straight from the bitboard state (no canonical detour).

    Same planes/remaps as :func:`observation` (reference twixt.cc:76-132,
    twixtboard.cc:590-597), computed from the packed planes:

      * planes 1+d / 7+d are exactly the canonical east-direction link planes
        (links are stored once, at their west endpoint — the same east-side
        dedup the reference's tensor emission performs, twixt.cc:84-89);
      * "peg with no links" needs all 8 directions, so the canonical planes
        are expanded with shifted reads before the OR;
      * "blocked east neighbors" (mask 15) is the OR of the canonical
        blocked planes (blocked pairs are recorded on both endpoints in the
        reference, twixtboard.cc:536-541, so the canonical bit is the east
        bit).

    Pinned bit-equal to ``observation(to_state(bs))`` by
    tests/test_bitboard.py.  Returns [12, size, size-2, *B] in ``dtype``
    (default float32 — the reference's TensorView is float; planes are
    binary, so bfloat16 is exact and halves learner-feed bandwidth).
    """
    from twixt_for_open_spiel_tpu.ops.bitboard import (
        _unpack_bool,
        expand_planes,
    )
    from twixt_for_open_spiel_tpu.ops.state import padded_size

    p = padded_size(board_size)
    red = _unpack_bool(bs.red, p)
    blue = _unpack_bool(bs.blue, p)
    east = [_unpack_bool(pl, p) for pl in bs.links]
    any_link_plane = bs.links[0]
    for pl in expand_planes(bs.links)[1:]:
        any_link_plane = any_link_plane | pl
    has_links = _unpack_bool(any_link_plane, p)
    blocked_e = _unpack_bool(
        bs.blocked[0] | bs.blocked[1] | bs.blocked[2] | bs.blocked[3], p
    )

    planes = []
    for is_color, view in ((red, _red_view), (blue, _blue_view)):
        c = view(is_color, board_size)
        planes.append(c & ~view(has_links, board_size))  # plane 0 / 6
        for d in range(4):  # planes 1-4 / 7-10
            planes.append(c & view(east[d], board_size))
        planes.append(c & view(blocked_e, board_size))  # plane 5 / 11
    return jnp.stack(planes).astype(dtype)


@functools.partial(jax.jit, static_argnums=(1,))
def bit_observation_packed_lanes(bs, board_size: int) -> jnp.ndarray:
    """Observation as PACKED u32 column words in the ENGINE's lane-major
    layout: [12, P, B] (env batch trailing).

    The cheapest possible materialisation of the observation — pure
    bitwise ops on the engine's bitplanes, NO cross-layout transpose: that
    cost moves to the consumer, who pays it once per training chunk
    (amortised over T x B frames) instead of once per env step.  This is
    the wire format the self-play learner feed stores
    (models/selfplay.Sample) and the primary config-4 bench row.

    Decode: transpose to [..., B, 12, P] and apply
    :func:`unpack_observation_nchw` (or use
    :func:`unpack_observation_lanes_nchw`).  Plane semantics match the
    reference's tensor emission exactly (twixt.cc:76-132).
    """
    from twixt_for_open_spiel_tpu.ops.bitboard import expand_planes

    any_link = bs.links[0]
    for pl in expand_planes(bs.links)[1:]:
        any_link = any_link | pl
    blocked_e = bs.blocked[0] | bs.blocked[1] | bs.blocked[2] | bs.blocked[3]
    packed = []
    for is_color in (bs.red, bs.blue):
        packed.append(is_color & ~any_link)   # plane 0 / 6
        for d in range(4):                    # planes 1-4 / 7-10
            packed.append(is_color & bs.links[d])
        packed.append(is_color & blocked_e)   # plane 5 / 11
    return jnp.stack(packed)                  # [12, P, *B] u32


# The self-play wire rides the legal plane INSIDE the obs words' free
# bits: every packed word's live bits sit at y in [PAD, PAD+n) = [3, 27)
# for n <= 24, leaving the LOW PAD=3 bits of every plane word free.  The
# mover's legal word for a column (n live bits) is split into 3-bit
# chunks carried by planes 0..7 of the same column — 8 planes x 3 bits =
# 24 bits >= n.  This keeps the wire a SINGLE [B, 12*P] scan output with
# no extra bytes (scripts/perf_obs_wire.py times it against a second
# legal output and a 13-plane concat).
_LEGAL_CHUNK_BITS = 3
_LEGAL_CHUNK_PLANES = 8
assert _LEGAL_CHUNK_BITS == geo.PAD
assert _LEGAL_CHUNK_BITS * _LEGAL_CHUNK_PLANES >= 24  # max board_size


def pack_legal_into_lanes(stack: jnp.ndarray, legal: jnp.ndarray):
    """OR the legal plane's 3-bit chunks into the low bits of obs planes
    0..7 (lane-major: ``stack`` [12, P, *B], ``legal`` [P, *B]).

    The planes' own low bits are cleared first (engine bitplanes may carry
    padding-region bits that the obs decode ignores but the legal decode
    would misread).  Inverse: :func:`legal_words_from_obs`."""
    one_chunk = jnp.uint32((1 << _LEGAL_CHUNK_BITS) - 1)
    planes = []
    for k in range(_LEGAL_CHUNK_PLANES):
        chunk = (
            legal >> jnp.uint32(geo.PAD + _LEGAL_CHUNK_BITS * k)
        ) & one_chunk
        planes.append((stack[k] & ~one_chunk) | chunk)
    return jnp.concatenate(
        [jnp.stack(planes), stack[_LEGAL_CHUNK_PLANES:]], axis=0
    )


def legal_words_from_obs(pk: jnp.ndarray) -> jnp.ndarray:
    """Recover the packed legal words from wire obs words ([..., 12, P]
    u32 with the legal chunks in planes 0..7's low bits) -> [..., P] u32
    with live bits at y in [PAD, PAD+n) exactly.  Decode the result with
    :func:`unpack_legal_words_flat`."""
    one_chunk = jnp.uint32((1 << _LEGAL_CHUNK_BITS) - 1)
    legal = jnp.zeros_like(pk[..., 0, :])
    for k in range(_LEGAL_CHUNK_PLANES):
        legal = legal | (
            (pk[..., k, :] & one_chunk)
            << jnp.uint32(geo.PAD + _LEGAL_CHUNK_BITS * k)
        )
    return legal


@functools.partial(jax.jit, static_argnums=(1,))
def bit_observation_packed_with_legal(bs, board_size: int) -> jnp.ndarray:
    """The full self-play wire as ONE array: [B, 12*P] u32 — the 12 packed
    observation planes with the MOVER's legal plane riding in the free low
    bits (see :func:`pack_legal_into_lanes`).

    Observation decode (:func:`unpack_observation_nchw`) is unaffected —
    it reads only bits [PAD, PAD+n) — and is pinned bit-equal to the
    legal-free wire's decode; the legal decode
    (:func:`legal_words_from_obs` + :func:`unpack_legal_words_flat`) is
    pinned bit-equal to the engine's ``bit_legal_mask_flat`` at sizes
    5-24 (tests/test_models.py)."""
    stack = bit_observation_packed_lanes(bs, board_size)  # [12, P, B]
    assert stack.ndim == 3, "wants a 1-D env batch"
    player = jnp.clip(bs.current_player, 0, 1)
    legal = jnp.where(player[None, :] == 0, bs.legal[0], bs.legal[1])
    full = pack_legal_into_lanes(stack, legal)            # [12, P, B]
    return jnp.transpose(full, (2, 0, 1)).reshape(full.shape[-1], -1)


@functools.partial(jax.jit, static_argnums=(1, 2))
def unpack_observation_lanes_nchw(pk, board_size: int, dtype=jnp.float32):
    """Decode lane-major packed planes ([..., 12, P, B]) to the network
    layout [..., B, 12, n, n-2]: one transpose (the consumer-side cost the
    lane-major wire format defers) + the static unpack."""
    perm = tuple(range(pk.ndim - 3)) + (pk.ndim - 1, pk.ndim - 3, pk.ndim - 2)
    return unpack_observation_nchw(
        jnp.transpose(pk, perm), board_size, dtype
    )


@functools.partial(jax.jit, static_argnums=(1,))
def bit_observation_packed(bs, board_size: int) -> jnp.ndarray:
    """Observation as PACKED u32 column words, batch-leading: [B, 12, P].

    The exact-but-compressed wire format of the learner feed (~1 bit per
    cell instead of 2 bytes of bf16): the 12 observation planes are
    computed with pure bitwise ops on the engine's bitplanes and the only
    cross-layout move is the packed [12, P, B] -> [B, 12, P] transpose.
    ``P`` is the padded board width (one u32 word per board column, bits
    along y).  Decode with :func:`unpack_observation_nchw`; the pair is
    pinned bit-equal to :func:`bit_observation` at every size 5-24
    (tests/test_bitboard.py).

    Plane semantics match the reference's tensor emission exactly
    (twixt.cc:76-132): planes 0/6 = peg with no links, 1-4/7-10 = east
    link dirs, 5/11 = blocked east neighbors; the coordinate remaps
    (twixtboard.cc:590-597) are applied at unpack time, where they are
    static shifts/flips.
    """
    stack = bit_observation_packed_lanes(bs, board_size)  # [12, P, *B]
    assert stack.ndim == 3, "bit_observation_packed wants a 1-D env batch"
    return jnp.transpose(stack, (2, 0, 1))    # [B, 12, P]


@functools.partial(jax.jit, static_argnums=(1, 2))
def unpack_observation_nchw(pk, board_size: int, dtype=jnp.float32):
    """Decode packed observation words to the network layout
    [B, 12, size, size-2] (the learner-side unpack, fused by XLA into the
    net's input transpose when jitted together).

    Uses the coordinate remaps' structure (reference twixtboard.cc:590-597):
    for the red block the word index is the output COLUMN and the bit
    shift the output row; for the blue block the word index is the output
    ROW (via a static flip) and the bit shift the output column.

    Accepts leading batch dims beyond one (e.g. [T, B, 12, P]).
    """
    n = board_size
    pad = geo.PAD
    lead = pk.shape[:-2]
    pk = pk.reshape((-1,) + pk.shape[-2:])
    red_pk, blue_pk = pk[:, :6, :], pk[:, 6:, :]
    one = jnp.uint32(1)
    # red block: out[r, c] = bit(word[x = pad+c+1], y = pad+n-1-r)
    words_r = red_pk[:, :, pad + 1 : pad + n - 1]           # [B, 6, n-2]
    shifts_r = (
        jnp.uint32(pad + n - 1) - jnp.arange(n, dtype=jnp.uint32)
    ).reshape(1, 1, n, 1)
    red_obs = (words_r[:, :, None, :] >> shifts_r) & one    # [B, 6, n, n-2]
    # blue block: out[r, c] = bit(word[x = pad+n-1-r], y = pad+n-2-c)
    words_b = jnp.flip(blue_pk[:, :, pad : pad + n], axis=-1)   # [B, 6, n]
    shifts_b = (
        jnp.uint32(pad + n - 2) - jnp.arange(n - 2, dtype=jnp.uint32)
    ).reshape(1, 1, 1, n - 2)
    blue_obs = (words_b[:, :, :, None] >> shifts_b) & one   # [B, 6, n, n-2]
    out = jnp.concatenate([red_obs, blue_obs], axis=1).astype(dtype)
    return out.reshape(lead + out.shape[1:])


@functools.partial(jax.jit, static_argnums=(1,))
def unpack_legal_words_flat(words: jnp.ndarray, board_size: int):
    """Decode a packed legal bitplane ([..., P] u32 column words, the
    batch-leading transpose of BitState.legal[player]) to the flat legal
    mask over the ``size*size`` action space: bool [..., n*n], ascending
    action order (a = x*n + y — the same order as
    ops/bitboard.bit_legal_mask_flat, whose lane-major output this is
    pinned against in tests/test_models.py).

    The learner-side decode of the legal plane models/selfplay.Sample
    appends to its obs wire (the policy loss normalises its CE over the
    legal set, not the visit support).
    """
    n = board_size
    pad = geo.PAD
    core = words[..., pad : pad + n]  # [..., n]
    ys = jnp.arange(pad, pad + n, dtype=jnp.uint32)
    bits = ((core[..., None] >> ys) & jnp.uint32(1)) != 0  # [..., n, n]
    return bits.reshape(bits.shape[:-2] + (n * n,))


@functools.partial(jax.jit, static_argnums=(1, 2))
def bit_observation_nchw(bs, board_size: int, dtype=jnp.float32):
    """Batched bitboard observation, network layout [B, 12, size, size-2].

    The batch-leading layout needs a lane-major -> batch-major transpose;
    doing it on the UNPACKED tensor (the round-1 path: unpack to
    [12, n, n-2, B] then moveaxis) moves 8-32x more bytes than the packed
    planes hold.  This path is :func:`bit_observation_packed` (planes as
    u32 words, one packed transpose) followed by
    :func:`unpack_observation_nchw`, all inside one fusion.

    Emits bit-identically to ``moveaxis(bit_observation(...), -1, 0)``
    (pinned by tests/test_bitboard.py); measured 7x faster at the config-4
    learner-feed shape (board 24, batch 8192) than the round-1 path.
    """
    if bs.red.ndim != 2:  # exotic batch shapes: fall back to the slow path
        return jnp.moveaxis(bit_observation(bs, board_size, dtype), -1, 0)
    pk = bit_observation_packed(bs, board_size)
    return unpack_observation_nchw(pk, board_size, dtype)
