"""Batched arena: head-to-head strength evaluation for trained nets.

The OpenSpiel ecosystem evaluates agents by playing matches through the
State API one game at a time (e.g. ``mcts_example``'s two-bot loop,
reference README.md:38-40); the batched equivalent plays a whole BATCH
of games in lockstep on the bitboard engine, with one array-of-trees MCTS
per move for all boards at once.

Both sides share one search program per move: the leaf evaluator holds both
parameter trees, runs BOTH networks on every leaf, and selects per env by
whose turn it is at the LEAF state (colors alternate by env so first-move
advantage cancels) — the tree work is paid once, the network twice.

Openings are diversified by sampling the first ``temp_moves`` plies from
the visit distribution (per-env RNG); play is argmax thereafter.  Dirichlet
noise is off — arena play is evaluation, not exploration.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from twixt_for_open_spiel_tpu.models import mcts
from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.bitboard import (
    bit_legal_mask_flat,
    bit_reset,
    sample_bits,
    step_bits,
)


@functools.lru_cache(maxsize=None)
def _dual_net_evaluator(net_apply, board_size: int):
    """Evaluator dispatching between two nets by the leaf's mover.

    ``params`` is ``(params_a, params_b, a_is_red)`` where ``a_is_red`` is
    a [B] bool.  BOTH nets run on every leaf batch (2x network cost) and
    the result is selected per env: side A's output is used wherever the
    leaf's player-to-move is A's color.  Works at any tree depth because
    the dispatch looks at the leaf state itself, not the root.
    """
    base = mcts.net_evaluator(net_apply, board_size)

    def evaluate(params, bs, key):
        params_a, params_b, a_is_red = params
        logits_a, value_a = base(params_a, bs, key)
        logits_b, value_b = base(params_b, bs, key)
        mover = jnp.clip(bs.current_player, 0, 1)
        use_a = (mover == 0) == a_is_red                      # [B]
        logits = jnp.where(use_a[:, None], logits_a, logits_b)
        value = jnp.where(use_a, value_a, value_b)
        return logits, value

    return evaluate


@functools.partial(
    jax.jit,
    static_argnames=(
        "net_apply", "board_size", "batch", "num_simulations", "temp_moves",
        "random_b", "reuse_a", "search",
    ),
)
def arena_match(
    params_a,
    params_b,
    key,
    *,
    net_apply,
    board_size: int,
    batch: int,
    num_simulations: int,
    temp_moves: int = 6,
    c_puct: float = 1.4,
    random_b: bool = False,
    reuse_a: bool = False,
    search: str = "puct",
):
    """Play ``batch`` lockstep games of A vs B; returns the tally.

    Colors alternate by env (A is red in even envs).  Each move runs ONE
    batched search over every still-open board with the dual-net evaluator;
    finished boards are frozen (their slot searches a dummy reset state so
    the lockstep program stays well-formed, and the step is discarded).

    With ``random_b`` side B ignores the search and plays uniform random
    legal moves (the baseline OpenSpiel's random bot provides).

    ``search`` selects BOTH sides' move generator: ``"puct"`` (default) —
    AlphaZero PUCT without Dirichlet; ``"gumbel"`` — Gumbel sequential
    halving in EVALUATION mode (the move is the argmax of the improved
    policy softmax(logits + sigma(completed Q)); the sampled Gumbels
    drive only in-search candidate selection).  On a strong net Gumbel@16
    matches PUCT@64 verdicts at ~4x less search (docs/PERF.md), making it
    the cheap-gate setting for big-board training runs.

    With ``reuse_a`` side A searches with TREE REUSE
    (mcts.search_batch_reuse) while side B cold-starts every move — the
    strength-at-equal-simulations experiment for reuse: the game's search
    tree is carried across plies and re-rooted on each played action, but
    only A's moves are allowed to inherit the surviving subtree (B's
    moves force a cold root), so both sides spend the same per-move
    budget and differ only in reuse.

    Returns ``{"a_wins", "b_wins", "draws", "games", "a_score"}`` —
    ``a_score`` is the match score with draws counting half.
    """
    assert search in ("puct", "gumbel"), search
    assert not (reuse_a and search == "gumbel"), "reuse_a is PUCT-only"
    n = board_size
    a_is_red = (jnp.arange(batch, dtype=jnp.int32) % 2) == 0
    bs = bit_reset(n, batch)
    dummy = bit_reset(n, batch)
    evaluator = _dual_net_evaluator(net_apply, n)
    max_moves = n * n - 3 + 1  # MaxGameLength + 1 safety bound (twixt.h:136-139)
    tree0 = (
        mcts.init_reuse_tree(bs, board_size=n, num_simulations=num_simulations)
        if reuse_a
        else jnp.zeros((batch,), jnp.int32)  # placeholder carry leaf
    )

    def cond(carry):
        bs, move, key, tree, played = carry
        return jnp.any(bs.result == geo.RESULT_OPEN) & (move < max_moves)

    def body(carry):
        bs, move, key, tree, played = carry
        key, k_search, k_act, k_rand = jax.random.split(key, 4)
        open_ = bs.result == geo.RESULT_OPEN
        safe = jax.tree_util.tree_map(
            lambda live, d: jnp.where(
                jnp.broadcast_to(open_, live.shape), live, d
            ),
            bs,
            dummy,
        )
        player = jnp.clip(safe.current_player, 0, 1)
        if reuse_a:
            a_to_move = (player == 0) == a_is_red
            probs, _, tree = mcts.search_batch_reuse(
                (params_a, params_b, a_is_red),
                safe,
                k_search,
                tree,
                played,
                ~(a_to_move & open_),  # only A's moves may inherit
                evaluator=evaluator,
                board_size=n,
                num_simulations=num_simulations,
                c_puct=c_puct,
                dirichlet_frac=0.0,
            )
        elif search == "gumbel":
            _, probs, _ = mcts.gumbel_search_batch(
                (params_a, params_b, a_is_red),
                safe,
                k_search,
                evaluator=evaluator,
                board_size=n,
                num_simulations=num_simulations,
                c_puct=c_puct,
            )
        else:
            probs, _ = mcts.search_batch(
                (params_a, params_b, a_is_red),
                safe,
                k_search,
                evaluator=evaluator,
                board_size=n,
                num_simulations=num_simulations,
                c_puct=c_puct,
                dirichlet_frac=0.0,
            )
        legal = jnp.moveaxis(bit_legal_mask_flat(safe, player, n), 0, -1)
        logits = jnp.where(legal, jnp.log(jnp.maximum(probs, 1e-9)), -jnp.inf)
        sampled = jax.random.categorical(k_act, logits, axis=-1).astype(
            jnp.int32
        )
        greedy = jnp.argmax(jnp.where(legal, probs, -1.0), -1).astype(
            jnp.int32
        )
        action = jnp.where(move < temp_moves, sampled, greedy)
        if random_b:
            b_to_move = (player == 0) != a_is_red
            noise = jax.random.bits(
                k_rand, dtype=jnp.uint32
            ) + jnp.arange(batch, dtype=jnp.uint32) * jnp.uint32(0x9E3779B9)
            rand_action = sample_bits(safe, n, noise)
            action = jnp.where(b_to_move, rand_action, action)
        nxt = step_bits(safe, n, action)
        bs = jax.tree_util.tree_map(
            lambda new, old: jnp.where(
                jnp.broadcast_to(open_, new.shape), new, old
            ),
            nxt,
            bs,
        )
        return bs, move + 1, key, tree, action

    bs, moves, _, _, _ = jax.lax.while_loop(
        cond, body,
        (bs, jnp.int32(0), key, tree0, jnp.full((batch,), -1, jnp.int32)),
    )

    return _tally(bs.result, a_is_red, batch, moves)


def _tally(res, a_is_red, batch, moves):
    a_win = ((res == geo.RESULT_RED_WIN) & a_is_red) | (
        (res == geo.RESULT_BLUE_WIN) & ~a_is_red
    )
    b_win = ((res == geo.RESULT_BLUE_WIN) & a_is_red) | (
        (res == geo.RESULT_RED_WIN) & ~a_is_red
    )
    draw = (res == geo.RESULT_DRAW) | (res == geo.RESULT_OPEN)
    a_wins = jnp.sum(a_win, dtype=jnp.int32)
    b_wins = jnp.sum(b_win, dtype=jnp.int32)
    draws = jnp.sum(draw, dtype=jnp.int32)
    return {
        "a_wins": a_wins,
        "b_wins": b_wins,
        "draws": draws,
        "games": jnp.int32(batch),
        "moves": moves,
        "a_score": (a_wins + 0.5 * draws) / batch,
    }


@functools.partial(
    jax.jit,
    static_argnames=(
        "net_apply", "board_size", "batch", "sims_a", "sims_b", "temp_moves",
        "greedy_a", "max_considered_a",
    ),
)
def arena_match_asym(
    params,
    key,
    *,
    net_apply,
    board_size: int,
    batch: int,
    sims_a: int,
    sims_b: int,
    temp_moves: int = 6,
    c_puct: float = 1.4,
    greedy_a: bool = True,
    max_considered_a: int = 16,
):
    """A-vs-B with the SAME net but different SEARCHES: side A plays Gumbel
    sequential halving at ``sims_a`` simulations, side B AlphaZero PUCT
    (no Dirichlet) at ``sims_b`` — the equal-strength-per-simulation
    experiment behind Gumbel's "fewer simulations at equal strength" claim
    (Danihelka et al. 2022; measured result in docs/PERF.md).

    All envs are in lockstep from reset, so the player to move is uniform
    across the batch each ply; which SIDE that player is still varies by
    env (colors alternate: A is red in even envs).  Both searches run on
    the full batch every move and the action is selected per env by whose
    turn it is — 2x search cost, one compile, no ragged control flow.

    With ``greedy_a`` (default) side A ACTS with the argmax of the
    IMPROVED policy (softmax(logits + sigma(completed Q))) — evaluation
    mode per Danihelka et al. 2022, where the sampled Gumbels drive only
    the in-search candidate selection.  ``greedy_a=False`` plays the
    surviving candidate itself (the training-time act rule, whose move
    carries the exploration noise — measured ~0.25 arena score even at
    equal budgets, docs/PERF.md).

    Openings are diversified by Gumbel noise on A's side (candidate
    selection still shifts the improved policy through the tree it built)
    and by visit-distribution sampling for the first ``temp_moves`` plies
    on B's.
    """
    n = board_size
    a_is_red = (jnp.arange(batch, dtype=jnp.int32) % 2) == 0
    bs = bit_reset(n, batch)
    dummy = bit_reset(n, batch)
    evaluator = mcts.net_evaluator(net_apply, n)
    max_moves = n * n - 3 + 1  # MaxGameLength + 1 safety bound (twixt.h:136-139)

    def cond(carry):
        bs, move, key = carry
        return jnp.any(bs.result == geo.RESULT_OPEN) & (move < max_moves)

    def body(carry):
        bs, move, key = carry
        key, k_g, k_p, k_act = jax.random.split(key, 4)
        open_ = bs.result == geo.RESULT_OPEN
        safe = jax.tree_util.tree_map(
            lambda live, d: jnp.where(
                jnp.broadcast_to(open_, live.shape), live, d
            ),
            bs,
            dummy,
        )
        player = jnp.clip(safe.current_player, 0, 1)
        a_to_move = (player == 0) == a_is_red

        cand_a, improved_a, _ = mcts.gumbel_search_batch(
            params, safe, k_g,
            evaluator=evaluator, board_size=n, num_simulations=sims_a,
            max_considered=max_considered_a, c_puct=c_puct,
        )
        if greedy_a:
            act_a = jnp.argmax(improved_a, axis=-1).astype(jnp.int32)
        else:
            act_a = cand_a
        probs, _ = mcts.search_batch(
            params, safe, k_p,
            evaluator=evaluator, board_size=n, num_simulations=sims_b,
            c_puct=c_puct, dirichlet_frac=0.0,
        )
        legal = jnp.moveaxis(bit_legal_mask_flat(safe, player, n), 0, -1)
        logits = jnp.where(
            legal, jnp.log(jnp.maximum(probs, 1e-9)), -jnp.inf
        )
        sampled = jax.random.categorical(k_act, logits, axis=-1).astype(
            jnp.int32
        )
        greedy = jnp.argmax(jnp.where(legal, probs, -1.0), -1).astype(
            jnp.int32
        )
        act_b = jnp.where(move < temp_moves, sampled, greedy)
        action = jnp.where(a_to_move, act_a.astype(jnp.int32), act_b)
        nxt = step_bits(safe, n, action)
        bs = jax.tree_util.tree_map(
            lambda new, old: jnp.where(
                jnp.broadcast_to(open_, new.shape), new, old
            ),
            nxt,
            bs,
        )
        return bs, move + 1, key

    bs, moves, _ = jax.lax.while_loop(
        cond, body, (bs, jnp.int32(0), key)
    )
    return _tally(bs.result, a_is_red, batch, moves)
