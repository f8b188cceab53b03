"""Batched AlphaZero MCTS on the bitboard engine: one array-of-trees search.

The reference is exercised by OpenSpiel's CPU ``mcts_example``
(reference README.md:38-40) — one tree, one thread, pointer-chasing.  The
array-program redesign runs ONE search program over the whole env batch
("array of trees"): every tree array carries a leading ``[B]`` axis, every
phase of every simulation is a full-batch tensor op, and the env batch never
leaves the engine's lane-major layout.

Access-pattern discipline.  The search was shaped on another chip, where a
dynamic gather cost per INDEX and a gather with a [B, A]-shaped index set
was two orders of magnitude dearer than a per-env row gather; none of
those costs has been measured on the GPU yet (ROADMAP A6-A7).  The search
uses ONLY per-env-scalar ([B, 1]-index) gathers plus dense tensor ops;
every "read per-env state scattered across node slots" turns into one
of:

  * child-side best-edge scoring: instead of gathering child stats at the
    frequented node's action row ([B, A] indices), score every NODE SLOT as
    a candidate child of the current node in one ``[B, nodes]`` elementwise
    pass (``parent == node`` masking) — the PUCT argmax over expanded edges
    becomes a 65-wide reduction, no gather at all;
  * a single masked-prior array ``uprior`` (prior where legal & unexpanded,
    -1 otherwise), so the best UNEXPANDED edge needs one row gather, and
    expanding an edge retires it with a [B, 1]-index scatter on a flat
    view;
  * size-adaptive backup (``backup="auto"``): up to ``_AMASK_MAX_NODES``
    tree nodes each node stores its root-path set as a boolean
    ancestor-mask row, making backup two dense [B, nodes] ops (fast, but
    O(nodes^2) memory); above that a ``while_loop`` walks each env's
    leaf-to-root parent chain with [B, 1]-index gathers/scatter-adds —
    O(deepest leaf) time, O(nodes) memory, so 512+ simulation searches
    fit comfortably (0.59 GiB total tree at B=512/sims=512).
    Both variants are bit-identical (tests/test_mcts_exact.py pins each);
  * node BitStates gathered by a masked one-hot sum over the slots of
    small trees instead of a minor-axis gather (``_DENSE_GATHER_MAX_NODES``).

Expansion steps the BITBOARD engine (ops/bitboard.step_bits) once for the
whole batch — node states are packed ``BitState`` buffers with a leading
``[nodes]`` axis and the env batch trailing — and evaluation is one
``[B]``-batch network call on observations emitted straight from the
bitplanes (ops/observe.bit_observation_nchw).  K-leaf evaluation batching
is not implemented: on the chip the search was tuned on, the apply was
exactly linear in batch at B=512 (scripts/perf_cliff.py), which the GPU
has yet to confirm (ROADMAP A8).

Simulation count and tree size are static; search never reallocates.
:func:`search_batch_reuse` adds TREE REUSE across moves — fixed-shape
re-rooting of the array-of-trees on each env's played action (survivors
compacted to the low slots, fresh expansions above them), pinned
integer-exact over multi-move sequences (tests/test_reuse_exact.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.bitboard import (
    BitState,
    bit_legal_mask_flat,
    from_state,
    sample_bits,
    step_bits,
    step_noise,
)
from twixt_for_open_spiel_tpu.ops.observe import bit_observation_nchw

NO_NODE = jnp.int32(-1)
_U32 = jnp.uint32

# "auto" backup picks ancestor-mask up to this many tree nodes (the mask is
# [B, nodes, nodes] bool: 13 MB at B=512/nodes=161, linear-memory walk
# above).  The value was chosen by timing both forms on another chip; it
# is queued for a sweep on the H100 (ROADMAP A7).
_AMASK_MAX_NODES = 160

# _gather_node_state picks the dense one-hot select-and-reduce up to this
# many tree nodes and a per-element take_along_axis gather above: the
# dense form reads EVERY node's state buffer per simulation (linear in
# nodes — ~480 MB/sim at board 12, B=512, 513 nodes), the gather costs
# per fetched element and is constant in nodes.  The crossover was timed
# in situ on another chip (scripts/perf_sims_axis.py); it is queued for a
# sweep on the H100 (ROADMAP A7).
_DENSE_GATHER_MAX_NODES = 100


def _resolve_backup(backup: str, nodes: int) -> bool:
    assert backup in ("auto", "amask", "walk"), backup
    if backup == "auto":
        return nodes <= _AMASK_MAX_NODES
    return backup == "amask"


class Tree(NamedTuple):
    """Flat search trees for the whole env batch.

    Stats are batch-leading (``[B, nodes]`` / ``[B, nodes, A]``); node
    states are stacked buffers with a leading ``[nodes]`` axis over the
    engine's batch-trailing layout.  ``uprior`` fuses (prior, legal,
    unexpanded) into one array: ``>= 0`` holds the prior of a legal,
    not-yet-expanded edge; ``-1`` marks illegal or already-expanded.
    """

    visit: jnp.ndarray       # int32 [B, nodes]
    value_sum: jnp.ndarray   # f32 [B, nodes]
    uprior: jnp.ndarray      # f32 [B, nodes, A] masked prior (-1 = dead)
    parent: jnp.ndarray      # int32 [B, nodes]
    pa: jnp.ndarray          # int32 [B, nodes] action taken at the parent
    e_prior: jnp.ndarray     # f32 [B, nodes] prior of the edge into a node
    terminal: jnp.ndarray    # bool [B, nodes]
    # value of a terminal node from the perspective of the player to move at
    # its PARENT (the player who took parent_action); 0 for non-terminal.
    tval: jnp.ndarray        # f32 [B, nodes]
    linked: jnp.ndarray      # bool [B, nodes] slot actually in the tree
    root_child: jnp.ndarray  # int32 [B, A] child node id of root edges / -1
    # root-path sets + node depths for the amask backup variant; [B, 1, 1]
    # and [B, 1] PLACEHOLDERS when the walk backup is active (see
    # _make_simulate's ``use_amask``).
    amask: jnp.ndarray       # bool [B, nodes, nodes] or [B, 1, 1]
    depth: jnp.ndarray       # int32 [B, nodes] or [B, 1]
    planes: jnp.ndarray      # u32 [nodes, 16, P, B] packed bitplanes
    compid: jnp.ndarray      # i16 [nodes, N, N, B]
    scalars: jnp.ndarray     # i32 [nodes, 5, B]


def _rows(arr: jnp.ndarray, node: jnp.ndarray) -> jnp.ndarray:
    """Gather per-env node rows: [B, nodes, ...] x [B] -> [B, ...]."""
    idx = node.reshape(node.shape + (1,) * (arr.ndim - 1))
    return jnp.take_along_axis(arr, idx, axis=1)[:, 0]


def _cell(arr: jnp.ndarray, node: jnp.ndarray) -> jnp.ndarray:
    """Per-env scalar from [B, nodes] at node [B] -> [B] (TAA form)."""
    return jnp.take_along_axis(arr, node[:, None], axis=1)[:, 0]


# --- stacked node-state buffers <-> BitState ------------------------------
# plane order: red, blue, links[0..3], blocked[0..3], legal[0..1], flags[0..3]

def _stack_planes(bs: BitState) -> jnp.ndarray:
    return jnp.stack(
        (bs.red, bs.blue) + bs.links + bs.blocked + bs.legal + bs.flags
    )


def _stack_scalars(bs: BitState) -> jnp.ndarray:
    return jnp.stack(
        [
            bs.current_player,
            bs.move_counter,
            bs.move_one,
            bs.swapped.astype(jnp.int32),
            bs.result,
        ]
    )


def _unstack_bitstate(planes, compid, scalars) -> BitState:
    return BitState(
        red=planes[0],
        blue=planes[1],
        links=tuple(planes[2 + i] for i in range(4)),
        blocked=tuple(planes[6 + i] for i in range(4)),
        legal=(planes[10], planes[11]),
        flags=tuple(planes[12 + i] for i in range(4)),
        compid=compid,
        current_player=scalars[0],
        move_counter=scalars[1],
        move_one=scalars[2],
        swapped=scalars[3].astype(bool),
        result=scalars[4],
    )


def _gather_node_state(tree: Tree, node: jnp.ndarray) -> BitState:
    """Per-env node state: [nodes, ..., B] buffers x node [B] -> [..., B].

    Two bit-identical forms, picked by tree size
    (``_DENSE_GATHER_MAX_NODES``):

      * dense one-hot select-and-reduce — reads EVERY node slot's buffer
        (cost linear in nodes); at small trees this beat the gather
        where it was measured, because the gather costs per element on
        the minor (env) axis;
      * take_along_axis gather — fetches exactly the selected slot, cost
        CONSTANT in nodes; at 512-sim trees the dense form's full-buffer
        read is the dominant superlinear term of the sims axis
        (scripts/perf_sims_axis.py), so the gather wins above the
        crossover.
    """
    nodes = tree.planes.shape[0]
    if nodes <= _DENSE_GATHER_MAX_NODES:
        def leaf(buf):
            iota = jnp.arange(nodes, dtype=jnp.int32).reshape(
                (nodes,) + (1,) * (buf.ndim - 1)
            )
            oh = node.reshape((1,) * (buf.ndim - 1) + node.shape) == iota
            zero = jnp.zeros((), buf.dtype)
            return jnp.where(oh, buf, zero).sum(axis=0, dtype=buf.dtype)
    else:
        def leaf(buf):
            idx = node.reshape((1,) * (buf.ndim - 1) + node.shape)
            return jnp.take_along_axis(
                buf, idx.astype(jnp.int32), axis=0
            )[0]

    return _unstack_bitstate(
        leaf(tree.planes), leaf(tree.compid), leaf(tree.scalars)
    )


def _set_node_state(tree: Tree, node, bs: BitState) -> Tree:
    """Write one node slot (uniform traced index): three DUS writes."""
    zeros = (0,) * 3
    return tree._replace(
        planes=jax.lax.dynamic_update_slice(
            tree.planes, _stack_planes(bs)[None], (node,) + zeros
        ),
        compid=jax.lax.dynamic_update_slice(
            tree.compid, bs.compid[None], (node,) + zeros
        ),
        scalars=jax.lax.dynamic_update_slice(
            tree.scalars, _stack_scalars(bs)[None], (node,) + (0, 0)
        ),
    )


def _best_edge(tree: Tree, node: jnp.ndarray, c_puct):
    """Best PUCT edge at each env's ``node``: (action, kid, kid_term).

    ``kid`` is the chosen child slot (-1 when the best edge is unexpanded);
    ``kid_term`` marks a chosen terminal child.  Expanded edges are scored
    CHILD-SIDE: one ``[B, nodes]`` elementwise pass masks the slots whose
    ``parent`` is the current node, so no [B, A]-index gather exists.
    """
    up_row = _rows(tree.uprior, node)                       # [B, A]
    tot = _cell(tree.visit, node)
    sq = jnp.sqrt(jnp.maximum(tot, 1).astype(jnp.float32))  # [B]

    # unexpanded edges: masked prior row (-1 = illegal or expanded)
    sc_u = jnp.where(up_row >= 0, c_puct * up_row * sq[:, None], -jnp.inf)
    bu_s = sc_u.max(-1)
    bu_a = jnp.argmax(sc_u, -1).astype(jnp.int32)

    # expanded edges, child-side over all node slots
    valid = tree.linked & (tree.parent == node[:, None])    # [B, nodes]
    # child value stored from child's-player perspective; parent wants -Q.
    # terminal children have exact value from parent's perspective.
    q = jnp.where(
        tree.terminal,
        tree.tval,
        -tree.value_sum / jnp.maximum(tree.visit, 1).astype(jnp.float32),
    )
    u = c_puct * tree.e_prior * sq[:, None] / (
        1.0 + tree.visit.astype(jnp.float32)
    )
    sc_c = jnp.where(valid, q + u, -jnp.inf)
    bc_s = sc_c.max(-1)
    c_star = jnp.argmax(sc_c, -1).astype(jnp.int32)
    bc_a = _cell(tree.pa, c_star)
    bc_t = _cell(tree.terminal, c_star)

    # tie between an expanded and an unexpanded edge -> lower action index
    # (the round-2 argmax-over-actions order); ties among expanded children
    # break by creation order (lowest slot).
    expanded_wins = (bc_s > bu_s) | ((bc_s == bu_s) & (bc_a < bu_a))
    action = jnp.where(expanded_wins, bc_a, bu_a)
    kid = jnp.where(expanded_wins, c_star, NO_NODE)
    kid_term = expanded_wins & bc_t
    return action, kid, kid_term


def _init_tree(bs, batch, nodes, a_dim, root_value, root_uprior,
               use_amask=False):
    """Fresh array-of-trees state: root at slot 0, one visit, given prior."""

    def alloc(x):
        return jnp.broadcast_to(x[None], (nodes,) + x.shape)

    if use_amask:
        amask = jnp.zeros((batch, nodes, nodes), bool).at[:, 0, 0].set(True)
        depth = jnp.zeros((batch, nodes), jnp.int32)
    else:
        amask = jnp.zeros((batch, 1, 1), bool)
        depth = jnp.zeros((batch, 1), jnp.int32)

    return Tree(
        amask=amask,
        depth=depth,
        visit=jnp.zeros((batch, nodes), jnp.int32).at[:, 0].set(1),
        value_sum=jnp.zeros((batch, nodes), jnp.float32)
        .at[:, 0]
        .set(root_value),
        uprior=jnp.full((batch, nodes, a_dim), -1.0, jnp.float32)
        .at[:, 0]
        .set(root_uprior),
        parent=jnp.full((batch, nodes), NO_NODE),
        pa=jnp.zeros((batch, nodes), jnp.int32),
        e_prior=jnp.zeros((batch, nodes), jnp.float32),
        terminal=jnp.zeros((batch, nodes), bool),
        tval=jnp.zeros((batch, nodes), jnp.float32),
        linked=jnp.zeros((batch, nodes), bool).at[:, 0].set(True),
        root_child=jnp.full((batch, a_dim), NO_NODE),
        planes=alloc(_stack_planes(bs)),
        compid=alloc(bs.compid),
        scalars=alloc(_stack_scalars(bs)),
    )


def _make_simulate(
    *, params, key, evaluator, board_size, batch, nodes, a_dim, c_puct,
    root_entry, use_amask=False, fresh_base=1,
):
    """One-simulation body (selection -> expansion -> eval -> backup) for a
    ``fori_loop`` carrying ``(tree, sel_iter_count, backup_iter_count)``.

    ``root_entry(tree, sim) -> (action, kid, kid_term)`` chooses the ROOT
    edge of simulation ``sim``: PUCT best-edge for standard AlphaZero
    search (:func:`search_batch`), a forced candidate action for Gumbel
    sequential halving (:func:`gumbel_search_batch`).  Everything below the
    root is shared: lockstep PUCT walk, one batched engine step, one
    batched evaluator call, ancestor-mask backup.

    ``fresh_base``: slot index of simulation 0's expansion (slots are
    allocated uniformly across the batch at ``fresh_base + sim``).  1 for
    a cold tree (root at 0); ``reuse_cap`` for a re-rooted tree whose
    surviving subtree occupies slots [0, reuse_cap)
    (:func:`search_batch_reuse`).
    """
    def simulate(sim, carry):
        tree, sel_ct, bk_ct = carry
        new_node = fresh_base + sim  # next free slot (uniform over envs)

        # --- selection: all envs walk down in lockstep until each env's
        # best edge is unexpanded or leads to a terminal child
        def sel_cond(carry):
            _, _, _, _, can, _ = carry
            return jnp.any(can)

        def sel_body(carry):
            node, action, kid, kid_term, can, ct = carry
            descend = can & (kid >= 0) & ~kid_term
            node = jnp.where(descend, jnp.maximum(kid, 0), node)
            a, k, kt = _best_edge(tree, node, c_puct)
            action = jnp.where(descend, a, action)
            kid = jnp.where(descend, k, kid)
            kid_term = jnp.where(descend, kt, kid_term)
            return node, action, kid, kid_term, descend, ct + 1

        node0 = jnp.zeros((batch,), jnp.int32)
        a0, k0, kt0 = root_entry(tree, sim)
        leaf_parent, action, existing_kid, _, _, sel_ct = jax.lax.while_loop(
            sel_cond, sel_body,
            (node0, a0, k0, kt0, jnp.ones((batch,), bool), sel_ct),
        )
        # An existing child here is necessarily terminal (selection only
        # stops on missing or terminal children): no expansion, just back
        # its exact value up again.
        revisit = existing_kid >= 0

        # --- expansion: one batched bitboard step from the parent states
        parent_state = _gather_node_state(tree, leaf_parent)
        child_state = step_bits(parent_state, board_size, action)
        child_terminal = child_state.result != geo.RESULT_OPEN
        parent_player = jnp.clip(parent_state.current_player, 0, 1)
        res = child_state.result
        term_val = jnp.where(
            res == geo.RESULT_RED_WIN + parent_player,
            1.0,
            jnp.where(res == geo.RESULT_DRAW, 0.0, -1.0),
        )
        term_val = jnp.where(child_terminal, term_val, 0.0)

        child_player = jnp.clip(child_state.current_player, 0, 1)
        child_legal = jnp.moveaxis(
            bit_legal_mask_flat(child_state, child_player, board_size), 0, -1
        )
        logits, value = evaluator(
            params, child_state, jax.random.fold_in(key, sim)
        )
        prior = jax.nn.softmax(
            jnp.where(child_legal, logits, -1e9), axis=-1
        )
        # leaf value from the perspective of the player to move at the
        # child; terminal: exact value is from parent's perspective, negate.
        backup_value = jnp.where(child_terminal, -term_val, value)

        node_id = jnp.where(revisit, existing_kid, jnp.int32(new_node))

        # Write the new node unconditionally at slot new_node; for revisit
        # envs the slot holds unlinked garbage (linked=False keeps it out of
        # every child-side pass, and no edge retires in uprior — the chosen
        # edge was already retired when the existing child was created).
        parent_row = _rows(tree.uprior, leaf_parent)            # [B, A]
        e_prior_new = _cell(
            parent_row, action
        )  # prior of the expanded edge (>= 0: it was live)
        onehot_a = action[:, None] == jnp.arange(a_dim, dtype=jnp.int32)
        if use_amask:
            parent_amask = _rows(tree.amask, leaf_parent)       # [B, nodes]
            parent_depth = _cell(tree.depth, leaf_parent)
            iota_n = jnp.arange(nodes, dtype=jnp.int32)
            amask = tree.amask.at[:, new_node].set(
                parent_amask | (iota_n == new_node)
            )
            depth = tree.depth.at[:, new_node].set(parent_depth + 1)
        else:
            amask, depth = tree.amask, tree.depth

        # retire the expanded edge: -1 at (leaf_parent, action), as a
        # flat-view put_along_axis SCATTER (a no-op re-retire for revisit
        # envs).  A dense where-mask beat the scatter in isolation
        # (scripts/perf_cliff2.py) but lost end to end where it was
        # measured, by breaking uprior's donation through the walk's loop
        # carry, so the scatter is kept.  Re-evaluate only against the
        # end metric, never the microbench alone.
        up_flat = tree.uprior.reshape(batch, nodes * a_dim)
        up_flat = jnp.put_along_axis(
            up_flat,
            (leaf_parent * a_dim + action)[:, None],
            -1.0,
            axis=1,
            inplace=False,
        )
        tree = tree._replace(
            amask=amask,
            depth=depth,
            uprior=up_flat.reshape(batch, nodes, a_dim)
            .at[:, new_node]
            .set(jnp.where(child_legal, prior, -1.0)),
            parent=tree.parent.at[:, new_node].set(leaf_parent),
            pa=tree.pa.at[:, new_node].set(action),
            e_prior=tree.e_prior.at[:, new_node].set(e_prior_new),
            terminal=tree.terminal.at[:, new_node].set(child_terminal),
            tval=tree.tval.at[:, new_node].set(term_val),
            linked=tree.linked.at[:, new_node].set(~revisit),
            root_child=jnp.where(
                (~revisit & (leaf_parent == 0))[:, None] & onehot_a,
                jnp.int32(new_node),
                tree.root_child,
            ),
        )
        tree = _set_node_state(tree, new_node, child_state)

        # --- backup.  Two bit-identical variants (values alternate sign
        # per level, anchored at +backup_value on the leaf; float adds
        # happen once per path node in both):
        #
        #   * ancestor-mask (``use_amask``): each node row of ``amask``
        #     holds its root-path set, so backup is ``visit += row`` plus a
        #     depth-parity-signed ``value_sum`` update — two dense
        #     [B, nodes] ops, loop-free.  Fast at small trees, but the
        #     mask is O(B * nodes^2) memory (hundreds of MB at 512+ sims).
        #   * parent-chain walk: a ``while_loop`` from each env's leaf to
        #     the root — a [B,1]-index parent gather plus two [B,1]-index
        #     scatter-adds per level.  O(nodes) memory, but the loop runs
        #     to the DEEPEST env's leaf each simulation (measured ~15-20%
        #     of self-play time at 64 sims, B=512).
        #
        # search_batch/gumbel_search_batch pick by tree size
        # (``backup="auto"``): amask up to _AMASK_MAX_NODES, walk above.
        if use_amask:
            path = _rows(tree.amask, node_id)                   # [B, nodes]
            leaf_depth = _cell(tree.depth, node_id)
            sign = 1.0 - 2.0 * jnp.bitwise_and(
                leaf_depth[:, None] - tree.depth, 1
            ).astype(jnp.float32)
            tree = tree._replace(
                visit=tree.visit + path.astype(jnp.int32),
                value_sum=tree.value_sum
                + jnp.where(path, backup_value[:, None] * sign, 0.0),
            )
            return tree, sel_ct, bk_ct

        env = jnp.arange(batch)

        def bk_cond(carry):
            _, _, node, _, _ = carry
            return jnp.any(node >= 0)

        def bk_body(carry):
            visit, vsum, node, v, ct = carry
            live = node >= 0
            idx = jnp.maximum(node, 0)
            visit = visit.at[env, idx].add(
                jnp.where(live, 1, 0).astype(jnp.int32)
            )
            vsum = vsum.at[env, idx].add(jnp.where(live, v, 0.0))
            node = jnp.where(live, _cell(tree.parent, idx), NO_NODE)
            return visit, vsum, node, -v, ct + 1

        visit, vsum, _, _, bk_ct = jax.lax.while_loop(
            bk_cond,
            bk_body,
            (tree.visit, tree.value_sum, node_id, backup_value, bk_ct),
        )
        tree = tree._replace(visit=visit, value_sum=vsum)
        return tree, sel_ct, bk_ct

    return simulate


@functools.lru_cache(maxsize=None)
def net_evaluator(net_apply, board_size: int):
    """Batched leaf evaluator backed by a policy/value network.

    Evaluators map (params, bitstate [.., B], key) -> (logits [B, A],
    value [B]), value from the perspective of the player to move.

    Cached per (net_apply, board_size) so the returned closure is a stable
    jit static argument (no spurious recompiles).
    """

    def evaluate(params, bs: BitState, key):
        del key
        obs = bit_observation_nchw(bs, board_size)
        return net_apply(params, obs)

    return evaluate


@functools.lru_cache(maxsize=None)
def rollout_evaluator(board_size: int, rollout_count: int = 1):
    """Batched leaf evaluator backed by uniform random playouts (vanilla
    MCTS mode — the batched equivalent of OpenSpiel's RandomRolloutEvaluator
    used by ``mcts_example --rollout_count``, reference README.md:38-40).

    Plays ``rollout_count`` lockstep random games to termination on the
    bitboard engine and averages the outcomes.  Priors are uniform (zero
    logits).
    """
    n = board_size
    max_moves = n * n  # >= remaining game length (MaxGameLength = n*n-3)

    def one_rollout(bs: BitState, seed):
        to_move = jnp.clip(bs.current_player, 0, 1)
        nenv = bs.current_player.shape[-1]
        env = jnp.arange(nenv, dtype=_U32)

        def cond(carry):
            s, i = carry
            return jnp.any(s.result == geo.RESULT_OPEN) & (i < max_moves)

        def body(carry):
            s, i = carry
            open_ = s.result == geo.RESULT_OPEN
            noise = step_noise(seed, i, env)
            a = sample_bits(s, n, noise)
            nxt = step_bits(s, n, a)
            # freeze finished envs (their sampled action is garbage)
            s = jax.tree_util.tree_map(
                lambda new, old: jnp.where(open_, new, old), nxt, s
            )
            return s, i + 1

        final, _ = jax.lax.while_loop(cond, body, (bs, jnp.int32(0)))
        res = final.result
        return jnp.where(
            res == geo.RESULT_RED_WIN + to_move,
            1.0,
            jnp.where(res == geo.RESULT_DRAW, 0.0, -1.0),
        )

    def evaluate(params, bs: BitState, key):
        del params
        total = jnp.zeros(bs.current_player.shape, jnp.float32)
        for r in range(rollout_count):
            seed = jax.random.bits(
                jax.random.fold_in(key, r), dtype=jnp.uint32
            )
            total = total + one_rollout(bs, seed)
        nenv = bs.current_player.shape[-1]
        logits = jnp.zeros((nenv, n * n), jnp.float32)
        return logits, total / rollout_count

    return evaluate


@functools.partial(
    jax.jit,
    static_argnames=(
        "board_size", "num_simulations", "evaluator", "return_stats",
        "backup",
    ),
)
def search_batch(
    params,
    bs: BitState,
    key,
    *,
    evaluator,
    board_size: int,
    num_simulations: int,
    c_puct: float = 1.4,
    dirichlet_alpha: float = 0.3,
    dirichlet_frac: float = 0.25,
    return_stats: bool = False,
    backup: str = "auto",
):
    """Run MCTS from a batch of root BitStates (batch-trailing, 1-D batch).

    Roots must be non-terminal (self-play's auto-reset guarantees it).
    Returns (visit_probs [B, A], root_value [B]) — the policy targets and
    value estimates self-play consumes.  With ``return_stats`` (a separate
    compile) additionally returns diagnostic counters ``{"sel_iters",
    "backup_iters"}``: total lockstep selection-walk and backup-walk
    iterations (each walk runs until the DEEPEST env finishes;
    backup_iters is 0 under the loop-free amask backup).
    """
    a_dim = board_size * board_size
    nodes = num_simulations + 1
    batch = bs.current_player.shape[-1]
    assert bs.current_player.ndim == 1, "search_batch wants a 1-D env batch"
    key, k_root, k_noise = jax.random.split(key, 3)
    root_player = jnp.clip(bs.current_player, 0, 1)
    root_legal = jnp.moveaxis(
        bit_legal_mask_flat(bs, root_player, board_size), 0, -1
    )  # [B, A]
    root_logits, root_value = evaluator(params, bs, k_root)
    noise = jax.random.dirichlet(
        k_noise, jnp.full((a_dim,), dirichlet_alpha), shape=(batch,)
    )
    root_prior = jax.nn.softmax(
        jnp.where(root_legal, root_logits, -1e9), axis=-1
    )
    root_prior = jnp.where(
        root_legal,
        (1 - dirichlet_frac) * root_prior + dirichlet_frac * noise,
        0.0,
    )
    root_prior = root_prior / jnp.maximum(
        root_prior.sum(-1, keepdims=True), 1e-9
    )

    use_amask = _resolve_backup(backup, nodes)
    tree = _init_tree(
        bs, batch, nodes, a_dim, root_value,
        jnp.where(root_legal, root_prior, -1.0),
        use_amask=use_amask,
    )
    node0 = jnp.zeros((batch,), jnp.int32)
    simulate = _make_simulate(
        params=params,
        key=key,
        evaluator=evaluator,
        board_size=board_size,
        batch=batch,
        nodes=nodes,
        a_dim=a_dim,
        c_puct=c_puct,
        root_entry=lambda tree, sim: _best_edge(tree, node0, c_puct),
        use_amask=use_amask,
    )
    tree, sel_ct, bk_ct = jax.lax.fori_loop(
        0, num_simulations, simulate, (tree, jnp.int32(0), jnp.int32(0))
    )

    # root visit counts, child-side: one dense select over the node axis
    iota_n = jnp.arange(nodes, dtype=jnp.int32)
    oh = tree.root_child[..., None] == iota_n                 # [B, A, nodes]
    kid_visits = jnp.where(oh, tree.visit[:, None, :], 0).sum(-1)
    kid_visits = jnp.where(root_legal, kid_visits, 0)
    visit_probs = kid_visits.astype(jnp.float32) / jnp.maximum(
        kid_visits.sum(-1, keepdims=True), 1
    ).astype(jnp.float32)
    root_q = tree.value_sum[:, 0] / jnp.maximum(
        tree.visit[:, 0], 1
    ).astype(jnp.float32)
    if return_stats:
        return visit_probs, root_q, {
            "sel_iters": sel_ct, "backup_iters": bk_ct
        }
    return visit_probs, root_q


def _halving_schedule(max_considered: int, a_dim: int, num_simulations: int):
    """Static sequential-halving schedule (Danihelka et al. 2022 style).

    Returns ``(m, [(live, per), ...])``: the (possibly clamped) candidate
    count and, per phase, the live-candidate count and forced simulations
    per live candidate.  Pure Python over static ints — shared verbatim by
    the numpy reference in tests/test_gumbel_exact.py.

    Budget allocation follows the paper: each phase targets an equal share
    ``num_simulations // n_phases`` of the budget, remainders flow to LATER
    phases, and the final (live=2) phase spends everything left.  Two
    guarantees the round-2 schedule lacked:

      * ``m`` is clamped (halved) until the minimal schedule — one visit
        per live candidate per phase — fits the budget, so no phase is ever
        silently skipped and the final pair always receives fresh
        simulations;
      * total spent simulations equal ``num_simulations`` up to the last
        phase's ``% 2`` remainder (at most 1 stranded), instead of up to
        ``n_phases * m``.
    """
    assert num_simulations >= 2, (
        "gumbel search needs num_simulations >= 2 (a 1-sim budget would "
        "pick by g+logits alone with zero search)"
    )

    def lives_of(m):
        # halving sequence clamped to end at a live PAIR (the final pick
        # scores exactly two candidates), e.g. 6 -> [6, 3, 2], 3 -> [3, 2]
        lives, live = [], m
        while live >= 2:
            lives.append(live)
            if live == 2:
                break
            live = max(2, live // 2)
        return lives

    m = max(2, min(max_considered, a_dim, num_simulations))
    while m > 2 and sum(lives_of(m)) > num_simulations:
        m = max(2, m // 2)

    lives = lives_of(m)
    n_phases = len(lives)
    share = num_simulations // n_phases
    schedule = []
    remaining = num_simulations
    for i, live in enumerate(lives):
        rest_min = sum(lives[i + 1:])  # 1 visit/candidate for later phases
        if i == n_phases - 1:
            per = remaining // live
        else:
            per = min(max(1, share // live), (remaining - rest_min) // live)
        schedule.append((live, per))
        remaining -= per * live
    return m, schedule


@functools.partial(
    jax.jit,
    static_argnames=(
        "board_size", "num_simulations", "evaluator", "max_considered",
        "backup",
    ),
)
def gumbel_search_batch(
    params,
    bs: BitState,
    key,
    *,
    evaluator,
    board_size: int,
    num_simulations: int,
    max_considered: int = 16,
    c_puct: float = 1.4,
    c_visit: float = 50.0,
    c_scale: float = 1.0,
    gumbel_noise=None,
    backup: str = "auto",
):
    """Gumbel sequential-halving root search (Danihelka et al. 2022 style).

    Root exploration without Dirichlet noise or visit-count temperature:
    sample one Gumbel per root action, keep the top ``max_considered``
    candidates by ``g + logits``, and spend the simulation budget in
    log2(m) sequential-halving phases — every live candidate gets the same
    number of forced-root-action simulations per phase, then the field
    halves by ``g + logits + sigma(qhat)`` with
    ``sigma(q) = (c_visit + max_visit) * c_scale * q``.  Below the root the
    shared PUCT walk/expansion/backup of :func:`_make_simulate` runs
    unchanged.

    Returns ``(action, improved_policy, root_value)``:

      * ``action`` [B] — the surviving candidate (play this move; the
        Gumbel sample IS the exploration, so self-play plays it directly);
      * ``improved_policy`` [B, A] — softmax(logits + sigma(completed Q))
        over legal actions, the Gumbel-MuZero policy target (visited root
        children contribute their search Q, unvisited actions the root
        value estimate);
      * ``root_value`` [B] — mean value of the root's visits.

    Why: simulations are the only SEQUENTIAL part of the batched
    search — everything inside one is a full-batch tensor op — so budgets
    that extract more strength per simulation matter.  The literature
    reports Gumbel roots reaching equal TRAINING strength with far fewer
    simulations (Danihelka et al. 2022).  Measured head-to-head on THIS
    engine with a PUCT-trained net (scripts/arena_gumbel_vs_puct.py,
    board 8, 256 games, docs/PERF.md): Gumbel does NOT reach PUCT's
    playing strength at equal or lower budgets (arena score 0.21-0.28 vs
    PUCT@64 for gumbel at 16/32/64 sims, any max_considered) — the claim
    is about learning efficiency, not fixed-net match play, and this
    framework's self-play default therefore remains PUCT.
    """
    a_dim = board_size * board_size
    nodes = num_simulations + 1
    batch = bs.current_player.shape[-1]
    assert bs.current_player.ndim == 1
    key, k_root, k_gumbel = jax.random.split(key, 3)
    root_player = jnp.clip(bs.current_player, 0, 1)
    root_legal = jnp.moveaxis(
        bit_legal_mask_flat(bs, root_player, board_size), 0, -1
    )  # [B, A]
    root_logits, root_value = evaluator(params, bs, k_root)
    root_logits = jnp.where(root_legal, root_logits, -jnp.inf)
    root_prior = jax.nn.softmax(
        jnp.where(root_legal, root_logits, -1e9), axis=-1
    )

    if gumbel_noise is None:  # injectable for the exactness pin
        gumbel_noise = jax.random.gumbel(k_gumbel, (batch, a_dim))
    base = jnp.where(root_legal, gumbel_noise + root_logits, -jnp.inf)

    m, schedule = _halving_schedule(max_considered, a_dim, num_simulations)
    cand_base, cand_actions = jax.lax.top_k(base, m)          # [B, m]
    # envs with fewer than m legal actions: duplicate the top candidate
    # (its extra forced simulations are ordinary revisits/descents)
    cand_valid = jnp.isfinite(cand_base)
    cand_actions = jnp.where(cand_valid, cand_actions, cand_actions[:, :1])
    cand_base = jnp.where(cand_valid, cand_base, cand_base[:, :1])

    use_amask = _resolve_backup(backup, nodes)
    tree = _init_tree(
        bs, batch, nodes, a_dim, root_value,
        jnp.where(root_legal, root_prior, -1.0),
        use_amask=use_amask,
    )

    def node_q(tree):
        """Per-node value from the PARENT's perspective ([B, nodes])."""
        return jnp.where(
            tree.terminal,
            tree.tval,
            -tree.value_sum
            / jnp.maximum(tree.visit, 1).astype(jnp.float32),
        )

    def cand_qhat(tree, cand_actions):
        """Completed Q per candidate: child Q if visited, else v_root."""
        kid = jnp.take_along_axis(tree.root_child, cand_actions, axis=1)
        q = jnp.take_along_axis(node_q(tree), jnp.maximum(kid, 0), axis=1)
        return jnp.where(kid >= 0, q, root_value[:, None])

    offset = 0
    for phase_i, (live, per) in enumerate(schedule):
        live_actions = cand_actions[:, :live]

        def root_entry(tree, sim, live_actions=live_actions,
                       offset=offset, live=live):
            k = jnp.mod(sim - offset, live)
            a0 = jax.lax.dynamic_index_in_dim(
                live_actions, k, axis=1, keepdims=False
            )
            k0 = _cell(tree.root_child, a0)
            kt0 = (k0 >= 0) & _cell(tree.terminal, jnp.maximum(k0, 0))
            return a0, k0, kt0

        simulate = _make_simulate(
            params=params, key=key, evaluator=evaluator,
            board_size=board_size, batch=batch, nodes=nodes, a_dim=a_dim,
            c_puct=c_puct, root_entry=root_entry, use_amask=use_amask,
        )
        tree, _, _ = jax.lax.fori_loop(
            offset, offset + live * per, simulate,
            (tree, jnp.int32(0), jnp.int32(0)),
        )
        offset += live * per

        if phase_i + 1 < len(schedule):
            # shrink the field to the next phase's live count by
            # g + logits + sigma(qhat)
            kid_all = tree.root_child
            iota_n = jnp.arange(nodes, dtype=jnp.int32)
            ohv = kid_all[..., None] == iota_n
            visits_all = jnp.where(ohv, tree.visit[:, None, :], 0).sum(-1)
            maxvisit = visits_all.max(-1).astype(jnp.float32)   # [B]
            sigma_scale = (c_visit + maxvisit) * c_scale
            score = (
                cand_base[:, :live]
                + sigma_scale[:, None] * cand_qhat(tree, live_actions)
            )
            keep = schedule[phase_i + 1][0]
            _, top_idx = jax.lax.top_k(score, keep)             # [B, keep]
            new_actions = jnp.take_along_axis(live_actions, top_idx, axis=1)
            new_base = jnp.take_along_axis(
                cand_base[:, :live], top_idx, axis=1
            )
            # survivors first; pad the tail with the leader (never used)
            pad_a = jnp.broadcast_to(new_actions[:, :1], (batch, m - keep))
            pad_b = jnp.broadcast_to(new_base[:, :1], (batch, m - keep))
            cand_actions = jnp.concatenate([new_actions, pad_a], axis=1)
            cand_base = jnp.concatenate([new_base, pad_b], axis=1)

    # final pick: every halving path ends with a live pair (top_k sorts
    # descending, so after the last halve the best two lead the field)
    final_live = 2
    live_actions = cand_actions[:, :final_live]
    iota_n = jnp.arange(nodes, dtype=jnp.int32)
    ohv = tree.root_child[..., None] == iota_n
    visits_all = jnp.where(ohv, tree.visit[:, None, :], 0).sum(-1)
    maxvisit = visits_all.max(-1).astype(jnp.float32)
    sigma_scale = (c_visit + maxvisit) * c_scale
    final_score = (
        cand_base[:, :final_live]
        + sigma_scale[:, None] * cand_qhat(tree, live_actions)
    )
    action = jnp.take_along_axis(
        live_actions, jnp.argmax(final_score, -1)[:, None], axis=1
    )[:, 0]

    # improved policy over ALL actions: logits + sigma(completed Q)
    q_all_nodes = node_q(tree)
    oh = tree.root_child[..., None] == iota_n
    q_all = jnp.where(oh, q_all_nodes[:, None, :], 0.0).sum(-1)
    visited = (tree.root_child >= 0) & (visits_all > 0)
    q_completed = jnp.where(visited, q_all, root_value[:, None])
    improved = jax.nn.softmax(
        jnp.where(
            root_legal,
            jnp.where(root_legal, root_logits, 0.0)
            + sigma_scale[:, None] * q_completed,
            -jnp.inf,
        ),
        axis=-1,
    )
    improved = jnp.where(root_legal, improved, 0.0)
    root_q = tree.value_sum[:, 0] / jnp.maximum(
        tree.visit[:, 0], 1
    ).astype(jnp.float32)
    return action, improved, root_q


def reuse_nodes(num_simulations: int, reuse_cap: int | None = None) -> int:
    """Slot count of a reuse-capable tree: ``reuse_cap`` survivor slots
    (new root at 0) + one fresh slot per simulation."""
    cap = num_simulations + 1 if reuse_cap is None else reuse_cap
    return cap + num_simulations


def init_reuse_tree(
    bs: BitState, *, board_size: int, num_simulations: int,
    reuse_cap: int | None = None, backup: str = "auto",
) -> Tree:
    """Empty tree of the reuse layout (everything unlinked, root_child all
    -1): the scan-carry seed for :func:`search_batch_reuse` — its first
    call sees no reusable child anywhere and cold-starts every env."""
    cap = num_simulations + 1 if reuse_cap is None else reuse_cap
    nodes = cap + num_simulations
    a_dim = board_size * board_size
    batch = bs.current_player.shape[-1]
    tree = _init_tree(
        bs, batch, nodes, a_dim,
        jnp.zeros((batch,), jnp.float32),
        jnp.full((batch, a_dim), -1.0, jnp.float32),
        use_amask=_resolve_backup(backup, nodes),
    )
    return tree._replace(
        visit=jnp.zeros_like(tree.visit),
        linked=jnp.zeros_like(tree.linked),
    )


def _descendant_mask(tree: Tree, kid, nodes: int, use_amask: bool):
    """bool [B, nodes]: linked nodes whose root path passes through (or
    is) ``kid`` — the surviving subtree of a re-root on ``kid``.

    amask variant: one [B, 1]-per-env column gather of the stored
    root-path sets.  walk variant: pointer doubling over the parent
    array — ceil(log2(nodes)) rounds of [B, nodes]-index gathers.
    """
    if use_amask:
        col = jnp.take_along_axis(
            tree.amask, jnp.maximum(kid, 0)[:, None, None], axis=2
        )[:, :, 0]
        return col & tree.linked
    iota = jnp.arange(nodes, dtype=jnp.int32)
    reach = iota[None, :] == kid[:, None]
    ptr = tree.parent
    hops = max(1, (nodes - 1).bit_length())
    for _ in range(hops):
        hop = jnp.take_along_axis(reach, jnp.maximum(ptr, 0), axis=1)
        reach = reach | (hop & (ptr >= 0))
        ptr = jnp.where(
            ptr >= 0,
            jnp.take_along_axis(ptr, jnp.maximum(ptr, 0), axis=1),
            NO_NODE,
        )
    return reach & tree.linked


@functools.partial(
    jax.jit,
    static_argnames=(
        "board_size", "num_simulations", "evaluator", "backup", "reuse_cap",
        "return_stats",
    ),
)
def search_batch_reuse(
    params,
    bs: BitState,
    key,
    tree: Tree,
    played,
    was_done,
    *,
    evaluator,
    board_size: int,
    num_simulations: int,
    reuse_cap: int | None = None,
    c_puct: float = 1.4,
    dirichlet_alpha: float = 0.3,
    dirichlet_frac: float = 0.25,
    backup: str = "auto",
    return_stats: bool = False,
):
    """MCTS with TREE REUSE across moves: re-root the previous search's
    array-of-trees on the action each env just played, keep the surviving
    subtree's nodes/visits/values/priors, and spend the new simulation
    budget on top.  Returns ``(visit_probs [B, A], root_q [B], tree)`` —
    feed the returned tree (plus the action you then play and the env's
    auto-reset ``done`` flag) into the next call.

    The reference's ecosystem bot reuses nothing between moves (its README
    drives OpenSpiel's cold-start ``mcts_example``, reference
    README.md:36-42); at batch scale the subtree under the played
    action — typically a third to a half of the tree — is the largest
    free strength-per-FLOP win available, so this framework makes reuse a
    first-class search mode.

    Fixed-shape re-rooting (nothing reallocates):

      * slots [0, reuse_cap) hold the SURVIVORS, compacted per env — the
        played child at slot 0, the rest in creation order; fresh
        expansions go to uniform slots ``reuse_cap + sim``
        (``_make_simulate(fresh_base=reuse_cap)``), so the per-sim DUS
        writes stay uniform across the batch;
      * the surviving set is read from the ancestor-mask column of the
        played child (amask backup) or by parent-pointer doubling (walk
        backup) — :func:`_descendant_mask`;
      * the per-env compaction permutation is applied with
        ``take_along_axis`` row gathers on the [B, nodes] stat arrays and
        node-axis gathers on the stacked state buffers — a per-MOVE cost,
        amortised over the whole simulation budget;
      * an env falls back to a cold root (exactly :func:`search_batch`'s
        init) when its played action has no child in the tree, the env
        auto-reset (``was_done``), or the subtree exceeds ``reuse_cap``
        nodes — branch-free per-env selects, pinned deterministic;
      * the new root's prior is RE-NOISED with the same
        ``(1-frac)*p + frac*dirichlet`` mix and renormalisation a fresh
        root gets (exploration must not decay across reused moves): the
        assembled prior vector takes unexpanded edges from the root's
        masked-prior row and expanded edges from their stored edge
        priors, and the mixed result is written back to both.

    Exactness: pinned integer-equal against tests/naive_mcts.py's
    pointer-walking implementation of the SAME reuse rule over multi-move
    sequences (tests/test_reuse_exact.py), for both backup variants.

    ``reuse_cap`` defaults to ``num_simulations + 1`` (the whole previous
    budget can survive); the tree then has ``2*num_simulations + 1``
    slots, so the default stays under the amask backup's size threshold
    at 64 sims.
    """
    a_dim = board_size * board_size
    cap = num_simulations + 1 if reuse_cap is None else reuse_cap
    nodes = cap + num_simulations
    batch = bs.current_player.shape[-1]
    assert bs.current_player.ndim == 1
    assert tree.visit.shape == (batch, nodes), (
        "tree layout mismatch: build the carry with init_reuse_tree using "
        "the same num_simulations/reuse_cap statics"
    )
    use_amask = _resolve_backup(backup, nodes)
    key, k_root, k_noise = jax.random.split(key, 3)
    root_player = jnp.clip(bs.current_player, 0, 1)
    root_legal = jnp.moveaxis(
        bit_legal_mask_flat(bs, root_player, board_size), 0, -1
    )  # [B, A]
    root_logits, root_value = evaluator(params, bs, k_root)
    noise = jax.random.dirichlet(
        k_noise, jnp.full((a_dim,), dirichlet_alpha), shape=(batch,)
    )

    def mix_prior(p):
        mixed = jnp.where(
            root_legal, (1 - dirichlet_frac) * p + dirichlet_frac * noise,
            0.0,
        )
        return mixed / jnp.maximum(mixed.sum(-1, keepdims=True), 1e-9)

    # fresh-root init (identical to search_batch's)
    fresh_prior = mix_prior(
        jax.nn.softmax(jnp.where(root_legal, root_logits, -1e9), axis=-1)
    )
    fresh = _init_tree(
        bs, batch, nodes, a_dim, root_value,
        jnp.where(root_legal, fresh_prior, -1.0),
        use_amask=use_amask,
    )

    # --- which envs can re-root?
    iota = jnp.arange(nodes, dtype=jnp.int32)
    kid = jnp.take_along_axis(
        tree.root_child, jnp.clip(played, 0, a_dim - 1)[:, None], axis=1
    )[:, 0]
    desc = _descendant_mask(tree, kid, nodes, use_amask)
    k_cnt = desc.sum(-1).astype(jnp.int32)
    kid_ok = (kid >= 0) & ~_cell(tree.terminal, jnp.maximum(kid, 0))
    reuse = (~was_done) & (played >= 0) & kid_ok & (k_cnt <= cap)
    desc = desc & reuse[:, None]

    # --- compaction permutation: kid -> 0, other survivors in slot order
    not_kid = desc & (iota[None, :] != kid[:, None])
    new_id = jnp.where(
        iota[None, :] == kid[:, None], 0,
        jnp.cumsum(not_kid.astype(jnp.int32), axis=1),
    )
    tgt = jnp.where(desc, new_id, nodes)  # dump column for non-survivors
    oon = jnp.put_along_axis(
        jnp.zeros((batch, nodes + 1), jnp.int32),
        tgt, jnp.broadcast_to(iota[None, :], (batch, nodes)),
        axis=1, inplace=False,
    )[:, :nodes]  # old_of_new: old slot feeding each new slot
    valid = (iota[None, :] < k_cnt[:, None]) & reuse[:, None]

    def g(arr):  # [B, nodes] permute
        return jnp.take_along_axis(arr, oon, axis=1)

    visit_p = jnp.where(valid, g(tree.visit), 0)
    vsum_p = jnp.where(valid, g(tree.value_sum), 0.0)
    pa_p = jnp.where(valid, g(tree.pa), 0)
    e_prior_p = jnp.where(valid, g(tree.e_prior), 0.0)
    term_p = jnp.where(valid, g(tree.terminal), False)
    tval_p = jnp.where(valid, g(tree.tval), 0.0)
    old_parent_p = g(tree.parent)
    parent_p = jnp.where(
        valid & (iota[None, :] > 0),
        jnp.take_along_axis(new_id, jnp.maximum(old_parent_p, 0), axis=1),
        NO_NODE,
    )
    uprior_p = jnp.where(
        valid[:, :, None],
        jnp.take_along_axis(tree.uprior, oon[:, :, None], axis=1),
        -1.0,
    )

    # --- re-noise the new root's prior (same mix as a fresh root)
    up0 = uprior_p[:, 0, :]                                   # [B, A]
    child_mask = valid & (parent_p == 0) & (iota[None, :] > 0)
    ohc = (
        pa_p[:, None, :] == jnp.arange(a_dim, dtype=jnp.int32)[None, :, None]
    ) & child_mask[:, None, :]                                # [B, A, nodes]
    pe = jnp.where(ohc, e_prior_p[:, None, :], 0.0).sum(-1)
    p_full = jnp.where(up0 >= 0, up0, 0.0) + pe
    renorm = mix_prior(p_full)
    up0_new = jnp.where(up0 >= 0, renorm, -1.0)
    uprior_p = uprior_p.at[:, 0, :].set(up0_new)
    e_prior_p = jnp.where(
        child_mask,
        jnp.take_along_axis(renorm, jnp.clip(pa_p, 0, a_dim - 1), axis=1),
        e_prior_p,
    )
    root_child_p = jnp.where(ohc, iota[None, None, :] + 1, 0).sum(-1) - 1

    # --- node states: node-axis permute per env (batch trailing)
    def gn(buf):
        idx = oon.T.reshape((nodes,) + (1,) * (buf.ndim - 2) + (batch,))
        return jnp.take_along_axis(buf, idx, axis=0)

    planes_p = gn(tree.planes)
    compid_p = gn(tree.compid)
    scalars_p = gn(tree.scalars)

    if use_amask:
        am1 = jnp.take_along_axis(tree.amask, oon[:, :, None], axis=1)
        am2 = jnp.take_along_axis(am1, oon[:, None, :], axis=2)
        amask_p = am2 & valid[:, :, None] & valid[:, None, :]
        depth_kid = jnp.take_along_axis(
            tree.depth, jnp.maximum(kid, 0)[:, None], axis=1
        )
        depth_p = jnp.where(valid, g(tree.depth) - depth_kid, 0)
    else:
        amask_p, depth_p = tree.amask, tree.depth

    # --- per-env select: re-rooted tree where reuse, fresh init otherwise
    def sel_b(re_arr, fr_arr):  # batch-leading leaves
        cond = reuse.reshape((batch,) + (1,) * (re_arr.ndim - 1))
        return jnp.where(cond, re_arr, fr_arr)

    def sel_t(re_arr, fr_arr):  # batch-trailing leaves (node states)
        cond = reuse.reshape((1,) * (re_arr.ndim - 1) + (batch,))
        return jnp.where(cond, re_arr, fr_arr)

    tree = Tree(
        visit=sel_b(visit_p, fresh.visit),
        value_sum=sel_b(vsum_p, fresh.value_sum),
        uprior=sel_b(uprior_p, fresh.uprior),
        parent=sel_b(parent_p, fresh.parent),
        pa=sel_b(pa_p, fresh.pa),
        e_prior=sel_b(e_prior_p, fresh.e_prior),
        terminal=sel_b(term_p, fresh.terminal),
        tval=sel_b(tval_p, fresh.tval),
        linked=sel_b(valid, fresh.linked),
        root_child=sel_b(root_child_p, fresh.root_child),
        amask=sel_b(amask_p, fresh.amask) if use_amask else fresh.amask,
        depth=sel_b(depth_p, fresh.depth) if use_amask else fresh.depth,
        planes=sel_t(planes_p, fresh.planes),
        compid=sel_t(compid_p, fresh.compid),
        scalars=sel_t(scalars_p, fresh.scalars),
    )

    # inherited budget: per-env root visit count carried over from the
    # previous move's tree (1 for cold roots) — the reuse diagnostic
    inherited = jnp.where(reuse, tree.visit[:, 0], 1)

    # --- spend the budget (standard PUCT below the root)
    node0 = jnp.zeros((batch,), jnp.int32)
    simulate = _make_simulate(
        params=params,
        key=key,
        evaluator=evaluator,
        board_size=board_size,
        batch=batch,
        nodes=nodes,
        a_dim=a_dim,
        c_puct=c_puct,
        root_entry=lambda tree, sim: _best_edge(tree, node0, c_puct),
        use_amask=use_amask,
        fresh_base=cap,
    )
    tree, _, _ = jax.lax.fori_loop(
        0, num_simulations, simulate, (tree, jnp.int32(0), jnp.int32(0))
    )

    oh = tree.root_child[..., None] == iota                   # [B, A, nodes]
    kid_visits = jnp.where(oh, tree.visit[:, None, :], 0).sum(-1)
    kid_visits = jnp.where(root_legal, kid_visits, 0)
    visit_probs = kid_visits.astype(jnp.float32) / jnp.maximum(
        kid_visits.sum(-1, keepdims=True), 1
    ).astype(jnp.float32)
    root_q = tree.value_sum[:, 0] / jnp.maximum(
        tree.visit[:, 0], 1
    ).astype(jnp.float32)
    if return_stats:
        return visit_probs, root_q, tree, {
            "reused_envs": reuse.sum(),
            "inherited_visits": inherited.sum(),
        }
    return visit_probs, root_q, tree


def batched_search(params, states, key, **kw):
    """Search from canonical tensor states (ops/state.State, trailing env
    batch): packs to BitState and runs :func:`search_batch`.

    Convenience wrapper for hosts that live in the canonical representation
    (examples/mcts_example.py); the self-play stack stays in BitState and
    calls :func:`search_batch` directly.
    """
    return search_batch(params, from_state(states), key, **kw)
