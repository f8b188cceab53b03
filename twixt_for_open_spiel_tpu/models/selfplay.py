"""AlphaZero-style self-play + learner loop (BASELINE.json config 5).

Everything is a fixed-shape jitted program running on the BITBOARD engine
end to end (the rollout hot path's representation — packed u32 bitplanes,
env batch trailing):

  * ``selfplay_chunk``: T lockstep env steps over a [B] batch where each
    action comes from the array-of-trees batched MCTS (models/mcts.py);
    emits the training tuple (obs, policy target, outcome) with a backward
    scan assigning each position the final result of its episode
    (auto-reset keeps envs dense);
  * ``train_step``: masked cross-entropy + value MSE on the chunk, optax
    adam; gradients are averaged across the data-parallel mesh by XLA's
    collectives when the batch is sharded (parallel/).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.bitboard import (
    BitState,
    bit_legal_mask_flat,
    bit_step_auto_reset,
)
from twixt_for_open_spiel_tpu.ops.observe import (
    bit_observation_packed_with_legal,
    legal_words_from_obs,
    unpack_legal_words_flat,
    unpack_observation_nchw,
)
from twixt_for_open_spiel_tpu.models import mcts


class Sample(NamedTuple):
    """One training chunk, time-major [T, B, ...].

    ``obs`` is the FULL wire in one array ([T, B, 12*P] u32 column words,
    ~1 bit/cell): the 12 packed observation planes
    (ops/observe.bit_observation_packed, trailing dims coalesced so each
    step writes one dense block) with the MOVER's packed LEGAL-action
    plane riding in the words' free low bits
    (ops/observe.bit_observation_packed_with_legal) — 16-32x fewer bytes
    than the unpacked bf16 tensor.  The policy loss needs the legal plane
    to normalise its cross-entropy over the legal set rather than the
    visit support (a zero-visit legal action must still receive gradient
    through the softmax denominator — round-3's support-normalised CE
    never penalised probability piled on unvisited legal moves, a
    board-12 training bug).  Riding it in the free bits keeps the wire a
    SINGLE scan output with no extra bytes (scripts/perf_obs_wire.py
    times it against a second [T, B, P] output and a 13-plane concat).  The learner decodes observations with
    ``unpack_observation_nchw`` (reads only live bits, unaffected by the
    stowaways) fused into its input transpose, and the legal mask with
    ``legal_words_from_obs`` + ``unpack_legal_words_flat`` (loss_fn);
    both decodes are pinned bit-exact (tests/test_bitboard.py,
    tests/test_models.py).
    """

    obs: jnp.ndarray       # u32 [T, B, 12*P] obs planes + stowaway legal
    policy: jnp.ndarray    # f32 [T, B, A] MCTS visit distribution
    value: jnp.ndarray     # f32 [T, B] outcome from mover's perspective
    weight: jnp.ndarray    # f32 [T, B] 0 for positions of unfinished games


@functools.partial(
    jax.jit,
    static_argnames=(
        "net_apply", "board_size", "num_steps", "num_simulations", "search",
        "temp_moves", "reuse_cap", "value_bootstrap", "debug_trace",
    ),
)
def selfplay_chunk(
    params,
    bs: BitState,
    key,
    *,
    net_apply,
    board_size: int,
    num_steps: int,
    num_simulations: int,
    temperature: float = 1.0,
    temp_moves: int = 10 ** 9,
    search: str = "puct",
    reuse_cap: int | None = None,
    dirichlet_alpha: float | None = None,
    dirichlet_frac: float = 0.25,
    value_bootstrap: float = 0.0,
    debug_trace: bool = False,
):
    """Run ``num_steps`` MCTS-driven lockstep steps; returns
    (final_bitstate, Sample).

    ``bs`` uses the engine's trailing-env-axis batch layout (1-D batch);
    the emitted Sample is time-major, batch-second ([T, B, ...]) as the
    learner expects.

    ``search`` selects the move generator: ``"puct"`` — AlphaZero search
    with Dirichlet root noise, visit-count policy targets, and
    temperature-sampled actions (greedy argmax once an episode's move
    counter reaches ``temp_moves``, the AlphaZero opening-temperature
    anneal; the default never anneals); ``"puct_reuse"`` — the same
    search with TREE REUSE across moves (mcts.search_batch_reuse): each
    move re-roots the previous move's tree on the action just played and
    keeps the surviving subtree's visits/values/priors (auto-reset envs
    cold-start; the tree carry re-seeds at chunk boundaries, so 1 move
    per chunk is cold).  ``reuse_cap`` bounds the survivor slots
    (default num_simulations+1 = the whole budget can survive; smaller
    caps shrink the tree — every dense search pass scales with
    cap+sims — at the cost of cold-starting envs whose surviving
    subtree overflows); ``"gumbel"`` — Gumbel sequential halving
    (mcts.gumbel_search_batch): the sampled Gumbels are the exploration,
    the chosen candidate is played directly, and the policy target is the
    completed-Q improved policy.
    """
    assert search in ("puct", "puct_reuse", "gumbel"), search
    batch = bs.current_player.shape[-1]
    reuse = search == "puct_reuse"
    # Root-noise concentration.  The historical fixed default (0.3) is
    # fine up to ~board 16 but too DIFFUSE at board 24: spread over ~530
    # legal actions, no single noise component gets enough prior mass to
    # compete with a sharpening net policy for visits, PUCT selection
    # turns prior-driven (the value head is outcome-starved on big
    # boards), and self-play collapses to a deterministic opening spike
    # (measured: empty-board policy entropy 0.000 by iteration 150,
    # gates ~0.16 vs init — docs/PERF.md board-24).  AlphaZero's own
    # scaling rule is alpha ~ 10/|legal|; pass dirichlet_alpha
    # explicitly (train_arena_gate --dirichlet_alpha) for big boards.
    if dirichlet_alpha is None:
        dirichlet_alpha = 0.3
    # bootstrap frames must never outweigh exact-outcome frames (w=1.0):
    # a value > 1 would silently invert the valve's intent in the MSE.
    if not 0.0 <= value_bootstrap <= 1.0:
        raise ValueError(
            f"value_bootstrap must be in [0, 1], got {value_bootstrap}"
        )

    def body(carry, i):
        if reuse:
            bs, key, tree, played, done_prev = carry
        else:
            bs, key = carry
        key, k_search, k_act = jax.random.split(key, 3)
        # one [B, 12*P] wire: obs planes + the mover's legal plane in the
        # free low bits (see the Sample docstring)
        obs = bit_observation_packed_with_legal(bs, board_size)
        player = jnp.clip(bs.current_player, 0, 1)

        if search == "gumbel":
            actions, probs, root_q = mcts.gumbel_search_batch(
                params,
                bs,
                k_search,
                evaluator=mcts.net_evaluator(net_apply, board_size),
                board_size=board_size,
                num_simulations=num_simulations,
            )
        else:
            if reuse:
                probs, root_q, tree = mcts.search_batch_reuse(
                    params,
                    bs,
                    k_search,
                    tree,
                    played,
                    done_prev,
                    evaluator=mcts.net_evaluator(net_apply, board_size),
                    board_size=board_size,
                    num_simulations=num_simulations,
                    reuse_cap=reuse_cap,
                    dirichlet_alpha=dirichlet_alpha,
                    dirichlet_frac=dirichlet_frac,
                )
            else:
                probs, root_q = mcts.search_batch(
                    params,
                    bs,
                    k_search,
                    evaluator=mcts.net_evaluator(net_apply, board_size),
                    board_size=board_size,
                    num_simulations=num_simulations,
                    dirichlet_alpha=dirichlet_alpha,
                    dirichlet_frac=dirichlet_frac,
                )
            # temperature sampling over visit counts; illegal actions
            # carry zero visit mass, but mask explicitly for safety
            logits = jnp.log(jnp.maximum(probs, 1e-9)) / temperature
            legal = jnp.moveaxis(
                bit_legal_mask_flat(bs, player, board_size), 0, -1
            )  # [B, A]
            logits = jnp.where(legal, logits, -jnp.inf)
            sampled = jax.random.categorical(k_act, logits, axis=-1)
            greedy = jnp.argmax(jnp.where(legal, probs, -1.0), axis=-1)
            actions = jnp.where(
                bs.move_counter < temp_moves, sampled, greedy
            )

        actions = actions.astype(jnp.int32)
        nxt, done, result = bit_step_auto_reset(bs, actions, board_size)
        out = {
            "obs": obs,
            "policy": probs,
            "player": player,
            "done": done,
            "result": result,
        }
        if value_bootstrap:
            out["root_q"] = root_q
        if reuse:
            return (nxt, key, tree, actions, done), out
        return (nxt, key), out

    if reuse:
        tree0 = mcts.init_reuse_tree(
            bs, board_size=board_size, num_simulations=num_simulations,
            reuse_cap=reuse_cap,
        )
        carry0 = (
            bs, key, tree0,
            jnp.full((batch,), -1, jnp.int32),
            jnp.ones((batch,), bool),
        )
        (final_bs, *_), tr = jax.lax.scan(
            body, carry0, jnp.arange(num_steps)
        )
    else:
        (final_bs, _), tr = jax.lax.scan(
            body, (bs, key), jnp.arange(num_steps)
        )

    # Backward scan: propagate each episode's terminal outcome (red's
    # perspective) to all of its positions.  Positions whose episode never
    # finished inside the chunk get weight 0 — UNLESS ``value_bootstrap``
    # is set, in which case the trailing unfinished episode's frames are
    # trained toward the LAST step's search root value (converted to
    # red's perspective) with weight ``value_bootstrap``: the n-step
    # truncation bootstrap.  On big boards games run several chunks long
    # (board 24: ~150 plies vs chunk 56), so outcome-only targets starve
    # the value head (~3.5% of frames, all endgame) and PUCT selection
    # turns prior-driven — the entropy-collapse mechanism docs/PERF.md's
    # board-24 section measures.  Exact-outcome frames always keep
    # weight 1.0 and their exact targets (pinned by
    # tests/test_models.py::test_value_bootstrap_targets).
    def back(carry, t):
        z_red, w = carry
        done, result = t["done"], t["result"]
        z_here = jnp.where(
            result == geo.RESULT_RED_WIN,
            1.0,
            jnp.where(result == geo.RESULT_BLUE_WIN, -1.0, 0.0),
        )
        z_red = jnp.where(done, z_here, z_red)
        w = jnp.where(done, 1.0, w)
        return (z_red, w), (z_red, w)

    batch_shape = tr["done"].shape[1:]
    if value_bootstrap:
        # mover-perspective root value of the chunk's last position,
        # flipped to red's perspective
        q_last = tr["root_q"][-1]
        z0 = jnp.where(tr["player"][-1] == 0, q_last, -q_last)
        w0 = jnp.full(batch_shape, float(value_bootstrap))
    else:
        z0 = jnp.zeros(batch_shape)
        w0 = jnp.zeros(batch_shape)
    (_, _), (z_red, w) = jax.lax.scan(
        back, (z0, w0), tr, reverse=True,
    )
    value = jnp.where(tr["player"] == 0, z_red, -z_red)
    sample = Sample(
        obs=tr["obs"],
        policy=tr["policy"],
        value=value,
        weight=w.astype(jnp.float32),
    )
    if debug_trace:
        # test/diagnostic hook: per-frame mover + (with bootstrap) the
        # last step's mover-perspective root value — exactly the inputs
        # of the perspective conversion above, so tests can pin the SIGN
        # of bootstrap targets, not just their magnitude
        aux = {"player": tr["player"]}
        if value_bootstrap:
            aux["root_q_last"] = tr["root_q"][-1]
        return final_bs, sample, aux
    return final_bs, sample


def make_optimizer(
    lr: float = 2e-3, weight_decay: float = 1e-4, clip_norm: float = 1.0
):
    """adamw with global-norm gradient clipping.

    Clipping matters for the value head: outcome targets are almost always
    +-1 (draws are rare above board 5), so un-clipped adam saturates the
    tanh early — measured as value MSE ~1.9 (saturated, uncorrelated)
    while the policy loss kept falling (round-3 training runs).
    """
    return optax.chain(
        optax.clip_by_global_norm(clip_norm),
        optax.adamw(lr, weight_decay=weight_decay),
    )


def policy_ce(logits, target, legal):
    """Cross-entropy of the MCTS visit target vs softmax(logits) over the
    LEGAL action set (softmax denominator = all legal actions, [..., A]).

    Normalising over the target's support instead (round 3's
    ``where(target > 0, logits, -inf)``) silently excluded every legal
    zero-visit action from the denominator, so the net was never
    penalised for piling probability onto unvisited legal moves — nearly
    invisible at board 8 (64 sims / <=60 legal: targets are dense), but
    at board 12 (64 sims / ~140 legal) most legal actions sit outside
    the support of every target, and training anti-learned.  Pinned by
    tests/test_models.py::test_policy_ce_gradient_covers_legal_set.
    """
    logp = jax.nn.log_softmax(
        jnp.where(legal, logits, logits - 1e9), axis=-1
    )
    return -(target * logp).sum(-1)


def loss_fn(params, net_apply, sample: Sample, *, val_denom=None):
    """AlphaZero loss on one chunk: legal-set policy CE (every frame) +
    outcome-weighted value MSE.

    ``val_denom`` overrides the value term's normaliser (default: this
    sample's own finished-frame count).  The distributed learner passes
    ``max(global_frames, 1) / num_shards`` so that the plain ``pmean`` of
    per-shard gradients equals the EXACT global gradient of
    ``sum_shards(val_num) / max(global_frames, 1)`` — without it, a shard
    with few finished episodes would get the same value-gradient weight
    as a full shard (parallel/learner_feed.py; pinned exact vs the local
    step by tests/test_sharding.py::test_dist_train_step_matches_local).
    """
    t, b = sample.obs.shape[:2]
    a_dim = sample.policy.shape[-1]
    n = int(round(a_dim ** 0.5))  # action space is board_size**2
    p_words = sample.obs.shape[-1] // 12
    pk = sample.obs.reshape(t, b, 12, p_words)
    legal = unpack_legal_words_flat(
        legal_words_from_obs(pk), n
    )  # [T, B, A] bool — the stowaway legal plane in the obs free bits
    obs = unpack_observation_nchw(pk.reshape(t * b, 12, p_words), n)
    logits, value = net_apply(params, obs)
    logits = logits.reshape(t, b, -1)
    value = value.reshape(t, b)

    pol_loss = policy_ce(logits, sample.policy, legal)
    val_loss = (value - sample.value) ** 2
    # The VALUE target needs the episode's terminal outcome, so it is
    # weighted by ``sample.weight`` (0 for positions whose episode never
    # finished inside the chunk).  The POLICY target — the MCTS visit
    # distribution — is valid on-policy data regardless of the outcome,
    # so EVERY frame trains the policy head.  (Round 3 weighted both by
    # ``weight``, discarding ~3/4 of the search compute's policy signal
    # at board 12 / chunk 32, where most episodes span chunks.)
    w = sample.weight
    if val_denom is None:
        val_denom = jnp.maximum(w.sum(), 1.0)
    pol_mean = pol_loss.mean()
    val_mean = (val_loss * w).sum() / val_denom
    loss = pol_mean + val_mean
    # mean entropy of the visit targets — the collapse canary: a healthy
    # big-board run sits well above 0 (board-24's entropy collapse to a
    # deterministic opening spike showed here first; docs/PERF.md)
    tgt_ent = -(
        sample.policy * jnp.log(jnp.maximum(sample.policy, 1e-12))
    ).sum(-1).mean()
    return loss, {
        "loss": loss,
        "policy_loss": pol_mean,
        "value_loss": val_mean,
        "train_frames": w.sum(),
        "target_entropy": tgt_ent,
    }


def accumulate_grads(params, net_apply, sample: Sample, *, val_denom,
                     microbatch: int = 1):
    """Gradients + metrics of ``loss_fn`` over the chunk, with the value
    term normalised by ``val_denom``, accumulated over ``microbatch``
    equal time-slices via ``lax.scan``.

    EXACT: with K equal slices, the global objective
      mean_frames(pol_ce) + sum(val_mse * w) / val_denom
    equals the mean over slices of the per-slice surrogate
      pol_mean_slice + val_sum_slice / (val_denom / K)
    (the same telescoping the distributed combine uses across shards —
    parallel/learner_feed.py), so summing slice gradients and dividing
    by K reproduces the full-batch gradient up to float re-association.
    The point is MEMORY: the net's activations exist for one slice at a
    time instead of the whole T*B frame batch — board 24's chunk-56
    train step needed 16.95 GB monolithic, more than a 16 GB card holds,
    and fits there with microbatch=4.  Pinned against the monolithic step by
    tests/test_models.py::test_train_microbatch_matches_monolithic.
    """
    if microbatch == 1:
        return jax.grad(loss_fn, has_aux=True)(
            params, net_apply, sample, val_denom=val_denom
        )
    t = sample.obs.shape[0]
    assert t % microbatch == 0, (t, microbatch)
    slices = jax.tree_util.tree_map(
        lambda x: x.reshape((microbatch, t // microbatch) + x.shape[1:]),
        sample,
    )
    vd = val_denom / microbatch

    def body(acc, s):
        g, m = jax.grad(loss_fn, has_aux=True)(
            params, net_apply, s, val_denom=vd
        )
        return jax.tree_util.tree_map(jnp.add, acc, g), m

    zero = jax.tree_util.tree_map(jnp.zeros_like, params)
    acc, ms = jax.lax.scan(body, zero, slices)
    grads = jax.tree_util.tree_map(lambda x: x / microbatch, acc)
    metrics = {
        k: (v.sum() if k == "train_frames" else v.mean())
        for k, v in ms.items()
    }
    return grads, metrics


@functools.partial(
    jax.jit, static_argnames=("net_apply", "optimizer", "microbatch")
)
def train_step(params, opt_state, sample: Sample, *, net_apply, optimizer,
               microbatch: int = 1):
    grads, metrics = accumulate_grads(
        params, net_apply, sample,
        val_denom=jnp.maximum(sample.weight.sum(), 1.0),
        microbatch=microbatch,
    )
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, metrics
