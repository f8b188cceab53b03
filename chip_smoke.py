#!/usr/bin/env python
"""Smoke check of the main paths on the GPU, each against a plain reference.

    python chip_smoke.py            # one card: phases a-d
    python chip_smoke.py --cards=4  # four cards: phases a and e only

a. Device: every JAX device is a GPU, else exit 1 with no result.  Prints
   the card's name and power limit, the JAX version and the compile-cache
   directory.
b. Engine exactness (integers, so the tolerance is zero):
   * ``bit_random_rollout`` at boards 8 and 24, batch 4096, 256 steps: the
     final BitState and stats equal, bit for bit, the same jitted function
     run on the CPU;
   * the canonical tensor engine (ops/step.py) replays the same actions on
     the GPU and agrees with ``to_state`` of the bitboard state after every
     step;
   * the packed learner wire (``bit_rollout_emit_obs(packed=True)``, board
     24, batch 8192, 16 steps) is bit-equal, GPU against CPU.
c. Net: AZNet at the flagship width (board 12, 128 channels, 6 blocks),
   batch 512, float32 at "highest" precision against the CPU, and bf16
   against the float32 CPU reference (tolerances and reasons at NET_TOL).
d. Self-play and learner: ``examples/selfplay_train.main`` at board 12,
   batch 512, chunk 16, 64 simulations, the 128x6 net, for 3 iterations,
   then resumed from its checkpoint for 1 more; and one ``search_batch``
   with the random-rollout evaluator, GPU against CPU.
e. Four cards: data-parallel self-play and learning, float32, batch 512 per
   card, against the same global batch on a one-card mesh; the sharded
   rollout's psum-ed stats against the per-shard seeds run on one card;
   and ``__graft_entry__.dryrun_multichip(4)``.

A failing phase raises and the script exits non-zero.  The last line of
stdout is the JSON result, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

# The CPU is the reference of phases b-d: keep its backend beside the GPU's
# where JAX_PLATFORMS names only the GPU.
_PLATFORMS = os.environ.get("JAX_PLATFORMS", "")
if _PLATFORMS and "cpu" not in _PLATFORMS.split(","):
    os.environ["JAX_PLATFORMS"] = _PLATFORMS + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from twixt_for_open_spiel_tpu.examples import selfplay_train  # noqa: E402
from twixt_for_open_spiel_tpu.models import (  # noqa: E402
    create_net,
    init_params,
    make_optimizer,
)
from twixt_for_open_spiel_tpu.models.mcts import (  # noqa: E402
    rollout_evaluator,
    search_batch,
)
from twixt_for_open_spiel_tpu.ops import bitboard as bb  # noqa: E402
from twixt_for_open_spiel_tpu.ops import geometry as geo  # noqa: E402
from twixt_for_open_spiel_tpu.ops.rollout import (  # noqa: E402
    batch_reset,
    step_auto_reset,
)
from twixt_for_open_spiel_tpu.parallel import (  # noqa: E402
    make_distributed_selfplay,
    make_distributed_train_step,
    make_env_mesh,
    make_sharded_bit_rollout,
    sharded_bit_reset,
)
from twixt_for_open_spiel_tpu.utils import device as devinfo  # noqa: E402
from twixt_for_open_spiel_tpu.utils import serialization  # noqa: E402
from twixt_for_open_spiel_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

# Net tolerances, as max |gpu - ref| <= atol + rtol * |ref| elementwise.
NET_TOL = {
    # Same float32 arithmetic at "highest" precision (no TF32); only the
    # summation order of the convolutions' 1152-term dot products and of
    # the LayerNorm means differs (cuDNN against the CPU).  Each order
    # change moves a sum by a few float32 ulps (2^-24 relative); 13
    # convolutions and 16 LayerNorms add those up to well under 1e-4.
    "float32": dict(rtol=1e-4, atol=1e-4),
    # bf16 operands keep 8 significant bits (relative step 2^-8 = 0.4%).
    # Every one of the 13 convolutions and 2 dense layers rounds its
    # inputs once and LayerNorm renormalises after each, so the errors add
    # roughly as sqrt(15) * 0.4% ~ 1.5% of the activation scale (about 1
    # for logits after LayerNorm); 0.1 absolute + 5% relative holds that
    # with margin and still fails on a wrong layer or layout.
    "bf16": dict(rtol=5e-2, atol=1e-1),
}
# Four-card train step against one card, float32 at "highest" (see
# check_dist_train for the inputs).  The loss terms are sums in another
# order (4 shards of 512 frames plus a psum against one sum over 2048): a
# few ulps, held elementwise.  The parameter update is held per leaf as the
# relative L2 distance of the two updates (2e-5 on 4 CPU devices at this
# width); 1% leaves room for the GPU's convolution algorithms and still
# fails a wrong combine: a missing pmean is off by 300%, a per-shard value
# denominator by 100% with half the envs weightless.
DIST_TOL = dict(rtol=1e-4, atol=1e-5)
DIST_UPDATE_REL_L2 = 1e-2

# search root values: one float32 division each (see check_search)
ROOT_Q_ULPS = 2

SMOKE_SEED = 7


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def assert_trees_equal(a, b, what: str) -> None:
    """Leaf by leaf, bit for bit (shape and dtype included)."""
    pa, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    if ta != tb:
        raise AssertionError(f"{what}: tree structures differ")
    for (path, x), y in zip(pa, lb):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(
                f"{what}{jax.tree_util.keystr(path)}: {x.shape}/{x.dtype} "
                f"vs {y.shape}/{y.dtype}"
            )
        bad = int(np.count_nonzero(x != y))
        if bad:
            raise AssertionError(
                f"{what}{jax.tree_util.keystr(path)}: {bad} of {x.size} "
                f"elements differ"
            )


def assert_close(x, ref, rtol, atol, what: str) -> float:
    """Elementwise |x - ref| <= atol + rtol*|ref|; returns max |x - ref|."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    if x.shape != ref.shape or not np.all(np.isfinite(x)):
        raise AssertionError(f"{what}: shape {x.shape} vs {ref.shape} or "
                             f"non-finite values")
    err = np.abs(x - ref)
    over = err > atol + rtol * np.abs(ref)
    if np.any(over):
        raise AssertionError(
            f"{what}: {int(over.sum())} of {x.size} elements outside "
            f"rtol={rtol} atol={atol} (max err {err.max():.3g})"
        )
    return float(err.max())


# --- phase a ---------------------------------------------------------------


def result_line(dev: dict) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}})


# --- phase b ---------------------------------------------------------------


def check_rollout_exact(board, batch, steps, dev, ref):
    """bit_random_rollout on ``dev`` equals the same function on ``ref``."""
    run = jax.jit(
        lambda seed, st: bb.bit_random_rollout(seed, board, steps, st)
    )
    state = bb.bit_reset(board, batch)
    out = run(SMOKE_SEED, jax.device_put(state, dev))
    assert_trees_equal(out, run(SMOKE_SEED, jax.device_put(state, ref)),
                       f"rollout board {board}")
    log(f"b: rollout board {board} batch {batch} x {steps} steps: state and "
        f"stats bit-equal to the CPU ({int(out[1]['episodes'])} episodes)")
    return out


def replay_canonical(board, batch, steps, dev, rollout_out):
    """Replays bit_random_rollout's actions on the canonical engine and
    counts the cells where ``to_state`` of the bitboard state disagrees
    with it after each step."""

    @jax.jit
    def run(bs, st):
        env = jnp.arange(batch, dtype=jnp.uint32)
        seed = jnp.uint32(SMOKE_SEED)

        def body(carry, i):
            bs, st, bad = carry
            a = bb.sample_bits(bs, board, bb.step_noise(seed, i, env))
            bs, _, _ = bb.bit_step_auto_reset(bs, a, board)
            st, _, _ = step_auto_reset(st, a, board)
            bad = bad + sum(
                jnp.sum(x != y, dtype=jnp.int32)
                for x, y in zip(bb.to_state(bs, board), st)
            )
            return (bs, st, bad), None

        (bs, _, bad), _ = jax.lax.scan(
            body, (bs, st, jnp.int32(0)), jnp.arange(steps)
        )
        return bs, bad

    bs, bad = run(jax.device_put(bb.bit_reset(board, batch), dev),
                  jax.device_put(batch_reset(board, batch), dev))
    assert_trees_equal(bs, rollout_out[0], f"replay board {board}")
    if int(bad):
        raise AssertionError(
            f"canonical engine disagrees with the bitboard state in "
            f"{int(bad)} cells at board {board}")
    log(f"b: canonical engine replays board {board}: equal after every step")


def check_wire_exact(board, batch, chunk, dev, ref):
    run = jax.jit(lambda seed, st: bb.bit_rollout_emit_obs(
        seed, board, chunk, st, packed=True))
    state = bb.bit_reset(board, batch)
    out = run(SMOKE_SEED, jax.device_put(state, dev))
    assert_trees_equal(out, run(SMOKE_SEED, jax.device_put(state, ref)),
                       f"packed wire board {board}")
    log(f"b: packed wire board {board} batch {batch} x {chunk}: "
        f"{out[2].shape} u32 bit-equal to the CPU")


# --- phase c ---------------------------------------------------------------


def net_inputs(board, channels, blocks, batch):
    """f32 params with a random value-output kernel (init's zeros would make
    the value trivially equal) and a random binary observation batch."""
    net = create_net(board, channels=channels, blocks=blocks,
                     dtype=jnp.float32)
    params = init_params(net, jax.random.PRNGKey(0))
    dense = params["params"]["Dense_2"]
    dense["kernel"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(1), dense["kernel"].shape)
    obs = jax.random.bernoulli(
        jax.random.PRNGKey(2), 0.3, (batch, geo.NUM_PLANES, board, board - 2)
    ).astype(jnp.float32)
    return params, obs


def check_net(board, channels, blocks, batch, dev, ref):
    params, obs = net_inputs(board, channels, blocks, batch)
    f32 = create_net(board, channels=channels, blocks=blocks,
                     dtype=jnp.float32)
    bf16 = create_net(board, channels=channels, blocks=blocks)
    with jax.default_matmul_precision("highest"):
        apply32 = jax.jit(f32.apply)
        want = apply32(*jax.device_put((params, obs), ref))
        got = apply32(*jax.device_put((params, obs), dev))
    got16 = jax.jit(bf16.apply)(*jax.device_put((params, obs), dev))
    for name, out in (("float32", got), ("bf16", got16)):
        errs = [assert_close(o, w, what=f"net {name} {part}", **NET_TOL[name])
                for o, w, part in zip(out, want, ("logits", "value"))]
        log(f"c: net {board}x{channels}ch x{blocks} batch {batch} {name}: "
            f"max err logits {errs[0]:.3g}, value {errs[1]:.3g} "
            f"({NET_TOL[name]})")


# --- phase d ---------------------------------------------------------------


def check_selfplay_train(workdir, board, batch, chunk, sims, channels,
                         blocks, iterations=3):
    """Train, resume from the checkpoint, and check what each left."""
    ckpt = os.path.join(workdir, "ckpt")
    argv = [f"--board_size={board}", f"--batch={batch}",
            f"--chunk_steps={chunk}", f"--simulations={sims}",
            f"--channels={channels}", f"--blocks={blocks}",
            f"--checkpoint_dir={ckpt}"]
    net = create_net(board, channels=channels, blocks=blocks)
    init = init_params(net, jax.random.PRNGKey(0))
    opt_like = make_optimizer().init(init)

    def checkpoint():
        params, _, it = serialization.restore_training(ckpt, init, opt_like)
        return params, it

    def changed(a, b):
        return any(not np.array_equal(x, y) for x, y in zip(
            jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))

    first = selfplay_train.main(argv + [f"--iterations={iterations}"])
    params, it = checkpoint()
    if [h["iteration"] for h in first] != list(range(iterations)) \
            or it != iterations or not changed(params, init):
        raise AssertionError(f"training run: iterations {first}, "
                             f"checkpoint at {it}")
    resumed = selfplay_train.main(argv + [f"--iterations={iterations + 1}"])
    params2, it2 = checkpoint()
    if [h["iteration"] for h in resumed] != [iterations] \
            or it2 != iterations + 1 or not changed(params2, params):
        raise AssertionError(f"resumed run: iterations {resumed}, "
                             f"checkpoint at {it2}")
    history = first + resumed
    for h in history:
        if not all(np.isfinite(h[k]) for k in
                   ("loss", "policy_loss", "value_loss")):
            raise AssertionError(f"non-finite loss: {h}")
    steady = [h["moves_per_s"] for h in first[1:]]  # the first compiles
    log(f"d: selfplay_train board {board} batch {batch} chunk {chunk} "
        f"{sims} sims {channels}x{blocks}: losses "
        f"{[round(h['loss'], 4) for h in history]}, resumed at {iterations}")
    return float(np.mean(steady)) if steady else float("nan")


def check_search(board, batch, sims, dev, ref):
    """One search_batch with the random-rollout evaluator, GPU against CPU.

    The Dirichlet root noise is drawn with log/exp, whose last bits differ
    between the GPU's and the CPU's libraries, so it is mixed in with
    weight 0 (exactly the uniform prior).  Everything else is integer
    visit counts and rollout outcomes, whose float sums are exact, and
    one float32 division per Q value: the GPU's quotient may differ from
    the CPU's correctly rounded one in the last bit (seen in most root
    values at 32 simulations, none at 64).  So the visit counts must be
    equal and the root values within ROOT_Q_ULPS units in the last place.
    """
    roots, _ = bb.bit_random_rollout(SMOKE_SEED, board, 9,
                                     bb.bit_reset(board, batch))
    ev = rollout_evaluator(board, 1)

    def run(d):
        return search_batch(None, *jax.device_put(
            (roots, jax.random.PRNGKey(3)), d), evaluator=ev,
            board_size=board, num_simulations=sims, dirichlet_frac=0.0)

    probs, q = (np.asarray(x) for x in run(dev))
    probs_ref, q_ref = (np.asarray(x) for x in run(ref))
    differ = np.flatnonzero(np.any(probs != probs_ref, axis=-1))
    if differ.size:
        raise AssertionError(
            f"search visit counts differ in {differ.size} of {batch} envs "
            f"(first {differ[:8].tolist()})")
    ulps = np.abs(q - q_ref) / np.spacing(np.abs(q_ref))
    if not np.all(ulps <= ROOT_Q_ULPS):
        raise AssertionError(f"root values differ by up to {ulps.max()} "
                             f"ulps (> {ROOT_Q_ULPS})")
    log(f"d: search_batch board {board} batch {batch} {sims} sims: visit "
        f"counts equal to the CPU; root values within {ulps.max():g} ulps "
        f"({int(np.count_nonzero(q != q_ref))} of {batch} not bit-equal)")


# --- phase e ---------------------------------------------------------------


def check_dist_train(devices, board, per_card, chunk, sims, channels,
                     blocks):
    """Four-card self-play feeds a four-card train step; the same global
    batch on a one-card mesh gives the same loss and params.

    Two changes to what self-play hands the learner keep the comparison
    about the combine.  Biases are drawn at random: with init's zero
    biases every LayerNorm behind an empty board region sees a constant
    input, back-propagates 1/sqrt(eps) = 1000 times its gradient, and
    float32 rounding of the near-zero variance decides the result (on
    the card that moved ResBlock_0's first update by 107% between 512-
    and 2048-frame batches, and also between two orders on one card).
    And the value targets and weights are drawn at random, with the first
    half of the envs weightless: a short chunk finishes no game, and the
    value term's global denominator is the part a naive per-shard combine
    gets wrong when the weights are uneven across shards."""
    n = len(devices)
    mesh, mesh1 = make_env_mesh(devices), make_env_mesh(devices[:1])
    net = create_net(board, channels=channels, blocks=blocks,
                     dtype=jnp.float32)
    params = init_params(net, jax.random.PRNGKey(0))
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    keys = jax.random.split(jax.random.PRNGKey(2), len(leaves))
    params = jax.tree_util.tree_unflatten(tree, [
        0.1 * jax.random.normal(k, x.shape)
        if jax.tree_util.keystr(path).endswith("['bias']") else x
        for (path, x), k in zip(leaves, keys)])
    # plain SGD so the param delta IS the gradient: adam's first step is
    # ~lr*sign(g) and would blow a last-bit difference of a near-zero
    # gradient up to 2*lr
    opt = optax.sgd(0.1)
    opt_state = opt.init(params)
    with jax.default_matmul_precision("highest"):
        selfplay, _ = make_distributed_selfplay(
            net.apply, board, num_steps=chunk, num_simulations=sims,
            mesh=mesh)
        train, _ = make_distributed_train_step(net.apply, opt, mesh)
        train1, _ = make_distributed_train_step(net.apply, opt, mesh1)
        state = sharded_bit_reset(board, n * per_card, mesh)
        t0 = time.perf_counter()
        _, sample = selfplay(params, state, jax.random.PRNGKey(1))
        jax.block_until_ready(sample)
        t_selfplay = time.perf_counter() - t0
        rng = np.random.default_rng(SMOKE_SEED)
        shape = sample.weight.shape
        weight = (rng.random(shape) < 0.5).astype(np.float32)
        weight[:, : shape[1] // 2] = 0.0
        sample = sample._replace(
            value=jax.device_put(rng.choice([-1.0, 1.0], shape).astype(
                np.float32), sample.value.sharding),
            weight=jax.device_put(weight, sample.weight.sharding))
        if {s.data.shape[1] for s in sample.obs.addressable_shards} != {
                per_card}:
            raise AssertionError("sample is not sharded per card")
        p_n, _, m_n = train(params, opt_state, sample)
        one = NamedSharding(mesh1, PartitionSpec())
        p_1, _, m_1 = train1(*jax.device_put((params, opt_state, sample),
                                             one))
    errs = [assert_close(float(m_n[k]), float(m_1[k]), what=f"metric {k}",
                         **DIST_TOL)
            for k in ("loss", "policy_loss", "value_loss", "train_frames")]
    perr = update_distance(params, p_n, p_1)
    log(f"e: {n}-card self-play ({n} x {per_card} envs, {chunk} moves, "
        f"{sims} sims, {t_selfplay:.1f} s incl. compile) + train step vs "
        f"one card: loss {float(m_n['loss']):.6f}, max metric err "
        f"{max(errs):.3g} ({DIST_TOL}), max update rel L2 {perr:.3g} "
        f"(<= {DIST_UPDATE_REL_L2})")


def update_distance(p0, p_a, p_b) -> float:
    """Max over leaves of |(a - p0) - (b - p0)|_2 / |b - p0|_2; raises
    above DIST_UPDATE_REL_L2."""
    worst = 0.0
    for path, x0, a, b in zip(
            *zip(*jax.tree_util.tree_flatten_with_path(p0)[0]),
            jax.tree_util.tree_leaves(p_a), jax.tree_util.tree_leaves(p_b)):
        x0, a, b = (np.asarray(v, np.float64) for v in (x0, a, b))
        if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
            raise AssertionError(f"update {jax.tree_util.keystr(path)}: "
                                 f"non-finite values")
        ref = np.linalg.norm(b - x0)
        err = np.linalg.norm(a - b) / ref if ref else np.linalg.norm(a - b)
        if err > DIST_UPDATE_REL_L2:
            raise AssertionError(
                f"update {jax.tree_util.keystr(path)}: relative L2 distance "
                f"{err:.3g} > {DIST_UPDATE_REL_L2}")
        worst = max(worst, float(err))
    return worst


def check_sharded_rollout(devices, board, per_card, steps):
    """psum-ed stats of the sharded rollout == per-shard seeds run on one
    card and summed; per-shard final states equal too."""
    n = len(devices)
    roll, mesh = make_sharded_bit_rollout(board, steps, make_env_mesh(devices))
    final, stats = roll(SMOKE_SEED, sharded_bit_reset(board, n * per_card,
                                                      mesh))
    one = jax.jit(lambda seed, st: bb.bit_random_rollout(seed, board, steps,
                                                         st))
    state = jax.device_put(bb.bit_reset(board, per_card), devices[0])
    episodes, results = 0, np.zeros(4, np.int64)
    for s in range(n):
        seed = np.uint32((SMOKE_SEED + s * 0x01000193) % 2 ** 32)
        fs, st = one(seed, state)
        episodes += int(st["episodes"])
        results += np.asarray(st["results"])
        assert_trees_equal(
            jax.tree_util.tree_map(
                lambda x: np.asarray(x)[..., s * per_card:(s + 1) * per_card],
                final),
            fs, f"shard {s} final state")
    if int(stats["episodes"]) != episodes or not np.array_equal(
            np.asarray(stats["results"]), results):
        raise AssertionError(
            f"psum stats {int(stats['episodes'])}/{stats['results']} vs "
            f"per-shard sums {episodes}/{results}")
    log(f"e: sharded rollout board {board} {n} x {per_card} x {steps}: psum "
        f"stats == per-shard sums ({episodes} episodes), states equal")


# --- driver ----------------------------------------------------------------


def run_one_card(gpu, cpu, workdir):
    timings = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        timings[name] = time.perf_counter() - t0
        log(f"{name}: {timings[name]:.1f} s")
        return out

    for board in (8, 24):
        out = phase(f"b rollout board {board}", check_rollout_exact, board,
                    4096, 256, gpu, cpu)
        phase(f"b canonical replay board {board}", replay_canonical, board,
              4096, 256, gpu, out)
    phase("b packed wire", check_wire_exact, 24, 8192, 16, gpu, cpu)
    phase("c net", check_net, 12, 128, 6, 512, gpu, cpu)
    moves = phase("d selfplay_train", check_selfplay_train, workdir, 12, 512,
                  16, 64, 128, 6)
    phase("d search", check_search, 12, 512, 64, gpu, cpu)
    return moves, timings


def run_four_cards(devices):
    import __graft_entry__

    t0 = time.perf_counter()
    check_dist_train(devices, 12, 512, 4, 16, 128, 6)
    check_sharded_rollout(devices, 8, 4096, 256)
    __graft_entry__.dryrun_multichip(len(devices))
    log(f"e: dryrun_multichip({len(devices)}) passed; phase e "
        f"{time.perf_counter() - t0:.1f} s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    dev = devinfo.require_gpu()
    if dev["count"] < args.cards:
        raise SystemExit(f"--cards={args.cards} but JAX found {dev['count']}")
    cards = devinfo.nvidia_smi()
    for line in cards:
        log(f"a: card {line}")
    log(f"a: jax {jax.__version__}, {dev['count']} x {dev['kind']}, "
        f"compile cache {enable_compile_cache()}")

    gpus = jax.devices()
    if args.cards == 4:
        run_four_cards(gpus[:4])
        dev["count"] = 4
    else:
        with tempfile.TemporaryDirectory() as workdir:
            moves, timings = run_one_card(gpus[0], jax.devices("cpu")[0],
                                          workdir)
        log(f"d: self-play + train {moves:,.0f} moves/s on {cards[0]} "
            f"(board 12, batch 512, 64 sims, 128x6 bf16; iterations 2 and 3 "
            f"of 3, the first compiles)")
        log(f"timings: {json.dumps(timings)}")
    print(cards[0] if args.cards == 1 else "; ".join(cards[:4]))
    print(result_line(dev))


if __name__ == "__main__":
    sys.exit(main())
