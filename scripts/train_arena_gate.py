#!/usr/bin/env python
"""Close the loop: train config-5 self-play for real and PROVE strength.

The reference exists to be played well (its README drives OpenSpiel's MCTS
bots, reference README.md:36-42); throughput alone doesn't show the
stack does that job.  This script runs the full self-play ->
train loop on the visible device (the GPU, or CPU with --smoke),
checkpointing via utils/serialization, and GATES the result with the
batched arena (models/arena.py):

  * at every gate iteration, current params vs the INITIAL params
    (both sides searching with the same simulation budget) — the
    iteration-vs-arena-score strength curve; the BEST-scoring gate's
    params are kept (self-play strength is not monotone: the round-3
    curve peaked at 0.89 and regressed to 0.72 by 1500 iterations);
  * at the end, the BEST params vs uniform-RANDOM moves.

Pass criteria (docs/PERF.md records the measured curve):
  trained-vs-init a_score >= 0.8 and trained-vs-random a_score >= 0.8
  over >= 256 games at fixed simulations.

Usage (real chip; the DEFAULTS reproduce the documented board-8 headline
curve — docs/PERF.md "Training for real", run JSONL at
docs/runs/train_gate_board8_seed0.jsonl):
    python scripts/train_arena_gate.py \
        --checkpoint_dir=checkpoints/twixt_az_gate --log=checkpoints/gate.jsonl
Smoke (CPU, tiny): python scripts/train_arena_gate.py --smoke
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--board_size", type=int, default=8)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--chunk_steps", type=int, default=24)
    ap.add_argument("--simulations", type=int, default=64)
    ap.add_argument("--iterations", type=int, default=1100)
    ap.add_argument("--temp_moves", type=int, default=12,
                    help="opening plies with temperature sampling; greedy after")
    ap.add_argument("--search", default="puct",
                    choices=["puct", "puct_reuse", "gumbel"],
                    help="self-play move generator (models/selfplay)")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dirichlet_alpha", type=float, default=None,
                    help="root-noise concentration (default 0.3).  Scale "
                         "DOWN with the action space (AlphaZero's rule "
                         "alpha ~ 10/|legal|, i.e. ~0.02 at board 24): "
                         "the fixed 0.3 is too diffuse above ~board 16 "
                         "and self-play collapses to a deterministic "
                         "opening spike (docs/PERF.md board-24)")
    ap.add_argument("--dirichlet_frac", type=float, default=0.25,
                    help="root prior noise fraction")
    ap.add_argument("--value_bootstrap", type=float, default=0.0,
                    help="weight for n-step-truncation value targets on "
                         "chunk-unfinished frames (bootstrapped from the "
                         "last step's search root value).  0 = outcome-"
                         "only (the small-board recipes).  Big boards "
                         "(games >> chunk) starve the value head without "
                         "it — docs/PERF.md board-24")
    ap.add_argument("--train_microbatch", type=int, default=1,
                    help="split the train step into K equal time-slices "
                         "with EXACT gradient accumulation (the big-board "
                         "memory valve: board 24's chunk-56 step needs "
                         "16.95G HBM monolithic, fits at K=4)")
    ap.add_argument("--arena_batch", type=int, default=256)
    ap.add_argument("--arena_sims", type=int, default=64)
    ap.add_argument("--arena_search", default="puct",
                    choices=["puct", "gumbel"],
                    help="gate search: gumbel@16 agrees with puct@64 "
                         "verdicts on strong nets at ~4x less search "
                         "(docs/PERF.md) — the cheap-gate setting for "
                         "big-board runs")
    ap.add_argument("--gates",
                    default="100,200,300,400,500,600,700,800,900,1000",
                    help="comma-separated iterations at which to arena-gate")
    ap.add_argument("--mesh", type=int, default=0,
                    help="N>0: run self-play AND training through the "
                         "DISTRIBUTED path (parallel/learner_feed) over an "
                         "N-device env mesh — sharded env state, sharded "
                         "sample, psum/pmean gradient combine.  0 (default): "
                         "single-device local path.  N=1 on the real chip "
                         "runs the identical shard_map program a pod would.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--checkpoint_dir (params, optimizer state, "
                         "iteration counter, and the best-gate record); "
                         "the recovery path after an interrupted run")
    ap.add_argument("--log", default=None, help="JSONL metrics file")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CPU run to validate the loop end to end")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend without --smoke's "
                         "tiny-budget overrides — for CPU tests of the "
                         "real argument surface")
    args = ap.parse_args()

    if args.smoke or args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        try:
            jax.extend.backend.clear_backends()
        except Exception:
            pass
    if args.smoke:
        args.board_size, args.batch, args.chunk_steps = 5, 32, 8
        args.simulations, args.channels, args.blocks = 8, 16, 1
        args.iterations, args.arena_batch, args.arena_sims = 4, 16, 8
        args.gates = "2,4"

    import numpy as np

    from twixt_for_open_spiel_tpu.models import (
        arena_match,
        create_net,
        init_params,
        make_optimizer,
        selfplay_chunk,
        train_step,
    )
    from twixt_for_open_spiel_tpu.ops.bitboard import bit_reset
    from twixt_for_open_spiel_tpu.utils import serialization

    n = args.board_size
    if args.search == "gumbel" and (
        args.dirichlet_alpha is not None or args.dirichlet_frac != 0.25
    ):
        # Gumbel search has no Dirichlet root noise (exploration comes
        # from the Gumbel perturbation itself) — fail fast rather than
        # burn hours of chip time on a flag that does nothing.
        ap.error("--dirichlet_alpha/--dirichlet_frac have no effect with "
                 "--search=gumbel (Gumbel explores via its own root "
                 "perturbation); drop the flags or use --search=puct")
    gates = sorted(int(g) for g in args.gates.split(",") if g)
    print(
        f"[train] backend={jax.default_backend()} n={n} batch={args.batch} "
        f"chunk={args.chunk_steps} sims={args.simulations} "
        f"net={args.channels}x{args.blocks} iters={args.iterations} "
        f"search={args.search} gates={gates}",
        file=sys.stderr,
    )
    logf = open(args.log, "a") if args.log else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, file=sys.stderr)
        if logf:
            logf.write(line + "\n")
            logf.flush()

    net = create_net(n, channels=args.channels, blocks=args.blocks)
    params0 = init_params(net, jax.random.PRNGKey(args.seed))
    params = params0
    opt = make_optimizer(args.lr)
    opt_state = opt.init(params)

    if args.mesh:
        # config 5's distributed clause (BASELINE.json): env-sharded
        # self-play feeding the sharded learner through XLA collectives —
        # the same shard_map program at N=1 (real chip) and N=8 (CPU mesh)
        from twixt_for_open_spiel_tpu.parallel import (
            make_distributed_selfplay,
            make_distributed_train_step,
            make_env_mesh,
            shard_env_pytree,
        )

        assert args.batch % args.mesh == 0, (args.batch, args.mesh)
        devices = jax.devices()[: args.mesh]
        assert len(devices) == args.mesh, (
            f"--mesh={args.mesh} but only {len(devices)} devices"
        )
        mesh = make_env_mesh(devices)
        dist_selfplay, _ = make_distributed_selfplay(
            net.apply,
            n,
            num_steps=args.chunk_steps,
            num_simulations=args.simulations,
            mesh=mesh,
            search=args.search,
            temp_moves=args.temp_moves,
            dirichlet_alpha=args.dirichlet_alpha,
            dirichlet_frac=args.dirichlet_frac,
            value_bootstrap=args.value_bootstrap,
        )
        dist_trainer, _ = make_distributed_train_step(
            net.apply, opt, mesh, microbatch=args.train_microbatch
        )

        def run_selfplay(params, state, k):
            return dist_selfplay(params, state, k)

        def run_train(params, opt_state, sample):
            return dist_trainer(params, opt_state, sample)

        def place_state(state):
            return shard_env_pytree(state, mesh)
    else:
        def run_selfplay(params, state, k):
            return selfplay_chunk(
                params,
                state,
                k,
                net_apply=net.apply,
                board_size=n,
                num_steps=args.chunk_steps,
                num_simulations=args.simulations,
                temp_moves=args.temp_moves,
                search=args.search,
                dirichlet_alpha=args.dirichlet_alpha,
                dirichlet_frac=args.dirichlet_frac,
                value_bootstrap=args.value_bootstrap,
            )

        def run_train(params, opt_state, sample):
            return train_step(
                params, opt_state, sample, net_apply=net.apply,
                optimizer=opt, microbatch=args.train_microbatch,
            )

        def place_state(state):
            return state

    def gate(params, it, key):
        t0 = time.perf_counter()
        tally = arena_match(
            params,
            params0,
            key,
            net_apply=net.apply,
            board_size=n,
            batch=args.arena_batch,
            num_simulations=args.arena_sims,
            search=args.arena_search,
        )
        tally = {k: float(np.asarray(v)) for k, v in tally.items()}
        emit(
            {
                "kind": "gate_vs_init",
                "iteration": it,
                "a_score": tally["a_score"],
                "a_wins": tally["a_wins"],
                "b_wins": tally["b_wins"],
                "draws": tally["draws"],
                "games": tally["games"],
                "secs": round(time.perf_counter() - t0, 1),
            }
        )
        return tally["a_score"]

    state = place_state(bit_reset(n, args.batch))
    key = jax.random.PRNGKey(args.seed + 1)
    best_score, best_params, best_it = -1.0, params, 0
    start_it = 1
    if args.resume and args.checkpoint_dir:
        restored = serialization.restore_training(
            args.checkpoint_dir, params, opt_state
        )
        if restored is not None:
            params, opt_state, last_it = restored
            start_it = last_it + 1
            meta_path = os.path.join(args.checkpoint_dir, "best_meta.json")
            best_dir = os.path.join(args.checkpoint_dir, "best")
            rb = serialization.restore_training(best_dir, params, opt_state)
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
                if rb is not None:
                    best_score, best_it = meta["a_score"], meta["iteration"]
                    best_params = rb[0]
                else:
                    # meta without a restorable best/: keeping the recorded
                    # score would pair it with the WRONG params (the latest),
                    # so stay conservative and let the next gate re-establish
                    emit({"kind": "warn", "msg": "best_meta.json present "
                          "but best/ restore failed; resetting best record"})
            elif rb is not None:
                # pre-meta checkpoint (best/ exists, score not recorded):
                # re-measure the restored best so the next gate can't
                # silently overwrite the true best with a weaker checkpoint
                best_params, _, best_it = rb
                key, kb = jax.random.split(key)
                emit({"kind": "warn", "msg": "best_meta.json missing; "
                      "re-gating restored best/ params"})
                best_score = gate(best_params, best_it, kb)
                with open(meta_path, "w") as f:  # repair the layout
                    json.dump({"a_score": best_score,
                               "iteration": best_it}, f)
            # the RNG stream restarts from the checkpointed iteration's
            # fold; exact bitwise continuation of the original stream is
            # not preserved (the env states are fresh), which is fine —
            # resume is a recovery path, not a determinism path
            key = jax.random.fold_in(key, start_it)
            emit({"kind": "resume", "from_iteration": last_it,
                  "best_score": best_score, "best_iteration": best_it})
    t_start = time.perf_counter()
    for it in range(start_it, args.iterations + 1):
        t0 = time.perf_counter()
        key, k = jax.random.split(key)
        state, sample = run_selfplay(params, state, k)
        params, opt_state, metrics = run_train(params, opt_state, sample)
        loss = float(np.asarray(metrics["loss"]))  # forces the readback
        dt = time.perf_counter() - t0
        if it <= 3 or it % 10 == 0:
            emit(
                {
                    "kind": "train",
                    "iteration": it,
                    "loss": round(loss, 4),
                    "policy_loss": round(
                        float(np.asarray(metrics["policy_loss"])), 4
                    ),
                    "value_loss": round(
                        float(np.asarray(metrics["value_loss"])), 4
                    ),
                    "train_frames": int(
                        np.asarray(metrics["train_frames"])
                    ),
                    "target_entropy": round(
                        float(np.asarray(
                            metrics.get("target_entropy", 0.0)
                        )), 3
                    ),
                    "secs": round(dt, 2),
                    "moves_per_s": round(
                        args.batch * args.chunk_steps / dt
                    ),
                }
            )
        if it in gates:
            key, kg = jax.random.split(key)
            score = gate(params, it, kg)
            if score > best_score:
                best_score, best_params, best_it = score, params, it
                if args.checkpoint_dir:
                    serialization.save_training(
                        os.path.join(args.checkpoint_dir, "best"),
                        params, opt_state, it,
                    )
                    with open(os.path.join(args.checkpoint_dir,
                                           "best_meta.json"), "w") as f:
                        json.dump({"a_score": best_score,
                                   "iteration": best_it}, f)
            if args.checkpoint_dir:
                serialization.save_training(
                    args.checkpoint_dir, params, opt_state, it
                )

    # final gate: BEST params vs uniform-random moves
    emit({"kind": "best", "iteration": best_it, "a_score": best_score})
    key, kr = jax.random.split(key)
    t0 = time.perf_counter()
    tally = arena_match(
        best_params,
        best_params,  # B's tree-params = A's: random_b replaces B's MOVES
        kr,
        net_apply=net.apply,
        board_size=n,
        batch=args.arena_batch,
        num_simulations=args.arena_sims,
        random_b=True,
        search=args.arena_search,
    )
    tally = {k: float(np.asarray(v)) for k, v in tally.items()}
    emit(
        {
            "kind": "gate_vs_random",
            "iteration": best_it,
            "a_score": tally["a_score"],
            "a_wins": tally["a_wins"],
            "b_wins": tally["b_wins"],
            "draws": tally["draws"],
            "games": tally["games"],
            "secs": round(time.perf_counter() - t0, 1),
        }
    )
    emit(
        {
            "kind": "done",
            "total_secs": round(time.perf_counter() - t_start, 1),
        }
    )
    if logf:
        logf.close()


if __name__ == "__main__":
    main()
