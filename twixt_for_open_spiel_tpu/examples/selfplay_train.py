"""AlphaZero-style self-play training driver (BASELINE.json config 5).

Runs the sharded self-play -> sharded-learner loop over the full device
mesh: env batch sharded over every chip/host, gradients psum-ed across the
mesh, checkpoints via utils/serialization.

Usage (any mesh size, incl. the virtual 8-device CPU mesh):
    python -m twixt_for_open_spiel_tpu.examples.selfplay_train \
        --board_size=12 --batch=256 --chunk_steps=16 --simulations=64 \
        --iterations=10 --checkpoint_dir=checkpoints/twixt_az

Multi-host (N>=2): run the SAME command on every host, adding the cluster
spec (or export JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID):
    python -m twixt_for_open_spiel_tpu.examples.selfplay_train \
        --coordinator=10.0.0.1:8476 --num_processes=4 --process_id=$RANK \
        --board_size=12 --batch=8192 ...
``--batch`` is the GLOBAL env batch; the hosts-major env mesh shards it so
each host steps its local cards' shard and gradient psums do their big
combines over NVLink (parallel/mesh.py).
"""

from __future__ import annotations

import argparse
import time

import jax

from twixt_for_open_spiel_tpu.models import (
    create_net,
    init_params,
    make_optimizer,
)
from twixt_for_open_spiel_tpu.parallel import (
    initialize_distributed,
    make_distributed_selfplay,
    make_distributed_train_step,
    make_env_mesh,
    replicated,
    sharded_bit_reset,
)
from twixt_for_open_spiel_tpu.utils import serialization
from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache


def main(argv=None):
    """Train; returns one dict per iteration run (loss terms, frames/s)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--board_size", type=int, default=12)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chunk_steps", type=int, default=16)
    ap.add_argument("--simulations", type=int, default=64)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--temp_moves", type=int, default=10 ** 9,
                    help="opening plies with temperature sampling (puct search)")
    ap.add_argument("--search", choices=("puct", "puct_reuse", "gumbel"),
                    default="puct",
                    help="root search: AlphaZero PUCT+Dirichlet or Gumbel sequential halving")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (multi-host runs)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    args = ap.parse_args(argv)

    pidx, pcount = initialize_distributed(
        args.coordinator, args.num_processes, args.process_id
    )
    is_lead = pidx == 0

    n = args.board_size
    mesh = make_env_mesh()
    if is_lead:
        print(
            f"mesh: {mesh} ({mesh.devices.size} devices, {pcount} hosts)"
        )

    net = create_net(n, channels=args.channels, blocks=args.blocks)
    params = init_params(net, jax.random.PRNGKey(args.seed))
    opt = make_optimizer(args.lr)
    opt_state = opt.init(params)

    selfplay, _ = make_distributed_selfplay(
        net.apply, n, num_steps=args.chunk_steps,
        num_simulations=args.simulations, mesh=mesh,
        search=args.search, temp_moves=args.temp_moves,
    )
    trainer, _ = make_distributed_train_step(net.apply, opt, mesh)

    start_iter = 0
    if args.checkpoint_dir:
        restored = serialization.restore_training(
            args.checkpoint_dir, params, opt_state
        )
        if restored is not None:
            params, opt_state, start_iter = restored
            print(f"restored checkpoint at iteration {start_iter}")
    # placed as the train step returns them, so the second iteration does
    # not compile selfplay and trainer again for another input sharding
    params, opt_state = jax.device_put((params, opt_state), replicated(mesh))

    state = sharded_bit_reset(n, args.batch, mesh)
    key = jax.random.PRNGKey(args.seed + 1)
    history = []
    for it in range(start_iter, args.iterations):
        t0 = time.perf_counter()
        key, k = jax.random.split(key)
        state, sample = selfplay(params, state, k)
        params, opt_state, metrics = trainer(params, opt_state, sample)
        jax.block_until_ready(params)
        dt = time.perf_counter() - t0
        row = {name: float(metrics[name])
               for name in ("loss", "policy_loss", "value_loss",
                            "train_frames")}
        row.update(iteration=it, seconds=dt,
                   moves_per_s=args.batch * args.chunk_steps / dt)
        history.append(row)
        if is_lead:
            print(
                f"iter {it}: loss={row['loss']:.4f} "
                f"policy={row['policy_loss']:.4f} "
                f"value={row['value_loss']:.4f} "
                f"train_frames={int(row['train_frames'])} "
                f"({row['moves_per_s']:,.0f} mcts-env-steps/s)"
            )
        if args.checkpoint_dir and is_lead:
            serialization.save_training(
                args.checkpoint_dir, params, opt_state, it + 1
            )
    return history


if __name__ == "__main__":
    enable_compile_cache()
    main()
