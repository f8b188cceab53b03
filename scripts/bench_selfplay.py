#!/usr/bin/env python
"""Config-5 benchmark: AlphaZero-style self-play feeding a learner
(BASELINE.json:11) on whatever devices are visible.

On the one real chip this measures single-chip self-play + train throughput
(MCTS sims/s, env-steps/s, train frames/s); on a CPU host with
``--virtual=8`` it additionally measures scaling efficiency of the sharded
path (same shard_map code that runs on a multi-card/multi-host GPU mesh).

Not part of bench.py (which must stay fast for the driver); run manually:
    python scripts/bench_selfplay.py [--virtual=8]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

_VIRTUAL = None
for _a in sys.argv[1:]:
    if _a.startswith("--virtual="):
        _VIRTUAL = int(_a.split("=", 1)[1])
if _VIRTUAL:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={_VIRTUAL}"
    ).strip()

import jax
import numpy as np

if _VIRTUAL:
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.extend.backend.clear_backends()
    except Exception:
        pass

from twixt_for_open_spiel_tpu.models import (
    create_net,
    init_params,
    make_optimizer,
)
from twixt_for_open_spiel_tpu.parallel import (
    make_distributed_selfplay,
    make_distributed_train_step,
    make_env_mesh,
    sharded_bit_reset,
)


def _readback(out):
    leaves = jax.tree_util.tree_leaves(out)
    return np.asarray(leaves[-1]).ravel()[0]


def main():
    backend = jax.default_backend()
    devices = jax.devices()
    print(f"backend={backend} n_devices={len(devices)}", file=sys.stderr)

    n = 12
    on_gpu = backend == "gpu"
    batch = 512 if on_gpu else 32
    chunk = 16 if on_gpu else 4
    sims = 64 if on_gpu else 8
    channels, blocks = (64, 4) if on_gpu else (16, 1)
    if "--weak" in sys.argv:
        # WEAK scaling: constant per-device env batch, so the global batch
        # grows with the mesh and per-iteration time should stay ~flat
        batch = (batch if on_gpu else 8) * len(devices)

    mesh = make_env_mesh(devices)
    net = create_net(n, channels=channels, blocks=blocks)
    params = init_params(net, jax.random.PRNGKey(0))
    search = "puct"
    if "--gumbel" in sys.argv:
        search = "gumbel"
    if "--reuse" in sys.argv:
        search = "puct_reuse"
    selfplay, _ = make_distributed_selfplay(
        net.apply, n, num_steps=chunk, num_simulations=sims, mesh=mesh,
        search=search,
    )
    trainer, _ = make_distributed_train_step(
        net.apply, make_optimizer(1e-3), mesh
    )
    opt = make_optimizer(1e-3)
    opt_state = opt.init(params)

    state = sharded_bit_reset(n, batch, mesh)
    key = jax.random.PRNGKey(1)

    # Warm up / compile with the SAME dataflow as the timed loop: the
    # trainer's output params flow back into selfplay (their sharding/
    # commitment differs from freshly-initialised params, so warming up
    # only the first-iteration signature leaves a recompile inside the
    # timed region — measured as an 8x slowdown before this feedback).
    for i in range(2):
        state, sample = selfplay(
            params, state, jax.random.fold_in(key, 1000 + i)
        )
        params, opt_state, metrics = trainer(params, opt_state, sample)
    _readback(metrics)

    reps = 3
    t0 = time.perf_counter()
    for i in range(reps):
        state, sample = selfplay(params, state, jax.random.fold_in(key, i))
        params, opt_state, metrics = trainer(params, opt_state, sample)
    _readback(metrics)
    dt = (time.perf_counter() - t0) / reps

    env_steps = batch * chunk
    sims_total = batch * chunk * sims
    print(
        f"[selfplay n={n} batch={batch} chunk={chunk} sims={sims} "
        f"search={search} "
        f"net={channels}x{blocks}] {dt*1e3:.0f} ms/iter -> "
        f"{env_steps/dt:,.0f} env-moves/s, {sims_total/dt:,.0f} MCTS sims/s, "
        f"{env_steps/dt:,.0f} train frames/s",
        file=sys.stderr,
    )

    if len(devices) > 1 and "--weak" not in sys.argv:
        # scaling efficiency: same global work on 1 device
        mesh1 = make_env_mesh(devices[:1])
        sp1, _ = make_distributed_selfplay(
            net.apply, n, num_steps=chunk, num_simulations=sims, mesh=mesh1
        )
        tr1, _ = make_distributed_train_step(
            net.apply, make_optimizer(1e-3), mesh1
        )
        from jax.sharding import NamedSharding, PartitionSpec as P

        rep1 = NamedSharding(mesh1, P())
        params1 = jax.device_put(params, rep1)
        opt1 = jax.device_put(opt_state, rep1)
        st1 = sharded_bit_reset(n, batch, mesh1)
        st1, sm1 = sp1(params1, st1, key)
        p1, os1, m1 = tr1(params1, opt1, sm1)
        _readback(m1)
        t0 = time.perf_counter()
        for i in range(reps):
            st1, sm1 = sp1(params1, st1, jax.random.fold_in(key, i))
            p1, os1, m1 = tr1(params1, os1, sm1)
        _readback(m1)
        dt1 = (time.perf_counter() - t0) / reps
        eff = dt1 / (dt * len(devices))
        caveat = (
            "  [virtual CPU devices contend for the same cores — this"
            " validates the sharded code path, it does NOT measure real"
            " scaling; run on a real multi-chip mesh for that]"
            if backend == "cpu"
            else ""
        )
        print(
            f"[scaling] 1-dev {dt1*1e3:.0f} ms vs {len(devices)}-dev "
            f"{dt*1e3:.0f} ms -> parallel efficiency {eff:.2f}{caveat}",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
