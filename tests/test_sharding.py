"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4, multi-node note): the same shard_map code path used on a
real multi-card/multi-host GPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np

from twixt_for_open_spiel_tpu.ops import geometry as geo
from twixt_for_open_spiel_tpu.ops.rollout import batch_reset, random_rollout
from twixt_for_open_spiel_tpu.parallel import (
    ENV_AXIS,
    make_env_mesh,
    make_sharded_rollout,
    sharded_batch_reset,
    sharded_bit_reset,
    make_distributed_selfplay,
    make_distributed_train_step,
)
from twixt_for_open_spiel_tpu.models import (
    create_net,
    init_params,
    make_optimizer,
)


def test_mesh_has_8_devices():
    mesh = make_env_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == (ENV_AXIS,)


def test_hosts_major_order_mocked_pod():
    """Unit-test the multi-host env-mesh layout logic without a cluster:
    the device order must be hosts-major (contiguous per-host blocks, hosts
    in process order, cards in id order) so env-axis collectives do their
    big combines inside a host and only per-host partials cross hosts."""
    from twixt_for_open_spiel_tpu.parallel import hosts_major_order

    class Dev:
        def __init__(self, pid, did):
            self.process_index, self.id = pid, did

        def __repr__(self):
            return f"d{self.process_index}.{self.id}"

    # scrambled 4-host x 4-card cluster: global ids interleaved across hosts
    devs = [Dev(did % 4, did) for did in range(16)]
    ordered = hosts_major_order(devs)
    assert [d.process_index for d in ordered] == sorted(
        d.process_index for d in devs
    )
    for host in range(4):
        block = [d for d in ordered if d.process_index == host]
        assert [d.id for d in block] == sorted(d.id for d in block)
        lo = ordered.index(block[0])
        assert ordered[lo : lo + 4] == block  # contiguous


def test_initialize_distributed_single_process_noop():
    from twixt_for_open_spiel_tpu.parallel import initialize_distributed

    pidx, pcount = initialize_distributed()
    assert (pidx, pcount) == (jax.process_index(), jax.process_count())
    assert pcount >= 1


def test_sharded_rollout_runs_and_reduces():
    n, b, steps = 5, 64, 32
    rollout, mesh = make_sharded_rollout(n, steps)
    state = sharded_batch_reset(n, b, mesh)
    final, stats = rollout(jax.random.PRNGKey(0), state)
    assert final.color.shape == (n + 6, n + 6, b)
    episodes = int(stats["episodes"])
    results = np.asarray(stats["results"])
    assert episodes > 0
    assert results[geo.RESULT_OPEN] == 0
    assert results.sum() == episodes
    # state stays sharded over the env axis
    shard_sizes = {s.data.shape[-1] for s in final.color.addressable_shards}
    assert shard_sizes == {b // 8}


def test_sharded_selfplay_feeds_sharded_learner():
    n, b, t = 5, 16, 6
    net = create_net(n, channels=16, blocks=1)
    params = init_params(net, jax.random.PRNGKey(0))
    selfplay, mesh = make_distributed_selfplay(
        net.apply, n, num_steps=t, num_simulations=4
    )
    trainer, _ = make_distributed_train_step(
        net.apply, make_optimizer(1e-3), mesh
    )
    state = sharded_bit_reset(n, b, mesh)
    state, sample = selfplay(params, state, jax.random.PRNGKey(1))
    assert sample.obs.shape == (t, b, geo.NUM_PLANES * (n + 2 * geo.PAD))
    # sample batch axis sharded over mesh
    shard_sizes = {s.data.shape[1] for s in sample.obs.addressable_shards}
    assert shard_sizes == {b // 8}
    opt = make_optimizer(1e-3)
    opt_state = opt.init(params)
    p2, opt_state, metrics = trainer(params, opt_state, sample)
    assert np.isfinite(float(metrics["loss"]))


def test_dist_train_step_matches_local():
    """The distributed train step must compute the EXACT global gradient:
    same params/opt-state/sample => same new params and metrics as the
    single-device ``train_step`` (up to float reduction order).

    The sample's finished-frame weights are deliberately made ASYMMETRIC
    across shards (half the envs zeroed) — the configuration where a naive
    per-shard-normalised pmean diverges from the global objective (the
    value term would weight a nearly-empty shard like a full one)."""
    from twixt_for_open_spiel_tpu.models import selfplay_chunk, train_step
    from twixt_for_open_spiel_tpu.ops.bitboard import bit_reset

    n, b, t = 5, 16, 6
    # f32 compute: bf16's reduction-shape sensitivity (local t*b batch vs
    # per-shard t*b/8) adds ~1e-3 relative noise that would force a
    # tolerance loose enough to mask real combine bugs
    net = create_net(n, channels=16, blocks=1, dtype=jnp.float32)
    params = init_params(net, jax.random.PRNGKey(0))
    _, sample = selfplay_chunk(
        params,
        bit_reset(n, b),
        jax.random.PRNGKey(1),
        net_apply=net.apply,
        board_size=n,
        num_steps=t,
        num_simulations=4,
    )
    w = np.asarray(sample.weight).copy()
    w[:, : b // 2] = 0.0  # shards 0-3 contribute no finished frames
    sample = sample._replace(weight=jnp.asarray(w))
    assert w.sum() > 0  # the asymmetry must leave live value frames

    # plain SGD so the param delta IS the gradient: adam's step-1 update
    # is ~lr*sign(g), which amplifies a reduction-order sign flip of a
    # near-zero gradient into a 2*lr mismatch (observed) — the pin's
    # subject is the gradient combine, not adam's conditioning
    import optax

    opt = optax.sgd(0.1)
    opt_state = opt.init(params)
    p_loc, _, m_loc = train_step(
        params, opt_state, sample, net_apply=net.apply, optimizer=opt
    )
    # microbatch=1 is the plain shard combine; microbatch=3 additionally
    # splits each shard's chunk into time-slices, so the surrogate
    # denominator must telescope through BOTH the slice mean and the
    # shard pmean (the board-24 memory-valve configuration)
    for microbatch in (1, 3):
        trainer, _ = make_distributed_train_step(
            net.apply, opt, microbatch=microbatch
        )
        p_dist, _, m_dist = trainer(params, opt_state, sample)

        for a, b_ in zip(
            jax.tree_util.tree_leaves(p_loc),
            jax.tree_util.tree_leaves(p_dist),
        ):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b_), rtol=2e-5, atol=1e-6,
                err_msg=f"microbatch={microbatch}",
            )
        for k in ("loss", "policy_loss", "value_loss", "train_frames"):
            np.testing.assert_allclose(
                float(m_loc[k]), float(m_dist[k]), rtol=2e-5,
                err_msg=f"microbatch={microbatch}",
            )


def test_dist_training_improves_gate():
    """The sharded selfplay -> sharded learner loop must LEARN, not just
    return finite losses: ~24 iterations at board 5 on the 8-device CPU
    mesh and the trained params beat their init in a 32-game arena.
    (Calibrated: seed 0 reaches ~0.75 by iteration 20; bar set at 0.6.)"""
    from twixt_for_open_spiel_tpu.models import arena_match

    n, batch, t, sims = 5, 32, 8, 8
    net = create_net(n, channels=16, blocks=1)
    params0 = init_params(net, jax.random.PRNGKey(0))
    params = params0
    opt = make_optimizer(1e-3)
    opt_state = opt.init(params)
    selfplay, mesh = make_distributed_selfplay(
        net.apply, n, num_steps=t, num_simulations=sims
    )
    trainer, _ = make_distributed_train_step(net.apply, opt, mesh)
    state = sharded_bit_reset(n, batch, mesh)
    key = jax.random.PRNGKey(1)
    for _ in range(24):
        key, k = jax.random.split(key)
        state, sample = selfplay(params, state, k)
        params, opt_state, _ = trainer(params, opt_state, sample)
    tally = arena_match(
        params,
        params0,
        jax.random.PRNGKey(123),
        net_apply=net.apply,
        board_size=n,
        batch=32,
        num_simulations=sims,
    )
    assert float(tally["a_score"]) >= 0.6, float(tally["a_score"])


def test_sharded_rollout_matches_unsharded_episode_accounting():
    # same seed, same global batch: sharded and single-device rollouts use
    # different RNG fan-out, so only invariants (not trajectories) compare
    n, b, steps = 5, 32, 48
    rollout, mesh = make_sharded_rollout(n, steps)
    state = sharded_batch_reset(n, b, mesh)
    _, stats_sharded = rollout(jax.random.PRNGKey(5), state)
    _, stats_local = random_rollout(
        jax.random.PRNGKey(5), n, steps, batch_reset(n, b)
    )
    for stats in (stats_sharded, stats_local):
        r = np.asarray(stats["results"])
        assert r[geo.RESULT_OPEN] == 0
        assert int(stats["episodes"]) == r.sum()


def test_sharded_bit_rollout_runs_and_reduces():
    from twixt_for_open_spiel_tpu.parallel import (
        make_sharded_bit_rollout,
        sharded_bit_reset,
    )

    n, b, steps = 5, 64, 32
    rollout, mesh = make_sharded_bit_rollout(n, steps)
    state = sharded_bit_reset(n, b, mesh)
    final, stats = rollout(7, state)
    episodes = int(stats["episodes"])
    results = np.asarray(stats["results"])
    assert episodes > 0
    assert results[geo.RESULT_OPEN] == 0
    assert results.sum() == episodes
    # bitplane state stays sharded over the env axis
    shard_sizes = {s.data.shape[-1] for s in final.red.addressable_shards}
    assert shard_sizes == {b // 8}
    # per-shard RNG streams must differ: shards can't all have identical
    # episode outcomes by coincidence at 8 shards x 8 envs
    reds = {
        np.asarray(s.data).tobytes() for s in final.red.addressable_shards
    }
    assert len(reds) > 1
