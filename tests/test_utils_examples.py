"""Serialization round-trips and example-runner smoke tests."""

import numpy as np
import pytest

from twixt_for_open_spiel_tpu.game import load_game
from twixt_for_open_spiel_tpu.utils import serialization


def test_history_replay_roundtrip():
    game = load_game("twixt")
    s = game.new_initial_state()
    for a in [14, 13, 33, 6, 26]:
        s.apply_action(a)
    data = serialization.serialize_state(s)
    s2 = serialization.deserialize_state(game, data)
    assert s2.history == s.history
    assert s2.to_string() == s.to_string()
    assert np.array_equal(
        s2.observation_tensor(0), s.observation_tensor(0)
    )


def test_pytree_snapshot_roundtrip(tmp_path):
    import jax

    from twixt_for_open_spiel_tpu.models import create_net, init_params

    net = create_net(5, channels=8, blocks=1)
    params = init_params(net, jax.random.PRNGKey(0))
    path = str(tmp_path / "params")
    serialization.save_pytree(path, params)
    restored = serialization.load_pytree(path, params)
    a = jax.tree_util.tree_leaves(params)
    b = jax.tree_util.tree_leaves(restored)
    assert all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def test_training_checkpoint_roundtrip(tmp_path):
    import jax

    from twixt_for_open_spiel_tpu.models import (
        create_net,
        init_params,
        make_optimizer,
    )

    net = create_net(5, channels=8, blocks=1)
    params = init_params(net, jax.random.PRNGKey(0))
    opt = make_optimizer(1e-3)
    opt_state = opt.init(params)
    d = str(tmp_path / "ckpt")
    assert serialization.restore_training(d, params, opt_state) is None
    serialization.save_training(d, params, opt_state, 7)
    restored = serialization.restore_training(d, params, opt_state)
    assert restored is not None
    _, _, it = restored
    assert it == 7


def test_example_runner(capsys):
    from twixt_for_open_spiel_tpu.examples import example

    example.main(["--game", "twixt(board_size=5)", "--seed", "1"])
    out = capsys.readouterr().out
    assert "Loaded game" in out
    assert "Utility for player 0" in out


def test_mcts_example_runner(capsys):
    from twixt_for_open_spiel_tpu.examples import mcts_example

    mcts_example.main(
        [
            "--game", "twixt(board_size=5)",
            "--player1", "mcts",
            "--player2", "random",
            "--max_simulations", "8",
            "--rollout_count", "1",
            "--seed", "3",
        ]
    )
    out = capsys.readouterr().out
    assert "Returns:" in out


def test_arena_example_runner(capsys):
    from twixt_for_open_spiel_tpu.examples import arena

    arena.main(
        [
            "--board_size=5",
            "--batch=4",
            "--simulations=4",
            "--channels=16",
            "--blocks=1",
            "--temp_moves=2",
            "--random_b",
        ]
    )
    out = capsys.readouterr().out
    assert "A score" in out


def test_npz_checkpoint_roundtrip_without_orbax(tmp_path, monkeypatch):
    """params, opt_state and a BitState round-trip through one .npz each,
    bit for bit, with orbax made unimportable."""
    import importlib
    import sys

    import jax

    from twixt_for_open_spiel_tpu.models import (
        create_net,
        init_params,
        make_optimizer,
    )
    from twixt_for_open_spiel_tpu.ops.bitboard import bit_random_rollout, bit_reset

    for name in ("orbax", "orbax.checkpoint"):
        monkeypatch.setitem(sys.modules, name, None)
    ser = importlib.reload(serialization)

    net = create_net(5, channels=8, blocks=1)
    params = init_params(net, jax.random.PRNGKey(0))
    opt = make_optimizer(1e-3)
    _, opt_state = opt.update(params, opt.init(params), params)  # count = 1
    bs, _ = bit_random_rollout(3, 6, 9, bit_reset(6, 5))
    for name, tree in (("params", params), ("opt", opt_state), ("bs", bs)):
        path = str(tmp_path / f"{name}.npz")
        ser.save_pytree(path, tree)
        like = jax.tree_util.tree_map(np.zeros_like, tree)
        back = ser.load_pytree(path, like)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(tree)
        for x, y in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(back)):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    with np.load(tmp_path / "params.npz") as data:  # keyed by tree path
        assert "['params']['Conv_0']['kernel']" in data.files
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "bs.npz", "opt.npz", "params.npz"]  # no temporary left behind


def test_load_pytree_rejects_another_tree(tmp_path):
    import jax

    from twixt_for_open_spiel_tpu.models import create_net, init_params

    path = str(tmp_path / "p.npz")
    serialization.save_pytree(
        path, init_params(create_net(5, channels=8, blocks=1),
                          jax.random.PRNGKey(0)))
    for other in (create_net(5, channels=16, blocks=1),
                  create_net(5, channels=8, blocks=2)):
        with pytest.raises(ValueError):
            serialization.load_pytree(
                path, init_params(other, jax.random.PRNGKey(0)))


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    import jax

    from twixt_for_open_spiel_tpu.utils import compile_cache

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert updates == []  # JAX took the directory from the variable


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import pathlib

    import jax

    from twixt_for_open_spiel_tpu.utils import compile_cache

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = pathlib.Path(__file__).resolve().parents[1]
    want = str(root / ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert compile_cache.enable_compile_cache() == want  # fixed, not per run
    assert updates == [("jax_compilation_cache_dir", want)] * 2
    ignored = (root / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_idle_share_of_intervals():
    from twixt_for_open_spiel_tpu.utils.profiling import idle_share

    # overlapping, nested, clipped at both ends, and outside the window
    busy = [(0, 30), (20, 40), (25, 35), (90, 130), (150, 160), (60, 70)]
    assert idle_share(busy, (10, 110)) == pytest.approx(1 - 60 / 100)
    assert idle_share([], (0, 10)) == 1.0
    assert idle_share([(0, 10)], (0, 10)) == 0.0
