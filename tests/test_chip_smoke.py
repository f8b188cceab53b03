"""chip_smoke.py's checks, run at tiny sizes on the CPU mesh.

On the card every check compares the GPU with the CPU; here two CPU devices
stand in for the pair, and four of the virtual CPU devices for the four
cards.  The device check itself must refuse CPU devices.
"""

import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest

from twixt_for_open_spiel_tpu.ops import bitboard as bb
from twixt_for_open_spiel_tpu.utils import device as devinfo

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pair():
    devices = jax.devices("cpu")
    return devices[0], devices[1]


def test_device_check_refuses_cpu(smoke):
    with pytest.raises(SystemExit, match="no GPU"):
        devinfo.require_gpu(jax.devices())
    with pytest.raises(SystemExit, match="no GPU"):
        smoke.main([])


def test_result_line_format(smoke):
    line = smoke.result_line({"platform": "gpu", "kind": "NVIDIA H100",
                              "count": 1})
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100", "count": 1},
    }


@pytest.mark.parametrize("board", [5, 8])
def test_rollout_exact_and_canonical_replay(smoke, pair, board):
    out = smoke.check_rollout_exact(board, 16, 24, *pair)
    smoke.replay_canonical(board, 16, 24, pair[0], out)


def test_canonical_replay_catches_a_wrong_state(smoke, pair):
    out = smoke.check_rollout_exact(5, 8, 6, *pair)
    wrong = out[0]._replace(move_counter=out[0].move_counter + 1)
    with pytest.raises(AssertionError, match="move_counter"):
        smoke.replay_canonical(5, 8, 6, pair[0], (wrong, out[1]))


def test_wire_exact(smoke, pair):
    smoke.check_wire_exact(6, 16, 3, *pair)


def test_assert_trees_equal_reports_leaf(smoke):
    a = bb.bit_reset(5, 4)
    smoke.assert_trees_equal(a, a, "same")
    b = a._replace(result=a.result.at[2].set(1))
    with pytest.raises(AssertionError, match=r"result.*1 of 4"):
        smoke.assert_trees_equal(a, b, "state")


def test_net_tolerances(smoke, pair):
    smoke.check_net(6, 16, 1, 8, *pair)
    with pytest.raises(AssertionError, match="outside"):
        smoke.assert_close(np.array([1.0, 2.0]), np.array([1.0, 2.5]),
                           what="x", **smoke.NET_TOL["bf16"])


def test_search_matches_across_devices(smoke, pair):
    smoke.check_search(5, 4, 8, *pair)


def test_selfplay_train_and_resume(smoke, tmp_path):
    moves = smoke.check_selfplay_train(str(tmp_path), 5, 8, 2, 4, 8, 1)
    assert moves > 0


def test_four_card_train_step_matches_one_card(smoke):
    smoke.check_dist_train(jax.devices()[:4], 5, 2, 3, 4, 8, 1)


def test_four_card_sharded_rollout_matches_per_shard_runs(smoke):
    smoke.check_sharded_rollout(jax.devices()[:4], 5, 8, 16)


def test_update_distance_catches_a_wrong_combine(smoke):
    p0 = {"w": np.zeros(4), "b": np.ones(3)}
    good = {"w": np.array([0.1, -0.2, 0.3, 0.0]), "b": np.ones(3) + 0.5}
    near = {"w": good["w"] * 1.001, "b": good["b"]}
    assert smoke.update_distance(p0, near, good) < 1e-2
    four_x = {"w": good["w"] * 4, "b": good["b"]}  # a missing pmean
    with pytest.raises(AssertionError, match="relative L2"):
        smoke.update_distance(p0, four_x, good)
