"""Checkpoint / resume (SURVEY.md §5).

Two complementary mechanisms, mirroring the reference's implicit capability:

  * **History replay** — any game state is reconstructible from its action
    sequence (the reference's ``History()`` replay, playthrough.txt:674).
    This is the canonical, version-stable restore path for game states.
  * **Pytree snapshots** — env-state pytrees and training state
    (params/opt_state) saved as one numpy ``.npz`` file of their leaves,
    keyed by tree path, so a snapshot needs nothing but numpy to load.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import jax
import numpy as np

from twixt_for_open_spiel_tpu.game.openspiel import TwixTGame, TwixTState


# --- history replay (canonical game-state checkpointing)

def serialize_state(state: TwixTState) -> str:
    """Action history, one action per line (OpenSpiel's wire format)."""
    return "\n".join(str(a) for a in state.history)


def deserialize_state(game: TwixTGame, data: str) -> TwixTState:
    state = game.new_initial_state()
    for line in filter(None, data.split("\n")):
        state.apply_action(int(line))
    return state


# --- pytree snapshots

def _keyed_leaves(tree):
    pairs, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): x for p, x in pairs}, treedef


def save_pytree(path: str, tree) -> None:
    """Write ``tree``'s leaves to the ``.npz`` file ``path``, atomically."""
    leaves, _ = _keyed_leaves(tree)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{k: np.asarray(x) for k, x in leaves.items()})
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_pytree(path: str, like):
    """Read a :func:`save_pytree` file into the structure of ``like``.

    Raises ``ValueError`` when the file's leaf paths or shapes differ from
    ``like``'s (a checkpoint of another net or optimizer)."""
    want, treedef = _keyed_leaves(like)
    with np.load(path, allow_pickle=False) as data:
        if set(data.files) != set(want):
            raise ValueError(
                f"{path}: leaf paths differ from the target tree "
                f"(missing {sorted(set(want) - set(data.files))}, "
                f"extra {sorted(set(data.files) - set(want))})"
            )
        leaves = [data[k] for k in want]
    for k, x in zip(want, leaves):
        if x.shape != np.shape(want[k]):
            raise ValueError(f"{path}: {k} has shape {x.shape}, "
                             f"expected {np.shape(want[k])}")
    return jax.tree_util.tree_unflatten(treedef, leaves)


# --- training checkpoints

def save_training(ckpt_dir: str, params, opt_state, iteration: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    save_pytree(os.path.join(ckpt_dir, "params.npz"), params)
    save_pytree(os.path.join(ckpt_dir, "opt_state.npz"), opt_state)
    with open(os.path.join(ckpt_dir, "iteration.txt"), "w") as f:
        f.write(str(iteration))


def restore_training(
    ckpt_dir: str, params_like, opt_state_like
) -> Optional[Tuple[object, object, int]]:
    marker = os.path.join(ckpt_dir, "iteration.txt")
    if not os.path.exists(marker):
        return None
    params = load_pytree(os.path.join(ckpt_dir, "params.npz"), params_like)
    opt_state = load_pytree(
        os.path.join(ckpt_dir, "opt_state.npz"), opt_state_like
    )
    with open(marker) as f:
        iteration = int(f.read().strip())
    return params, opt_state, iteration
