"""twixt_for_open_spiel_tpu — a TwixT environment engine in JAX.

Brand-new implementation of the game semantics of the OpenSpiel TwixT C++
plugin (stevens68/TwixT_for_open_spiel), re-designed for accelerators: fixed-shape
integer tensor state, branch-free jit/vmap-compatible transitions, sharded
batched environments over device meshes, and an AlphaZero-style self-play
stack on top.  See SURVEY.md for the layer map and component inventory.
"""

from twixt_for_open_spiel_tpu.ops import geometry
from twixt_for_open_spiel_tpu.ops.state import State, reset
from twixt_for_open_spiel_tpu.ops.step import step, returns, is_terminal
from twixt_for_open_spiel_tpu.ops.observe import observation

__all__ = [
    "geometry",
    "State",
    "reset",
    "step",
    "returns",
    "is_terminal",
    "observation",
]

__version__ = "0.1.0"
