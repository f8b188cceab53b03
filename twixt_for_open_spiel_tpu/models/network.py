"""AlphaZero-style policy/value network for TwixT observations.

The learner of the self-play stack (BASELINE.json config 5).  The reference
has no model at all (SURVEY.md §5, long-context note); this is new
framework surface, written in plain ``jax.numpy``/``lax``:

  * bfloat16 compute / float32 params: the convolutions and dense layers
    take bf16 operands, which puts them on the GPU's tensor cores (cuDNN
    and cuBLAS accumulate bf16 products in float32);
  * NHWC layout; the 12-plane CHW observation (ops/observe.py) is
    transposed once at the input; the policy head emits ``board_size**2``
    masked logits matching the engine's action space (corner/off-limit
    actions are masked by the caller using the state's legal mask).

Parameters are a plain nested dict ``{"params": {...}}`` whose layer names
(``Conv_0``, ``LayerNorm_0``, ``ResBlock_0`` ...) and initialisers (lecun
normal kernels, zero biases, unit LayerNorm scales, eps 1e-6) are the
ones the net had as a module of a layers library; tests/test_network.py
pins this net to that module's numbers on the same tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from twixt_for_open_spiel_tpu.ops import geometry as geo

LN_EPS = 1e-6
HEAD_CHANNELS = 32
VALUE_HIDDEN = 256

_lecun_normal = jax.nn.initializers.lecun_normal()


def _conv_init(key, kh, cin, cout):
    return {
        "kernel": _lecun_normal(key, (kh, kh, cin, cout), jnp.float32),
        "bias": jnp.zeros((cout,), jnp.float32),
    }


def _dense_init(key, din, dout, zero=False):
    kernel = (
        jnp.zeros((din, dout), jnp.float32)
        if zero
        else _lecun_normal(key, (din, dout), jnp.float32)
    )
    return {"kernel": kernel, "bias": jnp.zeros((dout,), jnp.float32)}


def _ln_init(c):
    return {"scale": jnp.ones((c,), jnp.float32),
            "bias": jnp.zeros((c,), jnp.float32)}


def _conv(p, x, dtype):
    y = lax.conv_general_dilated(
        x.astype(dtype),
        p["kernel"].astype(dtype),
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y + p["bias"].astype(dtype)


def _dense(p, x, dtype, precision=None):
    y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype),
                precision=precision)
    return y + p["bias"].astype(dtype)


def _layer_norm(p, x, dtype):
    """LayerNorm over the last axis with float32 statistics
    (var = E[x^2] - E[x]^2, clipped at 0)."""
    xf = x.astype(jnp.float32)
    mean = xf.mean(-1, keepdims=True)
    var = jnp.maximum(0.0, (xf * xf).mean(-1, keepdims=True) - mean * mean)
    y = (xf - mean) * (lax.rsqrt(var + LN_EPS) * p["scale"]) + p["bias"]
    return y.astype(dtype)


@dataclasses.dataclass(frozen=True)
class AZNet:
    """Policy/value net over the [12, N, N-2] observation tensor."""

    board_size: int
    channels: int = 128
    blocks: int = 6
    dtype: Any = jnp.bfloat16

    def init(self, key) -> dict:
        n, c = self.board_size, self.channels
        flat = HEAD_CHANNELS * n * (n - 2)
        keys = iter(jax.random.split(key, 2 * self.blocks + 5))
        p = {"Conv_0": _conv_init(next(keys), 3, geo.NUM_PLANES, c),
             "LayerNorm_0": _ln_init(c)}
        for i in range(self.blocks):
            p[f"ResBlock_{i}"] = {
                "Conv_0": _conv_init(next(keys), 3, c, c),
                "LayerNorm_0": _ln_init(c),
                "Conv_1": _conv_init(next(keys), 3, c, c),
                "LayerNorm_1": _ln_init(c),
            }
        p["Conv_1"] = _conv_init(next(keys), 1, c, HEAD_CHANNELS)
        p["LayerNorm_1"] = _ln_init(HEAD_CHANNELS)
        p["Dense_0"] = _dense_init(next(keys), flat, n * n)
        p["Conv_2"] = _conv_init(next(keys), 1, c, HEAD_CHANNELS)
        p["LayerNorm_2"] = _ln_init(HEAD_CHANNELS)
        p["Dense_1"] = _dense_init(next(keys), flat, VALUE_HIDDEN)
        p["LayerNorm_3"] = _ln_init(VALUE_HIDDEN)
        # ZERO-initialised value output: see apply()
        p["Dense_2"] = _dense_init(None, VALUE_HIDDEN, 1, zero=True)
        return {"params": p}

    def apply(self, params, obs) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """obs [B, 12, N, N-2] -> (logits [B, N*N] f32, value [B] f32)."""
        p, dt = params["params"], self.dtype
        x = jnp.transpose(obs, (0, 2, 3, 1)).astype(dt)
        x = jax.nn.relu(_layer_norm(p["LayerNorm_0"],
                                    _conv(p["Conv_0"], x, dt), dt))
        for i in range(self.blocks):
            b = p[f"ResBlock_{i}"]
            y = _conv(b["Conv_0"], x, dt)
            y = jax.nn.relu(_layer_norm(b["LayerNorm_0"], y, dt))
            y = _layer_norm(b["LayerNorm_1"], _conv(b["Conv_1"], y, dt), dt)
            x = jax.nn.relu(x + y)

        # policy head: action space is board_size**2 (incl. never-legal
        # corners, reference twixt.h:122-124); caller masks illegal logits.
        h = _conv(p["Conv_1"], x, dt)
        h = jax.nn.relu(_layer_norm(p["LayerNorm_1"], h, dt))
        logits = _dense(p["Dense_0"], h.reshape((h.shape[0], -1)), dt)

        # value head.  The final layers run in f32 with a LayerNorm and a
        # ZERO-initialised output kernel: outcome targets are almost always
        # +-1, and without this the bf16 tanh saturates early in training
        # (|pre-activation| > 8 makes 1 - tanh^2 EXACTLY 0 in bf16), after
        # which the head is frozen at a constant +-1 forever.  Zero-init
        # starts the output at tanh's maximum-gradient point and the norm
        # bounds the feature scale the kernel multiplies.  The f32 output
        # layer asks for full f32 precision so it never runs in TF32.
        v = _conv(p["Conv_2"], x, dt)
        v = jax.nn.relu(_layer_norm(p["LayerNorm_2"], v, dt))
        v = jax.nn.relu(_dense(p["Dense_1"], v.reshape((v.shape[0], -1)), dt))
        v = _layer_norm(p["LayerNorm_3"], v, jnp.float32)
        value = jnp.tanh(_dense(p["Dense_2"], v, jnp.float32,
                                precision=lax.Precision.HIGHEST))[:, 0]
        return logits.astype(jnp.float32), value


def create_net(board_size: int, channels: int = 128, blocks: int = 6,
               dtype=jnp.bfloat16):
    """``dtype`` sets the compute dtype (params stay f32).  bf16 is the
    production setting (tensor cores); f32 exists for numerical pins that
    need reduction-shape-independent results (tests/test_sharding.py)."""
    return AZNet(board_size=board_size, channels=channels, blocks=blocks,
                 dtype=dtype)


def init_params(net: AZNet, key):
    return net.init(key)


def masked_policy(logits: jnp.ndarray, legal_mask: jnp.ndarray):
    """Softmax over legal actions only; illegal actions get probability 0."""
    neg = jnp.asarray(-1e9, logits.dtype)
    masked = jnp.where(legal_mask, logits, neg)
    return jax.nn.softmax(masked, axis=-1)
