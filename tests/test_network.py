"""The plain-JAX AZNet against the flax module it replaces.

The flax definition below is the net as it was written with ``flax.linen``;
the plain version must apply the same parameter tree to the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from twixt_for_open_spiel_tpu.models import create_net, init_params
from twixt_for_open_spiel_tpu.ops import geometry as geo


def _flax_aznet(board_size, channels, blocks, dtype):
    nn = pytest.importorskip("flax.linen")

    class ResBlock(nn.Module):
        channels: int
        dtype: object

        @nn.compact
        def __call__(self, x):
            y = nn.Conv(self.channels, (3, 3), padding="SAME",
                        dtype=self.dtype)(x)
            y = nn.relu(nn.LayerNorm(dtype=self.dtype)(y))
            y = nn.Conv(self.channels, (3, 3), padding="SAME",
                        dtype=self.dtype)(y)
            y = nn.LayerNorm(dtype=self.dtype)(y)
            return nn.relu(x + y)

    class AZNet(nn.Module):
        @nn.compact
        def __call__(self, obs):
            x = jnp.transpose(obs, (0, 2, 3, 1)).astype(dtype)
            x = nn.Conv(channels, (3, 3), padding="SAME", dtype=dtype)(x)
            x = nn.relu(nn.LayerNorm(dtype=dtype)(x))
            for _ in range(blocks):
                x = ResBlock(channels, dtype)(x)
            p = nn.Conv(32, (1, 1), dtype=dtype)(x)
            p = nn.relu(nn.LayerNorm(dtype=dtype)(p))
            p = p.reshape((p.shape[0], -1))
            logits = nn.Dense(board_size * board_size, dtype=dtype)(p)
            v = nn.Conv(32, (1, 1), dtype=dtype)(x)
            v = nn.relu(nn.LayerNorm(dtype=dtype)(v))
            v = v.reshape((v.shape[0], -1))
            v = nn.relu(nn.Dense(256, dtype=dtype)(v))
            v = nn.LayerNorm(dtype=jnp.float32)(v.astype(jnp.float32))
            value = jnp.tanh(nn.Dense(
                1, dtype=jnp.float32, kernel_init=nn.initializers.zeros
            )(v))[:, 0]
            return logits.astype(jnp.float32), value.astype(jnp.float32)

    return AZNet()


def _obs(key, batch, n):
    return jax.random.bernoulli(
        key, 0.3, (batch, geo.NUM_PLANES, n, n - 2)
    ).astype(jnp.float32)


def _randomised(params, key):
    """Every leaf perturbed, so zero-initialised leaves are exercised too."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(tree, [
        x + 0.1 * jax.random.normal(k, x.shape, x.dtype)
        for x, k in zip(leaves, keys)
    ])


@pytest.mark.parametrize("n", [5, 12, 24])
def test_matches_flax_float32(n):
    net = create_net(n, channels=16, blocks=2, dtype=jnp.float32)
    ref = _flax_aznet(n, 16, 2, jnp.float32)
    params = _randomised(init_params(net, jax.random.PRNGKey(n)),
                         jax.random.PRNGKey(100 + n))
    obs = _obs(jax.random.PRNGKey(1), 3, n)
    logits, value = jax.jit(net.apply)(params, obs)
    ref_logits, ref_value = jax.jit(ref.apply)(params, obs)
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value, ref_value, rtol=1e-5, atol=1e-6)


def test_gradient_matches_flax_float32():
    n = 8
    net = create_net(n, channels=16, blocks=1, dtype=jnp.float32)
    ref = _flax_aznet(n, 16, 1, jnp.float32)
    params = _randomised(init_params(net, jax.random.PRNGKey(0)),
                         jax.random.PRNGKey(1))
    obs = _obs(jax.random.PRNGKey(2), 4, n)
    target = jnp.asarray([1.0, -1.0, 1.0, -1.0])

    def loss(apply):
        def f(p):
            logits, value = apply(p, obs)
            return (jax.nn.logsumexp(logits, -1).mean()
                    + jnp.mean((value - target) ** 2))
        return jax.jit(jax.grad(f))

    g = loss(net.apply)(params)
    g_ref = loss(ref.apply)(params)
    assert jax.tree_util.tree_structure(g) == jax.tree_util.tree_structure(
        g_ref)
    for a, b in zip(jax.tree_util.tree_leaves(g),
                    jax.tree_util.tree_leaves(g_ref)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_init_contract():
    """Value exactly 0 at init, flax's tree and parameter count, and
    flax's initialisers: zero biases, unit LayerNorm scales, zero value
    output kernel."""
    n, c, blocks = 12, 16, 2
    net = create_net(n, channels=c, blocks=blocks)
    params = init_params(net, jax.random.PRNGKey(3))
    _, value = net.apply(params, _obs(jax.random.PRNGKey(4), 5, n))
    assert np.all(np.asarray(value) == 0.0)

    ref = _flax_aznet(n, c, blocks, jnp.bfloat16)
    ref_params = ref.init(jax.random.PRNGKey(3), _obs(jax.random.PRNGKey(4),
                                                      1, n))
    shapes = jax.tree_util.tree_map(lambda x: (x.shape, x.dtype), params)
    ref_shapes = jax.tree_util.tree_map(lambda x: (x.shape, x.dtype),
                                        dict(ref_params))
    assert shapes == ref_shapes
    count = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert count == sum(x.size for x in jax.tree_util.tree_leaves(ref_params))

    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if name.endswith("['bias']"):
            assert np.all(x == 0), name
        elif name.endswith("['scale']"):
            assert np.all(x == 1), name
        elif "Dense_2" in name:
            assert np.all(x == 0), name
        else:  # lecun-normal: std sqrt(1/fan_in), truncated at 2 sigma
            fan_in = np.prod(x.shape[:-1])
            assert np.abs(x).max() <= 2.0 / np.sqrt(fan_in) * 1.2, name
            assert 0.5 < x.std() * np.sqrt(fan_in) < 1.5, name
