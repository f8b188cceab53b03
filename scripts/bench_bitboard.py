#!/usr/bin/env python
"""Compare bitboard vs canonical rollout throughput on the real chip."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import numpy as np


def readback(out):
    return np.asarray(jax.tree_util.tree_leaves(out)[-1]).ravel()[0]


def timeit(fn, *args, reps=3):
    out = fn(*args)
    readback(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    readback(out)
    return (time.perf_counter() - t0) / reps


def main():
    from twixt_for_open_spiel_tpu.ops.bitboard import (
        bit_random_rollout,
        bit_reset,
    )
    from twixt_for_open_spiel_tpu.ops.rollout import batch_reset, random_rollout

    print(f"backend={jax.default_backend()}", file=sys.stderr)
    steps = 1000
    for n, batch in ((12, 4096), (12, 8192), (8, 4096), (24, 8192)):
        bs = bit_reset(n, batch)
        dt = timeit(lambda b=bs: bit_random_rollout(12345, n, steps, b))
        print(f"bit  n={n:2d} b={batch:5d}: {batch*steps/dt:12,.0f} env-steps/s ({dt:.3f}s)")
    for n, batch in ((12, 4096),):
        st = batch_reset(n, batch)
        key = jax.random.PRNGKey(0)
        dt = timeit(lambda s=st: random_rollout(key, n, steps, s))
        print(f"xla  n={n:2d} b={batch:5d}: {batch*steps/dt:12,.0f} env-steps/s ({dt:.3f}s)")


if __name__ == "__main__":
    main()
