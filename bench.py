#!/usr/bin/env python
"""Benchmark: lockstep random-rollout env throughput on one GPU.

Rows, each one JSON line on stdout:
  * board 5,  batch 256   (config 2, minimal board)
  * board 8,  batch 4096  (the headline point)
  * board 12, batch 4096  (config 3)
  * board 24, batch 4096  (largest board)
  * board 24, batch 8192 with PER-STEP observation emission (config 4,
    the learner feed), two rows: the packed wire the self-play learner
    consumes ([T, B, 12*P] u32, bit-exact, models/selfplay.Sample) and the
    unpacked [T, B, 12, n, n-2] bf16 tensor.  Both are jit outputs, so the
    numbers include the full per-step emit+write cost.

All rows run the XLA bitboard engine (ops/bitboard.py), which is pinned
bit-exact against the canonical tensor engine (tests/test_bitboard.py).

Timing: every shape is compiled and run once before its window; a window
times ``launches`` back-to-back launches on the host clock and ends in
``jax.block_until_ready``.  Every row names the platform, device kind and
count, and the card's name and power limit from ``nvidia-smi``.

With no GPU the script exits 1, unless ``JAX_PLATFORMS=cpu`` is set
explicitly: that is a rehearsal at tiny sizes whose rows say ``cpu``.

``--trace DIR`` also traces a steady window of the board-8 and board-24
batch-4096 rollouts into DIR and prints each one's device idle share
(utils/profiling.device_idle_shares).

    python bench.py [--trace chiprun_out/trace]
"""

import argparse
import json
import math
import os
import time

import jax

from twixt_for_open_spiel_tpu.ops.bitboard import (
    bit_random_rollout,
    bit_reset,
    bit_rollout_emit_obs,
)
from twixt_for_open_spiel_tpu.utils import device, profiling
from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache

WINDOW_S = 2.0  # target length of a timed window on the GPU


def _launches(run, state, rehearsal):
    """Launch count that fills about WINDOW_S, from one timed launch."""
    if rehearsal:
        return 2
    t0 = time.perf_counter()
    jax.block_until_ready(run(1, state))
    return max(3, math.ceil(WINDOW_S / (time.perf_counter() - t0)))


def _window(run, state, launches):
    t0 = time.perf_counter()
    for i in range(launches):
        out = run(i + 2, state)
        state = out[0]
    jax.block_until_ready(out)
    return time.perf_counter() - t0, out


def rollout_fn(board_size, steps, obs=None):
    """jitted (seed, state) -> rollout outputs, state first."""
    if obs is None:
        return jax.jit(
            lambda seed, st: bit_random_rollout(seed, board_size, steps, st)
        )
    return jax.jit(lambda seed, st: bit_rollout_emit_obs(
        seed, board_size, steps, st, packed=(obs == "packed-u32")))


def bench_row(board_size, batch, steps, rehearsal, obs=None):
    run = rollout_fn(board_size, steps, obs)
    state = bit_reset(board_size, batch)
    t0 = time.perf_counter()
    jax.block_until_ready(run(0, state))  # compile + warm up
    compile_s = time.perf_counter() - t0
    launches = _launches(run, state, rehearsal)
    dt, out = _window(run, state, launches)
    return {
        "row": "rollout" if obs is None else "rollout_obs",
        "board": board_size,
        "batch": batch,
        "obs": obs or "none",
        "steps_per_launch": steps,
        "launches": launches,
        "window_s": dt,
        "env_steps_per_s": batch * steps * launches / dt,
        "first_call_s": compile_s,
        "episodes_last_launch": int(out[1]["episodes"]),
    }


def trace_row(board_size, batch, steps, trace_dir, launches=5):
    """Device idle share over a steady traced window (no compiles in it).

    A few launches only: every loop iteration leaves dozens of events."""
    run = rollout_fn(board_size, steps)
    state = bit_reset(board_size, batch)
    jax.block_until_ready(run(0, state))
    log_dir = os.path.join(trace_dir, f"board{board_size}_b{batch}")
    with profiling.trace(log_dir):
        with profiling.annotate("bench_window"):
            dt, _ = _window(run, state, launches)
    return {
        "row": "idle",
        "board": board_size,
        "batch": batch,
        "steps_per_launch": steps,
        "launches": launches,
        "window_s_traced": dt,
        "idle_share": profiling.device_idle_shares(log_dir, "bench_window"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None,
                    help="directory for the idle-share traces")
    args = ap.parse_args(argv)

    rehearsal = device.cpu_rehearsal()
    dev = device.describe() if rehearsal else device.require_gpu()
    tag = {
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "device_count": dev["count"],
        "gpu": "not measured (cpu rehearsal)" if rehearsal
        else "; ".join(device.nvidia_smi()),
        "cache_dir": enable_compile_cache(),
    }
    steps = 20 if rehearsal else 1000
    rows = [
        (5, 256, steps, None),
        (8, 4096, steps, None),
        (12, 4096, steps, None),
        (24, 4096, steps, None),
    ]
    if rehearsal:
        rows += [(24, 64, 4, "packed-u32"), (24, 64, 4, "bf16")]
    else:
        rows += [(24, 8192, 16, "packed-u32"), (24, 8192, 16, "bf16")]
    for board, batch, st, obs in rows:
        print(json.dumps({**bench_row(board, batch, st, rehearsal, obs),
                          **tag}), flush=True)
    if args.trace and not rehearsal:
        for board in (8, 24):
            print(json.dumps({**trace_row(board, 4096, steps, args.trace),
                              **tag}), flush=True)


if __name__ == "__main__":
    main()
