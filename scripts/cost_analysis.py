#!/usr/bin/env python
"""Dump XLA cost analysis of the headline rollout step (default backend).

Reports bytes-accessed / flops per lockstep step and the largest
intermediates, to direct optimisation at the real bottleneck.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp


def main():
    from twixt_for_open_spiel_tpu.ops.rollout import (
        batch_reset,
        sample_legal_action,
        step_auto_reset,
    )

    n, batch = 12, 4096
    state = batch_reset(n, batch)
    key = jax.random.PRNGKey(0)

    def one_step(state, key):
        actions = sample_legal_action(state, key, n)
        nxt, done, result = step_auto_reset(state, actions, n)
        return nxt, done

    lowered = jax.jit(one_step).lower(state, key)
    compiled = lowered.compile()
    ca = compiled.cost_analysis()
    keys = [
        "bytes accessed",
        "bytes accessed0{}",
        "bytes accessed1{}",
        "bytes accessedout{}",
        "flops",
        "transcendentals",
        "utilization operand 0 {}",
    ]
    for k in sorted(ca):
        v = ca[k]
        if isinstance(v, float) and v > 1e4:
            print(f"{k:40s} {v:,.0f}")
    print()
    print("full step (sample+step+reset):")
    print(f"  bytes accessed : {ca.get('bytes accessed', 0)/1e6:.1f} MB")
    print(f"  flops          : {ca.get('flops', 0)/1e6:.1f} Mflop")

    # per-op table from the optimized HLO: count + total bytes by opcode
    mod = compiled.as_text()
    import collections
    import re

    sizes = collections.Counter()
    counts = collections.Counter()
    for m in re.finditer(r"= ((?:[a-z0-9_]+)\[[0-9,]*\][^ ]*) ([a-z-]+)\(", mod):
        shape, op = m.groups()
        dims = re.search(r"\[([0-9,]*)\]", shape)
        numel = 1
        if dims and dims.group(1):
            for d in dims.group(1).split(","):
                numel *= int(d)
        dt = shape.split("[")[0]
        bytes_per = {
            "s8": 1, "u8": 1, "pred": 1, "s16": 2, "u16": 2,
            "s32": 4, "u32": 4, "f32": 4, "bf16": 2,
        }.get(dt, 4)
        sizes[op] += numel * bytes_per
        counts[op] += 1
    print("\nop outputs by opcode (count, MB):")
    for op, sz in sizes.most_common(20):
        print(f"  {op:20s} {counts[op]:5d}  {sz/1e6:9.2f} MB")

    # fusion count = number of launched kernels (roughly)
    nfusions = mod.count(" fusion(")
    print(f"\nfusions in module: {nfusions}")


if __name__ == "__main__":
    main()
