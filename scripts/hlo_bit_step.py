#!/usr/bin/env python
"""Dump the optimized HLO of one bitboard rollout step (default backend):
fusion kernels sorted by output bytes, to find unfused compid passes."""

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from twixt_for_open_spiel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp

from twixt_for_open_spiel_tpu.ops import bitboard as bb

_U32 = jnp.uint32


def main():
    n, batch = 12, 4096
    bs = bb.bit_reset(n, batch)

    def one_step(bs, noise):
        actions = bb.sample_bits(bs, n, noise)
        nxt, done, _ = bb.bit_step_auto_reset(bs, actions, n)
        return nxt, done

    noise = jnp.zeros((batch,), _U32)
    compiled = jax.jit(one_step).lower(bs, noise).compile()
    ca = compiled.cost_analysis()
    print(
        f"cost: bytes accessed={ca.get('bytes accessed', 0)/1e6:.1f}MB "
        f"flops={ca.get('flops', 0)/1e6:.1f}M",
        file=sys.stderr,
    )
    txt = compiled.as_text()
    # list fusion computations with their root shapes
    fusions = re.findall(r"^\s*(%?[\w.\-]+) = (\S+) fusion\(.*", txt, re.M)
    print(f"{len(fusions)} fusion ops:")
    for name, shape in fusions:
        print(f"  {shape:60s} {name}")
    # non-fused heavyweight ops
    for kind in ("reduce", "concatenate", "transpose", "copy", "gather",
                 "scatter", "dynamic-slice", "dynamic-update-slice"):
        ops = re.findall(rf"^\s*%?[\w.\-]+ = (\S+) {kind}\(", txt, re.M)
        if ops:
            print(f"{kind}: {len(ops)} ops: {ops[:12]}")


if __name__ == "__main__":
    main()
