"""Tracing / profiling helpers (SURVEY.md §5: new framework aux subsystem).

``jax.profiler`` traces + simple steps/s counters for the benchmark harness
and the training driver, and the reduction of a trace to the device's idle
share over a named host span.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from typing import Optional

import jax


class Throughput:
    """Steps/s counter with jax.block_until_ready semantics."""

    def __init__(self):
        self.t0 = None
        self.steps = 0

    def start(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        return self

    def add(self, n: int):
        self.steps += n

    def rate(self, sync=None) -> float:
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else float("inf")


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a jax.profiler trace (TensorBoard format) when log_dir set."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline."""
    with jax.profiler.TraceAnnotation(name):
        yield


def idle_share(busy, window) -> float:
    """1 - (union of the ``(start, end)`` intervals in ``busy``, clipped to
    ``window``) / the window's length."""
    ws, we = window
    clipped = sorted(
        (max(s, ws), min(e, we)) for s, e in busy if e > ws and s < we
    )
    covered, cur_s, cur_e = 0, None, None
    for s, e in clipped:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    return 1.0 - covered / (we - ws)


def device_idle_shares(log_dir: str, window_name: str) -> dict:
    """Idle share of every GPU over the host span ``window_name``
    (a :func:`annotate` region) in the newest trace under ``log_dir``.

    A device is busy while any event runs on one of its stream lines
    (kernels and copies).  Returns ``{device plane name: idle share}``.
    """
    from jax.profiler import ProfileData

    paths = glob.glob(
        os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True
    )
    pd = ProfileData.from_file(max(paths, key=os.path.getmtime))
    windows = [
        (ev.start_ns, ev.start_ns + ev.duration_ns)
        for plane in pd.planes
        if plane.name.startswith("/host:")
        for line in plane.lines
        for ev in line.events
        if ev.name == window_name
    ]
    if len(windows) != 1:
        raise ValueError(f"{len(windows)} spans named {window_name!r}")
    shares = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        busy = [
            (ev.start_ns, ev.start_ns + ev.duration_ns)
            for line in plane.lines
            if line.name.startswith("Stream")
            for ev in line.events
        ]
        shares[plane.name] = idle_share(busy, windows[0])
    return shares
