"""Profiling & metrics.

The reference instruments with editor-only Stopwatches + an FPS HUD
(Audio/AudioRayTracer.cs:58-59, _Editor/DebugDataDisplay.cs). Here the
equivalents are jax.profiler traces plus wall-clock step timing around
work that ends in ``jax.block_until_ready``."""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def step_timer(results: dict, key: str):
    """Wall-time a step into results[key] (end the block with
    jax.block_until_ready on the step's outputs)."""
    t0 = time.perf_counter()
    yield
    results[key] = results.get(key, 0.0) + (time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context (view with tensorboard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class ThroughputMeter:
    """Rolling rays/s meter (the DebugDataDisplay FPS average analog)."""

    def __init__(self, window: int = 20):
        self.window = window
        self._samples: list[tuple[float, float]] = []

    def record(self, rays: int, seconds: float):
        self._samples.append((rays, seconds))
        if len(self._samples) > self.window:
            self._samples.pop(0)

    @property
    def rays_per_s(self) -> float:
        if not self._samples:
            return 0.0
        rays = sum(r for r, _ in self._samples)
        secs = sum(s for _, s in self._samples)
        return rays / secs if secs else 0.0


def summarize_trace(log_dir: str, top: int = 20) -> list[tuple[str, float]]:
    """Aggregate device op durations from a jax.profiler trace.

    Parses the perfetto JSON (``*.trace.json.gz``) written under
    ``log_dir`` by ``device_trace`` and returns [(op_name, total_ms)]
    sorted descending — Pallas kernels appear as ``closed_call.*``,
    XLA fusions as ``fusion.*``.
    """
    import collections
    import glob
    import gzip
    import json

    paths = sorted(glob.glob(
        f"{log_dir}/plugins/profile/*/*.trace.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no trace.json.gz under {log_dir}")
    with gzip.open(paths[-1]) as f:
        events = json.load(f)["traceEvents"]
    # Device events carry the pid of the device track; find the pid
    # owning the longest total duration of complete ('X') events that
    # look like XLA ops (host tracks dominate raw counts, not XLA names).
    per_pid = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            name = e.get("name", "")
            if ("fusion" in name or "closed_call" in name
                    or name.startswith("jit")):
                per_pid[e.get("pid")] += e["dur"]
    if not per_pid:
        return []
    pid = per_pid.most_common(1)[0][0]
    tot = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and "dur" in e and e.get("pid") == pid:
            tot[e.get("name", "")] += e["dur"]
    return [(name, dur / 1000.0) for name, dur in tot.most_common(top)]
