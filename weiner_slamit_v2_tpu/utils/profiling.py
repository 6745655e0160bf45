"""Tracing & per-stage timing.

The reference's only observability is logcat prints and an on-screen
per-frame wall time (SURVEY.md §5); here: lightweight per-stage timers plus
hooks into ``jax.profiler`` for real device traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulates wall time per named stage; blocks on device results so
    the numbers are real compute, not dispatch."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1000.0 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        lines = [f"{'stage':30s} {'count':>6s} {'mean ms':>10s} {'total s':>9s}"]
        for k, v in self.summary().items():
            lines.append(
                f"{k:30s} {v['count']:6d} {v['mean_ms']:10.3f} {v['total_s']:9.3f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (viewable in TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_busy(log_dir: str) -> dict[str, dict]:
    """Per GPU plane of the newest trace under `log_dir`: busy time (union
    of the kernel intervals on its stream lines), the span from the first
    kernel start to the last kernel end, and the kernel count."""
    import glob
    import os

    paths = glob.glob(
        os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True
    )
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        spans = sorted(
            (e.start_ns, e.start_ns + e.duration_ns)
            for line in plane.lines
            if line.name.startswith("Stream")
            for e in line.events
        )
        if not spans:
            raise ValueError(
                f"no kernels on the stream lines of {plane.name}: "
                f"{[line.name for line in plane.lines]}"
            )
        busy, end = 0.0, float("-inf")
        for s, e in spans:
            if e > end:
                busy += e - max(s, end)
                end = e
        out[plane.name] = {
            "busy_ns": busy,
            "span_ns": end - spans[0][0],
            "n_kernels": len(spans),
        }
    return out
