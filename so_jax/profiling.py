"""Tracing / profiling — the counterpart of the reference's timers.

The reference's only instrumentation is a getrusage user-time delta around
kdSO (kdTime, kd2.c:46-59; so.c:539-541) and a bOutDiag flag hardwired off
(so.c:453). Here (SURVEY.md section 5):
  - PhaseTimer: named wall-clock phases with solves/sec style rates,
    reported to stderr under --verbose;
  - profile_trace: a jax.profiler trace context (--profile <dir>) capturing
    device timelines for xprof/tensorboard.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field


@dataclass
class PhaseTimer:
    phases: dict = field(default_factory=dict)
    _order: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if name not in self._order:
                self._order.append(name)

    def report(self, out=sys.stderr, items: dict | None = None) -> None:
        total = sum(self.phases.values())
        out.write("so_jax phase timings:\n")
        for name in self._order:
            dt = self.phases[name]
            rate = ""
            if items and name in items and dt > 0:
                rate = f"  ({items[name] / dt:,.0f}/s)"
            out.write(f"  {name:<24s} {dt:8.3f}s{rate}\n")
        out.write(f"  {'total':<24s} {total:8.3f}s\n")


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """jax.profiler trace when a log dir is given; no-op otherwise."""
    if not logdir:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield
