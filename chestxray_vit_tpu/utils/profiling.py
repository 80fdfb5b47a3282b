"""JAX profiler hooks (SURVEY §5: tracing/profiling as a first-class
subsystem — the reference has none)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional, Tuple

import jax


class StepProfiler:
    """Captures a profiler trace over a configured step window
    (cfg.train.profile_steps = (start, stop)); view with TensorBoard or
    Perfetto."""

    def __init__(self, output_dir: str,
                 profile_steps: Optional[Tuple[int, int]] = None):
        self.trace_dir = os.path.join(
            os.path.abspath(os.path.expanduser(output_dir)), "profile")
        self.window = tuple(profile_steps) if profile_steps else None
        self._active = False

    def in_window(self, step: int) -> bool:
        """True while a trace is (or should be) capturing this step."""
        return bool(self.window
                    and self.window[0] <= step <= self.window[1])

    def maybe_start(self, step: int) -> None:
        if (self.window and not self._active
                and step == self.window[0]):
            os.makedirs(self.trace_dir, exist_ok=True)
            jax.profiler.start_trace(self.trace_dir)
            self._active = True

    def maybe_stop(self, step: int) -> None:
        if self._active and (self.window is None or step >= self.window[1]):
            jax.profiler.stop_trace()
            self._active = False
            print(f"[profiling] trace written to {self.trace_dir}")

    def stop_if_active(self) -> None:
        if self._active:
            jax.profiler.stop_trace()
            self._active = False


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in profiler timelines."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def timed(label: str) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    print(f"[timing] {label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
