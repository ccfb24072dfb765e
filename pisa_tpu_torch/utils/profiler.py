"""
Host copy of ``pisa_tpu/utils/profiler.py`` with its imports rewritten to
``pisa_tpu_torch``.

Profiling decorators (cf. reference ``pisa/utils/profiler.py:51,104``):

- :func:`profile` — wall-time of each call, logged through the ``tprofile``
  logger.
- :func:`line_profile` — per-line cumulative time of each call, logged
  through ``tprofile``. The reference delegates to the ``line_profiler`` C
  extension; here a ``sys.settrace``-based pure-Python tracer keeps the
  dependency surface zero. Overhead is larger (fine for the debugging use
  case it serves) and, as in the reference, timings of traced lines are
  skewed by the tracing mechanism itself.

Both time the host: CUDA launches return before the card finishes, so a
wrapped function that launches kernels and reads no result logs their
enqueue. Device time belongs to ``torch.profiler``.
"""

from __future__ import annotations

import linecache
import sys
from functools import wraps
from time import perf_counter

from pisa_tpu_torch.utils.log import tprofile

__all__ = ["profile", "line_profile"]


def profile(func):
    """Decorator: log the wall-clock time of every call at tprofile DEBUG
    level (reference ``profiler.py:104``)."""

    @wraps(func)
    def profiled_func(*args, **kwargs):
        t0 = perf_counter()
        try:
            return func(*args, **kwargs)
        finally:
            dt = perf_counter() - t0
            tprofile.debug(
                "%s.%s : %.6f s", func.__module__, func.__qualname__, dt
            )

    return profiled_func


class _LineTimer:
    """Accumulate per-line wall time for one code object via settrace."""

    def __init__(self, code):
        self.code = code
        self.times = {}  # lineno -> cumulative seconds
        self.hits = {}
        self._last_line = None
        self._last_t = None

    def trace(self, frame, event, arg):
        if frame.f_code is not self.code:
            return None
        now = perf_counter()
        if self._last_line is not None:
            self.times[self._last_line] = (
                self.times.get(self._last_line, 0.0) + now - self._last_t
            )
            self.hits[self._last_line] = self.hits.get(self._last_line, 0) + 1
        if event in ("line", "call"):
            self._last_line = frame.f_lineno
            self._last_t = perf_counter()
        else:  # return / exception: close the interval
            self._last_line = None
        return self.trace

    def report(self, func):
        total = sum(self.times.values()) or 1e-30
        fname = self.code.co_filename
        tprofile.debug(
            "line profile of %s.%s (total %.6f s):",
            func.__module__, func.__qualname__, sum(self.times.values()),
        )
        for lineno in sorted(self.times):
            src = linecache.getline(fname, lineno).rstrip("\n")
            tprofile.debug(
                "  %5d | %10.6f s %5.1f%% %7dx | %s",
                lineno, self.times[lineno],
                100.0 * self.times[lineno] / total,
                self.hits.get(lineno, 0), src,
            )


def line_profile(func):
    """Decorator: log cumulative per-line timings of every call at tprofile
    DEBUG level (reference ``profiler.py:51``)."""

    @wraps(func)
    def profiled_func(*args, **kwargs):
        timer = _LineTimer(func.__code__)
        old = sys.gettrace()
        sys.settrace(timer.trace)
        try:
            return func(*args, **kwargs)
        finally:
            sys.settrace(old)
            timer.report(func)

    return profiled_func
