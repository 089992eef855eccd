"""Structured per-instance logging with per-phase wall-clock timing.

Capability parity with the reference's logger + @timeit
(ref: bayes_optim/utils/logger.py:8-84, bayes_optim/utils/utils.py:235-246),
re-designed: loggers are plain stdlib loggers (picklable by name), timing is
collected into a metrics dict on the instance so it can be exported as
structured data (and fed to torch.profiler record_function spans), instead of only
being printed.

Below the phases, `span(name)` times a block inside the running phase and
`count(name, n)` adds to a counter there, each under the key
"<phase>/<name>" of the phase's PhaseTimer; `host_sync()` is the span of a
device-to-host read. They keep totals and counts only, cost one lookup
where no phase runs (a bare `GaussianProcess.fit`), and open a profiler
range only while a profiler runs.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import logging
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

_LEVEL_FMT = {
    logging.DEBUG: "%(asctime)s - [%(name)s.%(levelname)s] {%(pathname)s:%(lineno)d} -- %(message)s",
    logging.INFO: "%(asctime)s - [%(name)s.%(levelname)s] -- %(message)s",
    logging.WARNING: "%(asctime)s - [%(name)s.%(levelname)s] -- %(message)s",
    logging.ERROR: "%(asctime)s - [%(name)s.%(levelname)s] {%(pathname)s:%(lineno)d} -- %(message)s",
}


class PerLevelFormatter(logging.Formatter):
    """Different formats per level (ref parity: utils/logger.py:8-39)."""

    default_time_format = "%m/%d/%Y %H:%M:%S"

    def format(self, record: logging.LogRecord) -> str:
        fmt = _LEVEL_FMT.get(record.levelno, _LEVEL_FMT[logging.INFO])
        return logging.Formatter(fmt).format(record)


def get_logger(
    name: str,
    file: Optional[str] = None,
    console: bool = False,
    level: int = logging.INFO,
) -> logging.Logger:
    """Create (or fetch) a named logger with optional file/console handlers."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False

    existing = {
        getattr(h, "baseFilename", None) if isinstance(h, logging.FileHandler) else type(h)
        for h in logger.handlers
    }
    fmt = PerLevelFormatter()
    if file is not None:
        path = os.path.abspath(file)
        if path not in existing:
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    if console and logging.StreamHandler not in existing:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


class PhaseTimer:
    """Accumulates wall-clock per named phase; exportable as a dict.

    Replaces the reference's print-only @timeit decorator
    (ref: bayes_optim/utils/utils.py:235-246) with queryable metrics. The
    spans and counters of the code a phase runs are kept beside the phases,
    as totals and counts under "<phase>/<name>" (no list a call)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.history: Dict[str, List[float]] = {}
        self.span_s: Dict[str, float] = {}
        self.span_n: Dict[str, int] = {}
        self.counters: Dict[str, int] = {}

    def __setstate__(self, state):
        # a checkpoint written before spans and counters existed
        self.__dict__.update({"span_s": {}, "span_n": {}, "counters": {}, **state})

    def record(self, phase: str, seconds: float) -> None:
        self.totals[phase] = self.totals.get(phase, 0.0) + seconds
        self.counts[phase] = self.counts.get(phase, 0) + 1
        self.history.setdefault(phase, []).append(seconds)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k], "mean_s": self.totals[k] / self.counts[k]}
            for k in self.totals
        }

    def snapshot(self) -> Dict[str, float]:
        """Every total as one flat dict: "<key>:s" the seconds and "<key>:n"
        the calls of each phase and span (a phase's seconds include its
        spans; a span's exclude the spans inside it), and each counter under
        its own key. The difference of two snapshots is the work between
        them."""
        out: Dict[str, float] = {}
        for sec, calls in ((self.totals, self.counts), (self.span_s, self.span_n)):
            out.update({f"{k}:s": v for k, v in sec.items()})
            out.update({f"{k}:n": v for k, v in calls.items()})
        out.update(self.counters)
        return out


# (timer, phase name) of the innermost running `timed_phase`, or None
_PHASE: contextvars.ContextVar[Optional[Tuple[PhaseTimer, str]]] = contextvars.ContextVar(
    "bo_torch_phase", default=None)
# the innermost open span, or None
_OPEN: contextvars.ContextVar[Optional["_Span"]] = contextvars.ContextVar("bo_torch_span", default=None)
_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def _open_range(name: str):
    """An entered torch.profiler range named `name` while a profiler runs;
    None otherwise (the range alone costs more than a small operator)."""
    if not _profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Span:
    """A span's own seconds: those of the spans opened inside it (a copy to
    the device inside the objective's forward) are theirs alone, so the
    spans of a phase add up without counting anything twice."""

    __slots__ = ("sec", "calls", "key", "name", "rf", "t0", "inner", "parent", "token")

    def __init__(self, timer: PhaseTimer, key: str, name: str):
        self.sec, self.calls, self.key, self.name = timer.span_s, timer.span_n, key, name

    def __enter__(self):
        self.parent = _OPEN.get()
        self.token = _OPEN.set(self)
        self.inner = 0.0
        self.rf = _open_range(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        _OPEN.reset(self.token)
        key, sec, calls = self.key, self.sec, self.calls
        sec[key] = sec.get(key, 0.0) + dt - self.inner
        calls[key] = calls.get(key, 0) + 1
        if self.parent is not None:
            self.parent.inner += dt
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def span(name: str):
    """Context manager: the block's seconds and one call, added to the
    running phase's timer under "<phase>/<name>". Outside any phase it
    records nothing."""
    cur = _PHASE.get()
    if cur is None:
        return _NO_SPAN
    return _Span(cur[0], f"{cur[1]}/{name}", name)


def count(name: str, n: int = 1) -> None:
    """Add n to the running phase's counter "<phase>/<name>" (outside any
    phase: nothing)."""
    cur = _PHASE.get()
    if cur is not None:
        cur[0].count(f"{cur[1]}/{name}", n)


def host_sync(n: int = 1):
    """The span "host_sync" around n device-to-host reads, which add n to the
    counter "host_syncs": the host waits there for the device's queue."""
    cur = _PHASE.get()
    if cur is None:
        return _NO_SPAN
    cur[0].count(f"{cur[1]}/host_syncs", n)
    return _Span(cur[0], f"{cur[1]}/host_sync", "host_sync")


def in_phase() -> bool:
    """Whether a timed phase is running (its spans and counters record)."""
    return _PHASE.get() is not None


def timed_phase(phase: str):
    """Method decorator: time the call, record into `self._timer` if present
    (the phase is then the current one for `span` and `count`), and log at
    DEBUG level via `self.logger` if present."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            timer = getattr(self, "_timer", None)
            token = _PHASE.set((timer, phase)) if timer is not None else None
            rf = _open_range(phase)
            t0 = time.perf_counter()
            try:
                out = fn(self, *args, **kwargs)
            finally:
                if rf is not None:
                    rf.__exit__(None, None, None)
                if token is not None:
                    _PHASE.reset(token)
            dt = time.perf_counter() - t0
            if timer is not None:
                timer.record(phase, dt)
            logger = getattr(self, "logger", None)
            if logger is not None:
                logger.debug("%s took %.4fs", phase, dt)
            return out

        return wrapper

    return deco
