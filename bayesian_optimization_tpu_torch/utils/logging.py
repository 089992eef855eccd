"""Structured per-instance logging with per-phase wall-clock timing.

Capability parity with the reference's logger + @timeit
(ref: bayes_optim/utils/logger.py:8-84, bayes_optim/utils/utils.py:235-246),
re-designed: loggers are plain stdlib loggers (picklable by name), timing is
collected into a metrics dict on the instance so it can be exported as
structured data (and fed to torch.profiler record_function spans), instead of only
being printed.
"""
from __future__ import annotations

import functools
import logging
import os
import sys
import time
from typing import Dict, List, Optional

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
    (ref: bayes_optim/utils/utils.py:235-246) with queryable metrics.
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.history: Dict[str, List[float]] = {}

    def record(self, phase: str, seconds: float) -> None:
        self.totals[phase] = self.totals.get(phase, 0.0) + seconds
        self.counts[phase] = self.counts.get(phase, 0) + 1
        self.history.setdefault(phase, []).append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k], "mean_s": self.totals[k] / self.counts[k]}
            for k in self.totals
        }


def timed_phase(phase: str):
    """Method decorator: time the call, record into `self._timer` if present,
    and log at DEBUG level via `self.logger` if present."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            t0 = time.perf_counter()
            import torch

            with torch.profiler.record_function(phase):
                out = fn(self, *args, **kwargs)
            dt = time.perf_counter() - t0
            timer = getattr(self, "_timer", None)
            if timer is not None:
                timer.record(phase, dt)
            logger = getattr(self, "logger", None)
            if logger is not None:
                logger.debug("%s took %.4fs", phase, dt)
            return out

        return wrapper

    return deco
