"""UNIX daemonization for the optimization service.

Counterpart of bayesian_optimization_tpu/service/daemon.py: detach from the
controlling terminal by a double fork, write a pidfile, handle SIGTERM, and
the read_pid/stop/status helpers. Call `daemonize` before the process
touches the GPU: a CUDA context made before a fork is unusable in the child.
"""
from __future__ import annotations

import atexit
import os
import signal
import sys
from typing import Optional


def daemonize(
    pidfile: str,
    stdin: str = "/dev/null",
    stdout: str = "/dev/null",
    stderr: str = "/dev/null",
) -> None:
    """Double-fork into the background and write `pidfile`."""
    if os.path.exists(pidfile):
        raise RuntimeError(f"pidfile {pidfile} exists — daemon already running?")

    if os.fork() > 0:  # first fork: detach from the parent
        raise SystemExit(0)
    os.setsid()
    if os.fork() > 0:  # second fork: relinquish session leadership
        raise SystemExit(0)

    sys.stdout.flush()
    sys.stderr.flush()
    with open(stdin, "rb") as f:
        os.dup2(f.fileno(), sys.stdin.fileno())
    with open(stdout, "ab") as f:
        os.dup2(f.fileno(), sys.stdout.fileno())
    with open(stderr, "ab") as f:
        os.dup2(f.fileno(), sys.stderr.fileno())

    with open(pidfile, "w") as f:
        f.write(str(os.getpid()))
    atexit.register(lambda: os.path.exists(pidfile) and os.remove(pidfile))

    def on_term(signum, frame):  # noqa: ARG001
        if os.path.exists(pidfile):
            os.remove(pidfile)
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, on_term)


def read_pid(pidfile: str) -> Optional[int]:
    try:
        with open(pidfile) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def stop(pidfile: str) -> bool:
    """SIGTERM the daemon recorded in `pidfile` (exact pid only)."""
    pid = read_pid(pidfile)
    if pid is None:
        return False
    try:
        os.kill(pid, signal.SIGTERM)
        return True
    except ProcessLookupError:
        os.remove(pidfile)
        return False


def status(pidfile: str) -> bool:
    pid = read_pid(pidfile)
    if pid is None:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
