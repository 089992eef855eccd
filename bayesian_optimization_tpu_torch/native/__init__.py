"""Host C++ code of the port, loaded with ctypes.

Currently: the WFG exact-hypervolume routine (wfg.cpp), the port's own copy
of the JAX package's native/wfg.cpp -- the native implementation the
reference wished for (ref: bayes_optim/utils/multi_objective/
hypervolume.py:29 "TODO: write this in C++"). It runs on the host, not the
GPU. It is built with g++ at first use into
`bayesian_optimization_tpu_torch/_build/` (listed in .gitignore), under a
name keyed by a hash of the source and flags, so an edited source rebuilds;
nothing is written beside the source. A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "wfg.cpp"
_BUILD_DIR = _SRC.parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libwfg_{h.hexdigest()[:16]}.so"


# serializes the first build among a process's threads; across processes
# the scratch name and the atomic rename keep builds apart
_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the WFG library; raises on failure."""
    so = library_path()
    with _BUILD_LOCK:
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
            out = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed to build {_SRC.name}:\n{out.stdout}{out.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(so))
    lib.wfg_hypervolume.restype = ctypes.c_double
    lib.wfg_hypervolume.argtypes = [_DOUBLE_P, ctypes.c_int, ctypes.c_int, _DOUBLE_P]
    return lib


def wfg_hypervolume(Y, ref) -> float:
    """Exact hypervolume (maximization) of front Y (n, m) above ref (m,)."""
    Y = np.ascontiguousarray(np.asarray(Y, dtype=np.float64))
    ref = np.ascontiguousarray(np.asarray(ref, dtype=np.float64).ravel())
    if Y.ndim != 2 or Y.shape[1] != ref.shape[0]:
        raise ValueError(f"front {Y.shape} and reference point {ref.shape} disagree")
    n, m = Y.shape
    return float(load_library().wfg_hypervolume(Y.ctypes.data_as(_DOUBLE_P), n, m,
                                                 ref.ctypes.data_as(_DOUBLE_P)))


def available() -> bool:
    """Whether the WFG library builds and loads here. A query only: the
    hypervolume path calls `load_library` itself and raises on a failed
    build, whatever this returns."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True
