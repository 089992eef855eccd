"""Build and load the port's hand-written CUDA kernels.

The sources in `bayesian_optimization_tpu_torch/csrc/` are compiled with
`nvcc` for sm_90a into one shared library with a plain C interface, loaded
with ctypes. The build runs at first use, into
`bayesian_optimization_tpu_torch/_build/` (listed in .gitignore), under a
name keyed by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused. `nvcc`'s `-Xptxas -v` report (registers,
shared memory and spills per kernel) is kept beside the library as a .log.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry point -> argument types; every pointer and the stream are c_void_p
_SIGNATURES = {
    # theta, X, Y, K, B, N, M, D, nu_code, sym, stream
    "botorch_matern": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # ws, dinv, piv, Bt, rows, n, T, stream
    "botorch_whiten": (_P, _P, _P, _I, _I, _I, _I, _P),
}


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbotorch_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; raises on failure."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.botorch_error_string.argtypes = [ctypes.c_int]
    lib.botorch_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """The ptxas report of the current build ('' before the first build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = load_library().botorch_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
