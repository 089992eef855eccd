"""Build and load the port's hand-written CUDA kernels.

The sources in `bayesian_optimization_tpu_torch/csrc/` are compiled with
`nvcc` for sm_90a into one shared library with a plain C interface, loaded
with ctypes: one `nvcc -c` per source, all started together, then one link.
The build runs at first use, into `bayesian_optimization_tpu_torch/_build/`
(listed in .gitignore), under a name keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused. `nvcc`'s
`-Xptxas -v` report (registers, shared memory and spills per kernel) is kept
beside the library as a .log.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry point -> (argument types, return type); every pointer and the
# stream are c_void_p; a launch returns its cudaError_t as an int
_SIGNATURES = {
    # theta, X, Y, K, B, N, M, D, nu_code, sym, stream
    "botorch_matern": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), _I),
    # B, N, M, D, same, need_x, need_y, sms -> floats of scratch
    "botorch_matern_bwd_scratch": ((_I,) * 8, ctypes.c_longlong),
    # B, N, M, D, same, need_x, need_y, sms -> row-tile counters
    "botorch_matern_bwd_row_tiles": ((_I,) * 8, _I),
    # theta, X, Y, G, scratch, counter, tile_counter, dtheta, dX, dY, B, N, M,
    # D, nu_code, sym, same, need_t, need_x, need_y, sms, stream
    "botorch_matern_bwd": ((_P,) * 10 + (_I,) * 11 + (_P,), _I),
    # B, N, M, D, sms -> floats of scratch
    "botorch_matern_bwd2_scratch": ((_I,) * 5, ctypes.c_longlong),
    # theta, X, Y, G, V, gG, gX, scratch, counter, B, N, M, D, nu_code, sym,
    # sms, stream
    "botorch_matern_bwd2": ((_P,) * 9 + (_I,) * 7 + (_P,), _I),
    # ws, dinv, piv, Bt, rows, n, T, stream
    "botorch_whiten": ((_P, _P, _P, _I, _I, _I, _I, _P), _I),
    # ws, iws, idx, f_a, g_a, z_trial, n_live, R, d, m, c1, max_ls, stream
    "botorch_lbfgs_update": ((_P,) * 6 + (_I,) * 4 + (ctypes.c_double, _I, _P), _I),
    "botorch_error_string": ((_I,), ctypes.c_char_p),
}


# matern.cu is compiled once per feature chunk (its 20 kernels each) and once
# for its entry points, so that its 160 kernels build in parallel
_DEFINES = {"matern.cu": [(f"-DMATERN_DC={k}",) for k in range(9)]}


def _sources():
    """The CUDA sources."""
    return sorted(SRC_DIR.glob("*.cu"))


def _units():
    """(source, nvcc defines) of each translation unit, each compiled on its own."""
    return [(src, d) for src in _sources() for d in _DEFINES.get(src.name, [()])]


def _hashed():
    """What the library's name hashes: the sources and the headers they include."""
    return _sources() + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + repr(_DEFINES).encode())
    for src in _hashed():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbotorch_kernels_{h.hexdigest()[:16]}.so"


# serializes the first build among a process's threads (two jobs of the
# threaded service can reach a first launch at once); across processes the
# scratch names and the atomic rename keep builds apart
_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; raises on failure."""
    so = library_path()
    with _BUILD_LOCK:
        if not so.exists():
            _build(so)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}.{threading.get_ident()}"
    units = _units()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.{i}.o" for i, (src, _) in enumerate(units)]
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, *defines, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for (src, defines), obj in zip(units, objs)
    ]
    outs = [p.communicate()[0] for p in procs]
    tmp = BUILD_DIR / f"{tag}.tmp"
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run(
            [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        outs.append(link.stdout + link.stderr)
    so.with_suffix(".log").write_text("".join(outs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "".join(outs))
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


def build_log() -> str:
    """The ptxas report of the current build ('' before the first build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = load_library().botorch_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
