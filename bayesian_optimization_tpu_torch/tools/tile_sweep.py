"""Time csrc/matern.cu's forward kernel at other tile heights (rows per
thread) on one NVIDIA GPU.

    python bayesian_optimization_tpu_torch/tools/tile_sweep.py [--rows 4,8,16]

For each rows-per-thread value r, builds a copy of csrc/matern.cu with
kFwdRows = r into `_build/` (the dispatch over the feature chunk cut to
D = 5 by text substitution, to keep the build short), checks the copy's
output against the twin, and prints one JSON line: the device time per call
(torch.profiler kernel durations over 20 calls) of the forward at each
main-path shape, nu = 3/2. (The backward's tiles follow its ring of shared
memory; chip_smoke.py's check_matern_bwd times it.)
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the checkout's root

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from bayesian_optimization_tpu_torch.ops import _build  # noqa: E402
from bayesian_optimization_tpu_torch.ops.hopper_kernels import _nu_code, matern_plain  # noqa: E402

DIM = 5
FWD_SHAPES = ((10, 256, None), (6, 512, None), (2, 1024, None), (1, 1024, None),
              (1, 25, 1024), (10, 1024, None))


def build_variant(rows: int) -> ctypes.CDLL:
    src = (_build.SRC_DIR / "matern.cu").read_text()
    src, n_rows = re.subn(r"constexpr int kFwdRows = \d+;", f"constexpr int kFwdRows = {rows};", src)
    src, n = re.subn(r"switch \(D < kMaxDC \? D : kMaxDC\) \{.*?\n  \}\n",
                     "return f(Int<5>{});\n", src, flags=re.S)
    assert n == 1 and n_rows == 1
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"matern_rows{rows}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR), "-shared",
                           "-o", str(so), str(cu)], check=True, capture_output=True, text=True)
    ptxas, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '\S*?(matern_\w+?(?:kernel|finalize)\w*?)'", line)
        name = m.group(1) if m else name
        m = re.search(r"(\d+) bytes spill stores|Used (\d+) registers", line)
        if m and name:
            ptxas.setdefault(name, {})["spill_bytes" if m.group(1) else "registers"] = int(
                m.group(1) or m.group(2))
    print(json.dumps({"rows": rows, "ptxas": ptxas}), flush=True)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = list(argtypes)
            getattr(lib, name).restype = restype
    return lib


def device_ms(fn, calls: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def inputs(B, N, M):
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.rand((N, DIM), generator=g, device="cuda")
    Y = X if M is None else torch.rand((M, DIM), generator=g, device="cuda")
    theta = 10 ** (torch.rand((B, DIM), generator=g, device="cuda") * 2 - 1)
    return theta, X, Y


def sweep(lib, rows: int) -> dict:
    code = _nu_code(1.5)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"rows": rows, "forward_ms": {}}
    for B, N, M in FWD_SHAPES:
        theta, X, Y = inputs(B, N, M)
        K = torch.empty((B, N, Y.shape[0]), device="cuda")

        def fwd():
            lib.botorch_matern(theta.data_ptr(), X.data_ptr(), Y.data_ptr(), K.data_ptr(), B, N,
                               Y.shape[0], DIM, code, int(M is None), stream)

        fwd()
        err = float((K - matern_plain(theta, X, Y, nu=1.5, sym=M is None)).abs().max())
        assert err < 5e-6, (rows, B, N, M, err)
        out["forward_ms"][f"{(B, N, Y.shape[0])}"] = device_ms(fwd)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="4,8,16")
    for rows in map(int, ap.parse_args().rows.split(",")):
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          **sweep(build_variant(rows), rows)}), flush=True)


if __name__ == "__main__":
    main()
