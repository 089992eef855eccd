"""Time csrc/matern.cu's forward and backward kernels at other tile heights
(rows per thread) on one NVIDIA GPU.

    python bayesian_optimization_tpu_torch/tools/tile_sweep.py [--rows 4,8,16]

For each rows-per-thread value r, builds a copy of csrc/matern.cu with
kFwdRows = kBwdRows = r into `_build/` (the dispatch over the feature chunk
cut to D = 5 by text substitution, to keep the build short), checks the
copy's output against the twins, and prints one JSON line: the device time
per call (torch.profiler kernel durations over 20 calls) of the forward at
each main-path shape and of the backward at the fit's and the argmax's
shapes, nu = 3/2.
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
from bayesian_optimization_tpu_torch.ops.hopper_kernels import (  # noqa: E402
    _nu_code, matern_bwd_plain, matern_plain,
)

DIM = 5
FWD_SHAPES = ((10, 256, None), (6, 512, None), (2, 1024, None), (1, 1024, None),
              (1, 25, 1024), (10, 1024, None))
BWD_SHAPES = ((2, 1024, None, (True, False, False)), (10, 256, None, (True, False, False)),
              (6, 512, None, (True, False, False)), (1, 25, 1024, (False, True, False)))


def build_variant(rows: int) -> ctypes.CDLL:
    src = (_build.SRC_DIR / "matern.cu").read_text()
    src, n_rows = re.subn(r"constexpr int k(Fwd|Bwd)Rows = \d+;",
                          lambda m: f"constexpr int k{m.group(1)}Rows = {rows};", src)
    src, n = re.subn(r"switch \(D < kMaxDC \? D : kMaxDC\) \{.*?\n  \}\n",
                     "return with_code<5>(code, f);\n", src, flags=re.S)
    assert n == 1 and n_rows == 2
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"matern_rows{rows}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                          check=True, capture_output=True, text=True)
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
    out = {"rows": rows, "forward_ms": {}, "backward_ms": {}}
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
    for B, N, M, need in BWD_SHAPES:
        theta, X, Y = inputs(B, N, M)
        same = M is None
        G = torch.randn((B, N, Y.shape[0]), device="cuda")
        scratch = torch.empty(lib.botorch_matern_bwd_scratch(B, N, Y.shape[0], DIM), device="cuda")
        gt, gx = torch.empty((B, DIM), device="cuda"), torch.empty((N, DIM), device="cuda")

        def bwd():
            lib.botorch_matern_bwd(theta.data_ptr(), X.data_ptr(), Y.data_ptr(), G.data_ptr(),
                                   scratch.data_ptr(), gt.data_ptr(), gx.data_ptr(), 0, B, N,
                                   Y.shape[0], DIM, code, int(same), int(same), int(need[0]),
                                   int(need[1]), int(need[2]), stream)

        bwd()
        K64 = matern_plain(theta.double(), X.double(), Y.double(), nu=1.5, sym=same)
        want = matern_bwd_plain(theta.double(), X.double(), Y.double(), K64, G.double(), code,
                                same, same, need)
        got = gt if need[0] else gx
        w = want[0] if need[0] else want[1]
        rel = float((got.double() - w).abs().max() / w.abs().max())
        assert rel < 1e-4, (rows, B, N, M, rel)
        out["backward_ms"][f"{(B, N, Y.shape[0])}"] = device_ms(bwd)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="4,8,16")
    for rows in map(int, ap.parse_args().rows.split(",")):
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          **sweep(build_variant(rows), rows)}), flush=True)


if __name__ == "__main__":
    main()
