"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing on its own lines; any failure raises and exits
non-zero, and no phase's exception is caught:
  1. device: require a Hopper GPU; print its name, power limit and versions;
  2. build: compile the hand-written kernels of csrc/ (nvcc, sm_90a);
  3. each kernel against its plain PyTorch twin on the card, at the main
     path's shapes (whiten_fused also at ragged blocks of n <= 128, at
     the hybrid factorisation's panel shape and with the multi-output
     fits' 3 and 4 right-hand sides, and both kernels at the samplers'
     8-chain and the ensemble predict's shapes, chol_inv_whiten at the
     stacked state's): max error against the stated
     tolerance, and both times (ms per call by CUDA events around 10 calls,
     median of 7 windows; ms on the device from the profiler, a session that
     traced no kernel retried, "not measured" if every try was empty: the
     device times are printed, never checked); matern_fused's
     forward at every path's shape (the parity configs' small buckets and
     the mixed space's D = 6 training matrices among them) with its share
     of the bound, and its backward kernel against the torch backward it
     replaces (error against the twin in float64, bit-identical over 100
     calls in a row and over calls in flight on two streams, the kernel's
     launches a call from the profiler, device ms of both beside the
     kernel's pre-PR-10 figure), and its second-derivative kernel against
     its twin in float64 at a Hessian's shapes (the same checks); the
     backward also at 7 and 8 features, where ptxas reports spills;
     whiten_fused's device time split by kernel name into its diagonal,
     panel and trailing kernels at (2, 1024), (10, 1024) and the hybrid
     panel; a failed lane (indefinite, NaN) flagged by its pivot; then the
     card's likelihood and gradient against the plain path on the CPU, on
     a small input;
  4. the main path at bench size (bench.py: n=1000, d=5): GaussianProcess.fit
     plus the BFGS EI argmax with 25 restarts, 2 warm-ups and 3 timed reps;
     the launch counters are zeroed just before and read just after, and
     every kernel (the Matern backward included) must have launched; one
     backward call is one L-BFGS trip, so the counters also give the trips;
     then the likelihood and gradient at this size against the plain path
     on the CPU;
  5. one fit at n=4000 (bucket 4096, the hybrid factorisation);
  6. fmin on the 2-D sphere (parity config 1 cut to 15 of its 30
     evaluations, seed 42);
  7. (a) ParallelBO's ask at bench size: a fit plus the batch argmax of 8
     MGFI criteria x 25 restarts as one L-BFGS (2 warm-ups, 3 timed reps),
     trips and ms a trip; one ask profiled and the same ask (same t, same
     starts) timed, for launches a trip and idle share; beside it a q=1 ask;
     the card's per-criterion values against the CPU path's criterion at
     its winners;
  8. (b) the mixed space's fit (parity config 4, 1000 observations of
     mixed_obj, D = 6), its NLL at its result against the CPU path's in
     float64 (3e-4 relative: the fit ends on an ill-conditioned R, where
     the CPU float32 path is 1.55e-4 off); the CMA and SMC engines on the
     phase-4 posterior and MIES on the mixed posterior: wall, generations,
     launches an evaluation, idle share, the winner against the CPU path's
     criterion (1e-4; MIES's against the CPU path in float64);
  9. (c) the CMA hyperparameter fit at n=1000: wall, counters, NLL, and the
     card's NLL (relative) and gradient (absolute, within the error phase 4
     allows) at its result against the CPU's, both float32 paths' errors
     against float64 printed;
 10. (d) parity configs 3 (ParallelBO, q=8) and 4 (mixed space, MIES)
     end to end, seed 0, cut to 24 (two batches) and 16 evaluations:
     regret and wall;
 11. the posterior-ensemble paths at n=1000, d=5: (a) bench.py's NUTS cell
     (hmc_warmup 64, n_ensemble 8, the BFGS EI argmax over the ensemble), a
     cold iteration, 2 carried warm-ups and 3 timed reps, with transitions,
     leapfrogs, mean depth, accept rates, step sizes, ESS, one profiled
     refit (launches a leapfrog, idle share) and the fit's quality beside
     the BFGS fit's; (b) one HMC and one VI fit; (c) the card against the
     CPU path: the mixture at 64 points, the sampler's target and gradient
     at the chain states, one NUTS transition from the same draws
     (printed); (d) the ensemble argmax alone;
 12. the constrained, PCA-reduced and GEI paths: (a) whiten's backward over
     the kernel's Dinv: phase 11's profiled refit must show no cuBLAS trsm
     kernel; the gradient at (8, 1024) against float64 autograd on the
     card; the backward's device ms beside the trsm backward it replaced;
     at cond(R) ~3e7, the gradient with each solver (the backward's,
     blocked substitution, trsm) against float64;
     (b) the constrained argmax on phase 4's posterior, each a warm refit
     plus the argmax: a traced inequality under BFGS (the card's penalized
     criterion and gradient against the CPU path's), the same inequality on
     the host (BFGS asked, CMA run) and a q=8 MGFI batch under it, every
     winner feasible; (c) parity config 6 (equality, BFGS) end to end:
     |h| <= 0.1 and fopt within the reference's worst seed; (d) parity
     config 5 (PCABO, 20-D ellipsoid) cut to 40 of its 60 evaluations,
     inside the box and below its DoE best, and one BO iteration with GEI
     (g=2), its criterion against the CPU path's;
 13. the tree-surrogate and conditional paths and the rest of the GP: (a)
     fits at n=1000, d=5 with the absolute-exponential kernel and Matern
     nu=7/2, each likelihood at 4 lanes against the CPU path (1e-4); (b) the
     float64 GP at n=1000 on the card (no kernel launched; its NLL at its
     optimum against the CPU float64 path, 1e-8) beside phase 4's float32
     log-likelihood; (c) gradient and Hessian of phase 4's GP at 5 points
     against the CPU path in float64, each Hessian through the
     second-derivative kernel once per dimension; (d) chol_and_inv at n=1024 against
     its CPU twin, with its device time; (e) a 100-tree RandomForest grown
     on phase 8's 1000 mixed observations (wall, nodes, depth), its
     traversal against the CPU's, and an MGFI MIES argmax on it; (f) a GP
     under a NonparametricTrend at n=1000: forest, residual fit and the
     BFGS EI argmax with the forest in the criterion (plugin at y's 10th
     percentile), every kernel launched, the winner better than every
     start and away from them, its criterion against the CPU path's; (g)
     ConditionalBO (30 evaluations) and BO with a RandomForest on parity
     config 4 (40 evaluations), regret below the DoE's;
 14. the multi-objective paths, on f_k(x) = |x - c_k|^2 over [0, 1]^d (the
     bi-sphere, c = 0.2 and 0.8; the tri-sphere, c = 0.2, 0.5, 0.8): (a)
     MOBO at n=1000, d=5: the 2-output fit and the BFGS EHVI argmax (25
     restarts), a cold ask, 2 warm-ups and 3 timed iterations (refit +
     ask), trips, the front, cells and hypervolume, one argmax profiled;
     the winner at least its best start; the card's EHVI at the winner and
     at 64 points against the CPU path in float64 (within 1e-4, or 10 times
     the CPU float32 path's own error); (b) MOBO_qEHVI's joint ask, q=4, on
     the CMA engine over the 20-dimensional replicated space: walls,
     evaluations, launches an evaluation, peak memory, qEHVI at the winner
     against the CPU path on the same samples; (c) MOBO on the tri-sphere
     at n=300 (cells, the host partition's seconds, the ask), and the WFG
     hypervolume at m=3 and 4 against the grid (1e-10); (d) MOBO end to end
     in d=2 with the GP, with a 30-tree RandomForest and under an
     inequality: each final front's hypervolume above its DoE's, every
     constrained point feasible;
 15. the ask/tell service, the particle mesh and the entry points: (a) the
     HTTP service in this process (device cuda) on bench.py's domain
     [0, 1]^5: the DoE ask, one tell of bench.py's 1000 points (a cold fit
     at n=1000) and the BFGS EI ask, walls beside the same tell and ask on
     the service object in this process, in three alternating pairs (the
     gap: HTTP and JSON), and phase 4's; every kernel launched, the point in
     the box, recommend's fopt the smallest told y, status and finalize;
     any reply carrying "error" fails; (b) a ParallelBO job (q=4) and a
     mixed-space (MIES) job at once from two client threads, 3 rounds each;
     (c) the daemon (`-d --device cuda`) in a subprocess: health, one job's
     ask/tell/ask, stop by its pidfile, the pid gone and the pidfile
     removed (a `finally` kills that exact pid); (d) the default mesh's BFGS
     EI argmax on phase 4's posterior against the unsharded one from one
     pool (identical on one card), and the BFGS, CMA and SMC engines on a
     2-entry mesh over cuda:0 against the unsharded engine on the same
     padded pool and generator (winner within 1e-4, lanes that part
     printed), with the mesh's gathers; (e) entry() on the card against
     the CPU path and dryrun_multidevice(2) on ["cuda:0"] * 2;
 16. the JAX package's remaining entry points on the card, d = 5 on
     bench.py's domain [0, 1]^5, a DoE of 10: (a) NoisyBO, AnnealingBO,
     SelfAdaptiveBO and MultiAcquisitionBO (q = 2, two batches), the
     criterion at each last winner against the CPU path in float64 at the
     same posterior (within 1e-4, or 10 times the CPU float32 path's own
     error near the winner); (b) save -> load in this process (the loaded
     BO on the card, its next ask against the original's from the same
     state: bit-equal or the largest difference), save_state -> a fresh
     BO -> load_state (the same theta within 1e-6 in log10, equal
     counters), ask(fixed={"x0": 0.5}) through the argmax and the DoE,
     warm data with eval_type="dict"; (c) a noise_estim fit, a noiseless
     fit of duplicated, conflicting rows, and a noiseless fit float32
     cannot factor, which must escalate to the noisy mode; walls and
     launches by path;
each of phases 4, 7-16's paths zeroes the launch counters just before it
and reads them just after, and fails if a kernel of its path did not
launch (the Matern forward on every GP path, its backward on the batched
BFGS, the mixed fit, the samplers, every phase-12 path, the derivatives
and the NonparametricTrend path, the MO asks, every phase-16 path, its
second derivative on the Hessians, the factorisation on the fits), or, on
the float64 fit, if any kernel launched. The forest's paths run no
hand-written kernel: their counts are printed. Then the kernels' JSON line
(with the batch and engine paths' shapes and every path's launches), the
card's name and power limit, and last the result line {"ok": true,
"device": {...}}.

Bounds: the least time the card could take for a call, the larger of its
bytes (each input read once, each output written once) over 3.35 TB/s and
its FP32 operations over 67 TFLOP/s (an H100 SXM's published peaks).
"""
import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace
import urllib.error
import urllib.request

import numpy as np
import torch
from torch.autograd import DeviceType

from bayesian_optimization_tpu_torch import (
    BO, MOBO, PCABO, AcquisitionArgmax, AnnealingBO, ConditionalBO, ConstraintProgram, DiscreteSpace,
    GaussianProcess, IntegerSpace, MOBO_qEHVI, MultiAcquisitionBO, NoisyBO, NonparametricTrend,
    ParallelBO, RandomForest, RealSpace, SearchSpace, SelfAdaptiveBO, constant_trend, fmin, require_cuda,
)
from bayesian_optimization_tpu_torch.native import wfg_hypervolume
from bayesian_optimization_tpu_torch.entry import dryrun_multidevice, entry
from bayesian_optimization_tpu_torch.optim.cma import run_cma
from bayesian_optimization_tpu_torch.optim.smc import run_smc
from bayesian_optimization_tpu_torch.parallel import make_particle_mesh, shard_population
from bayesian_optimization_tpu_torch.service import daemon
from bayesian_optimization_tpu_torch.service.http_server import pidfile_for, serve
from bayesian_optimization_tpu_torch.core.bo import _sample_t
from bayesian_optimization_tpu_torch.models import effective_sample_size
from bayesian_optimization_tpu_torch.models import gp as gp_module
from bayesian_optimization_tpu_torch.models.hmc import Draws, _Chains, _nuts_step, _value_and_grad
from bayesian_optimization_tpu_torch.models.likelihood import (
    PIV_TOL, GPConfig, neg_log_likelihood, predict_gp, trend_basis,
)
from bayesian_optimization_tpu_torch.models.random_forest import RFState, rf_predict
from bayesian_optimization_tpu_torch.optim import argmax as argmax_module
from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion
from bayesian_optimization_tpu_torch.ops import _build
from bayesian_optimization_tpu_torch.ops.box_decomposition import NondominatedPartitioning
from bayesian_optimization_tpu_torch.ops.ehvi import QEHVI_N_SAMPLES, ehvi
from bayesian_optimization_tpu_torch.ops.hypervolume import _hv_grid
from bayesian_optimization_tpu_torch.space import Discrete, Integer, Real
from bayesian_optimization_tpu_torch.ops.hopper_kernels import (
    _nu_code, matern_bwd2_fused, matern_bwd2_plain, matern_bwd_fused, matern_bwd_plain,
    matern_fused, matern_plain, reset_launch_counts, whiten_fused, whiten_plain,
)
from bayesian_optimization_tpu_torch.ops.linalg import (
    _block_tri_inv, _whiten_parts, chol_and_inv, chol_inv_whiten, whiten, whiten_vjp,
)
from bayesian_optimization_tpu_torch.tools.whiten_bwd_variants import SOLVERS, ill_conditioned, trsm_solver

DIM = 5
MIXED_D = 6  # parity config 4's space embedded: 2 reals, 1 integer, a 3-level one-hot
Q = 8        # parity config 3's batch
MATERN_TOL = 5e-6      # absolute, as tests/test_pallas.py holds matern_pallas
MATERN_BWD_TOL = 1e-4  # max |g - g_twin| / max |g_twin|, the twin in float64
WHITEN_L_TOL = 1e-4    # max |L - L_twin| / max |L_twin|
WHITEN_W_TOL = 1e-3    # max |W - W_twin| / max(1, max |W_twin|)
CHOL_INV_TOL = 1e-3    # max |L^-1 - plain| / max |plain|
WHITEN_GRAD_TOL = 1e-3  # max |dR - dR_f64| / max |dR_f64|, as tests/test_linalg.py holds the VJP
SOLVE_OWN_TOL = 1e-5    # a solver's own error in whiten's VJP, relative, at cond(R) ~3e7
# phase 8's mixed fit ends on an ill-conditioned R (theta at its bounds),
# where the CPU float32 path's NLL is 1.55e-4 off float64 (PERF.md): the
# card's within twice that
MIXED_NLL_F64_TOL = 3e-4
# EHVI on the near-interpolating multi-output posteriors of phase 14: the
# float32 predict's mean is ~7e-5 off float64 where sigma is ~1e-3, which
# moves EHVI by ~3e-3 of its largest value on the CPU float32 path itself;
# the card is held to float64 within 1e-4, or within this many times the CPU
# float32 path's own error where that is larger
MO_F32_FACTOR = 10.0
# cuBLAS trsm in one profiled NUTS refit before the backward used Dinv: ms and
# leapfrogs (PERF.md section 5)
TRSM_REFIT_MS, TRSM_REFIT_LEAPFROGS = 2873.07, 433
CONFIG6_WORST_REF = 15.5057  # the reference's worst seed, PARITY_6_constrained.json
PALLAS = "bayesian_optimization_tpu/ops/pallas_kernels.py"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
FP32_FLOP_PER_S = 67e12     # H100 SXM, outside the tensor cores

# (label, lanes B, N, M or None for the training matrix, D): the shapes the
# main path gives matern_fused, then those of the batch and engine paths
# (a (1, N, M) row is one theta vector, as the argmax calls it)
MATERN_SHAPES = (("cold ladder rung 1", 10, 256, None, DIM), ("cold ladder rung 2", 6, 512, None, DIM),
                 ("warm refit", 2, 1024, None, DIM), ("posterior state", 1, 1024, None, DIM),
                 ("argmax trip", 1, 25, 1024, DIM), ("headline", 10, 1024, None, DIM),
                 ("batched BFGS trip, q=8 x 25", 1, 200, 1024, DIM),
                 ("CMA/SMC generation", 1, 32, 1024, DIM),
                 ("MIES generation, 5 restarts", 1, 50, 1024, MIXED_D),
                 ("MIES generation, 6 restarts", 1, 60, 1024, MIXED_D),
                 ("config 3 fit, bucket 16", 10, 16, None, DIM),
                 ("config 3 fit, bucket 64", 10, 64, None, DIM),
                 ("config 4 fit, bucket 16", 10, 16, None, MIXED_D),
                 ("config 4 fit, bucket 64", 10, 64, None, MIXED_D),
                 ("mixed fit rung 1", 10, 256, None, MIXED_D),
                 ("mixed fit rung 2", 6, 512, None, MIXED_D),
                 ("mixed fit final", 2, 1024, None, MIXED_D),
                 ("mixed posterior state", 1, 1024, None, MIXED_D),
                 ("CMA fit on the mixed space", 10, 1024, None, MIXED_D),
                 ("sampler leapfrog, warm-up subset", 8, 256, None, DIM),
                 ("sampler leapfrog, ensemble state", 8, 1024, None, DIM),
                 ("ensemble predict, argmax trip", 8, 25, 1024, DIM),
                 ("config 6 fit, bucket 16", 10, 16, None, 2),
                 ("config 6 argmax trip", 1, 10, 16, 2),
                 ("config 5 argmax trip, bucket 64", 1, 25, 64, DIM),
                 ("qEHVI CMA generation, 80 chains x q=4", 1, 320, 1024, DIM))
NEW_SHAPES = ("batched BFGS trip, q=8 x 25", "CMA/SMC generation", "MIES generation, 5 restarts",
              "MIES generation, 6 restarts", "config 3 fit, bucket 16", "config 3 fit, bucket 64",
              "config 4 fit, bucket 16", "config 4 fit, bucket 64", "mixed fit rung 1",
              "mixed fit rung 2", "mixed fit final", "mixed posterior state",
              "CMA fit on the mixed space", "sampler leapfrog, warm-up subset",
              "sampler leapfrog, ensemble state", "ensemble predict, argmax trip",
              "config 6 fit, bucket 16", "config 6 argmax trip", "config 5 argmax trip, bucket 64",
              "qEHVI CMA generation, 80 chains x q=4", "fit at D = 7, n=1024", "argmax trip at D = 7",
              "fit at D = 8, n=1024", "argmax trip at D = 8")


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def stamp(phase: str) -> None:
    """The run's elapsed seconds as a phase starts."""
    log(f"  -- {phase} starts at {time.perf_counter() - T_START:.1f} s")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, windows: int = 7, calls: int = 10) -> float:
    """ms per call of fn(), by CUDA events around `calls` back-to-back calls,
    median over `windows` windows after a warm-up. The wrapper's host work
    is inside the window: where it outlasts the device work, this is the
    host's enqueue rate, which device_ms tells apart."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


PROFILE_TRIES = 5
# profiler sessions run and those that traced no kernel: now and then the
# profiler delivers no kernel record for up to three sessions in a row, so
# an empty session is retried, and device times are "not measured" only if
# every try is empty
PROFILER_SESSIONS = {"run": 0, "empty": 0}


def fmt(x, spec: str = ".4f") -> str:
    return "not measured" if x is None else format(x, spec)


def ratio(a, b):
    """a / b, None where either was not measured."""
    return None if a is None or b is None else a / b


def traced_kernels(fn) -> list:
    """The device's kernel events of one profiler session around fn()."""
    PROFILER_SESSIONS["run"] += 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    PROFILER_SESSIONS["empty"] += not kernels
    return kernels


def kernel_profile(fn, calls: int = 10):
    """Per call of fn(), by kernel name: [device ms, launches], the summed
    duration and count of the kernels of each name the profiler traced over
    `calls` calls, divided by `calls`; None if PROFILE_TRIES sessions in a
    row traced no kernel."""
    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(calls):
            fn()

    for _ in range(PROFILE_TRIES):
        by_name = {}
        for e in traced_kernels(window):
            ms_n = by_name.setdefault(e.name, [0.0, 0.0])
            ms_n[0] += e.time_range.elapsed_us() / 1e3 / calls
            ms_n[1] += 1 / calls
        if by_name:
            return by_name
    log(f"  (the profiler traced no kernel in {PROFILE_TRIES} sessions: device times not measured)")
    return None


def kernel_name(name: str) -> str:
    """A traced kernel's name without its namespace and parameters."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", name)
    return m.group(1) + (m.group(2) or "") if m else name


def device_ms_by_kernel(fn, calls: int = 10):
    """Device ms per call of fn(), by kernel name; None if not measured."""
    p = kernel_profile(fn, calls)
    return None if p is None else {name: ms for name, (ms, _) in p.items()}


def device_ms(fn, calls: int = 10):
    """Device ms per call of fn(): every traced kernel's time, summed; None
    if not measured."""
    by_name = device_ms_by_kernel(fn, calls)
    return None if by_name is None else sum(by_name.values())


def bound(nbytes: float, flops: float):
    """(bound ms, what sets it) for a call that moves nbytes and does flops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matern_bound(B: int, N: int, M, D: int = DIM):
    """The forward's bound: K written once, theta, X and Y read once; per
    element 4 D FP32 operations for the distance (sub, mul, fma) and ~8 for
    the map."""
    m = N if M is None else M
    return bound(4 * (B * N * m + B * D + N * D + (0 if M is None else m * D)),
                 B * N * m * (4 * D + 8))


def matern_bwd_bound(B: int, N: int, M, need, D: int = DIM):
    """The backward's bound: G read once, theta, X, Y read once, the asked
    gradients written once; per element 4 D + 9 operations for the distance,
    the map's derivative and A, 4 D for dtheta, 2 D for each of dX, dY."""
    m = N if M is None else M
    out = need[0] * B * D + need[1] * N * D + (need[2] and M is not None) * m * D
    per = 4 * D + 9 + 4 * D * need[0] + 2 * D * (need[1] + need[2])
    return bound(4 * (B * N * m + B * D + N * D + (0 if M is None else m * D) + out),
                 B * N * m * per)


def whiten_bound(batch: int, n: int, mb: int):
    """whiten_fused's bound: R and B read, L, W, Dinv and piv written; the
    Cholesky (n^3/3), the forward solve (n^2 mb) and the 128-block inverses
    (T^3/3 each), per matrix."""
    T = min(n, 128)
    return bound(4 * batch * (n * n + n * mb + n * n + n * mb + n * T + 1),
                 batch * (n ** 3 / 3 + n * n * mb + (n // T) * T ** 3 / 3))


WHITEN_PARTS = (("diagonal", "chol_diag_kernel"), ("panel", "panel_solve_kernel"),
                ("trailing", "trailing_update_kernel"))


def whiten_split(fn, calls: int = 10):
    """whiten_fused's device ms per call split into its three kernels (by
    name), and what else the call ran on the device (the workspace copies);
    None if not measured."""
    by_name = device_ms_by_kernel(fn, calls)
    if by_name is None:
        return None
    split = dict.fromkeys([part for part, _ in WHITEN_PARTS] + ["other"], 0.0)
    for name, ms in by_name.items():
        part = next((p for p, k in WHITEN_PARTS if k in name), "other")
        split[part] += ms
    return split


def bench_raw(n: int):
    """bench.py's problem: X ~ U[0,1]^5, y = sum(sin(3x)) + noise."""
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, (n, DIM))
    return X, np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n)


def bench_data(n: int):
    """bench.py's problem, y standardized."""
    X, y = bench_raw(n)
    return X, (y - y.mean()) / y.std()


def held_out(k: int):
    """k fresh points of the noiseless function, in the standardisation of
    bench_data(1000)."""
    _, y0 = bench_raw(1000)
    X = np.random.default_rng(5).uniform(0, 1, (k, DIM))
    return X, (np.sin(3 * X).sum(1) - y0.mean()) / y0.std()


def kernel_like(batch: int, n: int, seed: int) -> torch.Tensor:
    """SPD correlation matrices like the GP's (Matern-3/2 on random points),
    with the 1e-2 jitter of the matrices tests/test_pallas.py holds
    whiten_fused to (the W tolerance assumes that conditioning)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.rand((n, DIM), generator=g, device="cuda")
    theta = 10 ** (torch.rand((batch, DIM), generator=g, device="cuda") * 2 - 1)
    R = matern_plain(theta, X, nu=1.5)
    return R + 1e-2 * torch.eye(n, device="cuda")


def matern_inputs(B: int, N: int, M, seed: int = 0, D: int = DIM):
    """(theta, X, Y) for a main-path shape: the training matrix of B lanes
    (theta (B, D), Y None) or the argmax's cross matrix (theta (D,), or
    (B, D) for an ensemble's B members)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.rand((N, D), generator=g, device="cuda")
    Y = None if M is None else torch.rand((M, D), generator=g, device="cuda")
    theta = 10 ** (torch.rand((B, D), generator=g, device="cuda") * 2 - 1)
    if M is None:
        return theta, X
    return (theta[0].contiguous() if B == 1 else theta), X, Y


def shape_row(label, B, N, M, D, err, t_k, t_p, b_ms, b_by, d_k, d_p) -> dict:
    """One shape's numbers for the kernels' JSON line: ms a call by events
    (kernel and twin), ms on the device, and the bound."""
    return {"path": label, "shape": [B, N, N if M is None else M, D], "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "device_ms": d_k, "plain_device_ms": d_p, "bound_ms": b_ms,
            "bound_by": b_by}


def check_matern():
    """The forward at every main-path shape and nu against the twin; at
    nu = 3/2 its times and share of the bound. Returns (worst error, per-call
    ms, twin per-call ms, bound ms, bound_by) at the headline shape, and the
    rows of the batch and engine paths' shapes."""
    worst, head, rows = 0.0, None, []
    for label, B, N, M, D in MATERN_SHAPES:
        args = matern_inputs(B, N, M, D=D)
        err = 0.0
        for nu in (0.5, 1.5, 2.5, math.inf):
            K = matern_fused(*args, nu=nu)
            K0 = matern_plain(*args, nu=nu)
            torch.cuda.synchronize()
            err_nu = float((K - K0).abs().max())
            err, worst = max(err, err_nu), max(worst, err_nu)
            assert err_nu < MATERN_TOL, (nu, label, err_nu)
            if M is None:
                assert float((K.diagonal(dim1=-2, dim2=-1) - 1).abs().max()) == 0.0
        t_k = time_ms(lambda: matern_fused(*args, nu=1.5))
        d_k = device_ms(lambda: matern_fused(*args, nu=1.5))
        d_p = device_ms(lambda: matern_plain(*args, nu=1.5))
        b_ms, b_by = matern_bound(B, N, M, D)
        if label in NEW_SHAPES:
            rows.append(shape_row(label, B, N, M, D, err, t_k,
                                  time_ms(lambda: matern_plain(*args, nu=1.5)), b_ms, b_by, d_k, d_p))
        log(f"  matern_fused {label} ({B}, {N}, {N if M is None else M}, D={D}): max|K-K_twin| over the "
            f"four maps {err:.3e} (tol {MATERN_TOL}); nu=1.5: kernel {t_k:.4f} ms/call "
            f"({fmt(d_k)} ms on the device), bound {b_ms:.3g} ms ({b_by}), share of bound "
            f"{fmt(ratio(b_ms, d_k), '.3f')}; twin {fmt(d_p)} ms on the device")
        if label == "headline":
            for nu in (0.5, 2.5, math.inf):
                d_nu = device_ms(lambda: matern_fused(*args, nu=nu))
                log(f"    nu={nu}: kernel {fmt(d_nu)} ms on the device")
            head = (worst, t_k, time_ms(lambda: matern_plain(*args, nu=1.5)), b_ms, b_by)
    return head, rows


# (label, B, N, M or None, gradients asked, D): the backward's main-path
# calls (the fit asks for theta alone, the argmax for the query points
# alone), then the batch and engine paths' query shapes, the parity configs'
# small-bucket fits and the mixed space's fit (D = 6, the training matrix's
# own compile-time variant)
_DX = (False, True, False)
_DTHETA = (True, False, False)
MATERN_BWD_SHAPES = (("warm refit", 2, 1024, None, (True, False, False), DIM),
                     ("cold ladder rung 1", 10, 256, None, (True, False, False), DIM),
                     ("cold ladder rung 2", 6, 512, None, (True, False, False), DIM),
                     ("argmax trip", 1, 25, 1024, _DX, DIM),
                     ("batched BFGS trip, q=8 x 25", 1, 200, 1024, _DX, DIM),
                     ("CMA/SMC generation", 1, 32, 1024, _DX, DIM),
                     ("MIES generation, 5 restarts", 1, 50, 1024, _DX, MIXED_D),
                     ("MIES generation, 6 restarts", 1, 60, 1024, _DX, MIXED_D),
                     ("config 3 fit, bucket 16", 10, 16, None, _DTHETA, DIM),
                     ("config 3 fit, bucket 64", 10, 64, None, _DTHETA, DIM),
                     ("config 4 fit, bucket 16", 10, 16, None, _DTHETA, MIXED_D),
                     ("config 4 fit, bucket 64", 10, 64, None, _DTHETA, MIXED_D),
                     ("mixed fit rung 1", 10, 256, None, _DTHETA, MIXED_D),
                     ("mixed fit rung 2", 6, 512, None, _DTHETA, MIXED_D),
                     ("mixed fit final", 2, 1024, None, _DTHETA, MIXED_D),
                     ("CMA fit on the mixed space", 10, 1024, None, _DTHETA, MIXED_D),
                     ("sampler leapfrog, warm-up subset", 8, 256, None, _DTHETA, DIM),
                     ("sampler leapfrog, ensemble state", 8, 1024, None, _DTHETA, DIM),
                     ("ensemble predict, argmax trip", 8, 25, 1024, _DX, DIM),
                     ("config 6 fit, bucket 16", 10, 16, None, _DTHETA, 2),
                     ("config 6 argmax trip", 1, 10, 16, _DX, 2),
                     ("config 5 argmax trip, bucket 64", 1, 25, 64, _DX, DIM),
                     # 7 and 8 features, where ptxas reports spills: the fit's
                     # dtheta at n=1024 and an argmax trip's dX
                     ("fit at D = 7, n=1024", 2, 1024, None, _DTHETA, 7),
                     ("argmax trip at D = 7", 1, 25, 1024, _DX, 7),
                     ("fit at D = 8, n=1024", 2, 1024, None, _DTHETA, 8),
                     ("argmax trip at D = 8", 1, 25, 1024, _DX, 8))


# the backward's device ms a call before its one-launch redesign (PERF.md
# section 6, PR 9's table: two launches, the kernel and its finalize; a
# range where PERF.md gives one row for several shapes), by path label
PRE_PR10_BWD_MS = {
    "warm refit": "0.0083", "cold ladder rung 1": "0.0060-0.0062", "cold ladder rung 2": "0.0074",
    "argmax trip": "0.0058-0.0064", "batched BFGS trip, q=8 x 25": "0.0058-0.0064",
    "CMA/SMC generation": "0.0058-0.0064", "MIES generation, 5 restarts": "0.0058-0.0064",
    "MIES generation, 6 restarts": "0.0058-0.0064", "config 3 fit, bucket 16": "0.0044-0.0109",
    "config 3 fit, bucket 64": "0.0044-0.0109", "config 4 fit, bucket 16": "0.0044-0.0109",
    "config 4 fit, bucket 64": "0.0044-0.0109", "mixed fit rung 1": "0.0044-0.0109",
    "mixed fit rung 2": "0.0044-0.0109", "mixed fit final": "0.0044-0.0109",
    "CMA fit on the mixed space": "0.0331", "sampler leapfrog, warm-up subset": "0.0055-0.0056",
    "sampler leapfrog, ensemble state": "0.0219-0.0241", "ensemble predict, argmax trip": "0.0089-0.0092",
    "config 6 fit, bucket 16": "0.0040", "config 6 argmax trip": "0.0044",
    "config 5 argmax trip, bucket 64": "0.0058", "fit at D = 7, n=1024": "not measured",
    "argmax trip at D = 7": "not measured", "fit at D = 8, n=1024": "not measured",
    "argmax trip at D = 8": "not measured"}
# the second derivative's, one block a row (PERF.md section 6, PR 7-9)
PRE_PR10_BWD2_MS = {"Hessian, n=1000": "0.0052-0.0056", "Hessian, ensemble of 8": "0.0288-0.0291"}
REPEATS = 100  # calls in a row that must give the same bits


def bit_identical_repeats(fn, label: str) -> None:
    """REPEATS calls of fn() in a row, then fn() on two side streams in
    flight at once (each stream with its own arrival counters), all
    bit-identical to a first call: the last block's fixed-order sum, and the
    counter left at 0 by every call."""
    first = fn()
    outs = [fn() for _ in range(REPEATS)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(5):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(fn())
    torch.cuda.synchronize()
    for out in outs:
        for a, b in zip(first, out):
            assert (a is None and b is None) or torch.equal(a, b), f"not bit-identical ({label})"


def check_matern_bwd():
    """The backward kernel against matern_bwd_plain: the twin in float64 is
    the yardstick (the float32 twin's GEMM expansion of r2 cancels, worst
    near r = 0 for nu = 1/2; its error is printed beside);
    two calls bit-identical, and at nu = 3/2 REPEATS calls and calls on two
    streams; at nu = 3/2 the kernel launches a call (the profiler's count,
    one), the device ms of the kernel beside its pre-PR-10 figure, and of
    the torch backward it replaces. G is masked as _masked_correlation
    masks it. Returns (worst abs error, per-call ms, twin per-call ms, bound
    ms, bound_by) at the warm refit's shape, and the rows of the batch and
    engine paths' shapes."""
    worst, head, rows = 0.0, None, []
    for label, B, N, M, need, D in MATERN_BWD_SHAPES:
        theta, X, *rest = matern_inputs(B, N, M, seed=1, D=D)
        theta = theta.reshape(-1, D)
        Y = rest[0] if rest else X
        same = M is None
        g = torch.Generator(device="cuda").manual_seed(2)
        G = torch.randn((B, N, Y.shape[0]), generator=g, device="cuda")
        if same:
            mask = (torch.arange(N, device="cuda") < N - min(24, N // 4)).float()
            G = G * (torch.outer(mask, mask) * (1 - torch.eye(N, device="cuda")))
        errs, shape_err = [], 0.0
        for nu in (0.5, 1.5, 2.5, math.inf):
            code = _nu_code(nu)
            got = matern_bwd_fused(theta, X, Y, G, code, same, same, need)
            again = matern_bwd_fused(theta, X, Y, G, code, same, same, need)
            K64 = matern_plain(theta.double(), X.double(), Y.double(), nu=nu, sym=same)
            want = matern_bwd_plain(theta.double(), X.double(), Y.double(), K64, G.double(), code,
                                    same, same, need)
            K32 = matern_plain(theta, X, Y, nu=nu, sym=same)
            want32 = matern_bwd_plain(theta, X, Y, K32, G, code, same, same, need)
            torch.cuda.synchronize()
            for a, a2, w, w32 in zip(got, again, want, want32):
                if w is None:
                    assert a is None
                    continue
                assert torch.equal(a, a2), f"backward not bit-identical ({label}, nu={nu})"
                scale = float(w.abs().max())
                rel, rel32 = (float((a.double() - w).abs().max()) / scale,
                              float((w32.double() - w).abs().max()) / scale)
                worst = max(worst, float((a.double() - w).abs().max()))
                shape_err = max(shape_err, float((a.double() - w).abs().max()))
                errs.append(f"nu={nu} {rel:.2e} (float32 twin {rel32:.2e})")
                assert rel < MATERN_BWD_TOL, (label, nu, rel)
        code = _nu_code(1.5)
        bit_identical_repeats(lambda: matern_bwd_fused(theta, X, Y, G, code, same, same, need), label)
        K32 = matern_plain(theta, X, Y, nu=1.5, sym=same)
        t_k = time_ms(lambda: matern_bwd_fused(theta, X, Y, G, code, same, same, need))
        t_p = time_ms(lambda: matern_bwd_plain(theta, X, Y, K32, G, code, same, same, need))
        p_k = kernel_profile(lambda: matern_bwd_fused(theta, X, Y, G, code, same, same, need))
        p_p = kernel_profile(lambda: matern_bwd_plain(theta, X, Y, K32, G, code, same, same, need))
        (d_k, n_k), (d_p, n_p) = ((None, None) if p is None else
                                  [sum(v[i] for v in p.values()) for i in (0, 1)]
                                  for p in (p_k, p_p))
        b_ms, b_by = matern_bwd_bound(B, N, M, need, D)
        if label in NEW_SHAPES:
            rows.append(shape_row(label, B, N, M, D, shape_err, t_k, t_p, b_ms, b_by, d_k, d_p))
        asked = "/".join(n for n, f in zip(("theta", "X", "Y"), need) if f)
        log(f"  matern backward {label} ({B}, {N}, {Y.shape[0]}, D={D}), d{asked}: rel err against the "
            f"float64 twin {'; '.join(errs)} (tol {MATERN_BWD_TOL}); bit-identical repeats "
            f"({REPEATS} calls, two streams); nu=1.5: kernel {t_k:.4f} ms/call ({fmt(d_k)} ms on the "
            f"device, pre-PR-10 {PRE_PR10_BWD_MS[label]}; {fmt(n_k, 'g')} launches a call: "
            + ", ".join(f"{kernel_name(name)} {v[0]:.4f}" for name, v in (p_k or {}).items())
            + f"), bound {b_ms:.3g} ms ({b_by}), share of bound {fmt(ratio(b_ms, d_k), '.3f')}; torch "
            f"backward {t_p:.4f} ms/call ({fmt(d_p)} ms on the device in {fmt(n_p, 'g')} launches)")
        if label == "warm refit":
            head = (worst, t_k, t_p, b_ms, b_by)
    return head, rows


# (label, B, N, M, D): a Hessian's cross matrix, one query against the
# padded training rows, for one theta and for an ensemble's 8 members
MATERN_BWD2_SHAPES = (("Hessian, n=1000", 1, 1, 1024, DIM), ("Hessian, ensemble of 8", 8, 1, 1024, DIM))


def matern_bwd2_bound(B: int, N: int, M: int, D: int = DIM):
    """The second derivative's bound: G read and gG written once, theta, X,
    Y and V read once, gX written once; per element 4 D operations for r2
    and c, ~15 for the map's two derivatives and the scalars, 4 D for gX."""
    return bound(4 * (2 * B * N * M + B * D + 3 * N * D + M * D), B * N * M * (8 * D + 15))


def check_matern_bwd2():
    """The second-derivative kernel against matern_bwd2_plain: the twin in
    float64 is the yardstick (the float32 twin's error printed beside), both
    outputs (gG, gX), every map; two calls bit-identical, and at nu = 3/2
    REPEATS calls and calls on two streams; at nu = 3/2 the kernel's
    launches a call (the profiler's count, one), its and the float32 twin's
    ms a call and on the device, beside the pre-PR-10 figure and the bound.
    Returns (worst abs error, ms, twin ms, bound ms, bound_by) at the first
    shape, and every shape's row."""
    worst, head, rows = 0.0, None, []
    for label, B, N, M, D in MATERN_BWD2_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(3)
        theta = 10 ** (torch.rand((B, D), generator=g, device="cuda") * 2.5 - 1)
        X, Y = (torch.rand((k, D), generator=g, device="cuda") for k in (N, M))
        G = torch.randn((B, N, M), generator=g, device="cuda")
        V = torch.randn((N, D), generator=g, device="cuda")
        errs, shape_err = [], 0.0
        for nu in (0.5, 1.5, 2.5, math.inf):
            code = _nu_code(nu)
            got = matern_bwd2_fused(theta, X, Y, G, V, code, False, (True, True))
            again = matern_bwd2_fused(theta, X, Y, G, V, code, False, (True, True))
            want = matern_bwd2_plain(*(t.double() for t in (theta, X, Y, G, V)), code, False,
                                     (True, True))
            want32 = matern_bwd2_plain(theta, X, Y, G, V, code, False, (True, True))
            torch.cuda.synchronize()
            for name, a, a2, w, w32 in zip(("gG", "gX"), got, again, want, want32):
                assert torch.equal(a, a2), f"second derivative not bit-identical ({label}, nu={nu})"
                scale = float(w.abs().max())
                e = float((a.double() - w).abs().max())
                rel, rel32 = e / scale, float((w32.double() - w).abs().max()) / scale
                worst, shape_err = max(worst, e), max(shape_err, e)
                errs.append(f"nu={nu} {name} {rel:.2e} (float32 twin {rel32:.2e})")
                assert rel < MATERN_BWD_TOL, (label, nu, name, rel)
        code = _nu_code(1.5)

        def kernel():
            return matern_bwd2_fused(theta, X, Y, G, V, code, False, (True, True))

        def twin():
            return matern_bwd2_plain(theta, X, Y, G, V, code, False, (True, True))

        bit_identical_repeats(kernel, label)
        t_k, t_p = time_ms(kernel), time_ms(twin)
        p_k = kernel_profile(kernel)
        d_k, n_k = (None, None) if p_k is None else [sum(v[i] for v in p_k.values()) for i in (0, 1)]
        d_p = device_ms(twin)
        b_ms, b_by = matern_bwd2_bound(B, N, M, D)
        rows.append(shape_row(label, B, N, M, D, shape_err, t_k, t_p, b_ms, b_by, d_k, d_p))
        log(f"  matern second derivative {label} ({B}, {N}, {M}, D={D}): rel err against the float64 "
            f"twin {'; '.join(errs)} (tol {MATERN_BWD_TOL}); bit-identical repeats ({REPEATS} calls, "
            f"two streams); nu=1.5: kernel {t_k:.4f} ms/call ({fmt(d_k)} ms on the device, pre-PR-10 "
            f"{PRE_PR10_BWD2_MS[label]}; {fmt(n_k, 'g')} launches a call), bound {b_ms:.3g} ms "
            f"({b_by}), share of bound {fmt(ratio(b_ms, d_k), '.3f')}; float32 twin {t_p:.4f} ms/call "
            f"({fmt(d_p)} ms on the device)")
        if head is None:
            head = (worst, t_k, t_p, b_ms, b_by)
    return head, rows


def log_whiten_split(label: str, split, nb: int) -> None:
    if split is None:
        log(f"  whiten_fused {label} device split: not measured")
        return
    log(f"  whiten_fused {label} device split: " + ", ".join(
        f"{part} {ms:.4f} ms" for part, ms in split.items())
        + f"; diagonal {split['diagonal'] * 1e3 / nb:.2f} us per 128 block")


def check_whiten():
    """whiten_fused against its twin at every path's (batch, n); returns the
    worst absolute error, the (2, 1024) numbers and the rows of the
    samplers' 8-chain shapes."""
    worst, head, rows = 0.0, None, []
    # (batch, n, right-hand sides): the MLE ladder's lanes at each
    # bucket/rung size, ragged blocks (any n <= 128 is one block of width
    # n), and the samplers' 8 chains on the n/4 warm-up subset and on all
    # rows, with y and the constant trend (2); then the multi-output fits'
    # rungs: m objectives and the trend (m + 1 = 3 and 4)
    for batch, n, mb in ((10, 16, 2), (10, 37, 2), (10, 64, 2), (10, 100, 2), (2, 128, 2),
                         (10, 256, 2), (6, 512, 2), (2, 1024, 2), (10, 1024, 2), (8, 256, 2),
                         (8, 1024, 2), (10, 256, 3), (6, 512, 3), (2, 1024, 3), (10, 512, 4),
                         (2, 1024, 4)):
        R = kernel_like(batch, n, seed=n + batch)
        B = torch.randn((batch, n, mb), device="cuda", generator=torch.Generator(device="cuda").manual_seed(n))
        R_before = R.clone()
        d, W, piv, L, Dinv = whiten_fused(R, B)
        torch.cuda.synchronize()
        assert torch.equal(R, R_before), "whiten_fused wrote the caller's R"
        d0, W0, piv0, L0, Dinv0 = whiten_plain(R, B)
        errL = float((L - L0).abs().max() / L0.abs().max())
        errW = float((W - W0).abs().max()) / max(1.0, float(W0.abs().max()))
        worst = max(worst, float((L - L0).abs().max()), float((W - W0).abs().max()))
        t_k = time_ms(lambda: whiten_fused(R, B))
        t_p = time_ms(lambda: whiten_plain(R, B))
        d_k = device_ms(lambda: whiten_fused(R, B))
        d_p = device_ms(lambda: whiten_plain(R, B))
        b_ms, b_by = whiten_bound(batch, n, B.shape[-1])
        log(f"  whiten_fused ({batch}, {n}, {n}) x {mb} right-hand sides: relerr L {errL:.3e} (tol {WHITEN_L_TOL}), "
            f"W {errW:.3e} (tol {WHITEN_W_TOL}), min piv {float(piv.min()):.3e}; "
            f"kernel {t_k:.4f} ms/call ({fmt(d_k)} ms on the device), bound {b_ms:.4f} ms "
            f"({b_by}), share of bound {fmt(ratio(b_ms, d_k), '.3f')}; "
            f"twin {t_p:.4f} ms/call ({fmt(d_p)} ms on the device)")
        assert errL < WHITEN_L_TOL and errW < WHITEN_W_TOL, (n, errL, errW)
        assert bool((piv > 0).all()) and Dinv.shape == Dinv0.shape
        if batch == 8 or mb > 2:  # "shape" [batch, n, n, right-hand sides]
            label = f"sampler leapfrog, {n} rows" if batch == 8 else f"{mb - 1}-output fit, {n} rows"
            rows.append(shape_row(label, batch, n, None, mb,
                                  max(float((L - L0).abs().max()), float((W - W0).abs().max())),
                                  t_k, t_p, b_ms, b_by, d_k, d_p))
        if n == 1024 and mb == 2:
            log_whiten_split(f"({batch}, {n}, {n})", whiten_split(lambda: whiten_fused(R, B)), n // 128)
        if (batch, n, mb) == (2, 1024, 2):
            # no single PyTorch call computes (L, W, Dinv, piv); the Cholesky
            # alone is a subset of the work, timed as a yardstick only
            t_c = time_ms(lambda: torch.linalg.cholesky_ex(R))
            d_c = device_ms(lambda: torch.linalg.cholesky_ex(R))
            log(f"    torch.linalg.cholesky_ex alone (a subset of the work, not a port call): "
                f"{t_c:.4f} ms/call ({fmt(d_c)} ms on the device)")
            head = (t_k, t_p, b_ms, b_by)
    # _factor_hybrid's first superpanel at n=4096: S (2, 1024, 1024) against
    # [C^T, y], C the (3072, 1024) subdiagonal panel
    R4 = kernel_like(2, 4096, seed=4)
    S = R4[:, :1024, :1024].contiguous()
    B = torch.cat([R4[:, 1024:, :1024].mT, torch.ones((2, 1024, 1), device="cuda")], dim=-1).contiguous()
    del R4
    d, W, piv, L, Dinv = whiten_fused(S, B)
    d0, W0, piv0, L0, Dinv0 = whiten_plain(S, B)
    errL = float((L - L0).abs().max() / L0.abs().max())
    errW = float((W - W0).abs().max()) / max(1.0, float(W0.abs().max()))
    worst = max(worst, float((L - L0).abs().max()), float((W - W0).abs().max()))
    t_k = time_ms(lambda: whiten_fused(S, B), windows=5, calls=2)
    t_p = time_ms(lambda: whiten_plain(S, B), windows=5, calls=2)
    split = whiten_split(lambda: whiten_fused(S, B), calls=4)
    d_p = device_ms(lambda: whiten_plain(S, B), calls=4)
    log(f"  whiten_fused hybrid panel (2, 1024, 1024) x (2, 1024, {B.shape[-1]}): relerr L "
        f"{errL:.3e} (tol {WHITEN_L_TOL}), W {errW:.3e} (tol {WHITEN_W_TOL}), min piv "
        f"{float(piv.min()):.3e}; kernel {t_k:.4f} ms/call ({fmt(split and sum(split.values()))} ms on "
        f"the device), twin {t_p:.4f} ms/call ({fmt(d_p)} ms on the device)")
    log_whiten_split("hybrid panel", split, 8)
    assert errL < WHITEN_L_TOL and errW < WHITEN_W_TOL, ("hybrid", errL, errW)
    assert bool((piv > 0).all())
    # a failed lane: an indefinite pivot reads as not (piv > 0), a NaN wins
    # the pivot minimum; the healthy lane in the same batch is untouched
    R = kernel_like(3, 256, seed=9)
    R[1, 0, 0] = -1.0
    R[2, 200, 7] = R[2, 7, 200] = math.nan
    _, _, piv, _, _ = whiten_fused(R, torch.ones((3, 256, 1), device="cuda"))
    torch.cuda.synchronize()
    log(f"  whiten_fused failed lanes: indefinite piv = {float(piv[1]):.3e}, NaN piv = "
        f"{float(piv[2])} (healthy lane {float(piv[0]):.3e})")
    assert float(piv[0]) > 0 and not (float(piv[1]) > 0) and math.isnan(float(piv[2]))
    return worst, head, rows


def chol_inv_bound(batch: int, n: int, mb: int):
    """chol_inv_whiten's bound: R and B read, L, L^-1 and W written; the
    Cholesky (n^3/3), the triangular inverse (n^3/3) and the forward solve
    (n^2 mb), per matrix."""
    return bound(4 * batch * (3 * n * n + 2 * n * mb + 1), batch * (2 * n ** 3 / 3 + n * n * mb))


def check_chol_inv_whiten():
    """chol_inv_whiten for the stacked posterior state of 8 members at 1024
    rows (one whiten_fused launch and the block inversion) against its plain
    path (whiten_plain and the same inversion) on the card: L within
    WHITEN_L_TOL, L^-1 within CHOL_INV_TOL relative, W within WHITEN_W_TOL;
    returns its row."""
    R = kernel_like(8, 1024, seed=81)
    B = torch.randn((1024, 2), device="cuda", generator=torch.Generator(device="cuda").manual_seed(81))

    def plain():
        _, W0, piv0, L0, Dinv0 = whiten_plain(R, B.expand(8, 1024, 2))
        return L0, _block_tri_inv(L0, Dinv0), W0, piv0

    L, L_inv, W, piv = chol_inv_whiten(R, B)
    L0, L_inv0, W0, _ = plain()
    torch.cuda.synchronize()
    errs = (float((L - L0).abs().max() / L0.abs().max()),
            float((L_inv - L_inv0).abs().max() / L_inv0.abs().max()),
            float((W - W0).abs().max()) / max(1.0, float(W0.abs().max())))
    t_k = time_ms(lambda: chol_inv_whiten(R, B), windows=5, calls=3)
    t_p = time_ms(plain, windows=5, calls=3)
    d_k = device_ms(lambda: chol_inv_whiten(R, B), calls=3)
    d_p = device_ms(plain, calls=3)
    b_ms, b_by = chol_inv_bound(8, 1024, 2)
    log(f"  chol_inv_whiten (8, 1024, 1024), the stacked posterior state: relerr L {errs[0]:.3e} (tol "
        f"{WHITEN_L_TOL}), L^-1 {errs[1]:.3e} (tol {CHOL_INV_TOL}), W {errs[2]:.3e} (tol {WHITEN_W_TOL}); "
        f"{t_k:.4f} ms/call ({fmt(d_k)} ms on the device), bound {b_ms:.4f} ms ({b_by}), share of bound "
        f"{fmt(ratio(b_ms, d_k), '.3f')}; plain path {t_p:.4f} ms/call ({fmt(d_p)} ms on the device)")
    assert errs[0] < WHITEN_L_TOL and errs[1] < CHOL_INV_TOL and errs[2] < WHITEN_W_TOL, errs
    assert bool((piv > 0).all())
    return shape_row("chol_inv_whiten, ensemble state", 8, 1024, None, 2,
                     max(float((L - L0).abs().max()), float((W - W0).abs().max())),
                     t_k, t_p, b_ms, b_by, d_k, d_p)


def padded(X, y, n_pad: int):
    n = X.shape[0]
    Xp = np.zeros((n_pad, X.shape[1]))
    Xp[:n] = X
    Yp = np.zeros((n_pad, 1))
    Yp[:n, 0] = y
    mask = np.zeros(n_pad)
    mask[:n] = 1.0
    return Xp, Yp, mask


def likelihood_vs_cpu(X, y, n_pad: int, pars: np.ndarray, noise_var: float = 1e-6,
                      f64: bool = False, config: GPConfig = GPConfig()) -> dict:
    """The concentrated likelihood and its gradient for a batch of restart
    lanes at fixed log10 parameters, on the card (both kernels and both
    backwards) and on the plain path on the CPU: "err_v" and "err_g", the
    errors relative to the CPU's largest magnitude; "abs_g", the gradient's
    largest absolute error, and "scale_g", the CPU gradient's largest entry;
    "nll", the card's values. With f64, the plain path also runs in float64
    on the CPU, the yardstick of both float32 paths: "err_v64" and
    "err_v64_cpu" the card's and the CPU's value errors relative to it,
    "abs_g64" the card's largest absolute gradient error against it,
    "abs_g64_cpu" the CPU's."""
    n = X.shape[0]
    Xp, Yp, mask = padded(X, y, n_pad)
    out = {}
    runs = [("cuda", torch.float32), ("cpu", torch.float32)] + [("cpu", torch.float64)] * f64
    for dev, dt in runs:
        def t(a):
            return torch.tensor(a, dtype=dt, device=dev)

        p = t(pars).requires_grad_(True)
        v = neg_log_likelihood(p, t(Xp), t(Yp), t(mask[:, None]), t(mask), n, noise_var,
                               t(np.zeros((1, 1))), config)
        (g,) = torch.autograd.grad(v.sum(), p)
        out[dev, dt] = (v.detach().cpu().double().numpy(), g.cpu().double().numpy())
    (v_k, g_k), (v_p, g_p) = out["cuda", torch.float32], out["cpu", torch.float32]
    scale_g = float(np.abs(g_p).max())
    res = {"err_v": float(np.abs(v_k - v_p).max() / np.abs(v_p).max()),
           "err_g": float(np.abs(g_k - g_p).max()) / scale_g,
           "abs_g": float(np.abs(g_k - g_p).max()), "scale_g": scale_g, "nll": v_k}
    if f64:
        v64, g64 = out["cpu", torch.float64]
        res["err_v64"], res["err_v64_cpu"] = (float(np.abs(v - v64).max() / np.abs(v64).max())
                                              for v in (v_k, v_p))
        res["abs_g64"], res["abs_g64_cpu"] = (float(np.abs(g - g64).max()) for g in (g_k, g_p))
    return res


def lanes(rng, k: int) -> np.ndarray:
    """k log10 parameter rows (theta in [1e-1, 1e2], noise in [1e-5, 1e-1])."""
    return np.c_[rng.uniform(-1.0, 2.0, (k, DIM)), rng.uniform(-5.0, -1.0, k)]


def check_reference():
    """The card's likelihood and gradient against the plain path on the CPU,
    for four restart lanes at n=200 (bucket 256)."""
    X, y = bench_data(200)
    r = likelihood_vs_cpu(X, y, 256, lanes(np.random.default_rng(3), 4))
    err_v, err_g = r["err_v"], r["err_g"]
    log(f"  likelihood at 4 lanes, n=200 (bucket 256): rel err value {err_v:.3e} (tol 1e-4), "
        f"gradient {err_g:.3e} (tol 1e-3)")
    assert err_v < 1e-4 and err_g < 1e-3, (err_v, err_g)


def main_path(X, y):
    gp = GaussianProcess(
        mean=constant_trend(DIM), corr="matern",
        thetaL=1e-3 * np.ones(DIM), thetaU=1e3 * np.ones(DIM),
        nugget=1e-6, random_start=10, random_state=0,
    )
    argmax = AcquisitionArgmax(RealSpace([[0.0, 1.0]] * DIM).encoding(), method="BFGS",
                               n_restart=5 * DIM, seed=0)
    out = {}

    def one_iter():
        """One BO iteration; returns (fit seconds, argmax seconds)."""
        t0 = time.perf_counter()
        gp.fit(X, y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["u"], out["val"] = argmax(gp.posterior, gp.config, "EI", {"plugin": float(y.min())})
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    reset_launch_counts()
    cold = one_iter()  # cold fit: the full MLE ladder
    one_iter()  # the warm-refit path, first time
    parts = [one_iter() for _ in range(3)]
    launches = counts()
    return gp, out, cold, parts, launches


def counts() -> dict:
    return {"matern_fused": matern_fused.launches, "matern_fused_bwd": matern_fused.bwd_launches,
            "matern_fused_bwd2": matern_fused.bwd2_launches, "whiten_fused": whiten_fused.launches}


def live(c: dict) -> bool:
    """Whether each kernel of a GP path launched: the Matern forward and
    backward and the factorisation (the second derivative belongs to the
    Hessian's path alone, 13c)."""
    return all(c[k] > 0 for k in ("matern_fused", "matern_fused_bwd", "whiten_fused"))


def profiled(fn, by_name=None):
    """(result, device ms, kernel launches, wall s) of one call of fn under
    the profiler: every traced kernel's duration summed, their count (both
    None if the session traced no kernel), and the call's wall time with the
    profiler on (longer than without it). A dict `by_name` receives each
    kernel name's device ms."""
    res = {}

    def call():
        t0 = time.perf_counter()
        res["out"] = fn()
        torch.cuda.synchronize()
        res["wall"] = time.perf_counter() - t0

    torch.cuda.synchronize()
    kernels = traced_kernels(call)
    if not kernels:
        log("  (the profiler traced no kernel in this call: its device time is not measured)")
        return res["out"], None, None, res["wall"]
    for e in kernels if by_name is not None else ():
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return res["out"], sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels), res["wall"]


def idle_share(dev_ms, wall_s):
    """1 - device time / wall time; None if the device time was not measured."""
    return None if dev_ms is None else 1 - dev_ms / (wall_s * 1e3)


def timed(fn):
    """(result, seconds) of one call of fn, to the device's last kernel."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def on_cpu(gp):
    """The card's fitted posterior carried into a CPU model (the plain path)."""
    d = gp.theta_.shape[0]
    cpu = GaussianProcess(thetaL=1e-3 * np.ones(d), thetaU=1e3 * np.ones(d), device="cpu")
    return cpu.load_fitted(gp.theta_, {k: v.cpu().numpy() for k, v in gp.posterior._asdict().items()},
                           gp.config._asdict())


def cpu_values(model, enc, acq, params, U, dtype=torch.float32, prior=None) -> np.ndarray:
    """The CPU path's criterion at unit points U (k, dim) from a model's
    state (a GP's posterior or a forest's RFState) carried to the CPU in
    `dtype` (widened from float32 for float64), with a NonparametricTrend
    forest `prior` carried too."""
    def carry(state):
        moved = type(state)(*(t.cpu() for t in state))
        if isinstance(moved, RFState):  # the thresholds stay as grown
            return moved._replace(value=moved.value.to(dtype))
        return type(state)(*(t.to(dtype) for t in moved))

    params = {k: torch.tensor(v, dtype=dtype) for k, v in params.items()}
    if prior is not None:
        params.update(_prior_state=carry(prior.posterior), _prior_depth=prior.config.max_depth)
    crit = make_unit_criterion(type(enc)(enc.space, dtype=dtype), carry(model.posterior),
                               model.config, acq, params)
    with torch.no_grad():
        return crit(torch.tensor(np.atleast_2d(U), dtype=dtype)).double().numpy()


def check_against_cpu(label, values, cpu_vals, tol: float = 1e-4, cpu64=None) -> float:
    """The card's criterion values against the CPU path's at the card's
    winners, within tol relative; with cpu64 (the CPU path in float64) the
    yardstick is float64 instead, the CPU float32 path's error printed
    beside."""
    values = np.asarray(values)
    rel = float(np.max(np.abs(values - cpu_vals) / np.abs(cpu_vals).clip(1e-30)))
    if cpu64 is None:
        log(f"  {label}: the CPU path's criterion at the card's winners, max rel err {rel:.3e} (tol {tol})")
        assert np.all(np.isfinite(values)) and rel < tol, (label, values, cpu_vals)
        return rel
    err, err_cpu = (float(np.max(np.abs(v - cpu64) / np.abs(cpu64).clip(1e-30))) for v in (values, cpu_vals))
    log(f"  {label}: the criterion at the card's winners against the CPU path in float64: the card "
        f"{err:.3e} (tol {tol}), the CPU float32 path {err_cpu:.3e}; card against CPU float32 {rel:.3e}")
    assert np.all(np.isfinite(values)) and err < tol, (label, values, cpu_vals, cpu64)
    return err


def parallel_ask(X, y, paths: dict) -> dict:
    """(a) ParallelBO's ask at bench size: a fit plus the batch argmax of
    Q = 8 MGFI criteria, t from ParallelBO's sampler, 25 restarts each, as
    one L-BFGS over 200 lanes; 2 warm-ups, then 3 timed reps. Beside it one
    q = 1 MGFI ask on the same posterior. Then, from one fixed pool of
    starts and a posterior carried to the CPU, the card's per-criterion
    values against the CPU path."""
    enc = RealSpace([[0.0, 1.0]] * DIM).encoding()
    gp = GaussianProcess(mean=constant_trend(DIM), corr="matern", thetaL=1e-3 * np.ones(DIM),
                         thetaU=1e3 * np.ones(DIM), nugget=1e-6, random_start=10, random_state=0)
    argmax = AcquisitionArgmax(enc, method="BFGS", n_restart=25, seed=0)
    rng, plugin = np.random.default_rng(0), float(y.min())

    def pars():
        return [{"plugin": plugin, "t": _sample_t(rng, {"t": 2.0})} for _ in range(Q)]

    reset_launch_counts()
    reps = []
    for _ in range(5):
        _, fit_s = timed(lambda: gp.fit(X, y))
        c0 = counts()
        (us, vals), ask_s = timed(lambda: argmax.batch(gp.posterior, gp.config, "MGFI", pars()))
        c1 = counts()
        reps.append((fit_s, ask_s, c1["matern_fused_bwd"] - c0["matern_fused_bwd"]))
    paths["parallel_bo_q8"] = counts()
    assert live(paths["parallel_bo_q8"]), paths["parallel_bo_q8"]
    assert len(us) == Q and len({tuple(np.round(u, 6)) for u in us}) > 1 and np.all(np.isfinite(vals))
    t = reps[2:]
    asks = [a for _, a, _ in t]
    trips = [n for _, _, n in t]
    log(f"[7] (a) ParallelBO ask, n={len(X)} d=5, q={Q} MGFI x 25 restarts: fit + batch argmax median "
        f"{statistics.median([f + a for f, a, _ in t]):.4f} s, min {min(f + a for f, a, _ in t):.4f} s "
        f"over {len(t)} reps; argmax alone median {statistics.median(asks):.4f} s, min {min(asks):.4f} s "
        f"{[round(a, 4) for a in asks]}; fit {[round(f, 4) for f, _, _ in t]} s; L-BFGS trips "
        f"{trips}, ms a trip {[round(a / n * 1e3, 2) for a, n in zip(asks, trips)]}; counters over "
        f"the {len(reps)} iterations {paths['parallel_bo_q8']}")
    # one ask profiled, then the same ask timed: one draw of the t values
    # and one pool of starts (a fresh argmax from one seed), the trips
    # counted in each call
    ps = pars()

    def same_ask():
        return AcquisitionArgmax(enc, method="BFGS", n_restart=25, seed=1).batch(
            gp.posterior, gp.config, "MGFI", ps)

    c0 = counts()
    _, dev_ms, n_k, wall_prof = profiled(same_ask)
    trips_prof = counts()["matern_fused_bwd"] - c0["matern_fused_bwd"]
    c0 = counts()
    _, ask_p = timed(same_ask)
    trips_p = counts()["matern_fused_bwd"] - c0["matern_fused_bwd"]
    log(f"  one ask profiled (t {[round(p['t'], 4) for p in ps]}): {trips_prof} trips, {fmt(n_k, 'g')} "
        f"launches, {fmt(ratio(n_k, trips_prof), '.1f')} a trip, {fmt(dev_ms, '.2f')} ms on the device, "
        f"{wall_prof:.4f} s with the profiler on (idle share {fmt(idle_share(dev_ms, wall_prof), '.3f')}); "
        f"the same ask unprofiled: {ask_p:.4f} s in {trips_p} trips ({ask_p / trips_p * 1e3:.2f} ms a "
        f"trip, idle share {fmt(idle_share(dev_ms, ask_p), '.3f')}"
        f"{'' if trips_p == trips_prof else ', OTHER TRIPS'})")
    one, one_trips = [], []
    for _ in range(2):
        c0 = counts()
        _, a = timed(lambda: argmax(gp.posterior, gp.config, "MGFI", {"plugin": plugin, "t": 2.0}))
        one.append(a)
        one_trips.append(counts()["matern_fused_bwd"] - c0["matern_fused_bwd"])
    log(f"  q=1 MGFI ask on the same posterior: median {statistics.median(one):.4f} s "
        f"{[round(a, 4) for a in one]}, trips {one_trips}; q={Q} costs "
        f"{statistics.median(asks) / statistics.median(one):.2f}x the q=1 ask")
    # fixed starts (4 a criterion), the card's values against the CPU path's
    # criterion at the card's winners, on the posterior carried to the CPU
    pool = np.random.default_rng(7).uniform(0, 1, (4, DIM))
    ps = pars()
    am4 = AcquisitionArgmax(enc, method="BFGS", n_restart=4, seed=0)
    us, vals = am4.batch(gp.posterior, gp.config, "MGFI", ps, x0_seed=pool)
    cpu_gp = on_cpu(gp)
    at_card = np.array([cpu_values(cpu_gp, enc, "MGFI", p, u)[0] for p, u in zip(ps, us)])
    log(f"  fixed pool of 4 starts a criterion: card values {np.round(vals, 6).tolist()}")
    check_against_cpu("batch, 8 criteria", vals, at_card)
    return {"median_s": statistics.median([f + a for f, a, _ in t]), "ask_median_s": statistics.median(asks),
            "q1_median_s": statistics.median(one)}


def engine_runs(gp, X, y, paths: dict):
    """(b) The derivative-free engines at bench size: CMA and SMC on the
    phase-4 posterior (n=1000, d=5), MIES on parity config 4's space with
    1000 observations of mixed_obj; EI each. One warm-up, then one timed
    call with the counters zeroed just before and read just after, and one
    profiled call; each winner against the CPU path's criterion there."""
    enc = RealSpace([[0.0, 1.0]] * DIM).encoding()
    enc_m, X_m, y_m = mixed_data(len(X))
    gp_m = GaussianProcess(mean=constant_trend(MIXED_D), corr="matern",
                           thetaL=1e-3 * np.ones(MIXED_D), thetaU=1e3 * np.ones(MIXED_D),
                           nugget=1e-6, random_start=10, random_state=0)
    reset_launch_counts()
    _, fit_m = timed(lambda: gp_m.fit(X_m, y_m))
    c = paths["mixed_fit"] = counts()
    assert live(c), c
    par = np.r_[np.log10(gp_m.theta_), np.log10(gp_m.sigma2)][None]
    r = likelihood_vs_cpu(X_m, y_m, gp_m.posterior.X.shape[0], par, gp_m.noise_var, f64=True)
    log(f"[8] (b) engines at bench size (EI); the mixed space's fit at n={len(X)}, D={MIXED_D}: "
        f"{fit_m:.4f} s, log-likelihood {gp_m.log_likelihood_:.4f}, theta "
        f"{np.round(gp_m.theta_, 4).tolist()}, counters {c}; at its final hyperparameters against "
        f"the CPU: the card's NLL {float(r['nll'][0]):.4f}, rel err value {r['err_v']:.3e} (tol "
        f"1e-4), gradient abs err {r['abs_g']:.3e} (largest entry {r['scale_g']:.3e}); against the "
        f"float64 plain path: the card's value {r['err_v64']:.3e} (tol {MIXED_NLL_F64_TOL}) and gradient "
        f"abs err {r['abs_g64']:.3e}, the CPU float32 path's {r['err_v64_cpu']:.3e} and "
        f"{r['abs_g64_cpu']:.3e}")
    # the float64 path is the yardstick: the fit ends on an ill-conditioned
    # R (theta at its bounds), where each float32 path is ~1e-4 off it, in
    # its own direction
    assert np.isfinite(gp_m.log_likelihood_) and r["err_v64"] < MIXED_NLL_F64_TOL, r
    for method, model, e, plugin in (("OnePlusOne_Cholesky_CMA", gp, enc, float(y.min())),
                                     ("SMC", gp, enc, float(y.min())),
                                     ("MIES", gp_m, enc_m, float(y_m.min()))):
        am = AcquisitionArgmax(e, method=method, seed=0)
        params = {"plugin": plugin}

        def call():
            return am(model.posterior, model.config, "EI", params)

        call()
        reset_launch_counts()
        (u, v), wall = timed(call)
        c = paths[method] = counts()
        assert c["matern_fused"] > 0, (method, c)
        evals = c["matern_fused"]  # one Matern forward per criterion evaluation
        _, dev_ms, n_k, _ = profiled(call)
        gens = {"OnePlusOne_Cholesky_CMA": am.n_generations,
                "SMC": (am.n_smc_rounds + 1) * am.n_smc_moves,
                "MIES": am.n_mies_generations}[method]
        log(f"  {method}: {wall:.4f} s, {gens} generations ({evals} criterion evaluations), "
            f"{wall / evals * 1e3:.3f} ms and {fmt(ratio(n_k, evals), '.1f')} launches an evaluation, "
            f"{fmt(dev_ms, '.2f')} ms on the device (idle share {fmt(idle_share(dev_ms, wall), '.3f')}); "
            f"winner value {v:.6e} at {np.round(u, 4).tolist()}; counters {c}")
        # MIES against float64: the mixed fit ends on an ill-conditioned R
        # (theta at its bounds), where the CPU float32 path is ~1e-4 off it
        cpu_m = on_cpu(model)
        check_against_cpu(method, [v], cpu_values(cpu_m, e, "EI", params, u),
                          cpu64=cpu_values(cpu_m, e, "EI", params, u, torch.float64) if method == "MIES" else None)


def cma_mle(X, y, bfgs_gp, paths: dict, grad_abs_tol: float):
    """(c) The CMA hyperparameter fit at n=1000, d=5: 4 * max_iter = 160
    generations of one batched likelihood over 10 chains; the card's NLL at
    the final hyperparameters against the CPU's (1e-4 relative; both
    float32 paths' errors against the float64 CPU path printed), and its
    gradient there against the CPU's in absolute terms, within the absolute
    error phase 4 allows on its random lanes (grad_abs_tol): at an optimum
    the gradient nearly vanishes, so its error relative to its own largest
    entry is no yardstick."""
    gp = GaussianProcess(mean=constant_trend(DIM), corr="matern", thetaL=1e-3 * np.ones(DIM),
                         thetaU=1e3 * np.ones(DIM), nugget=1e-6, random_start=10, random_state=0,
                         optimizer="CMA")
    reset_launch_counts()
    _, first = timed(lambda: gp.fit(X, y))
    c = paths["cma_mle"] = counts()
    assert c["matern_fused"] > 0 and c["whiten_fused"] > 0, c
    _, second = timed(lambda: gp.fit(X, y))
    par = np.r_[np.log10(gp.theta_), np.log10(gp.sigma2)][None]
    r = likelihood_vs_cpu(X, y, gp.posterior.X.shape[0], par, gp.noise_var, f64=True)
    log(f"[9] (c) CMA-MLE fit, n={len(X)} d=5: {first:.4f} s (first), {second:.4f} s (second), "
        f"{4 * gp.max_iter} generations; counters over the first fit {c}; NLL "
        f"{-gp.log_likelihood_:.4f} (the BFGS ladder's {-bfgs_gp.log_likelihood_:.4f}), theta "
        f"{np.round(gp.theta_, 4).tolist()}; at the final hyperparameters against the CPU: the "
        f"card's NLL {float(r['nll'][0]):.4f}, rel err value {r['err_v']:.3e} (tol 1e-4); gradient: "
        f"largest entry {r['scale_g']:.3e}, abs err {r['abs_g']:.3e} (tol {grad_abs_tol:.3e}, "
        f"phase 4's), {r['err_g']:.3e} relative to its largest entry; against the float64 plain "
        f"path: the card's value {r['err_v64']:.3e} and gradient abs err {r['abs_g64']:.3e}, "
        f"the CPU float32 path's {r['err_v64_cpu']:.3e} and {r['abs_g64_cpu']:.3e}")
    assert np.isfinite(gp.log_likelihood_) and float(gp.posterior.min_pivot) > PIV_TOL
    assert r["err_v"] < 1e-4 and r["abs_g"] < grad_abs_tol, r
    return first


def mixed_space():
    """Parity config 4's space (benchmark/parity.py:100-107), seed 0."""
    s = (RealSpace([[-3.0, 3.0]] * 2, var_name="r") + IntegerSpace([0, 10], var_name="i")
         + DiscreteSpace(["A", "B", "C"], var_name="c"))
    s.random_seed = 0
    return s


def mixed_obj(x):
    """Parity config 4's objective (benchmark/parity.py:43-48); minimum 0."""
    r0, r1, i0, c0 = x[0], x[1], x[2], x[3]
    return (float(r0) ** 2 + float(r1) ** 2 + abs(int(i0) - 5) / 5.0
            + {"A": 0.0, "B": 0.7, "C": 1.5}[c0])


def sphere(x):
    return float(np.sum(np.asarray(x, dtype=float) ** 2))


def mixed_data(n: int):
    """(encoding, embedded rows (n, D = 6), standardized y): n LHS samples
    of parity config 4's space and objective, the data of phase 8's mixed
    fit."""
    space = mixed_space()
    enc_m = space.encoding()
    raw = space.sample(n, method="LHS")
    y_m = np.array([mixed_obj(list(r)) for r in raw])
    return enc_m, enc_m.unit_to_embed_np(enc_m.encode_unit(raw)), (y_m - y_m.mean()) / y_m.std()


def parity_runs(paths: dict):
    """(d) Parity configs 3 and 4 end to end, seed 0 (benchmark/parity.py:84-118),
    cut in depth to keep the run short: config 3 to 24 evaluations (DoE 8
    and two batches of 8, of 48: a tell, a refit and a second ask of the
    batch path), config 4 to 16 (of 40)."""
    space = RealSpace([[-5.0, 5.0]] * 5, random_seed=0)
    gp = GaussianProcess(mean=constant_trend(5), corr="matern", thetaL=1e-2 * np.ones(5),
                         thetaU=1e4 * np.ones(5), nugget=1e-6, random_state=0)
    opt = ParallelBO(search_space=space, obj_fun=sphere, model=gp, n_point=Q,
                     acquisition_fun="MGFI", acquisition_par={"t": 2.0}, DoE_size=8, max_FEs=24,
                     random_seed=0)
    reset_launch_counts()
    _, wall3 = timed(opt.run)
    paths["parity_config_3"] = counts()
    doe3 = float(np.min(opt.data.fitness[:8]))
    log(f"[10] (d) parity config 3 (ParallelBO MGFI q=8, 5-D sphere, 24 of its 48 evaluations, seed 0): "
        f"regret {opt.fopt:.6g} (DoE-only best {doe3:.6g}), {opt.eval_count} evaluations in "
        f"{wall3:.2f} s; counters {paths['parity_config_3']}")
    assert opt.eval_count == 24 and opt.fopt < doe3
    assert live(paths["parity_config_3"])
    opt4 = BO(search_space=mixed_space(), obj_fun=mixed_obj, DoE_size=8, max_FEs=16,
              acquisition_fun="MGFI", acquisition_par={"t": 2.0}, random_seed=0)
    assert opt4._argmax.method == "MIES"
    reset_launch_counts()
    _, wall4 = timed(opt4.run)
    paths["parity_config_4"] = counts()
    doe4 = float(np.min(opt4.data.fitness[:8]))
    log(f"  parity config 4 (mixed space, BO MGFI with MIES, 16 of its 40 evaluations, seed 0): regret "
        f"{opt4.fopt:.6g} (DoE-only best {doe4:.6g}) at {opt4.xopt.tolist()[0]}, "
        f"{opt4.eval_count} evaluations in {wall4:.2f} s; counters {paths['parity_config_4']}")
    assert opt4.eval_count == 16 and np.isfinite(opt4.fopt) and opt4.fopt <= doe4
    assert paths["parity_config_4"]["matern_fused"] > 0


N_WARM, N_ENSEMBLE = 64, 8  # bench.py:162-163, the NUTS cell's settings


def posterior_gp(optimizer: str, **settings):
    """bench.py's posterior GP at n=1000, d=5 (hmc_warmup 64, n_ensemble 8)."""
    gp = GaussianProcess(mean=constant_trend(DIM), corr="matern", thetaL=1e-3 * np.ones(DIM),
                         thetaU=1e3 * np.ones(DIM), nugget=1e-6, random_state=0, optimizer=optimizer)
    gp.hmc_warmup, gp.n_ensemble = N_WARM, N_ENSEMBLE
    for k, v in settings.items():
        setattr(gp, k, v)
    return gp


class NutsResults:
    """Keeps every NUTSResult the GP's fit gets from nuts_sample (its mean
    depth, which the fit does not keep), for the duration of a with block."""

    def __enter__(self):
        self.results, self._inner = [], gp_module.nuts_sample

        def recorded(*args, **kwargs):
            self.results.append(self._inner(*args, **kwargs))
            return self.results[-1]

        gp_module.nuts_sample = recorded
        return self

    def __exit__(self, *exc):
        gp_module.nuts_sample = self._inner


def held_out_err(gp) -> float:
    X_h, y_h = held_out(200)
    return float(np.abs(gp.predict(X_h) - y_h).max())


def nuts_path(X, y, bfgs_gp, paths: dict):
    """(a) bench.py's NUTS cell: hmc_warmup 64, n_ensemble 8 (8 chains, one
    draw each at thin 2), then the BFGS EI argmax with 25 restarts over the
    ensemble; a cold fit (half-length MLE ladder for the chains' seed,
    phase 1 on the n/4 subset), 2 carried refits as warm-ups, 3 timed
    carried refits. A leapfrog is one Matern backward launch in the fit
    (plus one at each phase's start). One carried refit profiled."""
    enc = RealSpace([[0.0, 1.0]] * DIM).encoding()
    gp = posterior_gp("NUTS")
    argmax = AcquisitionArgmax(enc, method="BFGS", n_restart=5 * DIM, seed=0)
    plugin = float(y.min())
    n_w2 = max(8, N_WARM // 4)
    n_sampling = 2 * max(1, -(-N_ENSEMBLE // 8))  # thin 2

    def iteration():
        c0 = counts()
        _, fit_s = timed(lambda: gp.fit(X, y))
        bwd = counts()["matern_fused_bwd"] - c0["matern_fused_bwd"]
        (u, v), ask_s = timed(lambda: argmax(gp.posterior, gp.config, "EI", {"plugin": plugin}))
        assert np.all(np.isfinite(u)) and math.isfinite(v)
        return fit_s, ask_s, bwd

    reset_launch_counts()
    with NutsResults() as rec:
        cold = iteration()
        reps = [iteration() for _ in range(5)]
    c = paths["nuts_fit_argmax"] = counts()
    assert live(c), c
    t = reps[2:]
    walls = [f + a for f, a, _ in t]
    depth = [round(float(r.mean_depth.mean()), 3) for r in rec.results]
    log(f"[11] (a) NUTS fit + EI argmax, n={len(X)} d={DIM}, hmc_warmup {N_WARM}, n_ensemble {N_ENSEMBLE} "
        f"(bench.py's cell): median {statistics.median(walls):.4f} s, min {min(walls):.4f} s over "
        f"{len(walls)} carried reps {[round(w, 4) for w in walls]}; fit {[round(f, 4) for f, _, _ in t]} s, "
        f"argmax {[round(a, 4) for _, a, _ in t]} s; cold first iteration: fit {cold[0]:.4f} s, argmax "
        f"{cold[1]:.4f} s; counters over the {len(reps) + 1} iterations {c}")
    log(f"  transitions: cold fit {N_WARM} (phase 1, n/4 rows) + {n_w2} (phase 2) + {n_sampling} "
        f"(sampling), carried refit {n_w2} + {n_sampling}; Matern backward launches in each fit (the "
        f"leapfrogs, one more at each phase's start; the cold fit's also its MLE ladder): cold "
        f"{cold[2]}, carried {[b for _, _, b in reps]}; mean depth of the sampling transitions, each fit "
        f"{depth}")
    carry = gp._sampler_carry
    log(f"  accept rate per chain {np.round(gp.accept_rate_, 4).tolist()}, step sizes "
        f"{np.round(carry[1], 5).tolist()}, ESS over sample_chains_ {np.round(effective_sample_size(gp.sample_chains_), 2).tolist()} "
        f"({gp.sample_chains_.shape[0]} draw a chain: the estimator returns draws x chains)")
    c0, by_name = counts(), {}
    _, dev_ms, n_k, wall_prof = profiled(lambda: gp.fit(X, y), by_name)
    leaps = counts()["matern_fused_bwd"] - c0["matern_fused_bwd"]
    fit_med = statistics.median([f for f, _, _ in t])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"  one carried refit profiled: {leaps} Matern backward launches, {fmt(n_k, 'g')} kernel launches, "
        f"{fmt(ratio(n_k, leaps), '.1f')} a leapfrog, {fmt(dev_ms, '.2f')} ms on the device, {wall_prof:.4f} s "
        f"with the profiler on; idle share {fmt(idle_share(dev_ms, wall_prof), '.3f')} against it, "
        f"{fmt(idle_share(dev_ms, fit_med), '.3f')} against the median unprofiled fit {fit_med:.4f} s; "
        f"device ms by kernel, largest first: "
        + "; ".join(f"{name.split('(')[0][-48:]} {ms:.2f}" for name, ms in top))
    # 12a: whiten's backward solves over Dinv by GEMMs, so no cuBLAS trsm
    trsm = {name: ms for name, ms in by_name.items() if "trsm" in name}
    log(f"  [12a] the refit's device split {'not measured' if not by_name else 'by kernel name'}: "
        f"trsm kernels {trsm or 'none'} (the trsm backward: {TRSM_REFIT_MS} ms in {TRSM_REFIT_LEAPFROGS} "
        f"leapfrogs, {TRSM_REFIT_MS / TRSM_REFIT_LEAPFROGS:.3f} ms a leapfrog)")
    assert not trsm, trsm
    log(f"  posterior-median theta {np.round(gp.theta_, 4).tolist()}, ensemble NLL {-gp.log_likelihood_:.4f} "
        f"(the BFGS fit's {-bfgs_gp.log_likelihood_:.4f}, the CMA fit's in phase 9); max |mu - y| on 200 "
        f"held-out points {held_out_err(gp):.4f} (the BFGS fit's {held_out_err(bfgs_gp):.4f})")
    assert np.isfinite(gp.log_likelihood_) and np.all(np.isfinite(gp.theta_samples_))
    return gp, leaps


def hmc_vi_paths(X, y, paths: dict):
    """(b) HMC (12 leapfrogs a trajectory, jittered) and VI (400 ADVI steps,
    8 Monte-Carlo lanes) at n=1000, a cold fit each."""
    for optimizer, settings in (("HMC", {}), ("VI", {"vi_steps": 400})):
        gp = posterior_gp(optimizer, **settings)
        reset_launch_counts()
        _, wall = timed(lambda: gp.fit(X, y))
        c = paths[f"{optimizer.lower()}_fit"] = counts()
        assert live(c), (optimizer, c)
        extra = (f"accept rate per chain {np.round(gp.accept_rate_, 4).tolist()}" if optimizer == "HMC"
                 else f"(mean, log_std) {[np.round(p, 3).tolist() for p in gp.vi_params_]}")
        log(f"  (b) {optimizer} fit, n={len(X)}: {wall:.4f} s (cold), counters {c}; {extra}; "
            f"posterior-median theta {np.round(gp.theta_, 4).tolist()}, ensemble NLL "
            f"{-gp.log_likelihood_:.4f}, held-out max |mu - y| {held_out_err(gp):.4f}")
        assert np.isfinite(gp.log_likelihood_) and np.all(np.isfinite(gp.theta_samples_))


def logp_z_on(device, gp, X, y, dtype=torch.float32):
    """The sampler's target on `device` for gp's data: (value_and_grad over
    unconstrained z (C, P), lo, hi)."""
    Xp, Yp, mask = padded(X, y, gp.posterior.X.shape[0])

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    Xt, Yt, mt = t(Xp), t(Yp), t(mask)
    b = gp._hyper_bounds(DIM, y)
    lo, hi = t(b[:, 0]), t(b[:, 1])
    config = gp.config._replace(n_ensemble=0)

    def logp(p):
        return -neg_log_likelihood(p, Xt, Yt, mt[:, None], mt, len(X), gp.noise_var,
                                   t(np.zeros((1, 1))), config, prior_lo=lo, prior_hi=hi)

    return _value_and_grad(logp, lo, hi), lo, hi


def ensemble_vs_cpu(gp, X, y, paths: dict, val_abs_tol: float, grad_abs_tol: float):
    """(c) The card against the CPU path on the NUTS fit's carried state:
    the mixture at 64 points (1e-4 relative); the sampler's target and its
    gradient at the chain states, within the absolute errors phase 4 allows
    on its random lanes (val_abs_tol, grad_abs_tol: near an optimum the
    target is a small difference of large float32 sums and the gradient
    nearly vanishes, so their own scale is no yardstick), beside both
    float32 paths' errors against the CPU path in float64; one NUTS
    transition from the same draws (printed only: a U-turn decision at its
    threshold may flip in float32). (d) The ensemble argmax alone, with the
    counters zeroed just before it."""
    cpu_gp = on_cpu(gp)
    Xq = np.random.default_rng(8).uniform(0, 1, (64, DIM))
    (mu, var), (mu0, var0) = gp.predict(Xq, eval_MSE=True), cpu_gp.predict(Xq, eval_MSE=True)
    e_mu, e_var = (float(np.abs(a - b).max() / np.abs(b).max()) for a, b in ((mu, mu0), (var, var0)))
    x_box = gp.sample_chains_[-1]  # (C, P) chain states
    out = {}
    blk = Draws(torch.Generator().manual_seed(5)).nuts(*x_box.shape, 6, torch.float32)

    class Fixed:
        def __init__(self, device):
            self.device = device

        def nuts(self, *_):
            return tuple(b.to(self.device) for b in blk)

    inv_mass, step, _ = gp._sampler_carry
    vg64, lo64, hi64 = logp_z_on("cpu", gp, X, y, torch.float64)
    # a chain at its box's edge is stored saturated (frac 0 or 1); clamp
    # as ops/optimize.from_box does, so both sides take the same finite z
    frac64 = ((torch.tensor(x_box, dtype=torch.float64) - lo64) / (hi64 - lo64)).clamp(1e-6, 1 - 1e-6)
    lp64, g64 = (a.numpy() for a in vg64(torch.log(frac64) - torch.log1p(-frac64)))
    for dev in ("card", "cpu"):
        vg, lo, hi = logp_z_on(gp.device if dev == "card" else "cpu", gp, X, y)

        def t(a):
            return torch.tensor(a, dtype=torch.float32, device=lo.device)

        frac = ((t(x_box) - lo) / (hi - lo)).clamp(1e-6, 1 - 1e-6)
        z = torch.log(frac) - torch.log1p(-frac)
        lp, g = vg(z)
        zeros = torch.zeros(len(z), device=lo.device)
        chains = _Chains(z=z, logp=lp, grad=g, log_eps=torch.log(t(step)), log_eps_bar=zeros,
                         h_bar=zeros, m1=z, m2=z, count=zeros, inv_mass=t(inv_mass))
        c, alpha, depth = _nuts_step(chains, vg, Fixed(lo.device), 6)
        out[dev] = [a.detach().cpu().double().numpy() for a in (lp, g, c.z, alpha, depth)]
    (lp_k, g_k, z_k, a_k, d_k), (lp_p, g_p, z_p, a_p, d_p) = out["card"], out["cpu"]
    err_v, err_g = float(np.abs(lp_k - lp_p).max()), float(np.abs(g_k - g_p).max())
    log(f"  (c) card against the CPU path, the NUTS fit's carried state: mixture at 64 points rel err mu "
        f"{e_mu:.3e}, var {e_var:.3e} (tol 1e-4); the target at the {len(x_box)} chain states (largest "
        f"|value| {float(np.abs(lp_p).max()):.4g}) abs err {err_v:.3e} (tol {val_abs_tol:.3e}, phase 4's), "
        f"its gradient (largest entry {float(np.abs(g_p).max()):.4g}) abs err {err_g:.3e} (tol "
        f"{grad_abs_tol:.3e}); against the CPU path in float64: the card's value {float(np.abs(lp_k - lp64).max()):.3e}, "
        f"gradient {float(np.abs(g_k - g64).max()):.3e}, the CPU float32 path's "
        f"{float(np.abs(lp_p - lp64).max()):.3e} and {float(np.abs(g_p - g64).max()):.3e}; one NUTS "
        f"transition from the same draws: depths {d_k.tolist()} (CPU {d_p.tolist()}), alpha "
        f"{np.round(a_k, 4).tolist()} (CPU {np.round(a_p, 4).tolist()}), max |z - z_cpu| "
        f"{float(np.abs(z_k - z_p).max()):.3e}")
    assert e_mu < 1e-4 and e_var < 1e-4 and err_v < val_abs_tol and err_g < grad_abs_tol, (
        e_mu, e_var, err_v, err_g)
    am = AcquisitionArgmax(RealSpace([[0.0, 1.0]] * DIM).encoding(), method="BFGS", n_restart=5 * DIM, seed=1)
    reset_launch_counts()
    (u, v), wall = timed(lambda: am(gp.posterior, gp.config, "EI", {"plugin": float(y.min())}))
    c = paths["ensemble_argmax"] = counts()
    assert c["matern_fused"] > 0 and c["matern_fused_bwd"] > 0, c
    log(f"  (d) the EI argmax over the 8-member ensemble alone: {wall:.4f} s, {c['matern_fused_bwd']} trips, "
        f"{wall / c['matern_fused_bwd'] * 1e3:.2f} ms a trip, counters {c}; value {v:.4e}, its CPU "
        f"criterion's {cpu_values(cpu_gp, am.encoding, 'EI', {'plugin': float(y.min())}, u)[0]:.4e}")


def whiten_backward(leapfrogs: int):
    """12a: whiten's gradient at (8, 1024), the samplers' shape, against
    float64 autograd through torch's Cholesky on the card; the device ms of
    its backward (the VJP over Dinv) beside the cuBLAS trsm VJP it replaced,
    and beside the trsm backward's figure in a NUTS refit, per leapfrog."""
    R = kernel_like(8, 1024, seed=12)
    B = torch.randn((8, 1024, 2), device="cuda", generator=torch.Generator(device="cuda").manual_seed(12))
    Rt = R.clone().requires_grad_(True)
    d, W, _ = whiten(Rt, B)
    (torch.log(d).sum() + (W ** 2).sum()).backward()
    R64 = R.double().requires_grad_(True)
    L64 = torch.linalg.cholesky(R64)
    W64 = torch.linalg.solve_triangular(L64, B.double(), upper=False)
    (torch.log(L64.diagonal(dim1=-2, dim2=-1)).sum() + (W64 ** 2).sum()).backward()
    scale = float(R64.grad.abs().max())
    err = float((Rt.grad.double() - R64.grad).abs().max()) / scale
    _, Wf, _, L, Dinv = _whiten_parts(R, B)
    # the trsm backward it replaced, on the same cotangents (1/d, 2W)
    dR_trsm, _ = whiten_vjp(L, Wf, trsm_solver(L, Dinv), 1.0 / d.detach(), 2.0 * Wf)
    err_trsm = float((dR_trsm.double() - R64.grad).abs().max()) / scale
    g = torch.Generator(device="cuda").manual_seed(13)
    dbar, Wbar = (torch.randn(a.shape, device="cuda", generator=g) for a in (d, Wf))
    Rk = R.clone().requires_grad_(True)
    dk, Wk, _ = whiten(Rk, B)

    def kept():  # whiten's own backward, run again on one graph
        return torch.autograd.grad((dk, Wk), Rk, (dbar, Wbar), retain_graph=True)

    def trsm():
        return whiten_vjp(L, Wf, trsm_solver(L, Dinv), dbar, Wbar)

    split = device_ms_by_kernel(kept, calls=5)
    d_k = None if split is None else sum(split.values())
    d_t = device_ms(trsm, calls=5)
    t_k, t_t = time_ms(kept, windows=5, calls=5), time_ms(trsm, windows=5, calls=5)
    log(f"  [12a] whiten gradient at (8, 1024) against float64 autograd on the card: rel err {err:.3e} "
        f"(tol {WHITEN_GRAD_TOL}; the trsm backward's {err_trsm:.3e}); its backward alone: {t_k:.4f} ms/call ({fmt(d_k)} ms on the "
        f"device, kernels {None if split is None else len(split)}), the trsm backward it replaced "
        f"{t_t:.4f} ms/call ({fmt(d_t)} ms on the device); the trsm kernels alone took "
        f"{TRSM_REFIT_MS / TRSM_REFIT_LEAPFROGS:.3f} ms a leapfrog in a refit with the trsm backward, the new one "
        f"{fmt(d_k)} ms a leapfrog, {fmt(None if d_k is None else d_k * leapfrogs, '.1f')} ms over "
        f"this run's profiled refit ({leapfrogs} leapfrogs)")
    assert err < WHITEN_GRAD_TOL, err
    assert split is None or not any("trsm" in name for name in split), split
    whiten_backward_ill_conditioned()


def whiten_backward_ill_conditioned():
    """12a at the conditioning the fits reach with theta at its bounds: R
    (2, 1024), Matern-3/2 at theta 0.1 with a 1e-6 nugget (cond ~3e7).
    whiten's gradient and the gradients of the VJP with each solver on the
    card's float32 factor, against float64 autograd and against the float64
    VJP of that factor (the solver's own error): every solver within
    SOLVE_OWN_TOL, whiten's gradient no farther from float64 than the trsm
    backward's."""
    R64 = ill_conditioned(2, 1024, -1.0, "cuda")
    ev = torch.linalg.eigvalsh(R64[0])
    B = torch.tensor(np.random.default_rng(1).standard_normal((2, 1024, 2)), device="cuda")
    Rr = R64.clone().requires_grad_(True)
    L64 = torch.linalg.cholesky(Rr)
    W64 = torch.linalg.solve_triangular(L64, B, upper=False)
    (torch.log(L64.diagonal(dim1=-2, dim2=-1)).sum() + (W64 ** 2).sum()).backward()
    ref = Rr.grad
    Rt = R64.float().requires_grad_(True)
    d, W, piv = whiten(Rt, B.float())
    (torch.log(d).sum() + (W ** 2).sum()).backward()
    _, _, _, L, Dinv = _whiten_parts(R64.float(), B.float())
    Ld, Wd = L.double(), W.detach().double()
    own_ref = whiten_vjp(Ld, Wd, trsm_solver(Ld, None), 1.0 / d.detach().double(), 2.0 * Wd)[0]

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    errs = {name: whiten_vjp(L, W.detach(), make(L, Dinv), 1.0 / d.detach(), 2.0 * W.detach())[0]
            for name, make in SOLVERS.items()}
    err = rel(Rt.grad, ref)
    log(f"  [12a] at cond(R) {float(ev[-1] / ev[0]):.3e} (2, 1024), min pivot {float(piv.min()):.3e}: "
        f"whiten's gradient against float64 autograd {err:.3e}; with each solver, against float64 autograd "
        f"(the solver's own, tol {SOLVE_OWN_TOL}): "
        + "; ".join(f"{k} {rel(g, ref):.3e} ({rel(g, own_ref):.3e})" for k, g in errs.items()))
    assert bool((piv > 0).all()) and all(rel(g, own_ref) < SOLVE_OWN_TOL for g in errs.values()), errs
    assert err <= 1.1 * rel(errs["trsm"], ref), (err, rel(errs["trsm"], ref))


def con_g(x):
    """12b's traced inequality, written with numpy: sum(x) <= 1.5 cuts off
    most of the cube, EI's unconstrained winners among it."""
    return np.sum(x) - 1.5


def con_g_host(x):
    """The same inequality through np.array: it runs on the host."""
    return float(np.sum(np.array(list(x), dtype=float))) - 1.5


def constrained_call(label, X, y, gp, paths: dict, call, trips_of, profile: bool = True):
    """One path of 12b: a warm refit plus the argmax call, with the counters
    zeroed just before and read just after (all three must move); then,
    with `profile`, the same call profiled. Returns the argmax's result."""
    reset_launch_counts()
    _, fit_s = timed(lambda: gp.fit(X, y))
    c0 = counts()
    out, ask_s = timed(call)
    work = trips_of(c0)
    c = paths[label] = counts()
    assert live(c), (label, c)
    if not profile:
        log(f"  {label}: fit {fit_s:.4f} s, argmax {ask_s:.4f} s in {work[0]} {work[1]}s "
            f"({fmt(ratio(ask_s * 1e3, work[0] or None), '.2f')} ms a {work[1]}; not profiled); counters {c}")
        return out
    c1 = counts()
    _, dev_ms, n_k, wall_p = profiled(call)
    work_p = trips_of(c1)
    log(f"  {label}: fit {fit_s:.4f} s, argmax {ask_s:.4f} s in {work[0]} {work[1]}s; profiled call: "
        f"{work_p[0]} {work_p[1]}s, {fmt(n_k, 'g')} launches, {fmt(ratio(n_k, work_p[0]), '.1f')} a {work_p[1]}, "
        f"{fmt(dev_ms, '.2f')} ms on the device, {wall_p:.4f} s (idle share "
        f"{fmt(idle_share(dev_ms, wall_p), '.3f')}); counters {c}")
    return out


def constrained_paths(X, y, gp, u4, paths: dict):
    """12b: the constrained argmax at bench size on phase 4's posterior
    (n=1000, d=5; u4 its unconstrained winner), EI with con_g: (i) traced,
    BFGS, 25 restarts; the card's
    penalized criterion and its gradient at the winner and 8 random points
    against the CPU path's; (ii) con_g_host through BO's engine choice
    (BFGS asked, CMA run); (iii) the q=8 MGFI batch under con_g. Every
    winner must be feasible."""
    enc = RealSpace([[0.0, 1.0]] * DIM).encoding()
    plugin = float(y.min())
    cp = ConstraintProgram(enc, g=con_g, device="cuda")
    assert cp.traceable
    am = AcquisitionArgmax(enc, method="BFGS", n_restart=5 * DIM, seed=0, constraints=cp)
    params = {"plugin": plugin, "_penalty_t": 10.0 + am.max_FEs}

    def trips(c0):
        return counts()["matern_fused_bwd"] - c0["matern_fused_bwd"], "trip"

    log(f"[12] (b) constrained argmax at bench size, n={len(X)} d={DIM}, EI, g(x) = sum x - 1.5 <= 0 "
        f"(phase 4's unconstrained winner has sum {float(np.sum(u4)):.4f})")
    u, v = constrained_call("constrained_bfgs", X, y, gp, paths,
                            lambda: am(gp.posterior, gp.config, "EI", params), trips)
    assert con_g(u) <= 0.0, u
    cpu_gp = on_cpu(gp)
    U = np.r_[u[None], np.random.default_rng(12).uniform(0, 1, (8, DIM))]
    vals = {}
    for dev, model, prog in (("cuda", gp, cp), ("cpu", cpu_gp, ConstraintProgram(enc, g=con_g, device="cpu"))):
        crit = make_unit_criterion(enc, model.posterior, model.config, "EI",
                                   {k: torch.tensor(v_, dtype=torch.float32, device=dev)
                                    for k, v_ in params.items()}, constraints=prog)
        Ut = torch.tensor(U, dtype=torch.float32, device=dev, requires_grad=True)
        val = crit(Ut)
        (grad,) = torch.autograd.grad(val.sum(), Ut)
        vals[dev] = (val.detach().cpu().double().numpy(), grad.cpu().double().numpy())
    (v_k, g_k), (v_c, g_c) = vals["cuda"], vals["cpu"]
    err_v = float(np.abs(v_k - v_c).max() / np.abs(v_c).max())
    err_g = float(np.abs(g_k - g_c).max() / np.abs(g_c).max())
    log(f"  winner {np.round(u, 4).tolist()} (sum {float(np.sum(u)):.4f}), value {v:.6e}; the penalized "
        f"criterion at the winner and 8 random points against the CPU path: rel err value {err_v:.3e} "
        f"(tol 1e-4), gradient {err_g:.3e} (tol 1e-3, of the largest entry {float(np.abs(g_c).max()):.4g})")
    assert err_v < 1e-4 and err_g < 1e-3, (err_v, err_g)

    opt = BO(search_space=RealSpace([[0.0, 1.0]] * DIM), obj_fun=sphere, ineq_fun=con_g_host, model=gp,
             acquisition_optimization={"optimizer": "BFGS"}, random_seed=0)
    am_h = opt._argmax
    assert not opt._constraints.traceable and opt._optimizer_name == "OnePlusOne_Cholesky_CMA"
    host = opt._constraints

    def generations(c0):
        return am_h.n_generations, "generation"

    syncs = host.host_calls
    u_h, v_h = constrained_call(
        "constrained_host_cma", X, y, gp, paths,
        lambda: am_h(gp.posterior, gp.config, "EI", {"plugin": plugin, "_penalty_t": 10.0 + am_h.max_FEs}),
        generations)
    log(f"  host-path constraint: BFGS asked, {opt._optimizer_name} run; {host.host_calls - syncs} host "
        f"evaluations over both calls (one device sync each); winner {np.round(u_h, 4).tolist()} "
        f"(sum {float(np.sum(u_h)):.4f}), value {v_h:.6e}")
    assert con_g_host(u_h) <= 0.0, u_h

    am8 = AcquisitionArgmax(enc, method="BFGS", n_restart=25, seed=0, constraints=cp)
    rng = np.random.default_rng(12)
    pars = [{"plugin": plugin, "t": _sample_t(rng, {"t": 2.0}), "_penalty_t": 10.0 + am8.max_FEs}
            for _ in range(Q)]
    # not profiled: its trips cost what the q=1 trips above and phase 7's
    # profiled q=8 ask show, and a trace of ~10^5 launches takes its own time
    us, vs = constrained_call("constrained_batch_q8", X, y, gp, paths,
                              lambda: am8.batch(gp.posterior, gp.config, "MGFI", pars), trips,
                              profile=False)
    sums = [float(np.sum(u_)) for u_ in us]
    log(f"  q={Q} batch: winners' sums {np.round(sums, 4).tolist()}, values {np.round(vs, 6).tolist()}")
    assert all(con_g(u_) <= 0.0 for u_ in us) and np.all(np.isfinite(vs)), sums


def con_obj(x):
    """Parity config 6's objective (benchmark/parity.py:244-246)."""
    return float(np.sum(np.asarray(x, dtype=float) ** 2) + 5 * np.sum(np.asarray(x, dtype=float)) + 10)


def con_h(x):
    """Parity config 6's equality (benchmark/parity.py:249-250)."""
    return np.sum(x) - 1


def ellipsoid20(x):
    """Parity config 5's objective (benchmark/parity.py:37-40)."""
    x = np.asarray(x, dtype=float)
    return float(np.sum(10 ** np.linspace(0, 4, len(x)) * x ** 2))


# parity config 5 cut in depth: the whole run must stay well inside its
# 1200 s on a slow host (1065.2 s with all 60 evaluations, 220 s of them
# here)
CONFIG5_FES = 40


def parity_constrained_pca(X, y, gp, paths: dict):
    """12c: parity config 6 (BO, h = sum x - 1, GPR + MGFI(t=2) + BFGS, DoE
    3, 20 evaluations, seed 0); 12d: parity config 5 (PCABO, 20-D
    ellipsoid, 5 components, DoE 20, seed 0) cut to 40 of its 60
    evaluations, and one BO
    iteration with GEI (g=2) on phase 4's data: a refit and the argmax, its
    criterion at the winner against the CPU path's."""
    model = GaussianProcess(corr="squared_exponential", thetaL=1e-5 * np.ones(2), thetaU=np.ones(2),
                            nugget=1e-1, random_state=0)
    opt = BO(search_space=RealSpace([0, 1]) * 2, obj_fun=con_obj, eq_fun=con_h, model=model, max_FEs=20,
             DoE_size=3, acquisition_fun="MGFI", acquisition_par={"t": 2},
             acquisition_optimization={"optimizer": "BFGS"}, random_seed=0)
    assert opt._constraints.traceable and opt._optimizer_name == "BFGS"
    reset_launch_counts()
    (xopt, fopt, _), wall = timed(opt.run)
    c = paths["parity_config_6"] = counts()
    viol = abs(float(con_h(np.asarray(xopt, dtype=float).ravel())))
    log(f"[12] (c) parity config 6 (BO MGFI + BFGS, h = sum x - 1, 20 evaluations, seed 0): fopt "
        f"{float(fopt[0]):.6f} at {np.round(np.ravel(xopt), 6).tolist()}, |h| {viol:.3e} (tol 0.1), "
        f"the reference's worst seed {CONFIG6_WORST_REF}, the JAX package's median 15.4401; "
        f"{opt.eval_count} evaluations in {wall:.2f} s; counters {c}")
    assert live(c), c
    assert viol <= 0.1 and float(fopt[0]) <= CONFIG6_WORST_REF and opt.eval_count == 20

    pca = PCABO(search_space=RealSpace([[-5.0, 5.0]] * 20, random_seed=0), obj_fun=ellipsoid20,
                n_components=5, DoE_size=20, max_FEs=CONFIG5_FES, random_seed=0)
    reset_launch_counts()
    _, wall = timed(pca.run)
    c = paths["parity_config_5"] = counts()
    V = np.asarray(pca.data.values, dtype=float)
    doe = float(np.min(pca.data.fitness[:20]))
    log(f"[12] (d) parity config 5 (PCABO, 20-D ellipsoid, 5 components, {CONFIG5_FES} of its 60 evaluations, "
        f"seed 0): fopt "
        f"{pca.fopt:.6g} (DoE-only best {doe:.6g}; PARITY.md's medians: JAX package 1.893e4, reference "
        f"1.053e4), points within [{V.min():.4f}, {V.max():.4f}], {pca.eval_count} evaluations in "
        f"{wall:.2f} s; counters {c}")
    assert live(c), c
    assert V.min() >= -5.0 - 1e-6 and V.max() <= 5.0 + 1e-6 and pca.fopt < doe and pca.eval_count == CONFIG5_FES

    enc = RealSpace([[0.0, 1.0]] * DIM).encoding()
    gei = BO(search_space=RealSpace([[0.0, 1.0]] * DIM), obj_fun=sphere, model=gp,
             acquisition_fun="GEI", acquisition_par={"g": 2}, random_seed=0)
    reset_launch_counts()

    def iteration():
        gei.tell([list(r) for r in X], list(y), warm_start=True)
        return gei.arg_max_acquisition(return_value=True)

    (cands, vals), wall = timed(iteration)
    c = paths["gei_bo_iteration"] = counts()
    u = enc.encode_unit(np.asarray(cands, dtype=object))
    at_cpu = cpu_values(on_cpu(gp), enc, "GEI2", {"plugin": gei.fmin}, u)
    log(f"  (d) one BO iteration with GEI (g=2) on phase 4's data: refit + argmax {wall:.4f} s, winner "
        f"{np.round(u[0], 4).tolist()}; counters {c}")
    assert live(c), c
    check_against_cpu("GEI (g=2)", vals, at_cpu)


REF_F32_LL = -1416.51   # phase 4's float32 fit at n=1000 (PERF.md)
REF_RF_REGRETS = (0.070, 1.336)  # the reference's RF on parity config 4, 10 seeds (PARITY.json)


def other_kernels(X, y, paths: dict):
    """13a: GP fits at n=1000, d=5 with the absolute-exponential kernel and
    Matern nu=7/2 (plain torch kernels, the factorisation on whiten_fused),
    each with its likelihood at 4 lanes against the CPU path."""
    for label, kernel in (("absolute_exponential", "absolute_exponential"),
                          ("matern_nu_3.5", ("matern", 3.5))):
        gp = GaussianProcess(mean=constant_trend(DIM), corr=kernel, thetaL=1e-3 * np.ones(DIM),
                             thetaU=1e3 * np.ones(DIM), nugget=1e-6, random_start=10, random_state=0)
        reset_launch_counts()
        _, wall = timed(lambda: gp.fit(X, y))
        c = paths[f"fit_{label}"] = counts()
        r = likelihood_vs_cpu(X, y, 1024, lanes(np.random.default_rng(6), 4),
                              config=GPConfig(kernel=kernel))
        log(f"[13] (a) fit with {kernel} at n={len(X)}, d={DIM}: {wall:.4f} s, log-likelihood "
            f"{gp.log_likelihood_:.4f}, theta {np.round(gp.theta_, 4).tolist()}, counters {c}; at 4 "
            f"lanes against the CPU: rel err value {r['err_v']:.3e} (tol 1e-4), gradient "
            f"{r['err_g']:.3e}")
        assert c["whiten_fused"] > 0 and np.isfinite(gp.log_likelihood_), c
        assert r["err_v"] < 1e-4, r


def float64_gp(X, y, paths: dict):
    """13b: the float64 GP at n=1000, d=5 on the card (the plain torch
    stack, chosen by dtype): its fit beside phase 4's float32 basin, no
    kernel launched, and its NLL at its own optimum against the CPU float64
    path (1e-8 relative)."""
    gp = GaussianProcess(mean=constant_trend(DIM), corr="matern", thetaL=1e-3 * np.ones(DIM),
                         thetaU=1e3 * np.ones(DIM), nugget=1e-6, random_start=10, random_state=0,
                         dtype="f64")
    reset_launch_counts()
    _, wall = timed(lambda: gp.fit(X, y))
    c = paths["float64_fit"] = counts()
    Xp, Yp, mask = padded(X, y, 1024)
    par = gp._map_par_log10[None]
    nll = {}
    for dev in ("cuda", "cpu"):
        def t(a):
            return torch.tensor(a, dtype=torch.float64, device=dev)

        nll[dev] = float(neg_log_likelihood(t(par), t(Xp), t(Yp), t(mask[:, None]), t(mask), len(X),
                                            gp.noise_var, t(np.zeros((1, 1))), gp.config)[0])
    err = abs(nll["cuda"] - nll["cpu"]) / abs(nll["cpu"])
    log(f"[13] (b) float64 fit at n={len(X)}, d={DIM} on the card: {wall:.4f} s, log-likelihood "
        f"{gp.log_likelihood_:.4f} (phase 4's float32 basin {REF_F32_LL}), theta "
        f"{np.round(gp.theta_, 4).tolist()}, noise {gp.noise_var:.1e}, counters {c}; its NLL at its "
        f"optimum {nll['cuda']:.8f}, the CPU float64 path's {nll['cpu']:.8f}, rel err {err:.3e} (tol 1e-8)")
    assert all(v == 0 for v in c.values()), c
    assert gp.posterior.L.dtype == torch.float64 and err < 1e-8 and np.isfinite(gp.log_likelihood_)


def derivatives(gp, paths: dict):
    """13c: gradient and Hessian of phase 4's GP at 5 points against the CPU
    path on the same posterior; the yardstick is the CPU path in float64 on
    that posterior, and the card's error must stay within 3x the CPU
    float32 path's (or 1e-4 of the largest entry). Every Hessian must run
    the second-derivative kernel once per dimension."""
    cpu32 = on_cpu(gp)
    d = gp.theta_.shape[0]
    cpu64 = GaussianProcess(thetaL=1e-3 * np.ones(d), thetaU=1e3 * np.ones(d), dtype="f64",
                            device="cpu").load_fitted(
        gp.theta_, {k: v.cpu().double().numpy() for k, v in gp.posterior._asdict().items()},
        gp.config._asdict())
    pts = np.random.default_rng(7).uniform(0.05, 0.95, (5, d))
    reset_launch_counts()
    errs = {}
    t0 = time.perf_counter()
    for x in pts:
        for name, fn in (("gradient mean", lambda m: m.gradient(x)[0]),
                         ("gradient mse", lambda m: m.gradient(x)[1]),
                         ("Hessian mean", lambda m: m.Hessian(x, of="mean")),
                         ("Hessian mse", lambda m: m.Hessian(x, of="mse"))):
            card, c32, c64 = fn(gp), fn(cpu32), fn(cpu64)
            scale = float(np.abs(c64).max())
            e, e32 = float(np.abs(card - c64).max()), float(np.abs(c32 - c64).max())
            prev = errs.get(name, (0.0, 0.0, 0.0))
            errs[name] = (max(prev[0], e / scale), max(prev[1], e32 / scale), max(prev[2], scale))
            assert np.all(np.isfinite(card)) and e <= max(3 * e32, 1e-4 * scale), (name, x, card, c64)
    wall = time.perf_counter() - t0
    c = paths["gradient_hessian"] = counts()
    for name, (e, e32, scale) in errs.items():
        log(f"  (c) {name} at 5 points against the CPU path in float64: the card {e:.3e}, the CPU "
            f"float32 path {e32:.3e} (relative to the largest entry, up to {scale:.3e})")
    log(f"[13] (c) gradient/Hessian of phase 4's GP at 5 points: {wall:.4f} s with the CPU runs; "
        f"counters {c} (the gradient through the Matern backward kernel, each Hessian through the "
        f"forward, the backward and the second-derivative kernel, once per dimension)")
    assert c["matern_fused"] > 0 and c["matern_fused_bwd"] > 0, c
    assert c["matern_fused_bwd2"] == 2 * len(pts) * d, c


def chol_and_inv_check(paths: dict):
    """13d: chol_and_inv at n=1024 on the card against its CPU twin, with
    its device time and the plain twin's on the card."""
    R = kernel_like(1, 1024, 11)[0]
    B1 = torch.zeros(1024, 1, device=R.device)
    reset_launch_counts()
    L, Li, piv = chol_and_inv(R)
    torch.cuda.synchronize()
    c = paths["chol_and_inv"] = counts()
    Lc, Lic, _ = chol_and_inv(R.cpu())
    err_l = float((L.cpu() - Lc).abs().max() / Lc.abs().max())
    err_i = float((Li.cpu() - Lic).abs().max() / Lic.abs().max())

    def plain():
        _d, _W, _p, Lp, Dp = whiten_plain(R, B1)
        return _block_tri_inv(Lp, Dp)

    t_k, t_p = time_ms(lambda: chol_and_inv(R)), time_ms(plain)
    d_k, d_p = device_ms(lambda: chol_and_inv(R)), device_ms(plain)
    b_ms, b_by = chol_inv_bound(1, 1024, 0)
    log(f"[13] (d) chol_and_inv at n=1024: L rel err {err_l:.3e} (tol {WHITEN_L_TOL}), L^-1 rel err "
        f"{err_i:.3e} (tol {CHOL_INV_TOL}) against the CPU twin; {t_k:.4f} ms a call "
        f"({fmt(d_k)} ms on the device), bound {b_ms:.4f} ms ({b_by}), share of bound "
        f"{fmt(ratio(b_ms, d_k), '.3f')}; the plain twin on the card {t_p:.4f} ms ({fmt(d_p)} ms); "
        f"min pivot {float(piv):.3e}; counters {c}")
    assert c["whiten_fused"] == 1 and err_l < WHITEN_L_TOL and err_i < CHOL_INV_TOL and float(piv) > 0


def forest_paths(paths: dict):
    """13e: RandomForest() (100 trees) grown on phase 8's 1000 mixed
    observations (D = 6): grow wall, nodes and depth; its traversal on the
    card against the CPU's on the same forest; then an MGFI MIES argmax on
    it: wall, generations, criterion evaluations, launches an evaluation,
    idle share."""
    enc_m, X_m, y_m = mixed_data(1000)
    rf = RandomForest(feature_space="embedding", random_state=0)
    rf.fit(X_m[:50], y_m[:50])  # a warm-up growth
    reset_launch_counts()
    _, wall = timed(lambda: rf.fit(X_m, y_m))
    paths["forest_grow"] = counts()
    st = rf.posterior
    live_nodes = (st.feature >= 0).sum(1) * 2 + 1  # a tree's nodes: two for each split, and the root
    Xq = torch.tensor(np.random.default_rng(8).uniform(0, 1, (1000, MIXED_D)), dtype=torch.float32)
    mu_d, var_d = rf_predict(st, Xq.cuda(), rf.config)
    mu_c, var_c = rf_predict(RFState(*(t.cpu() for t in st)), Xq, rf.config)
    err = max(float((mu_d.cpu() - mu_c).abs().max()), float((var_d.cpu() - var_c).abs().max()))
    t_trav = time_ms(lambda: rf_predict(st, Xq.cuda(), rf.config), windows=3, calls=5)
    log(f"[13] (e) RandomForest (100 trees) grown on {len(X_m)} mixed observations (D = {MIXED_D}): "
        f"{wall:.4f} s, {int(live_nodes.sum())} nodes ({int(live_nodes.min())}-{int(live_nodes.max())} "
        f"a tree, table width {st.feature.shape[1]}), depth {rf.config.max_depth}; traversal of 1000 "
        f"points on the card against the CPU on the same forest: max abs err {err:.3e} (tol 1e-6), "
        f"{t_trav:.4f} ms a call; counters {paths['forest_grow']}")
    assert err <= 1e-6 and rf.config.max_depth > 1
    am = AcquisitionArgmax(enc_m, method="MIES", seed=0)
    params = {"plugin": float(y_m.min()), "t": 2.0}

    def call():
        return am(rf.posterior, rf.config, "MGFI", params)

    call()
    evals = [0]
    inner = argmax_module.rf_predict

    def counted(*args):  # one forest traversal a criterion evaluation
        evals[0] += 1
        return inner(*args)

    argmax_module.rf_predict = counted
    try:
        reset_launch_counts()
        (u, v), wall = timed(call)
    finally:
        argmax_module.rf_predict = inner
    paths["forest_mies_argmax"] = counts()
    _, dev_ms, n_k, wall_p = profiled(call)
    log(f"  (e) MGFI MIES argmax on the forest: {wall:.4f} s, {am.n_mies_generations} generations, "
        f"{evals[0]} criterion evaluations, {fmt(ratio(n_k, evals[0]), '.1f')} launches an evaluation, "
        f"{fmt(dev_ms, '.2f')} ms on the device "
        f"in a profiled call of {wall_p:.4f} s (idle share {fmt(idle_share(dev_ms, wall_p), '.3f')}); "
        f"winner value {v:.6e} at {np.round(u, 4).tolist()}; counters {paths['forest_mies_argmax']}")
    check_against_cpu("MIES on the forest", [v], cpu_values(rf, enc_m, "MGFI", params, u))


def nonparametric_trend_path(X, y, paths: dict):
    """13f: a GP under a NonparametricTrend (100-tree forest) at n=1000,
    d=5: the forest, the residual fit and the BFGS EI argmax (25 restarts)
    with the forest riding in the criterion; every Hopper kernel must
    launch. The plugin is y's 10th percentile, a level the model's mean
    reaches (at min(y) the residual GP's EI underflows everywhere and no
    lane moves); the winner must beat every start and lie away from them,
    and its criterion must equal the CPU path's there."""
    forest = RandomForest(feature_space="embedding", random_state=0)
    gp = GaussianProcess(mean=NonparametricTrend(forest), corr="matern", thetaL=1e-3 * np.ones(DIM),
                         thetaU=1e3 * np.ones(DIM), nugget=1e-6, random_start=10, random_state=0)
    am = AcquisitionArgmax(RealSpace([[0.0, 1.0]] * DIM).encoding(), method="BFGS", n_restart=5 * DIM,
                           seed=0)
    reset_launch_counts()
    _, grow = timed(lambda: forest.fit(X, y))
    _, fit = timed(lambda: gp.fit(X, y))
    params = {"plugin": float(np.quantile(y, 0.1))}
    reserved = {"_prior_state": forest.posterior, "_prior_depth": forest.config.max_depth}
    gen = torch.Generator().set_state(am._gen.get_state())  # the argmax's own starts
    starts = torch.rand((am.n_restart, DIM), generator=gen, dtype=am.encoding.dtype).numpy()
    (u, v), ask = timed(lambda: am(gp.posterior, gp.config, "EI", {**params, **reserved}))
    c = paths["nonparametric_trend"] = counts()
    held = held_out(200)
    err = float(np.abs(gp.predict(held[0]) - held[1]).max())
    at_starts = cpu_values(gp, am.encoding, "EI", params, starts, prior=forest)
    moved = float(np.sqrt(((starts - np.asarray(u).ravel()) ** 2).sum(1)).min())
    log(f"[13] (f) NonparametricTrend GP at n={len(X)}, d={DIM}: forest {grow:.4f} s, residual fit "
        f"{fit:.4f} s (log-likelihood {gp.log_likelihood_:.4f}), BFGS EI argmax (plugin "
        f"{params['plugin']:.4f}) {ask:.4f} s in {c['matern_fused_bwd']} backward launches, winner "
        f"value {v:.6e} at {np.round(u, 4).tolist()} (the best of its {len(starts)} starts "
        f"{float(at_starts.max()):.6e}, the nearest start {moved:.4f} away); max |mu - y| on 200 "
        f"held-out points {err:.4f}; counters {c}")
    assert live(c), c
    assert v > float(at_starts.max()) and moved > 1e-3, (v, at_starts, moved)
    check_against_cpu("NonparametricTrend EI", [v], cpu_values(gp, am.encoding, "EI", params, u,
                                                               prior=forest))


def conditional_and_rf_bo(paths: dict):
    """13g: ConditionalBO on tests/test_extensions.py's conditional space, 30
    evaluations, seed 0; then BO with a RandomForest surrogate on parity
    config 4's mixed problem, 40 evaluations, seed 0, its regret beside the
    reference's RF regrets."""
    space = SearchSpace([Integer([1, 3], "x"), Discrete(["A", "B", "C"], "y1", conditions="x == 1"),
                         Discrete(["A", "B", "C"], "y2", conditions="x == 2"), Real([-5, 5], "z")])

    def fitness(p):
        v = p["x"] ** 2 + p["z"] ** 2
        if p.get("y1"):
            v += p["y1"] == "B"
        if p.get("y2"):
            v += p["y2"] == "A"
        return float(v)

    opt = ConditionalBO(search_space=space, obj_fun=fitness, DoE_size=4, max_FEs=30, random_seed=0)
    reset_launch_counts()
    _, wall = timed(opt.run)
    paths["conditional_bo"] = counts()
    log(f"[13] (g) ConditionalBO ({opt.n_subspace} subspaces, RF sub-BOs, MIES), 30 evaluations, seed 0: "
        f"fopt {opt.fopt:.6g} (optimum 1) at {opt.xopt.tolist()[0]}, {opt.eval_count} evaluations in "
        f"{wall:.2f} s; counters {paths['conditional_bo']}")
    assert opt.eval_count == 30 and np.isfinite(opt.fopt)
    rf_bo = BO(search_space=mixed_space(), obj_fun=mixed_obj,
               model=RandomForest(feature_space="embedding", random_state=0), DoE_size=8, max_FEs=40,
               acquisition_fun="MGFI", acquisition_par={"t": 2.0}, random_seed=0)
    assert rf_bo._argmax.method == "MIES"
    reset_launch_counts()
    _, wall = timed(rf_bo.run)
    paths["rf_bo_parity_config_4"] = counts()
    doe = float(np.min(rf_bo.data.fitness[:8]))
    log(f"  (g) BO with a RandomForest on parity config 4 (mixed space, MGFI, MIES), 40 evaluations, "
        f"seed 0: regret {rf_bo.fopt:.6g} (DoE-only best {doe:.6g}; the reference's RF over 10 seeds "
        f"{REF_RF_REGRETS[0]}-{REF_RF_REGRETS[1]}) at {rf_bo.xopt.tolist()[0]}, {rf_bo.eval_count} "
        f"evaluations in {wall:.2f} s; counters {paths['rf_bo_parity_config_4']}")
    assert rf_bo.eval_count == 40 and rf_bo.fopt < doe


# phase 14's objectives: f_k(x) = ||x - c_k||^2 on [0, 1]^d, centers at these
# levels (the bi- and tri-sphere)
BI_SPHERE, TRI_SPHERE = (0.2, 0.8), (0.2, 0.5, 0.8)


def spheres(levels):
    """The objective callables of a multi-sphere, one a center level."""
    return [lambda x, c=c: float(np.sum((np.asarray(x, dtype=float) - c) ** 2)) for c in levels]


def sphere_data(n: int, d: int, levels, seed: int):
    """n uniform points of [0, 1]^d from the seed and their objectives (n, m)."""
    X = np.random.default_rng(seed).uniform(0, 1, (n, d))
    return X, np.stack([((X - c) ** 2).sum(1) for c in levels], axis=1)


def mo_optimizer(cls, levels, d: int = DIM, **kw):
    return cls(search_space=RealSpace([[0.0, 1.0]] * d, random_seed=0), obj_fun=spheres(levels),
               n_obj=len(levels), random_seed=0, **kw)


def front_line(opt) -> str:
    part = opt._partition()
    return (f"front {len(part.pareto_Y)} of {opt.data.N} points, {len(part.cell_lower)} cells, "
            f"hypervolume {opt._last_hv:.6f}")


def mobo_ask(paths: dict):
    """14a: MOBO's ask at full width: 1000 bi-sphere observations told at
    once (the cold 2-output fit), one cold ask, then 2 warm-ups and 3 timed
    iterations of a warm refit plus the ask (partition on the host, the BFGS
    EHVI argmax with 25 restarts); one argmax profiled; the card's EHVI at
    the winner and at 64 random points against the CPU path in float64."""
    X, F = sphere_data(1000, DIM, BI_SPHERE, seed=14)
    opt = mo_optimizer(MOBO, BI_SPHERE, DoE_size=10, max_FEs=10 ** 6)
    assert opt._argmax.method == "BFGS" and opt._argmax.n_restart == 25
    reset_launch_counts()
    _, cold_fit = timed(lambda: opt.tell(X.tolist(), F))
    gp = opt.model
    _, cold_ask = timed(opt.ask)
    reps = []
    for _ in range(5):
        _, fit_s = timed(opt.update_model)
        c0 = counts()
        _, ask_s = timed(opt.ask)
        reps.append((fit_s, ask_s, counts()["matern_fused_bwd"] - c0["matern_fused_bwd"]))
    c = paths["mobo_ehvi_ask"] = counts()
    assert live(c), c
    _, part_s = timed(opt._partition)
    t = reps[2:]
    log(f"[14] (a) MOBO ask, n=1000 d=5 bi-sphere (2-output GP, whiten_fused mb=3): cold fit "
        f"{cold_fit:.4f} s, cold ask {cold_ask:.4f} s; warm refit {[round(f, 4) for f, _, _ in t]} s, "
        f"ask {[round(a, 4) for _, a, _ in t]} s (median fit + ask "
        f"{statistics.median([f + a for f, a, _ in t]):.4f} s); L-BFGS trips an ask "
        f"{[n for _, _, n in t]}, ms a trip {[round(a / n * 1e3, 2) for _, a, n in t]}; the "
        f"partition alone {part_s * 1e3:.2f} ms (host); {front_line(opt)}; log-likelihood "
        f"{gp.log_likelihood_:.4f}; counters over the {len(reps) + 1} iterations {c}")
    am, enc = opt._argmax, opt.encoding
    par = opt._acq_par_defaults({})
    pool_state = am._gen.get_state()
    c0 = counts()
    (Xw, vals), dev_ms, n_k, wall_p = profiled(lambda: opt.arg_max_acquisition(return_value=True))
    trips = counts()["matern_fused_bwd"] - c0["matern_fused_bwd"]
    u, v = np.asarray(Xw[0], dtype=float), float(vals[0])
    log(f"  one argmax profiled: {trips} trips, {fmt(n_k, 'g')} launches, {fmt(ratio(n_k, trips), '.1f')} "
        f"a trip, {fmt(dev_ms, '.2f')} ms on the device, {wall_p:.4f} s with the profiler on (idle share "
        f"{fmt(idle_share(dev_ms, wall_p), '.3f')}); EHVI {v:.6e} at {np.round(u, 4).tolist()}")
    # the card's criterion at the pool of starts the argmax drew and at 64 points
    starts = torch.rand((1, am.n_restart, DIM), generator=torch.Generator().set_state(pool_state))[0]
    crit = make_unit_criterion(enc, gp.posterior, gp.config, "EHVI", am._lane_params(par))
    U64 = np.random.default_rng(15).uniform(0, 1, (64, DIM))
    with torch.no_grad():
        at_starts = crit(starts.to(opt.device)).cpu().double().numpy()
        at_64 = crit(torch.tensor(U64, dtype=torch.float32, device=opt.device)).cpu().double().numpy()
    log(f"  EHVI at its best start {at_starts.max():.6e}, at the winner {v:.6e}")
    assert v >= at_starts.max(), (v, at_starts.max())
    check_mo_f32("EHVI at 64 random points", at_64, *(cpu_values(gp, enc, "EHVI", par, U64, dtype=dt)
                                                      for dt in (torch.float32, torch.float64)))
    # what limits float32 there: the posterior's moments at the 64 points,
    # the card's state carried to the CPU in float32 and in float64
    (mu32, sd32), (mu64, sd64) = (cpu_moments(gp, U64, dt) for dt in (torch.float32, torch.float64))
    cells = [torch.tensor(par[k], dtype=torch.float64) for k in ("cell_lower", "cell_upper")]
    e64 = ehvi(mu64, sd64, *cells)

    def off(e):
        return float((e - e64).abs().max() / e64.abs().max())

    log(f"  the float32 posterior there against float64: mean max abs err "
        f"{float((mu32 - mu64).abs().max()):.3e}, sigma max rel err "
        f"{float(((sd32 - sd64).abs() / sd64).max()):.3e}, sigma {float(sd64.min()):.3e}-"
        f"{float(sd64.max()):.3e}; EHVI from the float32 mean alone {off(ehvi(mu32, sd64, *cells)):.3e} of "
        f"its largest value, from the float32 sigma alone {off(ehvi(mu64, sd32, *cells)):.3e}")
    check_mo_f32("EHVI at the winner", [v], *(cpu_values(gp, enc, "EHVI", par, u, dtype=dt)
                                              for dt in (torch.float32, torch.float64)))
    return X, F


def cpu_moments(gp, U, dtype):
    """(mu, sigma) in float64 of a GP's state carried to the CPU in dtype,
    at unit points U of a [0, 1]^d space."""
    state = type(gp.posterior)(*(t.cpu().to(dtype) for t in gp.posterior))
    E = torch.tensor(U, dtype=dtype)
    mu, var = predict_gp(state, E, trend_basis(gp.config, E), gp.config, True)
    return mu.double(), var.clamp_min(0.0).sqrt().double()


def check_mo_f32(label, values, cpu32, cpu64) -> None:
    """A multi-objective criterion on the card against the CPU path in
    float64, by the largest error over the largest value: within 1e-4, or
    within MO_F32_FACTOR times the CPU float32 path's own error."""
    values, scale = np.asarray(values, dtype=float), float(np.abs(cpu64).max())
    err, err_cpu = (float(np.abs(a - cpu64).max()) / scale for a in (values, cpu32))
    tol = max(1e-4, MO_F32_FACTOR * err_cpu)
    log(f"  {label} (largest {scale:.4e}) against the CPU path in float64, max abs err over the "
        f"largest value: the card {err:.3e} (tol {tol:.3e}), the CPU float32 path {err_cpu:.3e}")
    assert np.all(np.isfinite(values)) and err < tol, (label, values, cpu32, cpu64)


def mobo_qehvi_ask(X, F, paths: dict):
    """14b: MOBO_qEHVI's joint ask, q = 4, on 14a's 1000 observations: the
    CMA engine on the 20-dimensional replicated space (80 chains); a cold
    and a warm ask, one joint argmax profiled, peak device memory; the
    card's qEHVI at the winner against the CPU path on the same samples."""
    q = 4
    opt = mo_optimizer(MOBO_qEHVI, BI_SPHERE, DoE_size=10, max_FEs=10 ** 6, n_point=q)
    reset_launch_counts()
    _, fit_s = timed(lambda: opt.tell(X.tolist(), F))
    gp = opt.model
    torch.cuda.reset_peak_memory_stats()
    Xq, cold = timed(opt.ask)
    _, warm = timed(opt.ask)
    c = paths["mobo_qehvi_ask"] = counts()
    assert live(c), c
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    am = opt._q_argmax(q)
    par = opt._qehvi_par(q)
    c0 = counts()
    (u, v), dev_ms, n_k, wall_p = profiled(lambda: am(gp.posterior, gp.config, f"qEHVI{q}", par))
    evals = counts()["matern_fused"] - c0["matern_fused"]  # one cross-covariance an evaluation
    log(f"[14] (b) MOBO_qEHVI, q={q}, n=1000: cold fit {fit_s:.4f} s, ask cold {cold:.4f} s, warm "
        f"{warm:.4f} s ({am.n_chains} chains x {am.n_generations} generations on the "
        f"{am.encoding.dim}-dimensional replicated space, {QEHVI_N_SAMPLES} samples); {len(Xq)} points; "
        f"peak device memory over the asks "
        f"{peak:.1f} MiB; one joint argmax profiled: {evals} criterion evaluations, {fmt(n_k, 'g')} "
        f"launches, {fmt(ratio(n_k, evals), '.1f')} an evaluation, {fmt(dev_ms, '.2f')} ms on the device, "
        f"{wall_p:.4f} s with the profiler on (idle share {fmt(idle_share(dev_ms, wall_p), '.3f')}); "
        f"qEHVI {v:.6e}; counters over the fit and the two asks {c}")
    assert len(Xq) == q and all(len(x) == DIM for x in Xq)
    par_np = {k: np.asarray(t) for k, t in par.items()}
    check_mo_f32(f"qEHVI{q} at the winner, same samples", [v],
                 *(cpu_values(gp, am.encoding, f"qEHVI{q}", par_np, u, dtype=dt)
                   for dt in (torch.float32, torch.float64)))


def mobo_three_objectives(paths: dict):
    """14c: MOBO on the tri-sphere at n = 300 (3-output GP, whiten_fused
    mb = 4): cells, the partition's host seconds, the argmax's wall; then
    the port's WFG hypervolume at m = 3 and 4 against the grid."""
    X, F = sphere_data(300, DIM, TRI_SPHERE, seed=16)
    opt = mo_optimizer(MOBO, TRI_SPHERE, DoE_size=10, max_FEs=10 ** 6)
    reset_launch_counts()
    _, fit_s = timed(lambda: opt.tell(X.tolist(), F))
    part, part_s = timed(opt._partition)
    Xa, ask_s = timed(opt.ask)
    c = paths["mobo_m3_ask"] = counts()
    assert live(c) and len(Xa) == 1, c
    log(f"[14] (c) MOBO, m=3 tri-sphere, n=300: fit {fit_s:.4f} s, partition {part_s:.4f} s (host, "
        f"{len(part.cell_lower)} cells), ask {ask_s:.4f} s; {front_line(opt)}; counters {c}")
    rng = np.random.default_rng(17)
    for m, n in ((3, 30), (4, 12)):
        Y = rng.uniform(0.1, 1.0, (n, m))
        (hv_w, t_w), (hv_g, t_g) = timed(lambda: wfg_hypervolume(Y, np.zeros(m))), \
            timed(lambda: _hv_grid(Y, np.zeros(m)))
        rel = abs(hv_w - hv_g) / hv_g
        log(f"  WFG hypervolume, {n} points, m={m}: {hv_w:.12f} in {t_w * 1e3:.2f} ms, the grid "
            f"{hv_g:.12f} in {t_g * 1e3:.2f} ms, rel err {rel:.3e} (tol 1e-10)")
        assert rel < 1e-10


def mobo_end_to_end(paths: dict):
    """14d: MOBO runs on the bi-sphere in d = 2, seed 0: with the GP (DoE
    10, 30 objective evaluations), with a 30-tree RandomForest (MIES over a
    multi-output forest, DoE 6, 20 evaluations) and under an inequality
    x0 + x1 <= 1 (DoE 6, 24 evaluations); each front's hypervolume on the
    final normalization against its DoE's, every constrained point
    feasible."""
    def run(label, key, **kw):
        opt = mo_optimizer(MOBO, BI_SPHERE, d=2, **kw)
        reset_launch_counts()
        _, wall = timed(opt.run)
        paths[key] = counts()
        doe = NondominatedPartitioning(opt.ref_point, opt.y[:kw["DoE_size"]]).compute_hypervolume()
        log(f"  (d) {label}: {opt.data.N} points, {opt.eval_count} objective evaluations in {wall:.2f} s; "
            f"{front_line(opt)} (the DoE's {doe:.6f}); counters {paths[key]}")
        assert opt._last_hv > doe and opt.eval_count == kw["max_FEs"]
        return opt

    log("[14] (d) MOBO end to end, bi-sphere, d=2, seed 0")
    run("GP, EHVI on BFGS", "mobo_e2e", DoE_size=10, max_FEs=30)
    rf = run("30-tree RandomForest, EHVI on MIES", "mobo_rf_e2e", DoE_size=6, max_FEs=20,
             model=RandomForest(n_estimators=30, random_state=0, feature_space="embedding"))
    assert rf._argmax.method == "MIES"
    con = run("GP under x0 + x1 <= 1", "mobo_constrained_e2e", DoE_size=6, max_FEs=24,
              ineq_fun=lambda x: x[0] + x[1] - 1.0)
    V = np.asarray(con.data.values, dtype=float)
    log(f"  (d) constrained: largest x0 + x1 of a told point {float(V.sum(1).max()):.6f} (<= 1)")
    assert float(V.sum(1).max()) <= 1.0 + 1e-6


# ------------------------------------------------------------------ phase 15
REPO = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"  # phase 15's device (the CPU only to debug the phase off the card)


def http(url: str, payload=None) -> dict:
    """One request (POST when payload is given); a reply carrying "error"
    (the handler's 4xx/5xx for any exception) fails the phase."""
    req = url if payload is None else urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise AssertionError(f"{url}: HTTP {e.code} {e.read().decode()}") from e
    assert "error" not in out, (url, out)
    return out


def rows(X) -> list:
    return [{f"x{j}": float(v) for j, v in enumerate(r)} for r in np.atleast_2d(X)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pid_gone(pid: int) -> bool:
    """Whether pid no longer runs (absent, or a zombie nobody reaped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


BOX5 = {"x": {"type": "r", "range": [-5, 5], "N": DIM}}
# bench.py's domain: the job's unit cube holds phase 4's X. On [-5, 5]^5
# these points fill a tenth of each axis, the EI is flat wherever a start
# lands and the ask returns the pool's first start unmoved.
UNIT5 = {"x": {"type": "r", "range": [0, 1], "N": DIM}}
MIXED_PARAM = {"r": {"type": "r", "range": [-3, 3], "N": 2}, "i": {"type": "i", "range": [0, 10]},
               "c": {"type": "c", "range": ["A", "B", "C"]}}


def service_bench(url: str, service, cold, parts, paths: dict):
    """(a) one job at bench size: DoE ask, a tell of 1000 points, the ask;
    then the same job's tell and ask over HTTP and on the service object in
    this process, in three pairs that alternate which side runs first, so
    that the walls' gap is what HTTP and JSON cost."""
    create = {"search_param": UNIT5, "bo_param": {"DoE_size": 5, "max_iter": 2000, "random_seed": 0}}
    X, y = bench_raw(1000)
    told = {"X": rows(X), "y": y.tolist()}

    def over_http():
        job = http(url, create)["job_id"]
        assert len(http(f"{url}/?ask=null&job_id={job}")["X"]) == 5
        reset_launch_counts()
        ack, tell_s = timed(lambda: http(url, {"job_id": job, **told}))
        out, ask_s = timed(lambda: http(f"{url}/?ask=null&job_id={job}"))
        return job, ack, out["X"], counts(), tell_s, ask_s

    def on_object():
        job = service.create(create)["job_id"]
        assert len(service.ask(job)["X"]) == 5
        _, tell_s = timed(lambda: service.tell({"job_id": job, **told}))
        out, ask_s = timed(lambda: service.ask(job))
        assert service.finalize(job)["finalized"]
        return job, None, out["X"], None, tell_s, ask_s

    job, ack, asked, c, tell_s, ask_s = over_http()
    paths["service_bench"] = c
    assert live(c), c
    u = np.array([[x[f"x{j}"] for j in range(DIM)] for x in asked])
    assert u.shape == (1, DIM) and np.all((u >= 0) & (u <= 1)), u
    rec = http(f"{url}/?recommend=null&job_id={job}")
    assert rec["fopt"] == [float(y.min())], (rec["fopt"], float(y.min()))
    st = http(f"{url}/?status=null&job_id={job}")["job"]
    assert st["eval_count"] == len(X) and st["fopt"] == float(y.min()), st
    assert http(f"{url}/?finalize=null&job_id={job}")["finalized"]
    runs = {"HTTP": [(tell_s, ask_s)], "object": []}
    points = [asked]
    for side in ("object", "object", "HTTP", "HTTP", "object"):
        job_i, _, pts, _, t, a = (over_http if side == "HTTP" else on_object)()
        if side == "HTTP":
            assert http(f"{url}/?finalize=null&job_id={job_i}")["finalized"]
        runs[side].append((t, a))
        points.append(pts)
    t0 = time.perf_counter()
    json.loads(json.dumps({"job_id": job, **told}))
    json_s = time.perf_counter() - t0
    med = {side: [statistics.median(w[i] for w in ws) for i in (0, 1)] for side, ws in runs.items()}
    fit4 = statistics.median([f for f, _ in parts])
    arg4 = statistics.median([a for _, a in parts])
    log(f"[15] (a) the service (device cuda, in this process) on [0, 1]^5, n=1000: tell (1000 dict "
        f"rows, the cold fit) over HTTP {[round(t, 4) for t, _ in runs['HTTP']]} s, on the service "
        f"object {[round(t, 4) for t, _ in runs['object']]} s (medians {med['HTTP'][0]:.4f} and "
        f"{med['object'][0]:.4f}, gap {med['HTTP'][0] - med['object'][0]:+.4f} s); ask (the BFGS EI "
        f"argmax) over HTTP {[round(a, 4) for _, a in runs['HTTP']]} s, on the object "
        f"{[round(a, 4) for _, a in runs['object']]} s (medians {med['HTTP'][1]:.4f} and "
        f"{med['object'][1]:.4f}, gap {med['HTTP'][1] - med['object'][1]:+.4f} s); the pairs ran HTTP "
        f"first, then the object first, then HTTP first; JSON encode + decode of the tell "
        f"{json_s * 1e3:.2f} ms; every job asked the same point {all(p == asked for p in points)}; "
        f"phase 4's warm fit {fit4:.4f} s and argmax {arg4:.4f} s (medians), its cold fit "
        f"{cold[0]:.4f} s; n={len(X)}, iteration {ack['iteration']}, asked {np.round(u[0], 4).tolist()}, "
        f"recommend fopt {rec['fopt'][0]:.6f}; counters of the first tell + ask over HTTP {c}")
    return tell_s, ask_s


def service_two_jobs(url: str, paths: dict):
    """(b) a ParallelBO job and a mixed-space job at once, 3 rounds each."""
    def parallel_obj(x):
        return sphere([x[f"x{j}"] for j in range(DIM)])

    def mixed(x):
        return mixed_obj([x["r0"], x["r1"], x["i"], x["c"]])

    jobs = {"ParallelBO q=4": (BOX5, {"n_point": 4, "DoE_size": 8, "max_iter": 10, "random_seed": 0},
                               parallel_obj),
            "mixed (MIES)": (MIXED_PARAM, {"DoE_size": 8, "max_iter": 10, "random_seed": 0}, mixed)}
    results, errors = {}, []

    def client(name):
        try:
            space, bo, f = jobs[name]
            job = http(url, {"search_param": space, "bo_param": bo})["job_id"]
            t0, sizes = time.perf_counter(), []
            for _ in range(3):
                X = http(f"{url}/?ask=null&job_id={job}")["X"]
                sizes.append(len(X))
                http(url, {"job_id": job, "X": X, "y": [f(x) for x in X]})
            rec = http(f"{url}/?recommend=null&job_id={job}")
            http(f"{url}/?finalize=null&job_id={job}")
            results[name] = (time.perf_counter() - t0, sizes, rec["fopt"][0])
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)

    reset_launch_counts()
    threads = [threading.Thread(target=client, args=(name,)) for name in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    c = paths["service_two_jobs"] = counts()
    assert live(c), c
    log(f"  (b) two jobs at once, 3 ask/tell rounds each: " + "; ".join(
        f"{name}: {w:.2f} s, asks of {sizes} points, fopt {f:.6g}" for name, (w, sizes, f) in results.items())
        + f"; counters {c}")
    assert results["ParallelBO q=4"][1] == [8, 4, 4] and results["mixed (MIES)"][1] == [8, 1, 1], results


def service_daemon():
    """(c) `python -m ...simple_http_server -d --device cuda` and stop."""
    port = free_port()
    pidfile = pidfile_for(port)
    assert not os.path.exists(pidfile), pidfile
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    launcher = subprocess.run([sys.executable, "-m", "bayesian_optimization_tpu_torch.simple_http_server",
                               "-d", "--device", DEV, "-w", str(port)], env=env,
                              capture_output=True, text=True, timeout=120)
    assert launcher.returncode == 0, launcher.stderr
    pid, url = None, f"http://127.0.0.1:{port}"
    try:
        while True:
            pid = pid or daemon.read_pid(pidfile)
            try:
                health = http(f"{url}/health")
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.perf_counter() - t0 < 120, "the daemon never answered"
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        pid = daemon.read_pid(pidfile)
        assert health["status"] == "ok" and pid is not None and daemon.status(pidfile)
        job = http(url, {"search_param": {"x": {"type": "r", "range": [-5, 5], "N": 2}},
                         "bo_param": {"DoE_size": 5, "random_seed": 0}})["job_id"]
        t1 = time.perf_counter()
        X = http(f"{url}/?ask=null&job_id={job}")["X"]
        http(url, {"job_id": job, "X": X, "y": [x["x0"] ** 2 + x["x1"] ** 2 for x in X]})
        nxt = http(f"{url}/?ask=null&job_id={job}")["X"]
        work_s = time.perf_counter() - t1
        assert len(nxt) == 1 and all(-5 <= v <= 5 for v in nxt[0].values()), nxt
        assert daemon.stop(pidfile)
        t2 = time.perf_counter()
        while not (pid_gone(pid) and not os.path.exists(pidfile)):
            assert time.perf_counter() - t2 < 60, "the daemon outlived SIGTERM"
            time.sleep(0.1)
        log(f"  (c) the daemon (pid {pid}, port {port}, pidfile {os.path.basename(pidfile)}): answered "
            f"after {up_s:.2f} s; DoE ask + tell (a fit on the card) + ask {work_s:.2f} s, no error; "
            f"stopped in {time.perf_counter() - t2:.2f} s, pid gone, pidfile removed")
    finally:
        if pid is not None and not pid_gone(pid):
            os.kill(pid, signal.SIGKILL)  # this exact pid, never by pattern


def mesh_checks(gp, y, paths: dict):
    """(d) the particle mesh on the card."""
    enc = RealSpace([[0.0, 1.0]] * DIM).encoding()
    plugin = float(y.min())
    mesh = make_particle_mesh()
    pool = np.random.default_rng(9).uniform(0, 1, (25, DIM))
    reset_launch_counts()
    u1, v1 = AcquisitionArgmax(enc, method="BFGS", n_restart=25, seed=0, mesh=mesh, device=DEV)(
        gp.posterior, gp.config, "EI", {"plugin": plugin}, x0_seed=pool)
    u0, v0 = AcquisitionArgmax(enc, method="BFGS", n_restart=25, seed=0, device=DEV)(
        gp.posterior, gp.config, "EI", {"plugin": plugin}, x0_seed=pool)
    log(f"  (d) torch.cuda.device_count() {torch.cuda.device_count()}, default mesh size {mesh.size}: "
        f"BFGS EI argmax on phase 4's posterior from one pool of 25, sharded {v1:.9e} at "
        f"{np.round(u1, 6).tolist()}, unsharded {v0:.9e} at {np.round(u0, 6).tolist()}; gathers {mesh.gathers}")
    assert mesh.gathers == 1
    if mesh.size == 1:  # the same lanes on the same card: the same winner
        assert np.array_equal(u1, u0) and v1 == v0, (u1, u0, v1, v0)
    else:
        assert abs(v1 - v0) <= 1e-4 * abs(v0), (v1, v0)
    crit = make_unit_criterion(enc, gp.posterior, gp.config, "EI",
                               {"plugin": torch.tensor(plugin, device=DEV)})
    am = AcquisitionArgmax(enc, method="SMC", seed=0, device=DEV)
    zeros = torch.zeros(DIM, device=DEV)

    def neg(U):
        return -crit(U)

    def gen():
        return torch.Generator(device=DEV).manual_seed(5)

    walls = {}
    for engine, P, want in (("BFGS", 25, 1), ("CMA", am.n_chains, 1), ("SMC", am.n_chains, am.n_smc_rounds + 1)):
        mesh2 = make_particle_mesh(devices=[DEV] * 2)
        x0 = torch.tensor(pool if engine == "BFGS" else np.random.default_rng(10).uniform(0, 1, (P, DIM)),
                          dtype=torch.float32, device=DEV)
        pop = shard_population(x0, mesh2)
        full = torch.cat(pop.chunks)
        with torch.no_grad():
            if engine == "BFGS":
                (xr, fr), t_ref = timed(lambda: argmax_module._bfgs_lanes(crit, full, 40))
                (xs, fs), t_sh = timed(lambda: argmax_module._bfgs_lanes([crit] * 2, pop, 40))
                best_r, best_s = float(fr.max()), float(fs.max())
            elif engine == "CMA":
                ref, t_ref = timed(lambda: run_cma(gen(), neg, full, zeros, zeros + 1.0, am.n_generations))
                got, t_sh = timed(lambda: run_cma(gen(), [neg] * 2, pop, zeros, zeros + 1.0, am.n_generations))
                (_, fr0, xr, fr), (_, fs0, xs, fs) = ref, got
                best_r, best_s = -float(fr0), -float(fs0)
            else:
                ref, t_ref = timed(lambda: run_smc(gen(), neg, full, zeros, zeros + 1.0, am.n_smc_rounds,
                                                   am.n_smc_moves))
                got, t_sh = timed(lambda: run_smc(gen(), [neg] * 2, pop, zeros, zeros + 1.0, am.n_smc_rounds,
                                                  am.n_smc_moves))
                (_, fr0, xr, fr), (_, fs0, xs, fs) = ref, got
                best_r, best_s = -float(fr0), -float(fs0)
        lane = (fs - fr).abs() / fr.abs().clamp_min(1e-30)
        parted = int((lane > 1e-6).sum())
        walls[engine] = (t_ref, t_sh)
        log(f"    2-entry mesh over cuda:0, {engine} ({pop.shape[0]} lanes from {P}): winner sharded "
            f"{best_s:.9e}, unsharded {best_r:.9e} (rel {abs(best_s - best_r) / abs(best_r):.3e}, tol 1e-4); "
            f"{parted} of {pop.shape[0]} lanes part by > 1e-6 relative (largest {float(lane.max()):.3e}); "
            f"gathers {mesh2.gathers} (want {want}); {t_sh:.4f} s sharded, {t_ref:.4f} s unsharded")
        assert mesh2.gathers == want, (engine, mesh2.gathers)
        assert abs(best_s - best_r) <= 1e-4 * abs(best_r), (engine, best_s, best_r)
    torch.cuda.synchronize()
    c = paths["mesh_argmax"] = counts()
    # an argmax factors nothing: the Matern forward and backward only
    assert c["matern_fused"] > 0 and c["matern_fused_bwd"] > 0, c


def entry_checks(paths: dict, grad_abs_tol: float):
    """(e) the entry analog on the card."""
    reset_launch_counts()
    fn, args = entry(DEV)
    (vals, grads), wall = timed(lambda: fn(*args))
    c = paths["entry"] = counts()
    assert live(c), c
    fn_c, args_c = entry(device="cpu")
    vals_c, grads_c = fn_c(*args_c)
    err_v = float(((vals.cpu() - vals_c).abs() / vals_c.abs()).max())
    abs_g = float((grads.cpu() - grads_c).abs().max())
    err_g = abs_g / float(grads_c.abs().max())
    # phase 4's absolute tolerance comes from n=1000's gradients, loose at
    # n=24: the gradient is also held to phase 4's relative one
    log(f"  (e) entry() on the card, 8 theta x (n=24 padded to 32, d=3): {wall * 1e3:.2f} ms, values "
        f"rel err {err_v:.3e} against the CPU path (tol 1e-4), gradient abs err {abs_g:.3e} (tol "
        f"{grad_abs_tol:.3e}, phase 4's), {err_g:.3e} relative to its largest entry (tol 1e-3); "
        f"counters {c}")
    assert err_v < 1e-4 and abs_g < grad_abs_tol and err_g < 1e-3, (err_v, abs_g, err_g)
    _, dry = timed(lambda: dryrun_multidevice(2, devices=[DEV] * 2))
    log(f"  dryrun_multidevice(2) on ['cuda:0', 'cuda:0']: {dry:.2f} s")


def service_and_mesh(gp, y, cold, parts, paths: dict, grad_abs_tol: float):
    """Phase 15: the service, the daemon, the mesh and the entry points."""
    server = serve(port=0, device=DEV)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        service_bench(url, server.service, cold, parts, paths)
        stamp("phase 15b")
        service_two_jobs(url, paths)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    stamp("phase 15c")
    service_daemon()
    stamp("phase 15d")
    mesh_checks(gp, y, paths)
    stamp("phase 15e")
    entry_checks(paths, grad_abs_tol)


# phase 16: d = 5 on bench.py's domain [0, 1]^5 (on [-5, 5]^5 EI goes flat
# where every start lands), a DoE of 10
P16_DOE, P16_Q, P16_BATCHES = 10, 2, 2


def p16_f(x):
    """bench.py's function without its noise."""
    return float(np.sin(3 * np.asarray(x, dtype=float)).sum())


def p16_bo(cls=BO, **kw):
    """cls on [0, 1]^5 (variables x0..x4) on the card with the default
    model, seed 0."""
    return cls(search_space=RealSpace([[0.0, 1.0]] * DIM, var_name="x", random_seed=0),
               obj_fun=kw.pop("obj_fun", p16_f),
               DoE_size=P16_DOE, random_seed=0, device=DEV, **kw)


def record_batches(opt) -> list:
    """Wrap opt's batch argmax: each call appends (criterion, its parameters,
    the winners, their values, the posterior and config it ran on)."""
    calls, batch = [], opt._argmax.batch

    def recorder(state, config, acq, pars, **kw):
        us, vals = batch(state, config, acq, pars, **kw)
        calls.append((acq, pars, us, vals, type(state)(*(t.clone() for t in state)), config))
        return us, vals

    opt._argmax.batch = recorder
    return calls


def check_against_f64(label, model, enc, acq, pars, us, vals, floor: float = 1e-30) -> None:
    """The card's criterion values at its winners against the CPU path in
    float64 at the same posterior, within 1e-4 of |value| (or `floor`, the
    larger), or within MO_F32_FACTOR times the CPU float32 path's own error
    where that is larger. On these near-interpolating posteriors of a few
    points float32's error scatters from point to point, so its scale is the
    largest over the winner and 32 points within 1e-2 of it."""
    parts = []
    for p, u, v in zip(pars, us, vals):
        U = np.vstack([u, np.clip(u + np.random.default_rng(0).uniform(-1e-2, 1e-2, (32, u.size)), 0.0, 1.0)])
        c32, c64 = (cpu_values(model, enc, acq, p, U, dt) for dt in (torch.float32, torch.float64))
        scale = max(abs(c64[0]), floor)
        tol = max(1e-4, MO_F32_FACTOR * float(np.abs(c32 - c64).max()) / scale)
        err = abs(v - c64[0]) / scale
        parts.append(f"{err:.3e} (tol {tol:.3e})")
        assert np.isfinite(v) and err <= tol, (label, v, c64[0], c32[0], tol)
    log(f"  {label}: the card's criterion at its winners against the CPU path in float64, rel err "
        + ", ".join(parts))


def flavors(paths: dict) -> dict:
    """(a) NoisyBO, AnnealingBO, SelfAdaptiveBO and MultiAcquisitionBO on the
    card, q = 2, the DoE and two batches each; the criterion at each final
    winner against the CPU path's at the same posterior (check_against_f64;
    UCB, which crosses 0, relative to max(|value|, 1))."""
    noise = np.random.default_rng(3)
    walls = {}
    for cls, kw in ((NoisyBO, {"obj_fun": lambda x: p16_f(x) + 0.1 * float(noise.standard_normal())}),
                    (AnnealingBO, {"t0": 2.0, "tf": 0.1}), (SelfAdaptiveBO, {}), (MultiAcquisitionBO, {})):
        opt = p16_bo(cls, n_point=P16_Q, max_FEs=P16_DOE + P16_Q * P16_BATCHES, **kw)
        calls = record_batches(opt)
        reset_launch_counts()
        _, wall = timed(opt.run)
        c = paths[f"flavor_{cls.__name__}"] = counts()
        walls[cls.__name__] = wall
        assert live(c) and opt.eval_count >= P16_DOE + P16_Q * P16_BATCHES, (cls.__name__, c)
        last = calls[-2:] if cls is MultiAcquisitionBO else calls[-1:]
        for acq, pars, us, vals, state, config in last:
            check_against_f64(f"{cls.__name__} {acq} x {len(pars)}", SimpleNamespace(posterior=state, config=config),
                              opt.encoding, acq, pars, us, vals, floor=1.0 if acq == "UCB" else 1e-30)
        extra = (f", t {opt._acquisition_par['t']:.6g}" if "t" in opt._acquisition_par else "")
        log(f"  (a) {cls.__name__}: {opt.eval_count} evaluations ({P16_DOE} DoE + {len(calls)} batch argmax "
            f"calls) in {wall:.2f} s, fopt {opt.fopt:.6g}{extra}; criteria of the last ask "
            f"{[a for a, *_ in last]}; counters {c}")
    return walls


def checkpoint_paths(paths: dict) -> dict:
    """(b) one BO on the card after its DoE: save -> load in this process
    (the loaded BO on the card, its next ask against the original's from
    the same state, its kernels at the ask and the tell), save_state -> a
    fresh BO -> load_state (the same theta and counters), the fixed-variable
    ask through the argmax and through the DoE, and warm data with the dict
    eval type."""
    walls = {}
    opt = p16_bo(max_FEs=100)
    X = opt.ask()
    (_, walls["doe_tell"]) = timed(lambda: opt.tell(X, [p16_f(x) for x in X]))
    theta0, counters0 = opt.model.theta_.copy(), (opt.iter_count, opt.eval_count)
    with tempfile.TemporaryDirectory() as tmp:
        opt.save(os.path.join(tmp, "bo.pkl"))
        opt.save_state(os.path.join(tmp, "bo.json"))
        loaded, walls["load"] = timed(lambda: BO.load(os.path.join(tmp, "bo.pkl")))
        fresh = p16_bo(max_FEs=100)
        _, walls["load_state"] = timed(lambda: fresh.load_state(os.path.join(tmp, "bo.json")))
    on = torch.device(DEV).type
    assert loaded.device.type == on and loaded.model.device.type == on
    assert loaded.model.posterior.L.device.type == on, loaded.model.posterior.L.device
    reset_launch_counts()
    (x_l,), walls["loaded_ask"] = timed(loaded.ask)
    loaded.tell([x_l], [p16_f(x_l)])
    c = paths["loaded_bo"] = counts()
    assert live(c), c
    (x_o,) = opt.ask()
    diff = float(np.abs(np.asarray(x_l) - np.asarray(x_o)).max())
    log(f"  (b) save -> load on the card: loaded in {walls['load']:.4f} s, its model on "
        f"{loaded.model.posterior.L.device}; its next ask {'bit-equal to' if diff == 0.0 else 'apart from'} the "
        f"original's from the same state (largest difference {diff:.3e}) at {np.round(x_l, 6).tolist()}; "
        f"ask + tell counters {c}")
    opt.tell([x_o], [p16_f(x_o)])
    # the JSON state: a cold refit of the same rows from the same generator
    rel = float(np.abs(np.log10(fresh.model.theta_) - np.log10(theta0)).max())
    log(f"  save_state -> fresh BO -> load_state: refit in {walls['load_state']:.4f} s, log10 theta "
        f"{'equal' if rel == 0.0 else f'apart by {rel:.3e}'} (tol 1e-6), counters "
        f"{(fresh.iter_count, fresh.eval_count)} (saved {counters0})")
    assert rel <= 1e-6 and (fresh.iter_count, fresh.eval_count) == counters0, (rel, fresh.theta_, theta0)
    # the fixed-variable ask: the argmax with x0 pinned, then its tell
    reset_launch_counts()
    Xf, walls["fixed_ask"] = timed(lambda: opt.ask(fixed={"x0": 0.5}))
    opt.tell(Xf, [p16_f(x) for x in Xf])
    c = paths["fixed_ask"] = counts()
    assert live(c), c
    doe = p16_bo(max_FEs=100).ask(fixed={"x0": 0.5})
    for x in Xf + doe:
        assert abs(float(x[0]) - 0.5) <= 1e-6 and all(0.0 <= float(v) <= 1.0 for v in x), x
    log(f"  ask(fixed={{'x0': 0.5}}): the argmax's row {np.round(Xf[0], 6).tolist()} in "
        f"{walls['fixed_ask']:.4f} s, the DoE's {len(doe)} rows all at x0 = 0.5, free coordinates in "
        f"[0, 1]; ask + tell counters {c}")
    # warm data, the dict eval type: the warm rows are the data, no evaluation counted
    X0, _ = bench_raw(20)
    reset_launch_counts()
    warm, walls["warm_fit"] = timed(lambda: p16_bo(
        obj_fun=lambda d: p16_f([d[f"x{i}"] for i in range(DIM)]), eval_type="dict", max_FEs=2,
        warm_data=(X0.tolist(), [p16_f(x) for x in X0])))
    c = paths["warm_data"] = counts()
    assert live(c) and warm.data.N == len(X0) and warm.eval_count == 0 and warm.model.is_fitted, c
    warm.run()
    asked = warm.ask()
    assert isinstance(asked[0], dict) and sorted(asked[0]) == [f"x{i}" for i in range(DIM)], asked
    assert warm.eval_count == 2 and warm.data.N == len(X0) + 2
    log(f"  warm_data (20 rows) with eval_type='dict': warm fit {walls['warm_fit']:.4f} s, data {len(X0)} rows, "
        f"0 evaluations counted, then {warm.eval_count} evaluations (data {warm.data.N}); an ask is "
        f"{sorted(asked[0])}; warm fit counters {c}")
    return walls


def gp_modes(paths: dict) -> dict:
    """(c) a noise-estimating fit, a noiseless fit of duplicated, conflicting
    rows (on the CPU the likelihood's jitter carries it; whether the card's
    float32 factorisation escalates it is printed), and a noiseless fit
    whose correlation float32 cannot factor at any theta in its bounds,
    which must escalate to the noisy mode (_escalate_nugget); all finite."""
    walls = {}
    X, y = bench_raw(200)
    reset_launch_counts()
    gp = GaussianProcess(thetaL=1e-2 * np.ones(DIM), thetaU=1e2 * np.ones(DIM), noise_estim=True,
                         nugget=1e-6, random_state=2, device=DEV)
    _, walls["noise_estim"] = timed(lambda: gp.fit(X, y))
    mu, mse = gp.predict(X, eval_MSE=True)
    c = paths["gp_noise_estim"] = counts()
    assert live(c) and np.isfinite(gp.log_likelihood_) and np.all(np.isfinite(mu)) and float(np.mean(mse)) > 1e-8
    log(f"  (c) noise_estim fit at n=200: {walls['noise_estim']:.4f} s, log-likelihood {gp.log_likelihood_:.4f}, "
        f"sigma2 {np.round(np.ravel(gp.sigma2), 6).tolist()}, mean mse "
        f"{float(np.mean(mse)):.3e}, corr(mu, y) {np.corrcoef(mu, y)[0, 1]:.4f}; counters {c}")
    for label, Xg, yg, tl, tu in (
            ("duplicated, conflicting rows", np.vstack([X[:100], X[:100]]),
             np.concatenate([y[:100], y[:100] + 0.5]), 1e-2, 1e2),
            ("theta in [1e-4, 1e-3], n=512", *bench_raw(512), 1e-4, 1e-3)):
        gp = GaussianProcess(mean=constant_trend(DIM), thetaL=tl * np.ones(DIM), thetaU=tu * np.ones(DIM),
                             nugget=0.0, random_start=4, random_state=0, device=DEV)
        escalations = []
        escalate = gp._escalate_nugget
        gp._escalate_nugget = lambda *a: escalations.append(gp.estimation_mode) or escalate(*a)
        reset_launch_counts()
        _, wall = timed(lambda: gp.fit(Xg, yg))
        mu, mse = gp.predict(Xg[:8], eval_MSE=True)
        c = paths["gp_noiseless" if label.startswith("dup") else "gp_escalated"] = counts()
        log(f"  noiseless fit, {label}: {wall:.4f} s, {len(escalations)} escalations, mode "
            f"{gp.estimation_mode}, noise {gp.noise_var:.1e}, log-likelihood {gp.log_likelihood_:.4f}; counters {c}")
        assert live(c) and np.isfinite(gp.log_likelihood_) and np.all(np.isfinite(mu)) and np.all(mse >= 0.0)
        if label.startswith("theta"):
            assert escalations and gp.estimation_mode == "noisy", escalations
        walls[label] = wall
    return walls


def reference_entry_points(paths: dict) -> None:
    """Phase 16: the JAX package's remaining public entry points on the card."""
    log(f"[16] the reference's entry points on the card, d={DIM} on [0, 1]^5, DoE {P16_DOE}")
    walls = {"flavors": flavors(paths)}
    stamp("phase 16b")
    walls["checkpoints"] = checkpoint_paths(paths)
    stamp("phase 16c")
    walls["gp_modes"] = gp_modes(paths)
    names = [k for k in paths if k.startswith(("flavor_", "loaded_bo", "fixed_ask", "warm_data", "gp_"))]
    log("  phase 16 walls (s): " + json.dumps({k: {n: round(v, 4) for n, v in w.items()} for k, w in walls.items()}))
    log("  phase 16 launches by path: " + json.dumps({k: paths[k] for k in names}))


def ptxas_summary(log_text: str):
    """One line per kernel of the build's ptxas report: registers and spill
    bytes. Of the Matern kernels' instantiations (per feature chunk DC and
    map) only those of D = 5 are listed, and any that spills."""
    kernels, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = [0, 0]
        elif name and "spill stores" in line:
            kernels[name][1] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line:
            kernels[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    out = []
    for mangled, (regs, spill) in kernels.items():
        # _ZN <namespace> <name> [I <template args> E] E <parameters>
        i, parts = mangled.index("_ZN") + 3, []
        for _ in range(2):
            n = re.match(r"\d+", mangled[i:]).group()
            parts.append(mangled[i + len(n):i + len(n) + int(n)])
            i += len(n) + int(n)
        short = parts[1]
        args = re.findall(r"L[ib](\d+)E", mangled[i:].split("EEv")[0]) if mangled[i] == "I" else []
        if short.startswith("matern") and args and args[0] != str(DIM) and not spill:
            continue
        out.append(f"{short}<{','.join(args)}>: {regs} registers, {spill} B spill stores")
    return len(kernels), out


def main() -> None:
    # 1. device
    require_cuda()
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[1] device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[2] kernels built from csrc/ in {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}")
    n_kernels, lines = ptxas_summary(_build.build_log())
    log(f"  ptxas: {n_kernels} kernels")
    for line in lines:
        log(f"  ptxas: {line}")

    # 3. kernels against their twins
    stamp("phase 3")
    log("[3] kernels vs plain twins on the card")
    (m_err, m_ms, m_plain, m_bound, m_by), m_rows = check_matern()
    (b_err, b_ms, b_plain, b_bound, b_by), b_rows = check_matern_bwd()
    (h_err, h_ms, h_plain, h_bound, h_by), h_rows = check_matern_bwd2()
    w_err, (w_ms, w_plain, w_bound, w_by), w_rows = check_whiten()
    w_rows.append(check_chol_inv_whiten())
    log("[3b] the card's path against the plain path on the CPU, on a small input")
    check_reference()

    # 4. main path at bench size
    stamp("phase 4")
    X, y = bench_data(1000)
    gp, out, cold, parts, launches = main_path(X, y)
    times = [f + a for f, a in parts]
    log(f"[4] fit + EI argmax, n=1000 d=5: median {statistics.median(times):.4f} s, "
        f"min {min(times):.4f} s over {len(times)} reps {[round(t, 4) for t in times]}; "
        f"fit {[round(f, 4) for f, _ in parts]} s, argmax {[round(a, 4) for _, a in parts]} s; "
        f"cold first iteration: fit {cold[0]:.4f} s, argmax {cold[1]:.4f} s; launches {launches}")
    assert live(launches), launches
    trips = launches["matern_fused_bwd"]  # one Matern backward per L-BFGS trip (fit or argmax)
    log(f"  L-BFGS trips over the {len(parts) + 2} iterations (fit and argmax): {trips}, "
        f"{trips / (len(parts) + 2):.1f} per iteration; matern_fused forward launches per trip "
        f"{launches['matern_fused'] / trips:.3f}")
    u, val = out["u"], out["val"]
    assert np.all(np.isfinite(u)) and math.isfinite(val) and u.shape == (DIM,)
    state = gp.posterior
    min_piv = float(state.min_pivot)
    assert min_piv > PIV_TOL, min_piv
    assert np.isfinite(gp.log_likelihood_) and bool(torch.isfinite(state.gamma).all())
    fit_err = float(np.abs(gp.predict(X[:64]) - y[:64]).max())
    log(f"  log-likelihood {gp.log_likelihood_:.4f}, theta {np.round(gp.theta_, 4).tolist()}, "
        f"min pivot {min_piv:.3e}, max |mu - y| on 64 training points {fit_err:.4f}, "
        f"EI argmax value {val:.4e} at {np.round(u, 4).tolist()}")
    assert fit_err < 0.1, fit_err
    X_h, y_h = held_out(200)
    log(f"  max |mu - y| on 200 held-out points {float(np.abs(gp.predict(X_h) - y_h).max()):.4f}")
    r = likelihood_vs_cpu(X, y, 1024, lanes(np.random.default_rng(4), 4))
    err_v, err_g = r["err_v"], r["err_g"]
    # phase 4's gradient tolerance in absolute terms, the bound phase 9
    # holds the gradient to at the CMA fit's optimum
    grad_abs_tol = 1e-3 * r["scale_g"]
    log(f"  likelihood at 4 lanes, n=1000 (bucket 1024) against the CPU: rel err value "
        f"{err_v:.3e} (tol 1e-4), gradient {err_g:.3e} (tol 1e-3; absolute {r['abs_g']:.3e}, "
        f"largest entry {r['scale_g']:.3e})")
    assert err_v < 1e-4 and err_g < 1e-3, (err_v, err_g)

    # 5. hybrid factorisation
    stamp("phase 5")
    X4, y4 = bench_data(4000)
    gp4 = GaussianProcess(
        mean=constant_trend(DIM), corr="matern",
        thetaL=1e-3 * np.ones(DIM), thetaU=1e3 * np.ones(DIM),
        nugget=1e-6, random_start=10, random_state=0,
    )
    t0 = time.perf_counter()
    gp4.fit(X4, y4)
    torch.cuda.synchronize()
    t4 = time.perf_counter() - t0
    piv4 = float(gp4.posterior.min_pivot)
    log(f"[5] fit n=4000 (bucket 4096, hybrid): {t4:.4f} s (first call), "
        f"log-likelihood {gp4.log_likelihood_:.4f}, min pivot {piv4:.3e}, noise {gp4.noise_var:.1e}")
    assert np.isfinite(gp4.log_likelihood_) and piv4 > PIV_TOL

    # 6. fmin end to end (parity config 1, cut in depth)
    stamp("phase 6")
    t0 = time.perf_counter()
    xopt, fopt, iters, evals, hist = fmin(sphere, [-5.0] * 2, [5.0] * 2, max_FEs=15, x0=5, seed=42)
    doe_best = min(sphere(x) for x in hist[0])
    log(f"[6] fmin 2-D sphere, 15 of parity config 1's 30 FEs, seed 42: regret {fopt:.6g} (DoE-only best {doe_best:.6g}), "
        f"{evals} evaluations in {time.perf_counter() - t0:.2f} s")
    assert fopt < doe_best and evals == 15

    # 7-10. the batch and derivative-free paths, each with the counters
    # zeroed just before it and read just after
    paths = {"bfgs_ei_main_path": launches}
    stamp("phase 7")
    parallel_ask(X, y, paths)
    stamp("phase 8")
    engine_runs(gp, X, y, paths)
    stamp("phase 9")
    cma_mle(X, y, gp, paths, grad_abs_tol)
    stamp("phase 10")
    parity_runs(paths)

    # 11. the posterior-ensemble paths at bench size
    stamp("phase 11")
    nuts_gp, leaps = nuts_path(X, y, gp, paths)
    hmc_vi_paths(X, y, paths)
    ensemble_vs_cpu(nuts_gp, X, y, paths, 1e-4 * float(np.abs(r["nll"]).max()), grad_abs_tol)

    # 12. the constrained, PCA-reduced and GEI paths; (a) whiten's backward
    stamp("phase 12")
    log("[12] (a) whiten's backward over the kernel's Dinv")
    whiten_backward(leaps)
    stamp("phase 12b")
    constrained_paths(X, y, gp, u, paths)
    stamp("phase 12c-d")
    parity_constrained_pca(X, y, gp, paths)

    # 13. the other covariances, float64 on the card, the GP's derivatives,
    # chol_and_inv, and the tree-surrogate and conditional paths
    stamp("phase 13")
    other_kernels(X, y, paths)
    float64_gp(X, y, paths)
    derivatives(gp, paths)
    chol_and_inv_check(paths)
    stamp("phase 13e")
    forest_paths(paths)
    nonparametric_trend_path(X, y, paths)
    stamp("phase 13g")
    conditional_and_rf_bo(paths)

    # 14. the multi-objective paths
    stamp("phase 14")
    X_mo, F_mo = mobo_ask(paths)
    stamp("phase 14b")
    mobo_qehvi_ask(X_mo, F_mo, paths)
    stamp("phase 14c")
    mobo_three_objectives(paths)
    stamp("phase 14d")
    mobo_end_to_end(paths)

    # 15. the service, the daemon, the particle mesh and the entry points
    stamp("phase 15")
    service_and_mesh(gp, y, cold, parts, paths, grad_abs_tol)

    # 16. the flavors, checkpoints, fixed asks, warm data and GP modes
    stamp("phase 16")
    reference_entry_points(paths)
    log(f"  profiler sessions: {PROFILER_SESSIONS['run']}, of which {PROFILER_SESSIONS['empty']} traced "
        f"no kernel")

    # ms, plain_ms and bound_ms: matern_fused at (10, 1024, 1024), its
    # backward at (2, 1024, 1024) (theta only), its second derivative at
    # (1, 1, 1024), whiten_fused at (2, 1024); "shapes" the batch and engine
    # paths' shapes; "launches" the main path's count (the second
    # derivative's: the Hessian path's, 13c), "launches_by_path" every
    # path's. No single PyTorch call computes any of the four functions
    def by_path(name):
        return {path: c[name] for path, c in paths.items()}

    kernels = [
        {"name": "matern_fused", "route": "cuda",
         "source": "bayesian_optimization_tpu_torch/csrc/matern.cu",
         "replaces": f"{PALLAS}:98", "launches": launches["matern_fused"],
         "max_abs_err": m_err, "ms": m_ms, "plain_ms": m_plain, "bound_ms": m_bound,
         "bound_by": m_by, "library_ms": None, "shapes": m_rows,
         "launches_by_path": by_path("matern_fused")},
        {"name": "matern_fused_bwd", "route": "cuda",
         "source": "bayesian_optimization_tpu_torch/csrc/matern.cu",
         "replaces": f"{PALLAS}:98", "launches": launches["matern_fused_bwd"],
         "max_abs_err": b_err, "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
         "bound_by": b_by, "library_ms": None, "shapes": b_rows,
         "launches_by_path": by_path("matern_fused_bwd")},
        {"name": "matern_fused_bwd2", "route": "cuda",
         "source": "bayesian_optimization_tpu_torch/csrc/matern_bwd2.cu",
         "replaces": f"{PALLAS}:98", "launches": paths["gradient_hessian"]["matern_fused_bwd2"],
         "max_abs_err": h_err, "ms": h_ms, "plain_ms": h_plain, "bound_ms": h_bound,
         "bound_by": h_by, "library_ms": None, "shapes": h_rows,
         "launches_by_path": by_path("matern_fused_bwd2")},
        {"name": "whiten_fused", "route": "cuda",
         "source": "bayesian_optimization_tpu_torch/csrc/whiten.cu",
         "replaces": f"{PALLAS}:278", "launches": launches["whiten_fused"],
         "max_abs_err": w_err, "ms": w_ms, "plain_ms": w_plain, "bound_ms": w_bound,
         "bound_by": w_by, "library_ms": None, "shapes": w_rows,
         "launches_by_path": by_path("whiten_fused")},
    ]
    log(f"total {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
