"""Entry points: the flagship compute step and a mesh dry run.

Counterpart of the JAX repository's `__graft_entry__.py`.

`entry()` returns (fn, args): fn is the batched GP concentrated negative
log-likelihood and its gradient over a batch of hyperparameter vectors (the
O(n^3) heart of every BO iteration) through models/likelihood.py, so on
the card it runs the Matern kernel (csrc/matern.cu) and the blocked
factorisation (csrc/whiten.cu) forward and backward; args is the same
problem the JAX entry builds (n = 24 rows padded to 32, d = 3, 8 theta
vectors), drawn with numpy from seed 0.

`dryrun_multidevice(n)` runs one sharded BO compute step on an n-entry
particle mesh: an MLE gradient step over sharded theta with the mesh-wide
argmin, the posterior, a CMA generation over 4n sharded chains, an SMC
resampling across the mesh and a second generation with the champion, and
2n HMC chains from sharded starts.

    python -m bayesian_optimization_tpu_torch.entry [--device cpu] [--mesh 8]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ._device import DEFAULT_DEVICE, resolve_device
from .models.hmc import hmc_sample
from .models.likelihood import GPConfig, neg_log_likelihood, posterior_state, predict, trend_basis
from .ops.acquisition import ei
from .optim.smc import run_smc
from .parallel.mesh import ParticleMesh, make_particle_mesh, replicated, shard_population

CONFIG = GPConfig(kernel="matern", mode="noisy", estimate_trend=True)
NUGGET = 1e-6


def _make_problem(n=24, n_pad=32, d=3, n_theta=8, dtype=torch.float32, device=DEFAULT_DEVICE):
    """(theta_batch, X, Y, F, mask, n): the JAX entry's problem, the same
    numpy draws, as tensors on `device`."""
    rng = np.random.default_rng(0)
    X = np.zeros((n_pad, d))
    X[:n] = rng.uniform(0, 1, (n, d))
    y = np.zeros((n_pad, 1))
    y[:n, 0] = np.sin(X[:n] * 6).sum(1)
    mask = np.zeros(n_pad)
    mask[:n] = 1.0
    F = np.zeros((n_pad, 1))
    F[:n] = 1.0
    theta_batch = rng.uniform(-1, 1, (n_theta, d + 1))  # log10(theta) ++ log10(sigma2)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (theta_batch, X, y, F, mask, float(n)))


def _nll(theta_batch, X, Y, F, mask, n):
    beta0 = torch.zeros(1, dtype=X.dtype, device=X.device)
    return neg_log_likelihood(theta_batch, X, Y, F, mask, float(n), NUGGET, beta0, CONFIG)


def nll_value_and_grad(theta_batch, X, Y, F, mask, n):
    """(values (B,), gradients (B, d + 1)) of the negative log-likelihood."""
    with torch.enable_grad():
        par = theta_batch.detach().requires_grad_(True)
        vals = _nll(par, X, Y, F, mask, n)
        (grads,) = torch.autograd.grad(vals.sum(), par)
    return vals.detach(), grads


def entry(device=DEFAULT_DEVICE):
    """(fn, example_args): the batched likelihood and its gradient."""
    return nll_value_and_grad, _make_problem(device=resolve_device(device))


def dryrun_multidevice(n_devices: int, devices=None) -> None:
    """One sharded BO compute step on an n-entry mesh: over every CUDA
    device (the first n), or over `devices`, which may repeat one (e.g.
    ["cuda:0"] * 2 or ["cpu"] * 8)."""
    if devices is None:
        mesh = make_particle_mesh(n_devices)
        if mesh.size < n_devices:
            raise RuntimeError(
                f"dryrun_multidevice({n_devices}): only {mesh.size} CUDA device(s); pass "
                f"devices=[...] naming {n_devices} entries (a device may repeat)")
    else:
        mesh = ParticleMesh(list(devices)[:n_devices])
        if mesh.size < n_devices:
            raise ValueError(f"dryrun_multidevice({n_devices}): {mesh.size} devices given")
    for dev in set(mesh.devices):
        resolve_device(dev)
    dev0 = mesh.device
    d = 3
    n_theta, n_chains, n_hmc = 2 * n_devices, 4 * n_devices, 2 * n_devices
    theta_batch, X, Y, F, mask, n = _make_problem(n_theta=n_theta, d=d, device=dev0)
    data = replicated(mesh).put((X, Y, F, mask))

    # --- sharded multi-restart MLE gradient step, the mesh-wide argmin ---
    thetas = shard_population(theta_batch, mesh)
    steps = mesh.map(lambda th, dd: nll_value_and_grad(th, *dd, n), thetas.chunks, data)
    vals, theta_all, theta_next = mesh.gather(
        [v for v, _ in steps], thetas.chunks, [th - 0.1 * g for th, (_, g) in zip(thetas.chunks, steps)])
    best_par = theta_all[torch.argmin(vals)]

    # --- posterior, then a sharded acquisition CMA generation -------------
    state = posterior_state(best_par, X, Y, F, mask, n, NUGGET, torch.zeros(1, device=dev0), CONFIG)

    def criterion(st):
        def crit(U):  # minimize negative EI; identity embedding on [0, 1]^d
            mu, var = predict(st, U, trend_basis(CONFIG, U), CONFIG, True)
            return -ei(mu[:, 0], torch.sqrt(var[:, 0].clamp_min(0.0)), 0.0)
        return crit

    crits = [criterion(st) for st in replicated(mesh).put(state)]
    gen = torch.Generator(device=dev0).manual_seed(0)
    x0 = torch.rand((n_chains, d), generator=gen, device=dev0)
    # one CMA generation, an SMC resampling across the mesh (a gather, the
    # resample, a split), a second generation, and the champion
    with torch.no_grad():
        champion, _, _, _ = run_smc(gen, crits, shard_population(x0, mesh), 0.0, 1.0,
                                    n_rounds=1, n_moves=1)
    assert theta_next.shape == (n_theta, d + 1)
    assert champion.shape == (d,)

    # --- sharded HMC over the GP hyperparameters ---------------------------
    x0h = torch.rand((n_hmc, d + 1), generator=torch.Generator().manual_seed(1)) * 2.0 - 1.0
    starts = shard_population(x0h, mesh)

    def chains(i, x, dd):
        res = hmc_sample(torch.Generator(device=x.device).manual_seed(2 + i),
                         lambda p: -_nll(p, *dd, n), x, torch.full((d + 1,), -2.0),
                         torch.full((d + 1,), 2.0), n_warmup=2, n_samples=2, n_leapfrog=3)
        return res.samples.transpose(0, 1), res.accept_rate

    runs = mesh.map(chains, mesh.local, starts.chunks, data)
    samples, acc = mesh.gather([s for s, _ in runs], [a for _, a in runs])
    samples = samples.transpose(0, 1)
    assert samples.shape == (2, n_hmc, d + 1) and acc.shape == (n_hmc,)
    print(f"dryrun_multidevice({n_devices}): OK - mesh {[str(x) for x in mesh.devices]}, "
          f"{n_theta} MLE restarts + {n_chains} CMA chains (SMC-resampled) "
          f"+ {n_hmc} HMC chains sharded, {mesh.gathers} gathers")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="the port's entry step and mesh dry run")
    parser.add_argument("--device", default=DEFAULT_DEVICE)
    parser.add_argument("--mesh", type=int, default=8, help="mesh entries, all on --device")
    args = parser.parse_args(argv)
    fn, fargs = entry(args.device)
    vals, grads = fn(*fargs)
    print("entry(): OK", tuple(vals.shape), tuple(grads.shape))
    dryrun_multidevice(args.mesh, devices=[args.device] * args.mesh)


if __name__ == "__main__":
    main()
