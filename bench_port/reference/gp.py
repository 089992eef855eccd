"""Plain reference of the Kriging surrogate and criteria the cells drive.

What the port's GaussianProcess computes for the configurations of this
benchmark (Matern nu = 3/2, constant trend estimated by GLS, 'noisy' mode:
a nugget of fixed variance beside a fitted process variance, concentrated
likelihood), written from the model's equations in plain PyTorch, over the
n observed rows only (the port pads to a size bucket; padded rows are
decoupled and add nothing). It imports nothing of the port.

`prec` is the arithmetic: "float64" (the reference), "float32" (the
configuration's own precision), or "tf32": float32 whose matrix products
round their operands to TF32 (10 mantissa bits), the precision just below
the configuration's, which the port has switched off. On a CUDA device
"tf32" runs the products on the tensor cores with TF32 allowed; on the CPU
it rounds the operands the same way before a float32 product. The
factorisation and the solves are blocked, so that nearly all of their
arithmetic is such products (in float64 each is one call).

For the check of the argmax's answer it also gives a bounded L-BFGS
(scipy) over float64 objectives.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_LOG2PI = math.log(2.0 * math.pi)
_BLOCK = 64
_SQRT3 = math.sqrt(3.0)


def dtype_of(prec: str) -> torch.dtype:
    return torch.float64 if prec == "float64" else torch.float32


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest TF32 (8 exponent, 10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b in the arithmetic `prec`."""
    if prec != "tf32":
        return a @ b
    if a.device.type != "cuda":
        return _round_tf32(a) @ _round_tf32(b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def cholesky(A: torch.Tensor, prec: str) -> torch.Tensor:
    """Lower Cholesky factor by right-looking 64-wide blocks: each diagonal
    block by torch's Cholesky, the panels and the trailing update as
    products (in float64 in one call). A factor that breaks down comes back
    as NaN."""
    if prec == "float64":
        L, info = torch.linalg.cholesky_ex(A)
        return L if int(info) == 0 else torch.full_like(A, float("nan"))
    A = A.clone()
    n = A.shape[0]
    L = torch.zeros_like(A)
    for k in range(0, n, _BLOCK):
        e = min(k + _BLOCK, n)
        L11, info = torch.linalg.cholesky_ex(A[k:e, k:e])
        if int(info) != 0:
            return torch.full_like(A, float("nan"))
        L[k:e, k:e] = L11
        if e < n:
            eye = torch.eye(e - k, dtype=A.dtype, device=A.device)
            L11inv = torch.linalg.solve_triangular(L11, eye, upper=False)
            L21 = mm(A[e:, k:e], L11inv.T, prec)
            L[e:, k:e] = L21
            A[e:, e:] -= mm(L21, L21.T, prec)
    return L


def solve_lower(L: torch.Tensor, B: torch.Tensor, prec: str) -> torch.Tensor:
    """L^-1 B by forward substitution in 64-wide blocks (in float64 in one
    call, which autograd can follow)."""
    if prec == "float64":
        return torch.linalg.solve_triangular(L, B, upper=False)
    X = torch.empty_like(B)
    n = L.shape[0]
    for k in range(0, n, _BLOCK):
        e = min(k + _BLOCK, n)
        rhs = B[k:e]
        if k > 0:
            rhs = rhs - mm(L[k:e, :k], X[:k], prec)
        X[k:e] = torch.linalg.solve_triangular(L[k:e, k:e], rhs, upper=False)
    return X


def solve_upper_t(L: torch.Tensor, B: torch.Tensor, prec: str) -> torch.Tensor:
    """L^-T B by back substitution in 64-wide blocks (in float64 in one call)."""
    if prec == "float64":
        return torch.linalg.solve_triangular(L.T, B, upper=True)
    X = torch.empty_like(B)
    n = L.shape[0]
    starts = list(range(0, n, _BLOCK))
    for k in reversed(starts):
        e = min(k + _BLOCK, n)
        rhs = B[k:e]
        if e < n:
            rhs = rhs - mm(L[e:, k:e].T, X[e:], prec)
        X[k:e] = torch.linalg.solve_triangular(L[k:e, k:e].T, rhs, upper=True)
    return X


def matern32(theta: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """k(a, b) = (1 + sqrt(3) r) exp(-sqrt(3) r), r^2 = sum_d theta_d (a_d - b_d)^2,
    from the differences (no expansion of the square)."""
    r2 = torch.zeros((A.shape[0], B.shape[0]), dtype=A.dtype, device=A.device)
    for d in range(A.shape[1]):
        diff = A[:, d, None] - B[None, :, d]
        r2 += theta[d] * diff * diff
    # the clamp keeps the gradient finite at r = 0 (the diagonal, where the
    # value is masked); it moves k by 1e-300 at most
    s = _SQRT3 * torch.sqrt(r2.clamp_min(1e-300))
    return (1.0 + s) * torch.exp(-s)


def maximize(f, x0: np.ndarray, lo, hi, device, maxiter: int = 300) -> np.ndarray:
    """Bounded L-BFGS (scipy's L-BFGS-B, float64 on the host) of a float64
    torch objective `f` (a scalar of a tensor shaped like x0) on `device`;
    returns the end point. Independent lanes may be summed into one
    objective: its Hessian is block diagonal."""
    from scipy.optimize import minimize

    shape = np.shape(x0)

    def fun(x):
        t = torch.tensor(x.reshape(shape), dtype=torch.float64, device=device, requires_grad=True)
        v = -f(t)
        (g,) = torch.autograd.grad(v, t)
        return float(v.detach()), g.detach().cpu().numpy().ravel().astype(float)

    bounds = np.broadcast_to(np.stack([lo, hi], -1), shape + (2,)).reshape(-1, 2)
    res = minimize(fun, np.clip(np.asarray(x0, float), lo, hi).ravel(), jac=True,
                   method="L-BFGS-B", bounds=bounds,
                   options={"maxiter": maxiter, "ftol": 1e-15, "gtol": 1e-10})
    return res.x.reshape(shape)


class Posterior:
    """The GP at log10 hyperparameters par = (log10 theta (D), log10 sigma2)
    on unit-cube rows U (n, D) with standardized targets ys (n,)."""

    def __init__(self, U, ys, par, nugget: float, jitter: float, prec: str, device):
        dt = dtype_of(prec)
        self.prec = prec
        self.U = torch.as_tensor(U, dtype=dt, device=device)
        ys = torch.as_tensor(ys, dtype=dt, device=device)
        par = torch.as_tensor(par, dtype=torch.float64)
        D = self.U.shape[1]
        self.theta = (10.0 ** par[:D]).to(device=device, dtype=dt)
        e = float(10.0 ** par[D])
        n = self.U.shape[0]
        self.sigma2 = e
        eye = torch.eye(n, dtype=dt, device=device)
        R0 = matern32(self.theta, self.U, self.U) * (1.0 - eye) + (1.0 + jitter) * eye
        R = (e * R0 + (nugget + jitter) * eye) / (e + nugget + jitter)
        self.L = cholesky(R, prec)
        Yt = solve_lower(self.L, ys[:, None], prec)[:, 0]
        self.Ft = solve_lower(self.L, torch.ones((n, 1), dtype=dt, device=device), prec)[:, 0]
        self.G = torch.linalg.vector_norm(self.Ft)
        self.beta = torch.dot(self.Ft, Yt) / (self.G * self.G)
        rho = Yt - self.Ft * self.beta
        s2t = e + nugget
        self.scale = e / s2t
        logdet = torch.log(torch.diagonal(self.L)).sum()
        self.log_likelihood = float(
            -0.5 * (n * (math.log(s2t) + _LOG2PI) + 2.0 * logdet + torch.dot(rho, rho) / s2t))
        self.gamma = solve_upper_t(self.L, rho[:, None], prec)[:, 0] * self.scale

    def predict(self, Uq):
        """(mean, variance) at unit-cube rows Uq (m, D), the variance the
        latent process's, clipped at 0."""
        Uq = torch.as_tensor(Uq, dtype=self.U.dtype, device=self.U.device)
        r0 = matern32(self.theta, Uq, self.U)  # (m, n)
        mu = self.beta + mm(r0, self.gamma[:, None], self.prec)[:, 0]
        rt = solve_lower(self.L, r0.T.contiguous(), self.prec)  # (n, m)
        reduction = (rt * rt).sum(0)
        u = (mm(self.Ft[None, :], rt, self.prec)[0] - 1.0) / self.G
        var = ((1.0 - self.scale * reduction + u * u) * self.sigma2).clamp_min(0.0)
        return mu, var


def mixture(posteriors, Uq):
    """Mean and law-of-total-variance variance of an equal-weight ensemble
    (of one posterior: its own mean and variance)."""
    parts = [p.predict(Uq) for p in posteriors]
    mus = torch.stack([m for m, _ in parts])
    vars_ = torch.stack([v for _, v in parts])
    mu = mus.mean(0)
    return mu, (vars_ + (mus - mu) ** 2).mean(0).clamp_min(0.0)


_SD_FLOOR = 1e-10


def _cdf(u):
    return 0.5 * torch.erfc(-u / math.sqrt(2.0))


def _pdf(u):
    return torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)


def _guard(value, sd):
    value = torch.where(torch.isfinite(value), value, torch.zeros_like(value))
    return torch.where(sd > _SD_FLOOR, value, torch.zeros_like(value))


def expected_improvement(mu, sd, plugin: float):
    """E[max(plugin - Y, 0)] for Y ~ N(mu, sd^2) (minimization); 0 where sd ~ 0."""
    sd_safe = sd.clamp_min(_SD_FLOOR)
    imp = plugin - mu
    u = imp / sd_safe
    return _guard(imp * _cdf(u) + sd_safe * _pdf(u), sd)

