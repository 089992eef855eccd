"""Masked, batched GP log-likelihoods and posterior state.

Counterpart of bayesian_optimization_tpu/models/likelihood.py: the
concentrated likelihood in 'noiseless', 'noisy' and 'noise_estim' modes, the
restricted (REML) likelihood, the optional MAP prior on log10 theta, the
posterior state at chosen hyperparameters, batched BLUP predict, and the
mixture predict of a hyperparameter ensemble (HMC, NUTS and VI fits).

Where the JAX package vmapped `neg_log_likelihood` over restart lanes, here
the lanes are a leading batch axis of `log10_par`, written out: one call
builds the (B, n, n) correlation through the hand Matern kernel and factors
all B matrices in one batched `whiten` (ops/linalg.py). Gradients come from
autograd. Variable n is handled by bucketed padding with a mask, exactly as
in the JAX package: padded rows/cols of R are identity, padded y/F rows 0.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.linalg import chol_inv_whiten, whiten
from .kernels import kernel_fn
from .trend import TRENDS

_LOG2PI = math.log(2.0 * math.pi)

# smallest acceptable raw Cholesky pivot: below this the 1e-12 clamp of the
# factorisation produced a wrong-but-finite factor and the likelihood value
# is garbage -- penalize instead of trusting it
PIV_TOL = 1e-10


class GPConfig(NamedTuple):
    """Static GP configuration (the JAX package's GPConfig, field for field)."""

    kernel: str = "matern"
    mode: str = "noisy"  # 'noiseless' | 'noisy' | 'noise_estim'
    likelihood: str = "concentrated"  # 'concentrated' | 'restricted'
    estimate_trend: bool = True
    n_basis: int = 1
    trend: str = "constant"  # 'constant' | 'linear' | 'quadratic' | 'custom'
    jitter: float = 1e-6
    n_ensemble: int = 0  # >0: a stacked posterior of that many samples (HMC/NUTS/VI), predicted as a mixture
    theta_prior_strength: float = 0.0  # >0: MAP with a weak Gaussian prior on log10 theta


def trend_basis(config: GPConfig, X: torch.Tensor) -> torch.Tensor:
    """The trend basis F(X) from the config (the three built-in trends)."""
    if config.trend not in TRENDS:
        raise ValueError(f"cannot rebuild custom trend {config.trend!r} from the config")
    return TRENDS[config.trend](X.shape[1]).F(X)


def n_hyper_params(dim: int, config: GPConfig) -> int:
    """Length of the log10-parameter vector: theta (dim) plus sigma2 or alpha."""
    return dim + (0 if config.mode == "noiseless" else 1)


def split_params(log10_par: torch.Tensor, config: GPConfig):
    """log10 parameters (..., P) -> (theta (..., D), extra (...,) or None)."""
    if config.mode == "noiseless":
        return 10.0 ** log10_par, None
    return 10.0 ** log10_par[..., :-1], 10.0 ** log10_par[..., -1]


def _masked_correlation(theta, X, mask, kern, jitter):
    """R0 with padded rows/cols zeroed off-diagonal and unit diagonal."""
    R0 = kern(theta, X)
    eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
    return R0 * (torch.outer(mask, mask) * (1.0 - eye)) + (1.0 + jitter) * eye


def _correlation_for_mode(theta, extra, X, mask, noise_var, config: GPConfig):
    R0 = _masked_correlation(theta, X, mask, kernel_fn(config.kernel), config.jitter)
    if config.mode == "noiseless":
        return R0
    eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
    e = extra[..., None, None]
    if config.mode == "noise_estim":
        return e * R0 + (1.0 - e + config.jitter) * eye
    total = e + noise_var
    return (e * R0 + (noise_var + config.jitter) * eye) / (total + config.jitter)


def _masked_logdet_d(d, mask):
    safe = torch.where(mask > 0, d, torch.ones_like(d))
    return torch.log(safe.clamp_min(1e-300)).sum(-1)


def _gls(Yt, Ft, beta0, estimate_trend: bool):
    """Trend coefficients and whitened residuals from L^-1 Y, L^-1 F. The
    constant trend (p = 1) takes the 1 x 1 QR in closed form, G = |F|
    (its sign, which only |G| and G^-1 G^-T ever see, taken positive) and
    beta = F^T Y / F^T F: no QR and no triangular solve, forward or
    backward."""
    if estimate_trend and Ft.shape[-1] == 1:
        G = torch.linalg.vector_norm(Ft, dim=-2, keepdim=True)
        beta = (Ft.mT @ Yt) / (G * G)
    elif estimate_trend:
        Q, G = torch.linalg.qr(Ft, mode="reduced")
        beta = torch.linalg.solve_triangular(G, Q.mT @ Yt, upper=True)
    else:
        p = Ft.shape[-1]
        G = torch.eye(p, dtype=Ft.dtype, device=Ft.device).expand(*Ft.shape[:-2], p, p)
        beta = beta0.reshape(p, -1).expand(*Ft.shape[:-2], p, Yt.shape[-1]).to(Ft.dtype)
    return G, beta, Yt - Ft @ beta


def _aux_nll(R, Y, F, mask, beta0, config: GPConfig):
    """Whitened GLS for the likelihood: (logdet_L, G, rho, min_pivot)."""
    m = Y.shape[1]
    d, W, min_pivot = whiten(R, torch.cat([Y, F], dim=1))
    G, _beta, rho = _gls(W[..., :m], W[..., m:], beta0, config.estimate_trend)
    return _masked_logdet_d(d, mask), G, rho, min_pivot


def _resolve_variances(extra, rho, n, p, noise_var, config: GPConfig):
    """Per-mode (sigma2, noise_var, sigma2_total), each (..., m)."""
    m_ss = (rho * rho).sum(-2)
    if config.mode == "noiseless":
        dof = n - (p if config.estimate_trend else 0)
        sigma2 = m_ss / max(dof, 1.0)
        return sigma2, torch.zeros_like(sigma2), sigma2
    if config.mode == "noise_estim":
        sigma2_total = m_ss / max(n, 1.0)
        a = extra[..., None]
        return a * sigma2_total, (1.0 - a) * sigma2_total, sigma2_total
    sigma2 = extra[..., None].expand_as(m_ss)
    nv = torch.full_like(m_ss, float(noise_var))
    return sigma2, nv, sigma2 + nv


def neg_log_likelihood(
    log10_par: torch.Tensor,
    X: torch.Tensor,
    Y: torch.Tensor,
    F: torch.Tensor,
    mask: torch.Tensor,
    n: float,
    noise_var: float,
    beta0: torch.Tensor,
    config: GPConfig,
    prior_lo=None,
    prior_hi=None,
) -> torch.Tensor:
    """Negative log-likelihood (summed over targets): log10_par (B, P) ->
    (B,), or (P,) -> scalar. Non-finite values and clamped factorisations
    (min raw pivot <= PIV_TOL) come back as the 1e12 penalty."""
    squeeze = log10_par.ndim == 1
    par = log10_par[None] if squeeze else log10_par
    par = par.to(X.dtype)
    n = float(n)
    theta, extra = split_params(par, config)
    R = _correlation_for_mode(theta, extra, X, mask, noise_var, config)
    logdet_L, G_w, rho, min_pivot = _aux_nll(R, Y, F, mask, beta0, config)
    p = F.shape[1]
    _sigma2, _nv, s2t = _resolve_variances(extra, rho, n, p, noise_var, config)
    m_ss = (rho * rho).sum(-2)
    ld = 2.0 * logdet_L[:, None]

    if config.likelihood == "restricted":
        if config.estimate_trend:
            _sign, logdet_FtF = torch.linalg.slogdet(F.T @ F)
            logdet_G = torch.log(G_w.diagonal(dim1=-2, dim2=-1).abs().clamp_min(1e-300)).sum(-1)
            ll = -0.5 * (
                (n - p) * (torch.log(s2t) + _LOG2PI) - logdet_FtF + ld
                + 2.0 * logdet_G[:, None] + m_ss / s2t
            ).sum(-1)
        else:
            ll = -0.5 * (n * (torch.log(s2t) + _LOG2PI) + ld + m_ss / s2t).sum(-1)
    elif config.mode == "noisy":
        ll = -0.5 * (n * (torch.log(s2t) + _LOG2PI) + ld + m_ss / s2t).sum(-1)
    else:  # sigma2(_total) concentrated out
        ll = -0.5 * (n * (torch.log(s2t.clamp_min(1e-300)) + _LOG2PI) + ld + n).sum(-1)
    nll = -ll
    if (
        config.likelihood != "restricted"
        and config.theta_prior_strength > 0.0
        and prior_lo is not None
    ):
        mid = 0.5 * (prior_lo + prior_hi)
        sd = (0.5 * (prior_hi - prior_lo)).clamp_min(1e-6)
        z = (par - mid) / sd
        nll = nll + config.theta_prior_strength * 0.5 * (z * z).sum(-1)
    ok = torch.isfinite(nll) & (min_pivot > PIV_TOL)
    nll = torch.where(ok, nll, torch.full_like(nll, 1e12))
    return nll[0] if squeeze else nll


class PosteriorState(NamedTuple):
    """Everything `predict` needs, all fixed-shape (padded) tensors; the
    fields of the JAX package's PosteriorState."""

    theta: torch.Tensor
    L: torch.Tensor
    L_inv: torch.Tensor     # (n_pad, n_pad) explicit L^-1
    Ft: torch.Tensor
    G: torch.Tensor
    G_inv: torch.Tensor     # (p, p) explicit G^-1
    beta: torch.Tensor      # (p, m)
    gamma: torch.Tensor     # (n_pad, m): scale * L^-T rho
    sigma2: torch.Tensor    # (m,)
    noise_var: torch.Tensor # (m,)
    scale: torch.Tensor     # sigma2 / sigma2_total
    X: torch.Tensor
    mask: torch.Tensor
    min_pivot: torch.Tensor  # <= PIV_TOL => L_inv is garbage, fit() escalates


@torch.no_grad()
def posterior_state(log10_par, X, Y, F, mask, n, noise_var, beta0, config: GPConfig) -> PosteriorState:
    """The fit-time auxiliary state at one hyperparameter vector (P,), or
    the stacked states of an ensemble (S, P): each field then carries a
    leading S axis, except X and mask, which its members share. The S
    correlation matrices are one Matern launch and one factorisation."""
    par = torch.as_tensor(log10_par).to(device=X.device, dtype=X.dtype)
    theta, extra = split_params(par, config)
    R = _correlation_for_mode(theta, extra, X, mask, noise_var, config)
    m = Y.shape[1]
    L, L_inv, W, min_pivot = chol_inv_whiten(R, torch.cat([Y, F], dim=1))
    Ft = W[..., m:]
    G, beta, rho = _gls(W[..., :m], Ft, beta0, config.estimate_trend)
    sigma2, nv, s2t = _resolve_variances(extra, rho, float(n), F.shape[1], noise_var, config)
    scale = sigma2 / s2t.clamp_min(1e-300)
    gamma = (L_inv.mT @ rho) * scale[..., None, :] * mask[:, None]
    if G.shape[-1] == 1:
        G_inv = 1.0 / G
    else:
        eye = torch.eye(G.shape[-1], dtype=X.dtype, device=X.device)
        G_inv = torch.linalg.solve_triangular(G, eye.expand_as(G), upper=True)
    return PosteriorState(
        theta=theta, L=L, L_inv=L_inv, Ft=Ft, G=G, G_inv=G_inv, beta=beta,
        gamma=gamma, sigma2=sigma2, noise_var=nv, scale=scale, X=X, mask=mask,
        min_pivot=min_pivot,
    )


def predict(state: PosteriorState, Xq: torch.Tensor, Fq: torch.Tensor, config: GPConfig,
            eval_mse: bool = True):
    """Batched BLUP mean and MSE at query points: (mu[Nq, m], mse[Nq, m]);
    mse is the latent posterior variance, clipped at 0. Differentiable in Xq.
    The (Nq, n_pad) cross-covariance is one hand-kernel launch. A stacked
    state gives every member's (mu, mse), (S, Nq, m), its S cross-covariances
    one launch of shape (S, Nq, n_pad)."""
    kern = kernel_fn(config.kernel)
    r0 = kern(state.theta, Xq, state.X) * state.mask[None, :]
    mu = Fq @ state.beta + r0 @ state.gamma
    if not eval_mse:
        return mu, None
    rt = state.L_inv @ r0.mT
    reduction = (rt * rt).sum(-2)
    if config.estimate_trend:
        u = state.G_inv.mT @ (state.Ft.mT @ rt - Fq.T)
        correction = (u * u).sum(-2)
    else:
        correction = torch.zeros_like(reduction)
    base = 1.0 - state.scale[..., None, :] * reduction[..., None] + correction[..., None]
    mse = (base * state.sigma2[..., None, :]).clamp_min(0.0)
    return mu, mse


def predict_ensemble(state: PosteriorState, Xq, Fq, config: GPConfig, eval_mse: bool = True):
    """Posterior-mixture prediction for a stacked PosteriorState (the
    hyperparameter posterior of HMC, NUTS or VI): the mixture mean and the
    law-of-total-variance mixture variance, clipped at 0. The variance is
    the mean of the members' variances plus that of their means about the
    mixture mean: the JAX package's E[var + mu^2] - mu^2, the same number,
    cancels in float32 where the means are large beside their spread."""
    point_cfg = config._replace(n_ensemble=0)
    mus, vars_ = predict(state, Xq, Fq, point_cfg, eval_mse)
    mu = mus.mean(0)
    if not eval_mse:
        return mu, None
    var = (vars_ + (mus - mu) ** 2).mean(0)
    return mu, var.clamp_min(0.0)


def predict_gp(state: PosteriorState, Xq, Fq, config: GPConfig, eval_mse: bool = True):
    """The GP's predict: the mixture of an ensemble state (config.n_ensemble
    > 0), else the point posterior's."""
    if config.n_ensemble > 0:
        return predict_ensemble(state, Xq, Fq, config, eval_mse)
    return predict(state, Xq, Fq, config, eval_mse)
