"""The comparison that decides `correct`.

Each iteration of the window leaves a record of what the port's timed path
produced there: the fitted hyperparameters (every ensemble member's for a
sampler's fit), the nugget and the log likelihood the fit reports, the r^2
of the posterior mean at the history that the tell logs, the acquisition
argmax's winner with the criterion's value as it returned it, and the
point the ask handed out. The
benchmark's own inputs (the history it evaluated) with the port's
hyperparameters go to the plain reference (`reference/gp.py`), which works
out again in float64 what the port reports, and how good its answers are.
The numbers compared, each the worst over the records:

- `ll_gap`: |log likelihood - reference's| / n, in nats a row (a sampler's
  fit reports its members' mean);
- `r2_gap`: |r^2 - reference's|;
- `crit_gap`: |criterion value - reference's| / (|reference's| + sd / 100),
  with sd the reference's posterior standard deviation at the point: a
  relative gap that a criterion near 0 (a point with no improvement left)
  measures against a hundredth of its own scale;
- `out_of_box`: coordinates of asked points outside the box (limit 0);

and, over a sample of the records drawn from the run's seed (each costs the
reference a maximisation), whether the argmax's answer is the local maximum
its L-BFGS is there to find:

- `argmax_ascent`: (EI after a float64 local ascent from the port's winner
  - EI at the winner) / the former, the EI the reference's; the median over
  the sampled records. A sound argmax stops short on a few records (at its
  40 trips), so the worst record swings from run to run, while an argmax
  cut short stops short on most (PERF.md, section 2).

A cell's file gives each number its limit; a null limit leaves the number
out of that cell's check. The control puts the reference in the port's
place at the precision below the configuration's ("tf32"): the gap numbers
worked out in that arithmetic at the same hyperparameters and points, held
against float64. `argmax_ascent` is held against a fault planted in the port
(`control.py`).
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from . import gp

NUMBERS = ("ll_gap", "r2_gap", "crit_gap", "out_of_box", "argmax_ascent")
# a number read over a sample of the records, and how the sample's readings reduce
SAMPLED = {"argmax_ascent": statistics.median}


def _unit(X, lb, ub):
    return (np.asarray(X, float) - lb) / (ub - lb)


def _standardized(y):
    y = np.asarray(y, float)
    return (y - y.mean()) / y.std()


def evaluate(rec: dict, model: dict, lb, ub, prec: str, device) -> dict:
    """The reference's log likelihood, r^2, criterion values and standard
    deviations at the record's hyperparameters and winners, in `prec`."""
    ys = _standardized(rec["y"])
    U = _unit(rec["X"], lb, ub)
    pars = np.atleast_2d(rec["par"])
    # the nugget as the fit left it: the port raises it tenfold when a
    # factorisation degenerates, a choice of the fit judged as its others
    nugget = rec.get("noise_var", model["nugget"])
    posts = [gp.Posterior(U, ys, p, nugget, model["jitter"], prec, device) for p in pars]
    lls = [p.log_likelihood for p in posts]
    mu_h, _ = gp.mixture(posts, U)
    ys_t = torch.as_tensor(ys, dtype=mu_h.dtype, device=mu_h.device)
    r2 = float(1.0 - ((ys_t - mu_h) ** 2).sum() / ((ys_t - ys_t.mean()) ** 2).sum())
    mu, var = gp.mixture(posts, _unit(rec["winners"], lb, ub))
    sd = torch.sqrt(var)
    if rec["crit"] != "EI":
        raise ValueError(f"no reference for the criterion {rec['crit']!r}")
    vals = gp.expected_improvement(mu, sd, float(ys.min()))
    return {"ll": float(np.mean(lls)), "lls": lls, "r2": r2, "crit": vals.double().cpu().numpy(),
            "sd": sd.double().cpu().numpy(), "n": len(ys), "posts": posts, "plugin": float(ys.min())}


def _gaps(got: dict, ref: dict, asked, lb, ub) -> dict:
    scale = np.abs(ref["crit"]) + ref["sd"] / 100.0
    crit = np.abs(np.asarray(got["crit"], float) - ref["crit"]) / np.maximum(scale, 1e-300)
    A = np.asarray(asked, float)
    return {
        "ll_gap": abs(got["ll"] - ref["ll"]) / ref["n"],
        "r2_gap": abs(got["r2"] - ref["r2"]),
        "crit_gap": float(np.max(crit)) if crit.size else 0.0,
        "out_of_box": int(np.sum((A < lb) | (A > ub))),
    }


def _ei(posts, plugin: float, Uq: torch.Tensor) -> torch.Tensor:
    """The ensemble's EI at unit-cube rows Uq, with a gradient autograd can
    follow (the clamp keeps it finite where the variance is 0)."""
    mu, var = gp.mixture(posts, Uq)
    return gp.expected_improvement(mu, torch.sqrt(var.clamp_min(1e-300)), plugin)


def _log_ei(posts, plugin: float, Uq: torch.Tensor) -> torch.Tensor:
    """log EI: the ascent's objective, of a scale that does not vanish."""
    return torch.log(_ei(posts, plugin, Uq).clamp_min(1e-300))


def argmax_ascent(ref: dict, rec: dict, lb, ub, device) -> float:
    """The EI that a bounded float64 L-BFGS from the port's winner adds, over
    the EI it reaches."""
    posts, plugin = ref["posts"], ref["plugin"]
    D = len(lb)
    Uw = _unit(rec["winners"], lb, ub)
    end = gp.maximize(lambda t: _log_ei(posts, plugin, t).sum(), Uw, np.zeros(D), np.ones(D),
                      device)
    with torch.no_grad():
        v_port, v_end = (float(_ei(posts, plugin, torch.as_tensor(U, dtype=torch.float64,
                                                                   device=device)).max())
                         for U in (Uw, end))
    up = max(v_end, v_port)
    return (up - v_port) / up if up > 0 else 0.0


def quality_sample(n_records: int, k: int, seed: int) -> list:
    """The records whose answers the reference maximises: k drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, 3]))
    return sorted(rng.choice(n_records, size=min(k, n_records), replace=False).tolist())


def program_rows(records, model: dict, lb, ub, device, seed: int, k_sample: int) -> list:
    """Each record's numbers for the port's outputs against the float64
    reference; the sampled numbers on the seed's sample of k_sample records
    (None on the others)."""
    sample = set(quality_sample(len(records), k_sample, seed))
    rows = []
    for i, rec in enumerate(records):
        ref = evaluate(rec, model, lb, ub, "float64", device)
        got = {"ll": rec["ll"], "r2": rec["r2"], "crit": rec["values"]}
        row = {**_gaps(got, ref, rec["asked"], lb, ub), "argmax_ascent": None}
        if i in sample:
            row["argmax_ascent"] = argmax_ascent(ref, rec, lb, ub, device)
        rows.append(row)
    return rows


def worst(rows):
    """Each number over the rows that have it: the worst reading, or for a
    sampled number its reduction (None where no row has it)."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in rows if r.get(k) is not None]
        # a NaN (a reference or control that broke down) is the worst reading
        out[k] = (None if not vals else float("inf") if any(v != v for v in vals)
                  else SAMPLED.get(k, max)(vals))
    return out


def control_numbers(records, model: dict, lb, ub, device, prec: str = "tf32") -> dict:
    """The gap numbers for the reference itself in `prec`, in the port's place."""
    rows = []
    for rec in records:
        ref = evaluate(rec, model, lb, ub, "float64", device)
        try:
            got = evaluate(rec, model, lb, ub, prec, device)
        except RuntimeError:  # a control that breaks down gives no number: it has failed
            got = {"ll": float("nan"), "r2": float("nan"), "crit": np.full(len(rec["values"]), np.nan)}
        rows.append(_gaps(got, ref, rec["asked"], lb, ub))
    return worst(rows)


def compared(limits: dict) -> list:
    """The numbers a cell compares: those its file gives a limit (a null
    limit: a number that no limit separates for that cell, see PERF.md)."""
    return [k for k in NUMBERS if limits.get(k) is not None]


def verdict(numbers: dict, limits: dict, partial: bool = False) -> bool:
    """Correct when every compared number is at or under its limit (NaN never
    is, nor a missing reading); `partial` (one record's row) passes the
    numbers it has no reading of."""
    return all((numbers.get(k) is None and partial) or
               (numbers.get(k) is not None and numbers[k] <= limits[k])
               for k in compared(limits))


def row_verdict(row: dict, limits: dict) -> bool:
    """One record's verdict on the numbers it is judged by alone (a sampled
    number is judged over its sample, not record by record)."""
    return verdict({k: v for k, v in row.items() if k not in SAMPLED}, limits, partial=True)
