"""The general generator of the benchmark's traffic: a closed ask/tell loop.

One client evaluates the asked point on the cell's BBOB function (host
numpy, microseconds), tells the value and waits for the next ask. A cell's
file (`workloads/<cell>.json`) sets the loop by data alone: `histories`
optimizers (BO, q = 1, the cell's `acquisition`), each told its own
`n0`-point history in set-up (the cold fit the traffic starts from), take
the window's iterations in turn. Each optimizer replays a fixed set of
`replay` iterations (tell the pending point, ask the next) from a snapshot
taken after its cold fit; when its set is done the snapshot is restored
(inside the window, outside any iteration's wall) and the set runs again.
The histories stay in one size bucket and under the 25% growth that would
trigger the full MLE ladder, so the work does not depend on how fast the
port runs.

The work is one fixed set, drawn from the cell's `work_seed`: each
history's BBOB instance, rows (uniform in the box) and first pending point,
and each optimizer's seed. The run's --seed draws the order in which the
histories take their turns (and, in `reference/judge.py`, the records whose
answers the reference maximises): the same set of work in another order.
Drawn from --seed, the work itself swings a window's mean by more than any
bound can hold (PERF.md, section 2). The history recipe (uniform rows from
one numpy stream, the objective on the host) is the one of
bayesian_optimization_tpu_torch/tools/profile_main_path.py's `bench_data`,
with the cell's BBOB function in place of its sine sum.
"""
from __future__ import annotations

import copy
import time

import numpy as np

from .bbob import BBOBFunction


def stream(seed: int, *salt: int) -> np.random.Generator:
    """The run's numpy stream for one purpose (`salt`), from its --seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, *salt]))


class Problem:
    """The configuration's box and BBOB function; its instances are drawn
    for each history."""

    def __init__(self, cfg: dict):
        p = cfg["problem"]
        self.dim, self.function = int(p["dim"]), int(p["function"])
        self.lb = np.full(self.dim, float(p["box"][0]))
        self.ub = np.full(self.dim, float(p["box"][1]))

    def instance(self, rng: np.random.Generator) -> BBOBFunction:
        return BBOBFunction(self.function, self.dim, int(rng.integers(1, 2**20)))


def build_optimizer(cfg: dict, tr: dict, seed: int, device):
    """The port's BO for a configuration and cell, on `device`."""
    import bayesian_optimization_tpu_torch as bo
    from bayesian_optimization_tpu_torch.models.trend import constant_trend

    p, m, a = cfg["problem"], cfg["model"], cfg["argmax"]
    d = int(p["dim"])
    gp = bo.GaussianProcess(
        mean=constant_trend(d), corr=m["corr"],
        thetaL=m["thetaL_raw"] * np.ones(d), thetaU=m["thetaU_raw"] * np.ones(d),
        nugget=m["nugget"], random_start=max(m["random_start_min"], d),
        optimizer=m["optimizer"], random_state=seed, device=device,
    )
    for key in ("hmc_warmup", "n_ensemble"):
        if key in m:
            setattr(gp, key, int(m[key]))
    space = bo.RealSpace([list(p["box"])] * d, random_seed=seed)
    opt = bo.BO(search_space=space, model=gp, DoE_size=int(p["doe_per_dim"]) * d,
                max_FEs=int(p["budget_per_dim"]) * d, acquisition_fun=tr["acquisition"],
                acquisition_optimization={"optimizer": a["optimizer"],
                                          "n_restart": int(a["restarts_per_dim"]) * d},
                random_seed=seed, device=device)
    opt._argmax = ArgmaxRecorder(opt._argmax)
    return opt


class ArgmaxRecorder:
    """Passes every call to the optimizer's acquisition argmax and keeps the
    unit-cube winner and criterion value it returned: the ask drops the
    value, and the check of `correct` holds both against the reference."""

    def __init__(self, inner):
        self.inner = inner
        self.last = None

    def __call__(self, *args, **kwargs):
        u, v = self.inner(*args, **kwargs)
        self.last = (np.atleast_2d(np.asarray(u, float)), np.atleast_1d(np.asarray(v, float)))
        return u, v

    def __getattr__(self, name):
        if name == "inner":  # not yet set (copy.deepcopy builds the object first)
            raise AttributeError(name)
        return getattr(self.inner, name)


def _counters():
    from bayesian_optimization_tpu_torch.ops import hopper_kernels as hk

    return getattr(hk.matern_fused, "bwd_launches", 0)


def _phase_total(opt, phase: str, start: int) -> float:
    return float(sum(opt._timer.history.get(phase, [])[start:]))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Client:
    """One optimizer with its objective, history and pending point."""

    def __init__(self, opt, f, X, y, pending):
        self.opt, self.f, self.X, self.y, self.pending = opt, f, X, y, pending
        self.step = 0


class Loop:
    """A cell's loop: `setup()` once, then `iterate()` -> one iteration's
    record, whose "t0" (perf_counter) and "wall" bracket the iteration (a
    restore before it is outside)."""

    def __init__(self, cfg: dict, tr: dict, device, seed: int):
        self.cfg, self.tr, self.device, self.seed = cfg, tr, device, int(seed)
        self.problem = Problem(cfg)
        self.n0, self.replay = int(tr["n0"]), int(tr["replay"])
        self.histories = int(tr["histories"])
        self.crit = tr["acquisition"]
        # the histories' turns: the run's seed orders the cell's fixed set
        self.order = stream(self.seed, 2).permutation(self.histories).tolist()

    def _client(self, h: int) -> Client:
        rng = stream(int(self.tr["work_seed"]), 1, h)
        f = self.problem.instance(rng)
        X = rng.uniform(self.problem.lb, self.problem.ub, (self.n0, self.problem.dim))
        y = f(X)
        pending = rng.uniform(self.problem.lb, self.problem.ub, (1, self.problem.dim))
        opt = build_optimizer(self.cfg, self.tr, int(rng.integers(0, 2**31 - 1)), self.device)
        opt.tell(X.tolist(), y.tolist())  # the cold fit the traffic starts from
        return Client(opt, f, X, y, pending)

    def setup(self):
        """The histories' cold fits and one warm-up iteration; `parts` keeps
        the seconds of each, and of the port's import and kernel library."""
        t0 = time.perf_counter()
        import bayesian_optimization_tpu_torch  # noqa: F401
        from bayesian_optimization_tpu_torch.ops import _build

        if self.device.type == "cuda":
            _build.load_library()  # built here on a checkout's first run
        t1 = time.perf_counter()
        self.snapshots = [self._client(h) for h in range(self.histories)]
        t2 = time.perf_counter()
        self.clients = [copy.deepcopy(c) for c in self.snapshots]
        first = self.order[0]
        self._iterate(self.clients[first])  # the warm-up iteration: the warm refit and the ask
        self.clients[first] = copy.deepcopy(self.snapshots[first])
        self.turn = 0
        self.parts = {"import_and_library_s": t1 - t0, "cold_fits_s": t2 - t1,
                      "warm_up_s": time.perf_counter() - t2}

    def rewind(self):
        """Every history back to its snapshot and the turns to their start,
        as set-up left them: the traced iterations leave the window the
        same work as a run without a trace."""
        self.clients = [copy.deepcopy(c) for c in self.snapshots]
        self.turn = 0

    def _iterate(self, c: Client) -> dict:
        """Tell the pending point, then ask, on the clock; the record of it."""
        opt = c.opt
        X = c.pending
        y = c.f(X)
        hX, hy = np.concatenate([c.X, X]), np.concatenate([c.y, y])
        n_fit = len(opt._timer.history.get("fit", []))
        n_arg = len(opt._timer.history.get("arg_max_acquisition", []))
        c0 = _counters()
        t0 = time.perf_counter()
        opt.tell(X.tolist(), list(map(float, y)))
        c1 = _counters()
        asked = opt.ask()
        _sync(self.device)
        t1 = time.perf_counter()
        c2 = _counters()
        gp = opt.model
        units, values = opt._argmax.last
        rec = {
            "t0": t0, "wall": t1 - t0,
            "fit_s": _phase_total(opt, "fit", n_fit),
            "argmax_s": _phase_total(opt, "arg_max_acquisition", n_arg),
            "fit_grad_calls": c1 - c0, "argmax_grad_calls": c2 - c1,
            "X": hX, "y": hy, "par": np.asarray(gp._map_par_log10, float).copy(),
            "noise_var": float(gp.noise_var), "ll": float(gp.log_likelihood_),
            "r2": float(opt._r2), "asked": np.asarray(asked, float),
            "winners": self.problem.lb + units * (self.problem.ub - self.problem.lb),
            "values": values, "crit": self.crit,
        }
        c.X, c.y, c.pending = hX, hy, np.asarray(asked, float)
        return rec

    def iterate(self) -> dict:
        """One iteration of the next history in turn; a history restores its
        snapshot first once its `replay` iterations are done."""
        h = self.order[self.turn % self.histories]
        self.turn += 1
        if self.clients[h].step == self.replay:
            self.clients[h] = copy.deepcopy(self.snapshots[h])
        rec = self._iterate(self.clients[h])
        self.clients[h].step += 1
        rec["history"] = h
        return rec

    def release(self):
        """Drop the optimizers and their device state."""
        for name in ("clients", "snapshots"):
            self.__dict__.pop(name, None)
