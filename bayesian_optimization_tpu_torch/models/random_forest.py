"""Random-forest surrogate: a forest grown on the device, traversed as tensor gathers.

Counterpart of bayesian_optimization_tpu/models/random_forest.py: one-hot
encoding of categorical levels, the empirical MSE as the variance of the
per-tree predictions, and `SurrogateAggregation` (a weighted sum of fitted
surrogates).

The forest is a padded node table (`RFState`: feature, threshold, children
and leaf values, (n_trees, max_nodes[, m])), and prediction advances
(points x trees) traversals in lock-step for `max_depth` steps
(`rf_predict_trees`), so a criterion over the forest is one batched program
of every engine's population, as over the GP.

The JAX package grows its forest with scikit-learn's RandomForestRegressor.
The port grows it itself (`grow_forest`), with sklearn's semantics, level by
level and batched over every tree on the device: bootstrap counts as sample
weights, `max_features` drawn per node without replacement, the weighted
MSE criterion, `min_samples_leaf` counted in rows, thresholds at the
midpoint of adjacent distinct values, no split on a constant feature. Its
forests differ from sklearn's in the random streams, in which of two equally
good splits wins, and so in held-out predictions; not in how it chooses a
split. The port needs no scikit-learn.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device

# sklearn's tree constants: values closer than FEATURE_THRESHOLD are one
# value, and a node whose impurity is at most EPSILON is pure
FEATURE_THRESHOLD = 1e-7
EPSILON = float(np.finfo(np.float64).eps)


class RFConfig(NamedTuple):
    """Static information of the traversal."""

    max_depth: int


class RFState(NamedTuple):
    """A flattened forest, arrays shaped (n_trees, max_nodes[, m])."""

    feature: torch.Tensor    # int32; -1 marks a leaf
    threshold: torch.Tensor  # float: go left where x[feature] <= threshold
    left: torch.Tensor       # int32
    right: torch.Tensor      # int32
    value: torch.Tensor      # float node means (n_trees, max_nodes, m)


def rf_predict_trees(state: RFState, X: torch.Tensor, config: RFConfig) -> torch.Tensor:
    """Per-tree predictions (P, n_trees, m): every (point, tree) pair steps
    down one level a step, for max_depth steps; a pair at a leaf stays."""
    T, N = state.feature.shape
    P = X.shape[0]
    base = torch.arange(T, device=X.device) * N           # (T,)
    feature, threshold = state.feature.reshape(-1).long(), state.threshold.reshape(-1)
    left, right = state.left.reshape(-1).long(), state.right.reshape(-1).long()
    idx = torch.zeros((P, T), dtype=torch.long, device=X.device)
    for _ in range(int(config.max_depth)):
        flat = idx + base
        feat = feature[flat]
        xv = torch.gather(X, 1, feat.clamp_min(0))
        nxt = torch.where(xv <= threshold[flat], left[flat], right[flat])
        idx = torch.where(feat < 0, idx, nxt)
    return state.value.reshape(T * N, -1)[idx + base]


def rf_predict(state: RFState, X: torch.Tensor, config: RFConfig):
    """(mu (P, m), var (P, m)): the mean over trees and the population
    variance of the trees' predictions, in X's dtype."""
    per_tree = rf_predict_trees(state, X, config).to(X.dtype)
    return per_tree.mean(1), per_tree.var(1, unbiased=False)


# ---------------------------------------------------------------------------
# the forest grower
# ---------------------------------------------------------------------------


def _bootstrap_weights(gen, T: int, n: int, bootstrap: bool, device) -> torch.Tensor:
    """(T, n) float64 sample weights: the count of each row among n draws
    with replacement a tree, or ones."""
    if not bootstrap:
        return torch.ones((T, n), dtype=torch.float64, device=device)
    draws = torch.randint(0, n, (T, n), generator=gen, device=device)
    w = torch.zeros((T, n), dtype=torch.float64, device=device)
    return w.scatter_add_(1, draws, torch.ones_like(w))


def _segments(key: torch.Tensor):
    """(first, last) position of each element's segment, for `key` sorted so
    that equal values are contiguous along the last axis."""
    L = key.shape[-1]
    pos = torch.arange(L, device=key.device).expand_as(key)
    start = torch.ones_like(key, dtype=torch.bool)
    start[..., 1:] = key[..., 1:] != key[..., :-1]
    end = torch.ones_like(start)
    end[..., :-1] = start[..., 1:]
    first = torch.where(start, pos, torch.zeros_like(pos)).cummax(-1).values
    last = torch.where(end, pos, torch.full_like(pos, L)).flip(-1).cummin(-1).values.flip(-1)
    return first, last


def _take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[..., i, :] elementwise: t (..., L, c), i (..., L) -> (..., L, c)."""
    return torch.gather(t, -2, i[..., None].expand(*i.shape, t.shape[-1]))


def grow_forest(X: torch.Tensor, y: torch.Tensor, n_trees: int, max_features: int,
                min_samples_leaf: int, gen: torch.Generator, bootstrap: bool = True,
                max_depth: Optional[int] = None):
    """Grow `n_trees` regression trees on X (n, d), y (n, m), all on X's
    device, with sklearn's RandomForestRegressor semantics; returns
    (RFState, depth).

    Level by level, every tree at once. A level orders, for each tree and
    each feature, the rows of the open nodes by (node, x) with one stable
    sort of the presorted order by node; takes prefix sums of w, w y, w y^2
    and the row count within each node; and scores every cut between
    adjacent distinct values by sklearn's proxy sum_k SL_k^2/WL + SR_k^2/WR.
    A node keeps its best cut among the features drawn for it (a random
    permutation's first `max_features`, and its first feature that varies
    in the node if none of those does), the first in draw order and then in
    x order among equal scores; a node splits unless it is pure, holds
    fewer than max(2, 2 min_samples_leaf) rows, is at max_depth or has no
    cut leaving min_samples_leaf rows on each side. X is taken as float32
    and the thresholds kept in float64, as sklearn does; the sums run in
    float64 and the node means are stored as float32. What the result depends on is sorts, scans and maxima, never a
    float atomic, so one seed gives one forest on every call."""
    dev = X.device
    Xf = X.to(torch.float32).to(torch.float64)   # sklearn's float32 features
    y = y.to(device=dev, dtype=torch.float64)
    n, d = Xf.shape
    m = y.shape[1]
    T = int(n_trees)
    k = max(1, min(int(max_features), d))
    msl = max(1, int(min_samples_leaf))
    cap = 2 * n                                   # nodes a tree can reach; also "no open node"
    w = _bootstrap_weights(gen, T, n, bootstrap, dev)

    feature = torch.full((T, cap), -1, dtype=torch.long, device=dev)
    threshold = torch.zeros((T, cap), dtype=torch.float64, device=dev)
    left = torch.full((T, cap), -1, dtype=torch.long, device=dev)
    right = torch.full((T, cap), -1, dtype=torch.long, device=dev)
    value = torch.zeros((T, cap, m), dtype=torch.float64, device=dev)
    n_nodes = torch.ones(T, dtype=torch.long, device=dev)

    order = torch.argsort(Xf, dim=0, stable=True).T.contiguous()   # (d, n) presorted rows
    xs = torch.gather(Xf.T, 1, order)                                # (d, n) their values
    node_of = torch.where(w > 0, 0, cap)                             # (T, n) each row's open node
    t_of = torch.arange(T, device=dev)[:, None, None].expand(T, d, n)
    f_of = torch.arange(d, device=dev)[None, :, None].expand(T, d, n)
    pos = torch.arange(n, device=dev).expand(T, d, n)
    rows_all = torch.arange(n, device=dev)[None, :]
    depth = 0
    while True:
        nd, perm = torch.sort(node_of[:, order], dim=-1, stable=True)   # (T, d, n)
        live = nd < cap
        rows = torch.gather(order.expand(T, d, n), -1, perm)
        xv = torch.gather(xs.expand(T, d, n), -1, perm)
        wv = torch.gather(w[:, None, :].expand(T, d, n), -1, rows) * live
        wy = y[rows] * wv[..., None]
        vals = torch.cat([wv[..., None], live[..., None].to(torch.float64), wy, y[rows] * wy], -1)
        first, last = _segments(nd)
        csum = vals.cumsum(-2)
        before = _take(torch.cat([torch.zeros_like(csum[..., :1, :]), csum[..., :-1, :]], -2), first)
        prefix, total = csum - before, _take(csum, last) - before
        WL, CL, SL = prefix[..., 0], prefix[..., 1], prefix[..., 2:2 + m]
        W, C, S, SQ = total[..., 0], total[..., 1], total[..., 2:2 + m], total[..., 2 + m:]
        Wc = W.clamp_min(1e-300)

        # each open node's mean, from feature 0's arrangement (every element
        # of a node writes the same total)
        l0 = live[:, 0]
        value[t_of[:, 0][l0], nd[:, 0][l0]] = (S[:, 0] / Wc[:, 0, :, None])[l0]
        mean = S / Wc[..., None]
        impurity = (SQ / Wc[..., None] - mean * mean).mean(-1)
        can_split = live & (C >= max(2, 2 * msl)) & (impurity > EPSILON)
        if (max_depth is not None and depth >= max_depth) or not bool(can_split.any()):
            break

        # the features drawn for each open node: a random permutation's
        # first k, and its first feature that varies in the node
        nodes = torch.unique(nd[live])                               # open node ids, sorted
        S_n = nodes.numel()
        keys = torch.rand((T, S_n, d), generator=gen, device=dev, dtype=torch.float64)
        rank = torch.argsort(torch.argsort(keys, dim=-1), dim=-1)    # (T, S_n, d)
        slot = torch.searchsorted(nodes, nd.clamp_max(int(nodes[-1])))   # (T, d, n)
        rank_el = torch.gather(rank.reshape(T, -1), 1, (slot * d + f_of).reshape(T, -1)).view(T, d, n)
        varies = live & (torch.gather(xv, -1, last) > torch.gather(xv, -1, first) + FEATURE_THRESHOLD)
        seg = slot.reshape(T, -1)
        vr = torch.full((T, S_n), d, dtype=torch.long, device=dev).scatter_reduce(
            1, seg, torch.where(varies, rank_el, d).reshape(T, -1), reduce="amin")
        drawn = (rank_el < k) | (rank_el == torch.gather(vr, 1, seg).view(T, d, n))

        # every cut between elements i and i + 1 of one node
        x_next = torch.cat([xv[..., 1:], xv[..., -1:]], -1)
        same_next = torch.zeros_like(live)
        same_next[..., :-1] = nd[..., 1:] == nd[..., :-1]
        CR, WR, SR = C - CL, W - WL, S - SL
        ok = (can_split & drawn & same_next & (x_next > xv + FEATURE_THRESHOLD)
              & (CL >= msl) & (CR >= msl))
        proxy = ((SL * SL).sum(-1) / WL.clamp_min(1e-300)
                 + (SR * SR).sum(-1) / WR.clamp_min(1e-300))
        proxy = torch.where(ok, proxy, -np.inf).reshape(T, -1)
        best = torch.full((T, S_n), -np.inf, dtype=torch.float64, device=dev).scatter_reduce(
            1, seg, proxy, reduce="amax")
        at_best = ok.reshape(T, -1) & (proxy == torch.gather(best, 1, seg))
        tie = (rank_el * n + pos).reshape(T, -1)                    # draw order, then x order
        none = d * n + n
        win = torch.full((T, S_n), none, dtype=torch.long, device=dev).scatter_reduce(
            1, seg, torch.where(at_best, tie, none), reduce="amin")
        wt, wflat = (at_best & (tie == torch.gather(win, 1, seg))).nonzero(as_tuple=True)
        if wt.numel() == 0:
            break

        # split the winners, children numbered after each tree's nodes (wt
        # is sorted: the k-th split of a tree takes its k-th pair)
        wf, wp = wflat // n, wflat % n
        wnode = nd[wt, wf, wp]
        a, b = xv[wt, wf, wp], x_next[wt, wf, wp]
        thr = a / 2.0 + b / 2.0
        thr = torch.where((thr == b) | torch.isinf(thr), a, thr)
        kth = torch.arange(wt.numel(), device=dev) - torch.searchsorted(wt, wt)
        lc = n_nodes[wt] + 2 * kth
        n_nodes = n_nodes + 2 * torch.bincount(wt, minlength=T)
        feature[wt, wnode], threshold[wt, wnode] = wf, thr
        left[wt, wnode], right[wt, wnode] = lc, lc + 1

        # each row of a node split here moves to its child; the rows of every
        # other open node have reached their leaf. An open node was split
        # iff it has a feature now: it was created at the previous level
        at = node_of.clamp_max(cap - 1)
        sf = feature.gather(1, at)
        go_left = Xf[rows_all, sf.clamp_min(0)] <= threshold.gather(1, at)
        child = torch.where(go_left, left.gather(1, at), right.gather(1, at))
        node_of = torch.where((node_of < cap) & (sf >= 0), child, cap)
        depth += 1

    N = int(n_nodes.max())
    i32 = lambda t: t[:, :N].to(torch.int32).contiguous()  # noqa: E731
    state = RFState(feature=i32(feature), threshold=threshold[:, :N].contiguous(),
                    left=i32(left), right=i32(right),
                    value=value[:, :N].to(torch.float32).contiguous())
    return state, max(depth, 1)


# ---------------------------------------------------------------------------
# the surrogates
# ---------------------------------------------------------------------------

_FOREST_KWARGS = ("bootstrap", "max_depth")


class RandomForest:
    """A random-forest surrogate with the JAX package's surface: fit,
    predict(eval_MSE), is_fitted, `levels` for a categorical one-hot, and
    the device handles `posterior`/`config`/`predict_torch`.

    feature_space 'raw': rows of raw values, the columns named in `levels`
    one-hot encoded; 'embedding': rows already numeric (the BO loop's
    embedding). Of sklearn's other keywords, which the JAX package forwards
    to RandomForestRegressor, `bootstrap` and `max_depth` are taken; any
    other raises TypeError. The forest's draws come from a torch.Generator
    on `device` seeded from `random_state` at each fit (None: a fresh seed
    from the OS)."""

    def __init__(
        self,
        n_estimators: int = 100,
        max_features: float = 5.0 / 6.0,
        min_samples_leaf: int = 2,
        levels: Optional[dict] = None,
        random_state: Optional[int] = None,
        feature_space: str = "raw",
        device=DEFAULT_DEVICE,
        **kwargs,
    ):
        unknown = sorted(set(kwargs) - set(_FOREST_KWARGS))
        if unknown:
            raise TypeError(f"RandomForest got unexpected keyword argument(s) {unknown}; "
                            f"the port's forest takes {list(_FOREST_KWARGS)}")
        if feature_space not in ("raw", "embedding"):
            raise ValueError("feature_space must be 'raw' or 'embedding'")
        self.device = resolve_device(device)
        self.feature_space = feature_space
        self.n_estimators = int(n_estimators)
        self.max_features = max_features
        self.min_samples_leaf = int(min_samples_leaf)
        self.levels = dict(levels) if levels else None
        self.random_state = random_state
        self.bootstrap = bool(kwargs.get("bootstrap", True))
        self.max_depth = kwargs.get("max_depth")
        self.is_fitted = False
        self._cat_idx = sorted(self.levels.keys()) if self.levels else []

    def _encode(self, X) -> np.ndarray:
        """Numeric rows: as given ('embedding'), or the numeric columns then
        a one-hot block a categorical column ('raw')."""
        if self.feature_space == "embedding":
            X = np.asarray(X, dtype=float)
            return X.reshape(1, -1) if X.ndim == 1 else X
        X = np.asarray(X, dtype=object)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if not self._cat_idx:
            return np.asarray(X, dtype=float)
        num_idx = [j for j in range(X.shape[1]) if j not in self._cat_idx]
        blocks = [np.asarray(X[:, num_idx], dtype=float) if num_idx else np.zeros((len(X), 0))]
        for j in self._cat_idx:
            levels = list(self.levels[j])
            oh = np.zeros((len(X), len(levels)))
            for i, v in enumerate(X[:, j]):
                oh[i, levels.index(v)] = 1.0
            blocks.append(oh)
        return np.hstack(blocks)

    def fit(self, X, y) -> "RandomForest":
        Xe = self._encode(X)
        y = np.asarray(y, dtype=float)
        self._m = 1 if y.ndim == 1 or y.shape[1] == 1 else y.shape[1]
        d = Xe.shape[1]
        # sklearn's max_features as a fraction: max(1, int(f * d))
        k = max(1, int(min(float(self.max_features), 1.0) * d))
        seed = (int(self.random_state) if isinstance(self.random_state, (int, np.integer))
                else int(np.random.SeedSequence().generate_state(1, np.uint64)[0] >> 1))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._state, depth = grow_forest(
            torch.as_tensor(Xe, device=self.device), torch.as_tensor(y.reshape(len(y), -1),
                                                                     device=self.device),
            self.n_estimators, k, self.min_samples_leaf, gen, bootstrap=self.bootstrap,
            max_depth=self.max_depth)
        self._config = RFConfig(max_depth=depth)
        self.is_fitted = True
        return self

    def predict(self, X, eval_MSE: bool = False):
        """(N,) (and the MSE (N,)) for a single-output fit, (N, m) for a
        multi-output one; the rows taken as float32, as sklearn does."""
        Xe = torch.as_tensor(self._encode(X), dtype=torch.float32, device=self.device)
        mu, var = rf_predict(self._state, Xe, self._config)
        mu = mu.cpu().double().numpy()
        var = var.cpu().double().numpy()
        if self._m == 1:
            mu, var = mu.ravel(), var.ravel()
        return (mu, var) if eval_MSE else mu

    # -- device-side handles, as GaussianProcess's -------------------------
    @property
    def posterior(self) -> RFState:
        if not self.is_fitted:
            raise ValueError("model is not fitted yet")
        return self._state

    @property
    def config(self) -> RFConfig:
        return self._config

    def predict_torch(self, Xq: torch.Tensor, eval_mse: bool = True):
        """(mu (Nq, m), var (Nq, m) or None) on device tensors."""
        mu, var = rf_predict(self._state, Xq, self._config)
        return (mu, var) if eval_mse else (mu, None)


class SurrogateAggregation:
    """A weighted sum of fitted surrogates: the mean sum_i w_i mu_i and the
    MSE sum_i w_i^2 mse_i."""

    def __init__(self, surrogates, aggregation: str = "WS", weights=None):
        self.surrogates = list(surrogates)
        self.aggregation = aggregation
        self.weights = np.asarray(
            weights if weights is not None else np.ones(len(self.surrogates)) / len(self.surrogates),
            dtype=float,
        )
        if aggregation != "WS":
            raise NotImplementedError("only weighted-sum ('WS') aggregation is supported")

    @property
    def is_fitted(self) -> bool:
        return all(getattr(s, "is_fitted", False) for s in self.surrogates)

    def fit(self, X, y):
        raise NotImplementedError("aggregate of already-fitted surrogates")

    def predict(self, X, eval_MSE: bool = False):
        outs = [s.predict(X, eval_MSE=eval_MSE) for s in self.surrogates]
        mus = np.stack([np.asarray(o[0] if eval_MSE else o).ravel() for o in outs])
        mu = np.average(mus, axis=0, weights=self.weights)
        if not eval_MSE:
            return mu
        mses = np.stack([np.asarray(o[1]).ravel() for o in outs])
        return mu, np.sum((self.weights[:, None] ** 2) * mses, axis=0)
