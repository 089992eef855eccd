"""The port's random forest (models/random_forest.py) against the JAX
package's on the CPU: the traversal of a forest carried across from a fitted
JAX RandomForest, the port's own grower against the JAX package's
sklearn-grown forest, the held-out error of the default forest, the MSE as
the trees' variance, the categorical one-hot and SurrogateAggregation
(tests/test_random_forest.py's cases), and that the port imports and grows
its forest with scikit-learn blocked."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.models.random_forest import RandomForest as JRF
from bayesian_optimization_tpu.models.random_forest import rf_predict as j_rf_predict
from bayesian_optimization_tpu_torch.models.convert import rf_state_from_numpy
from bayesian_optimization_tpu_torch.models.random_forest import RandomForest as TRF
from bayesian_optimization_tpu_torch.models.random_forest import SurrogateAggregation
from bayesian_optimization_tpu_torch.models.random_forest import rf_predict, rf_predict_trees

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

ROOT = Path(__file__).resolve().parents[1]


def _data(seed, n=80, d=3, m=1):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d))
    y = X[:, 0] ** 2 + np.sin(X[:, 1]) + X[:, 2] + 0.1 * rng.standard_normal(n)
    if m > 1:
        y = np.c_[y, np.cos(X[:, 0]) * X[:, 1]]
    return X, y


@pytest.mark.parametrize("m", [1, 2])
def test_traversal_of_a_carried_jax_forest(m):
    """rf_predict on exactly the JAX package's forest (its RFState carried
    by rf_state_from_numpy) equals the JAX traversal, mu and var, float32."""
    X, y = _data(0, m=m)
    jrf = JRF(n_estimators=30, feature_space="embedding", random_state=0).fit(X, y)
    state, config = rf_state_from_numpy(
        {k: np.asarray(v) for k, v in jrf.posterior._asdict().items()}, jrf.config.max_depth, "cpu")
    Xq = np.random.default_rng(1).uniform(-2, 2, (25, 3)).astype(np.float32)
    mu_j, var_j = (np.asarray(a) for a in j_rf_predict(jrf.posterior, jnp.asarray(Xq), jrf.config))
    mu_t, var_t = rf_predict(state, torch.tensor(Xq), config)
    assert mu_t.shape == (25, m)
    np.testing.assert_allclose(mu_t.numpy(), mu_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var_t.numpy(), var_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grower_matches_sklearns_without_randomness(seed, m):
    """bootstrap=False, max_features=1.0: no draw decides a split, so the
    port's trees are the JAX package's sklearn trees. Same depth and node
    count, and the same leaf of every training row (their predictions at
    1e-5). Held-out points may still fall differently: where two features
    cut a node into the same two sets, which of them is kept depends on the
    rounding of the sums (ROADMAP Queue 3)."""
    X, y = _data(seed, n=60, m=m)
    kw = dict(n_estimators=3, max_features=1.0, min_samples_leaf=2, bootstrap=False,
              feature_space="embedding", random_state=0)
    jrf = JRF(**kw).fit(X, y)
    trf = TRF(device="cpu", **kw).fit(X, y)
    np.testing.assert_allclose(trf.predict(X), jrf.predict(X), rtol=1e-5, atol=1e-5)
    assert trf.config.max_depth == jrf.config.max_depth
    counts = [int((f >= 0).sum()) for f in np.asarray(jrf.posterior.feature)]
    assert [int((f >= 0).sum()) for f in trf.posterior.feature.numpy()] == counts


def test_default_forest_heldout_error_against_jax():
    """With the defaults (100 trees, bootstrap, max_features 5/6,
    min_samples_leaf 2) the mean held-out RMSE over seeds 0-9 is within
    1.15x of the JAX package's sklearn forest's."""
    rmse_t, rmse_j = [], []
    for seed in range(10):
        X, y = _data(seed, n=120)
        Xh, yh = _data(100 + seed, n=200)
        trf = TRF(feature_space="embedding", random_state=seed, device="cpu").fit(X, y)
        jrf = JRF(feature_space="embedding", random_state=seed).fit(X, y)
        rmse_t.append(np.sqrt(np.mean((trf.predict(Xh) - yh) ** 2)))
        rmse_j.append(np.sqrt(np.mean((jrf.predict(Xh) - yh) ** 2)))
    assert np.mean(rmse_t) <= 1.15 * np.mean(rmse_j), (np.mean(rmse_t), np.mean(rmse_j))


def test_mse_is_tree_variance_and_seed_fixes_the_forest():
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, (60, 2))
    y = X.sum(1) + 0.3 * rng.standard_normal(60)
    rf = TRF(n_estimators=25, feature_space="embedding", random_state=0, device="cpu").fit(X, y)
    mu, mse = rf.predict(X[:10], eval_MSE=True)
    per_tree = rf_predict_trees(rf.posterior, torch.tensor(X[:10], dtype=torch.float32),
                                rf.config)[..., 0].double().numpy()
    np.testing.assert_allclose(mse, per_tree.var(axis=1), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mu, per_tree.mean(axis=1), rtol=1e-6, atol=1e-7)
    assert np.all(mse >= 0) and mse.max() > 0
    again = TRF(n_estimators=25, feature_space="embedding", random_state=0, device="cpu").fit(X, y)
    for a, b in zip(rf.posterior, again.posterior):
        assert torch.equal(a, b)


def test_keywords():
    """bootstrap and max_depth are taken (max_depth bounds the depth); any
    other sklearn keyword raises TypeError naming it."""
    X, y = _data(0, n=60)
    rf = TRF(n_estimators=5, max_depth=3, feature_space="embedding", random_state=0,
             device="cpu").fit(X, y)
    assert rf.config.max_depth == 3
    with pytest.raises(TypeError, match="criterion"):
        TRF(criterion="absolute_error", device="cpu")


def test_rf_categorical_levels():
    """tests/test_random_forest.py's categorical case."""
    rng = np.random.default_rng(2)
    n = 60
    xc = rng.choice(["a", "b", "c"], n)
    xr = rng.uniform(0, 1, n)
    X = np.empty((n, 2), dtype=object)
    X[:, 0] = xr
    X[:, 1] = xc
    y = xr + (xc == "b") * 2.0
    rf = TRF(n_estimators=40, levels={1: ["a", "b", "c"]}, random_state=0, device="cpu").fit(X, y)
    mu = rf.predict(X[:10])
    assert np.corrcoef(mu, y[:10])[0, 1] > 0.9
    assert rf.posterior.feature.max() <= 3  # 1 numeric column + 3 one-hot columns


def test_surrogate_aggregation():
    """tests/test_random_forest.py's aggregation case."""
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 1, (50, 2))
    y1, y2 = X.sum(1), (X ** 2).sum(1)
    rf1 = TRF(n_estimators=15, feature_space="embedding", random_state=0, device="cpu").fit(X, y1)
    rf2 = TRF(n_estimators=15, feature_space="embedding", random_state=0, device="cpu").fit(X, y2)
    agg = SurrogateAggregation([rf1, rf2], weights=[0.25, 0.75])
    mu, mse = agg.predict(X[:5], eval_MSE=True)
    want = 0.25 * rf1.predict(X[:5]) + 0.75 * rf2.predict(X[:5])
    np.testing.assert_allclose(mu, want, rtol=1e-6)
    np.testing.assert_allclose(mse, 0.0625 * rf1.predict(X[:5], True)[1]
                               + 0.5625 * rf2.predict(X[:5], True)[1], rtol=1e-6)
    assert agg.is_fitted
    with pytest.raises(NotImplementedError):
        SurrogateAggregation([rf1], aggregation="Tchebycheff")


def test_port_needs_no_sklearn():
    """Every module of the port imports, and a forest grows and predicts,
    with sklearn made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['sklearn'] = None\n"
        "import numpy as np\n"
        "import bayesian_optimization_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'bayesian_optimization_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "X = np.random.default_rng(0).uniform(0, 1, (30, 2))\n"
        "rf = p.RandomForest(n_estimators=5, feature_space='embedding', device='cpu')\n"
        "print(rf.fit(X, X.sum(1)).predict(X[:3]).shape)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(3,)"
