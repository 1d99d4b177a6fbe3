"""The port's 'svm' linear probe against ``bvc_tpu``'s, which fits
scikit-learn's ``make_pipeline(StandardScaler(), LinearSVC(random_state=0,
tol=1e-4))``; the port fits liblinear's solvers carried in
``native/linear_svc.cpp``.

Both regimes of ``dual="auto"``: fewer training rows than features (the dual
coordinate descent, which permutes its rows with liblinear's mt19937) and as
many or more (the primal trust-region Newton method), at 2 classes (one
binary problem) and 4 (one-vs-rest), with a test frame and with the 0.33
split.  Tolerance: none.  Both paths run liblinear's operations in its
order, and the primal one takes scipy's BLAS as scikit-learn's does, so the
scores and predictions are equal, and so are the fitted weights,
intercepts and iteration counts, bit for bit.  Without scipy the fit
raises.
"""

import sys

import warnings

import numpy as np
import pandas as pd
import pytest
from sklearn.exceptions import ConvergenceWarning as SkConvergenceWarning
from sklearn.pipeline import make_pipeline
from sklearn.preprocessing import StandardScaler as SkStandardScaler
from sklearn.svm import LinearSVC as SkLinearSVC

from bvc_tpu.evalbench import scores as jax_scores
from bvc_tpu_torch.evalbench import scores

# (rows, features): the dual regime keeps fewer training rows than features
# under the 0.33 split too; the primal one more
REGIMES = {"dual": (45, 64), "primal": (150, 24)}


def _frames(regime, classes, seed=0, spread=1.5):
    rows, width = REGIMES[regime]
    rng = np.random.default_rng(seed + 10 * classes + rows)
    labels = np.array([f"c{i % classes}" for i in range(rows)])
    codes = np.unique(labels, return_inverse=True)[1]
    centers = rng.standard_normal((classes, width))

    def frame(n):
        x = centers[codes[:n]] + spread * rng.standard_normal((n, width))
        return pd.DataFrame(x, columns=[f"dim{i}" for i in range(width)]).assign(
            cat=labels[:n])

    return frame(rows), frame(rows // 2)


def _sk_probe(x, y):
    return make_pipeline(SkStandardScaler(), SkLinearSVC(random_state=0, tol=1e-4)).fit(x, y)


@pytest.mark.parametrize("split", ["test_frame", "split_0.33"])
@pytest.mark.parametrize("classes", [2, 4])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_separability_score_matches_jax(regime, classes, split):
    """Train and test scores, the test predictions and labels, equal."""
    train, test = _frames(regime, classes)
    df_test = test if split == "test_frame" else None
    ours = scores.get_separability_score(train, df_test, "cat", method="svm", ret_preds=True)
    theirs = jax_scores.get_separability_score(train, df_test, "cat", method="svm",
                                               ret_preds=True)
    assert ours[:2] == theirs[:2]
    np.testing.assert_array_equal(ours[2], theirs[2])
    np.testing.assert_array_equal(ours[3], theirs[3])
    assert np.isfinite(ours[:2]).all() and 0 < ours[1] <= ours[0] <= 1


@pytest.mark.parametrize("classes", [2, 4])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_fit_matches_sklearn_bit_for_bit(regime, classes):
    """The scaler, ``coef_``, ``intercept_``, ``n_iter_`` and the solver the
    regime picks, equal to scikit-learn's LinearSVC."""
    train, _ = _frames(regime, classes)
    x, y = np.asarray(train.filter(like="dim"), dtype=np.float64), np.asarray(train["cat"])
    ref = _sk_probe(x, y)
    ours = scores.LinearProbe(method="svm").fit(x, y)
    assert ours.clf.dual_ == (regime == "dual")
    np.testing.assert_array_equal(ours.scaler.scale_, ref[0].scale_)
    np.testing.assert_array_equal(ours.clf.classes_, ref[1].classes_)
    assert ours.clf.coef_.shape == ref[1].coef_.shape == (1 if classes == 2 else classes,
                                                          x.shape[1])
    np.testing.assert_array_equal(ours.clf.coef_, ref[1].coef_)
    np.testing.assert_array_equal(ours.clf.intercept_, ref[1].intercept_)
    assert ours.clf.n_iter_ == ref[1].n_iter_
    np.testing.assert_array_equal(ours.predict(x), ref.predict(x))


@pytest.mark.parametrize("regime", list(REGIMES))
def test_fit_without_scipy_raises(regime, monkeypatch):
    """The fit takes scipy's BLAS in both regimes; without scipy it raises
    an ImportError that names it."""
    monkeypatch.setitem(sys.modules, "scipy.linalg", None)
    train, _ = _frames(regime, 2)
    x, y = np.asarray(train.filter(like="dim"), dtype=np.float64), np.asarray(train["cat"])
    with pytest.raises(ImportError, match="needs scipy"):
        scores.LinearSVC().fit(x, y)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_fit_repeats_and_threads_change_nothing(regime):
    """The seed comes from ``random_state=0``: two fits, and fits on 1 and 8
    threads, give the same weights."""
    train, _ = _frames(regime, 4, seed=3)
    x, y = np.asarray(train.filter(like="dim"), dtype=np.float64), np.asarray(train["cat"])
    fits = [scores.LinearSVC(n_jobs).fit(x, y) for n_jobs in (1, 1, 8)]
    for fit in fits[1:]:
        np.testing.assert_array_equal(fit.coef_, fits[0].coef_)
        np.testing.assert_array_equal(fit.intercept_, fits[0].intercept_)
        assert fit.n_iter_ == fits[0].n_iter_


@pytest.mark.parametrize("regime", list(REGIMES))
def test_max_iter_warns_as_sklearn(regime, monkeypatch):
    """A fit that reaches ``max_iter`` warns and stops where scikit-learn's
    does."""
    monkeypatch.setattr(scores, "SVM_MAX_ITER", 2)
    train, _ = _frames(regime, 4, spread=3.0)
    x, y = np.asarray(train.filter(like="dim"), dtype=np.float64), np.asarray(train["cat"])
    with pytest.warns(SkConvergenceWarning):
        ref = SkLinearSVC(random_state=0, tol=1e-4, max_iter=2).fit(x, y)
    with pytest.warns(scores.ConvergenceWarning, match="Liblinear failed to converge"):
        ours = scores.LinearSVC().fit(x, y)
    assert ours.n_iter_ == ref.n_iter_ == 2
    np.testing.assert_array_equal(ours.coef_, ref.coef_)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        monkeypatch.setattr(scores, "SVM_MAX_ITER", 1000)
        scores.LinearSVC().fit(x, y)


def test_one_class_raises():
    with pytest.raises(ValueError, match="at least 2 classes"):
        scores.LinearSVC().fit(np.zeros((3, 2)), np.array([1, 1, 1]))
