"""Embedding-quality scoring: kNN retrieval and linear probes (counterpart
of :mod:`bvc_tpu.evalbench.scores`).

The notebook's ``get_nn_score`` / ``get_separability_score``
(``notebooks/EvaluateEmbeddings.ipynb`` cell 5): top-k in {1,5,10,20,50}
retrieval accuracy under cosine/euclidean distance, and a StandardScaler +
linear classifier probe with the reference's hyperparameters:
``method="sgd"`` an SGDClassifier (hinge loss, L2 alpha 1e-4, the 'optimal'
learning rate, max_iter 5000, tol 1e-4, one binary classifier per class
beyond two, shuffled each epoch, no ``random_state``), ``method="svm"`` a
LinearSVC (squared hinge, L2, C 1, tol 1e-4, max_iter 1000, one-vs-rest,
``random_state=0``).

The JAX package calls scikit-learn for these.  The port carries the same
algorithms, step for step, so that it scores where scikit-learn is not
installed: LabelEncoder, StandardScaler, the pairwise distances and
``train_test_split`` in numpy; SGDClassifier's plain SGD (hinge loss,
xorshift shuffle, scaled weight vector) in C++, ``native/sgd.cpp``; and
liblinear's LinearSVC solvers (dual coordinate descent when there are fewer
rows than features, else the primal trust-region Newton method) in C++,
``native/linear_svc.cpp``; both built with ``g++`` at first use.  The
primal solver sums with scipy's BLAS, as scikit-learn's does, so the 'svm'
probe needs scipy.  The tests hold the results equal to the JAX package's.
As in scikit-learn the SGD one-vs-rest fits run on ``n_jobs`` threads, and
their shuffle seeds are drawn from numpy's global generator when there is
no ``random_state``: seed ``np.random`` before a call to repeat it.  The SVM
fit draws its seed from ``random_state=0`` and repeats without.
"""

from __future__ import annotations

import ctypes
import json
import os
import warnings
from math import ceil

import numpy as np
import pandas as pd

TOP_KS = (1, 5, 10, 20, 50)

# SGDClassifier(max_iter=5000, tol=1e-4) and the defaults it keeps
SGD_ALPHA = 1e-4
SGD_MAX_ITER = 5000
SGD_TOL = 1e-4
SGD_N_ITER_NO_CHANGE = 5
# LinearSVC(random_state=0, tol=1e-4) and the defaults it keeps
SVM_C = 1.0
SVM_TOL = 1e-4
SVM_MAX_ITER = 1000
SVM_INTERCEPT_SCALING = 1.0
SVM_RANDOM_STATE = 0
METHODS = ("sgd", "svm")
_MAX_INT = np.iinfo(np.int32).max
_EPS = np.finfo(np.float64).eps


def _dim_cols(df: pd.DataFrame) -> list[str]:
    return [c for c in df.columns if "dim" in c]


def _label_encode(train, test=None):
    """LabelEncoder: (sorted classes, train codes, test codes); a test label
    not seen in train raises."""
    classes, y_train = np.unique(np.asarray(train), return_inverse=True)
    if test is None:
        return classes, y_train, None
    test = np.asarray(test)
    unseen = np.setdiff1d(test, classes)
    if unseen.size:
        raise ValueError(f"y contains previously unseen labels: {unseen.tolist()}")
    return classes, y_train, np.searchsorted(classes, test)


def _row_norms(x: np.ndarray) -> np.ndarray:
    return np.einsum("ij,ij->i", x, x)


def _nonzero_scale(scale: np.ndarray, constant: np.ndarray | None = None) -> np.ndarray:
    scale = scale.copy()
    scale[scale < 10 * _EPS if constant is None else constant] = 1.0
    return scale


def cosine_distances(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """``1 - cos`` of every row of ``x`` against every row of ``y``, clipped
    to [0, 2]."""
    xn = x / _nonzero_scale(np.sqrt(_row_norms(x)))[:, None]
    yn = y / _nonzero_scale(np.sqrt(_row_norms(y)))[:, None]
    s = xn @ yn.T
    s *= -1
    s += 1
    return np.clip(s, 0.0, 2.0)


def euclidean_distances(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = -2 * (x @ y.T)
    d += _row_norms(x)[:, None]
    d += _row_norms(y)[None, :]
    np.maximum(d, 0, out=d)
    return np.sqrt(d)


def train_test_split(*arrays, test_size: float = 0.25, random_state=None):
    """``sklearn.model_selection.train_test_split`` with a float
    ``test_size`` and shuffling: one permutation from ``random_state`` (an
    int seed, or numpy's global generator when None); returns (train,
    test) of each array, rows taken with ``.iloc`` from DataFrames."""
    n = len(arrays[0])
    n_test = ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"with n_samples={n} and test_size={test_size} the train set "
                         "would be empty")
    rng = np.random.mtrand._rand if random_state is None else np.random.RandomState(
        random_state)
    perm = rng.permutation(n)
    test, train = perm[:n_test], perm[n_test:n_test + n_train]
    out = []
    for a in arrays:
        take = a.iloc.__getitem__ if hasattr(a, "iloc") else np.asarray(a).__getitem__
        out += [take(train), take(test)]
    return out


class StandardScaler:
    """Per-feature mean and standard deviation (the corrected two-pass
    variance); a near-constant feature keeps scale 1."""

    def fit(self, x: np.ndarray) -> "StandardScaler":
        n = float(x.shape[0])
        total = np.sum(x, axis=0)
        self.mean_ = total / n
        temp = x - total / n
        correction = np.sum(temp, axis=0)
        temp **= 2
        var = (np.sum(temp, axis=0) - correction ** 2 / n) / n
        constant = var <= n * _EPS * var + (n * self.mean_ * _EPS) ** 2
        self.scale_ = _nonzero_scale(np.sqrt(var), constant)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.array(x, dtype=np.float64, order="K", copy=True)
        x -= self.mean_
        x /= self.scale_
        return x


class ConvergenceWarning(UserWarning):
    """scikit-learn's warning of a fit that reached ``max_iter``."""


_ENTRY_ARGS = {
    "bvc_sgd": ("bvc_sgd_hinge", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int] + [ctypes.c_void_p] * 3),
    "bvc_linear_svc": ("bvc_linear_svc", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_void_p, ctypes.c_int32, ctypes.c_double,
                                          ctypes.c_double, ctypes.c_int, ctypes.c_uint32,
                                          ctypes.c_int, ctypes.c_double, ctypes.c_int]
                       + [ctypes.c_void_p] * 3),
}
_libs: dict[str, ctypes.CDLL] = {}


def _native_fit(name: str):
    """The fit function of ``native/``'s library ``name``, built at first
    use."""
    if name not in _libs:
        from bvc_tpu_torch.native.build import build

        lib = ctypes.CDLL(str(build(verbose=False, name=name)))
        entry, argtypes = _ENTRY_ARGS[name]
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        _libs[name] = lib
    return getattr(_libs[name], _ENTRY_ARGS[name][0])


def _scipy_blas() -> ctypes.Array:
    """The addresses of scipy's ddot, dnrm2, daxpy and dscal, the BLAS that
    scikit-learn hands liblinear's TRON."""
    try:
        from scipy.linalg import cython_blas
    except ImportError as e:
        raise ImportError("the 'svm' probe needs scipy: its primal solver sums with "
                          "scipy's BLAS, as scikit-learn's does") from e
    name, pointer = ctypes.pythonapi.PyCapsule_GetName, ctypes.pythonapi.PyCapsule_GetPointer
    name.restype, name.argtypes = ctypes.c_char_p, [ctypes.py_object]
    pointer.restype, pointer.argtypes = ctypes.c_void_p, [ctypes.py_object, ctypes.c_char_p]
    fns = (ctypes.c_void_p * 4)()
    for i, fn in enumerate(("ddot", "dnrm2", "daxpy", "dscal")):
        capsule = cython_blas.__pyx_capi__[fn]
        fns[i] = pointer(capsule, name(capsule))
    return fns


def _threads(n_jobs: int | None) -> int:
    """joblib's reading of ``n_jobs``: None is 1, -1 every core, -2 all but
    one."""
    if n_jobs is None:
        return 1
    return max(1, (os.cpu_count() or 1) + 1 + n_jobs if n_jobs < 0 else n_jobs)


class _LinearClassifier:
    """``coef_`` [k, d] and ``intercept_`` [k] (k = 1 for two classes) of
    the sorted ``classes_``; the prediction is LinearClassifierMixin's."""

    def predict(self, x: np.ndarray) -> np.ndarray:
        scores = x @ self.coef_.T + self.intercept_
        if scores.shape[1] == 1:
            return self.classes_[(scores.reshape(-1) > 0).astype(int)]
        return self.classes_[scores.argmax(axis=1)]


class SGDClassifier(_LinearClassifier):
    """Linear SVM by plain SGD (``native/sgd.cpp``), one-vs-rest beyond two
    classes; the binary fits run on ``n_jobs`` threads."""

    def __init__(self, n_jobs: int | None = None):
        self.n_jobs = n_jobs

    def fit(self, x: np.ndarray, y: np.ndarray) -> "SGDClassifier":
        x = np.ascontiguousarray(x, dtype=np.float64)
        self.classes_ = np.unique(y)
        if len(self.classes_) < 2:
            raise ValueError(f"The number of classes has to be greater than one; got "
                             f"{len(self.classes_)} class")
        if len(self.classes_) == 2:
            rngs = [np.random.mtrand._rand]
            positives = self.classes_[1:]
        else:
            rngs = [np.random.RandomState(s)
                    for s in np.random.randint(_MAX_INT, size=len(self.classes_))]
            positives = self.classes_
        seeds = []
        for rng in rngs:
            rng.randint(1, _MAX_INT)  # the dataset's own seed, which SGD leaves unused
            seeds.append(rng.randint(_MAX_INT))
        k, (n, d) = len(positives), x.shape
        labels = np.stack([np.where(y == c, 1.0, -1.0) for c in positives])
        seeds = np.asarray(seeds, dtype=np.uint32)
        coef, intercept = np.empty((k, d)), np.empty(k)
        epochs = np.empty(k, dtype=np.intc)
        _native_fit("bvc_sgd")(
            x.ctypes.data, n, d, labels.ctypes.data, seeds.ctypes.data, k, SGD_ALPHA, SGD_TOL,
            SGD_MAX_ITER, SGD_N_ITER_NO_CHANGE, _threads(self.n_jobs), coef.ctypes.data,
            intercept.ctypes.data, epochs.ctypes.data)
        if (epochs < 0).any():
            raise ValueError("Floating-point under-/overflow occurred at epoch "
                             f"#{-epochs.min()}")
        self.coef_, self.intercept_ = coef, intercept
        self.n_iter_ = int(epochs.max())
        if self.n_iter_ == SGD_MAX_ITER:
            warnings.warn("Maximum number of iteration reached before convergence.")
        return self


class LinearSVC(_LinearClassifier):
    """liblinear's L2-regularised squared-hinge SVM (``native/
    linear_svc.cpp``), one-vs-rest beyond two classes, the intercept a
    regularised extra feature: the dual solver when there are fewer rows
    than features (``dual="auto"``), else the primal one, whose binary fits
    run on ``n_jobs`` threads and whose level-1 BLAS is scipy's, as
    scikit-learn's is: without scipy the fit raises ImportError."""

    def __init__(self, n_jobs: int | None = None):
        self.n_jobs = n_jobs

    def fit(self, x: np.ndarray, y: np.ndarray) -> "LinearSVC":
        x = np.ascontiguousarray(x, dtype=np.float64)
        self.classes_, codes = np.unique(y, return_inverse=True)
        if len(self.classes_) < 2:
            raise ValueError("This solver needs samples of at least 2 classes in the data, "
                             f"but the data contains only one class: {self.classes_[0]!r}")
        (n, d), k = x.shape, len(self.classes_)
        self.dual_ = n < d
        # _fit_liblinear's draw from check_random_state(random_state)
        seed = np.random.RandomState(SVM_RANDOM_STATE).randint(np.iinfo("i").max)
        problems = 1 if k == 2 else k
        raw = np.empty((problems, d + 1))
        n_iter = np.empty(problems, dtype=np.intc)
        codes = np.ascontiguousarray(codes, dtype=np.int32)
        _native_fit("bvc_linear_svc")(
            x.ctypes.data, n, d, codes.ctypes.data, k, SVM_C, SVM_TOL, SVM_MAX_ITER, seed,
            int(self.dual_), SVM_INTERCEPT_SCALING, _threads(self.n_jobs), _scipy_blas(),
            raw.ctypes.data, n_iter.ctypes.data)
        raw = np.asfortranarray(raw)  # liblinear's layout, which the prediction's product reads
        self.coef_ = raw[:, :-1]
        self.intercept_ = SVM_INTERCEPT_SCALING * raw[:, -1]
        self.n_iter_ = int(n_iter.max())
        if self.n_iter_ >= SVM_MAX_ITER:
            warnings.warn("Liblinear failed to converge, increase the number of iterations.",
                          ConvergenceWarning)
        return self


class LinearProbe:
    """StandardScaler then SGDClassifier (``method="sgd"``) or LinearSVC
    (``"svm"``), as the reference's pipelines."""

    def __init__(self, n_jobs: int | None = None, method: str = "sgd"):
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        self.n_jobs, self.method = n_jobs, method

    def fit(self, x, y) -> "LinearProbe":
        self.scaler = StandardScaler().fit(x)
        cls = SGDClassifier if self.method == "sgd" else LinearSVC
        self.clf = cls(self.n_jobs).fit(self.scaler.transform(x), y)
        return self

    def predict(self, x) -> np.ndarray:
        return self.clf.predict(self.scaler.transform(x))

    def score(self, x, y) -> float:
        return float(np.average(self.predict(x) == np.asarray(y)))


def get_nn_score(
    df_train: pd.DataFrame,
    df_test: pd.DataFrame,
    label: str,
    metric: str = "cosine",
    savedir: str | None = None,
    run_id: str | None = None,
) -> dict[int, float]:
    """Top-k retrieval accuracy of test embeddings against train."""
    _, y_train, y_test = _label_encode(df_train[label], df_test[label])
    cols = _dim_cols(df_train)
    x_train = df_train[cols].to_numpy()
    x_test = df_test[cols].to_numpy()

    dist_fn = cosine_distances if metric == "cosine" else euclidean_distances
    distances = dist_fn(np.asarray(x_test, dtype=np.float64),
                        np.asarray(x_train, dtype=np.float64))
    indices = np.argsort(distances)

    topk: dict[int, float] = {}
    for k in TOP_KS:
        hits = sum(
            1
            for ind, yt in zip(indices[:, :k], y_test)
            if yt in y_train[ind]
        )
        topk[k] = hits / len(y_test)

    if savedir is not None:
        if run_id is None:
            raise ValueError("run_id required when saving")
        with open(os.path.join(savedir, f"{run_id}_topk_correct.json"), "w") as f:
            json.dump(topk, f)
    return topk


def get_separability_score(
    df_train: pd.DataFrame,
    df_test: pd.DataFrame | None,
    label: str,
    method: str = "sgd",
    ret_preds: bool = False,
    n_jobs: int = 8,
):
    """Linear-probe train/test accuracy (notebook cell 5), ``method``
    "sgd" or "svm"; the one-vs-rest fits run on ``n_jobs`` threads, as the
    reference's SGD fits do.  An unknown ``method`` raises once the labels
    are encoded and split, as in the JAX package."""
    if df_test is not None:
        _, y_train, y_test = _label_encode(df_train[label], df_test[label])
    else:
        _, y_train, _ = _label_encode(df_train[label])
    cols = _dim_cols(df_train)
    x_train = np.asarray(df_train[cols], dtype=np.float64)
    if df_test is not None:
        x_test = np.asarray(df_test[cols], dtype=np.float64)
    else:
        x_train, x_test, y_train, y_test = train_test_split(
            x_train, y_train, test_size=0.33, random_state=42
        )

    clf = LinearProbe(n_jobs, method).fit(x_train, y_train)
    train_score = clf.score(x_train, y_train)
    test_score = clf.score(x_test, y_test)
    if ret_preds:
        return train_score, test_score, clf.predict(x_test), y_test
    return train_score, test_score
