"""SVC family parity vs sklearn/libsvm.

Serving parity must be near-exact when loading an sklearn-fitted model
(the reference pickles SVC models for predict.py). Training parity is
to-the-same-optimum: the dual QP is strictly convex in the decision
function, so our SMO and libsvm agree on decisions and accuracy within
solver tolerance.
"""

import numpy as np
import pytest
from sklearn import svm

from radarml_tpu.models import svc as jsvc


def _blobs(rng, n=120, k=3, f=12, spread=2.5):
    centers = rng.normal(size=(k, f)) * spread
    y = np.arange(n) % k
    X = centers[y] + rng.normal(size=(n, f))
    return X.astype(np.float32), y


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_from_sklearn_decision_and_predict_parity(rng, kernel):
    X, y = _blobs(rng)
    clf = svm.SVC(
        kernel=kernel, C=10.0, gamma=0.05, probability=True,
        class_weight="balanced", random_state=1234,
    ).fit(X, y)
    model = jsvc.from_sklearn_svc(clf)

    Xq = rng.normal(size=(40, X.shape[1])).astype(np.float32) + X[:40] * 0.5
    want_dec = clf.decision_function(Xq)  # ovr-transformed by default
    clf.decision_function_shape = "ovo"
    want_ovo = clf.decision_function(Xq)
    got_ovo = np.asarray(jsvc.decision_function_ovo(model, Xq))
    np.testing.assert_allclose(got_ovo, want_ovo, atol=2e-4, rtol=1e-4)

    np.testing.assert_array_equal(
        np.asarray(jsvc.predict(model, Xq)), clf.predict(Xq)
    )

    want_proba = clf.predict_proba(Xq)
    got_proba = np.asarray(jsvc.predict_proba(model, Xq))
    np.testing.assert_allclose(got_proba, want_proba, atol=2e-4)


def test_binary_from_sklearn_parity(rng):
    X, y = _blobs(rng, k=2)
    clf = svm.SVC(kernel="rbf", C=1.0, gamma=0.1, probability=True).fit(X, y)
    model = jsvc.from_sklearn_svc(clf)
    Xq = X[:30] + 0.1
    # Internal OvO convention: positive favors class 0, i.e. the
    # negation of sklearn's binary decision_function.
    np.testing.assert_allclose(
        np.asarray(jsvc.decision_function_ovo(model, Xq))[:, 0],
        -clf.decision_function(Xq),
        atol=2e-4, rtol=1e-4,
    )
    np.testing.assert_array_equal(
        np.asarray(jsvc.predict(model, Xq)), clf.predict(Xq)
    )
    np.testing.assert_allclose(
        np.asarray(jsvc.predict_proba(model, Xq)), clf.predict_proba(Xq),
        atol=2e-4,
    )


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_smo_fit_matches_sklearn_optimum(rng, kernel):
    X, y = _blobs(rng, n=90, k=3, f=8)
    cfg = jsvc.SVCConfig(
        C=10.0, kernel=kernel, gamma=0.05, probability=False,
        class_weight="balanced",
    )
    ours = jsvc.svc_fit(X, y, cfg)
    ref = svm.SVC(
        kernel=kernel, C=10.0, gamma=0.05, class_weight="balanced"
    ).fit(X, y)

    Xq = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    ref.decision_function_shape = "ovo"
    want = ref.decision_function(Xq)
    got = np.asarray(jsvc.decision_function_ovo(ours, Xq))
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-2)
    assert (np.asarray(jsvc.predict(ours, Xq)) == ref.predict(Xq)).mean() > 0.98


def test_smo_binary_weighted(rng):
    X, y = _blobs(rng, n=80, k=2, f=6)
    # Imbalance the classes.
    keep = np.concatenate([np.where(y == 0)[0], np.where(y == 1)[0][:10]])
    X, y = X[keep], y[keep]
    cfg = jsvc.SVCConfig(C=1.0, kernel="rbf", gamma=0.1, probability=False)
    ours = jsvc.svc_fit(X, y, cfg)
    ref = svm.SVC(kernel="rbf", C=1.0, gamma=0.1, class_weight="balanced").fit(X, y)
    got = np.asarray(jsvc.decision_function_ovo(ours, X))[:, 0]
    # Internal convention: negation of sklearn's binary decision.
    np.testing.assert_allclose(got, -ref.decision_function(X), atol=5e-3, rtol=1e-2)


def test_own_probability_calibration_reasonable(rng):
    X, y = _blobs(rng, n=120, k=3, f=8)
    cfg = jsvc.SVCConfig(C=10.0, kernel="rbf", gamma=0.05, probability=True)
    model = jsvc.svc_fit(X, y, cfg)
    proba = np.asarray(jsvc.predict_proba(model, X))
    assert proba.shape == (120, 3)
    np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-5)
    # Calibrated argmax should mostly agree with the decision rule.
    agree = (proba.argmax(1) == np.asarray(jsvc.predict(model, X))).mean()
    assert agree > 0.9
    # And track sklearn's own calibrated probabilities loosely.
    ref = svm.SVC(
        kernel="rbf", C=10.0, gamma=0.05, probability=True, random_state=0
    ).fit(X, y)
    np.testing.assert_allclose(
        proba.mean(0), ref.predict_proba(X).mean(0), atol=0.05
    )


@pytest.mark.parametrize("kind", ["rbf", "linear"])
def test_kernel_matrix_matches_float64(rng, kind):
    """The XLA Gram (Precision.HIGHEST) vs a float64 numpy reference."""
    import jax.numpy as jnp

    X = rng.normal(size=(37, 50))
    S = rng.normal(size=(23, 50))
    got = np.asarray(jsvc.kernel_matrix(
        jnp.asarray(X, jnp.float32), jnp.asarray(S, jnp.float32), kind, 0.05
    ))
    G = X @ S.T
    if kind == "rbf":
        d2 = (X * X).sum(1)[:, None] + (S * S).sum(1)[None, :] - 2.0 * G
        G = np.exp(-0.05 * np.maximum(d2, 0.0))
    np.testing.assert_allclose(got, G, rtol=1e-5, atol=1e-5)
    assert got.shape == (37, 23)
