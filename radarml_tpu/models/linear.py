"""Linear classifier family: scoring, calibration, and SGD training.

JAX re-design of the reference's SGD/logistic path
(train.py:324-440, predict.py:56-70): scoring is one batched matmul on
the matrix units; probability calibration is Platt sigmoid scaling; training is
a jitted per-sample SGD scan with sklearn-compatible dynamics (optimal
learning-rate schedule, L1/L2/elasticnet penalties, optional averaging,
one-vs-all reduction) so hyperparameters transfer from the reference's
grids unchanged.

Scoring parity with pickled sklearn estimators is exact to float32
(tests/test_linear.py loads sklearn coefficients into this model and
compares); training parity is dynamics-level, not bit-level — sklearn's
per-epoch shuffling RNG is internal to its Cython loop, so we validate
by matching accuracy on held-out data instead.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class LinearModel(NamedTuple):
    """One-vs-all linear model: logits = X @ coef.T + intercept."""

    coef: jax.Array  # (n_classes_ova, n_features); (1, F) when binary
    intercept: jax.Array  # (n_classes_ova,)


class SigmoidCalibration(NamedTuple):
    """Per-column Platt scaling: p = 1 / (1 + exp(a * f + b))."""

    a: jax.Array  # (n_cols,)
    b: jax.Array  # (n_cols,)


def decision_function(model: LinearModel, X: jax.Array) -> jax.Array:
    """(N, F) → (N, C) margins. The serving hot path: a single matmul.

    Runs at HIGHEST precision so float32 matmuls (not TF32) keep
    scoring bit-comparable with the reference; the classes axis is
    tiny, so this costs nothing.
    """
    return (
        jnp.dot(
            X,
            model.coef.T,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        + model.intercept
    )


def predict(model: LinearModel, X: jax.Array) -> jax.Array:
    """Class indices. Binary models use the sklearn (df > 0) rule."""
    df = decision_function(model, X)
    if model.coef.shape[0] == 1:
        return (df[:, 0] > 0).astype(jnp.int32)
    return jnp.argmax(df, axis=1).astype(jnp.int32)


def proba_from_decision(df: jax.Array) -> jax.Array:
    """OvA margins → probabilities, SGDClassifier(loss='log') semantics.

    Multiclass: per-class sigmoid normalized to sum one (uniform when
    all sigmoids underflow). Binary (one column): plain sigmoid pair.
    """
    if df.shape[1] == 1:
        p1 = jax.nn.sigmoid(df[:, 0])
        return jnp.stack([1.0 - p1, p1], axis=1)
    prob = jax.nn.sigmoid(df)
    total = prob.sum(axis=1, keepdims=True)
    uniform = jnp.full_like(prob, 1.0 / prob.shape[1])
    return jnp.where(total > 0, prob / jnp.where(total > 0, total, 1.0), uniform)


def calibrated_from_decision(
    df: jax.Array, calib: SigmoidCalibration
) -> jax.Array:
    """OvR margins → calibrated probabilities (prefit-sigmoid
    CalibratedClassifierCV semantics)."""
    p = 1.0 / (1.0 + jnp.exp(calib.a * df + calib.b))
    if df.shape[1] == 1:
        return jnp.concatenate([1.0 - p, p], axis=1)
    total = p.sum(axis=1, keepdims=True)
    uniform = jnp.full_like(p, 1.0 / p.shape[1])
    return jnp.where(total > 0, p / jnp.where(total > 0, total, 1.0), uniform)


def predict_proba_log_loss(model: LinearModel, X: jax.Array) -> jax.Array:
    """Probabilities with sklearn SGDClassifier(loss='log') semantics
    (reference predict.py:60 relies on this contract)."""
    return proba_from_decision(decision_function(model, X))


def predict_proba_calibrated(
    model: LinearModel, calib: SigmoidCalibration, X: jax.Array
) -> jax.Array:
    """CalibratedClassifierCV(cv='prefit', sigmoid) semantics — the
    exact function the reference's saved model evaluates at predict
    time (train.py:722-724 + predict.py:60)."""
    return calibrated_from_decision(decision_function(model, X), calib)


def fit_sigmoid_calibration(
    df: np.ndarray, y: np.ndarray, max_iter: int = 100
) -> Tuple[float, float]:
    """Fit Platt scaling parameters (a, b) for one column.

    Implements Platt (1999) as refined by Lin/Weng/Keerthi (2007): a
    Newton iteration with backtracking on the regularized maximum
    likelihood objective, with Bayesian-prior targets. Host-side; runs
    once per class on a validation split.
    """
    df = np.asarray(df, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    prior0 = float(np.sum(y <= 0))
    prior1 = float(y.shape[0] - prior0)
    T = np.where(y > 0, (prior1 + 1.0) / (prior1 + 2.0), 1.0 / (prior0 + 2.0))

    a, b = 0.0, float(np.log((prior0 + 1.0) / (prior1 + 1.0)))

    def nll(a_, b_):
        # P(y=1|f) = sigmoid(-(a f + b)); cross-entropy against targets T
        # simplifies to sum log(1+e^z) - (1-T) z with z = a f + b.
        z = a_ * df + b_
        lse = np.logaddexp(0.0, z)
        return float(np.sum(T * lse + (1.0 - T) * (lse - z)))

    sigma = 1e-12
    fval = nll(a, b)
    for _ in range(max_iter):
        z = a * df + b
        # NLL = sum log(1+e^z) - (1-T) z  →  dNLL/dz = sigmoid(z) - (1-T)
        s = 1.0 / (1.0 + np.exp(-z))
        d1 = s - (1.0 - T)
        d2 = s * (1.0 - s)
        grad_a = float(np.dot(d1, df))
        grad_b = float(np.sum(d1))
        h_aa = float(np.dot(d2, df * df)) + sigma
        h_bb = float(np.sum(d2)) + sigma
        h_ab = float(np.dot(d2, df))
        det = h_aa * h_bb - h_ab * h_ab
        if det == 0:
            break
        da = -(h_bb * grad_a - h_ab * grad_b) / det
        db = -(h_aa * grad_b - h_ab * grad_a) / det
        gd = grad_a * da + grad_b * db
        step = 1.0
        while step >= 1e-10:
            na, nb = a + step * da, b + step * db
            nf = nll(na, nb)
            if nf < fval + 1e-4 * step * gd:
                a, b, fval = na, nb, nf
                break
            step /= 2.0
        else:
            break
        if abs(gd) < 1e-12:
            break
    return float(a), float(b)


def calibrate_ovr(
    model: LinearModel, X_val: np.ndarray, y_val: np.ndarray
) -> SigmoidCalibration:
    """Fit per-class sigmoid calibration on a validation split
    (the reference's CalibratedClassifierCV(cv='prefit') step)."""
    df = np.asarray(decision_function(model, jnp.asarray(X_val)))
    n_ova = model.coef.shape[0]
    a_list, b_list = [], []
    for k in range(n_ova):
        y_bin = (y_val == (1 if n_ova == 1 else k)).astype(np.float64)
        a, b = fit_sigmoid_calibration(df[:, k], y_bin)
        a_list.append(a)
        b_list.append(b)
    return SigmoidCalibration(
        a=jnp.asarray(a_list, dtype=jnp.float32),
        b=jnp.asarray(b_list, dtype=jnp.float32),
    )


# --------------------------------------------------------------------------
# sklearn interop
# --------------------------------------------------------------------------

def from_sklearn_linear(clf) -> LinearModel:
    """Load a fitted sklearn linear estimator (SGDClassifier /
    LogisticRegression / LinearSVC) into a LinearModel."""
    return LinearModel(
        coef=jnp.asarray(np.asarray(clf.coef_), dtype=jnp.float32),
        intercept=jnp.asarray(
            np.ravel(np.asarray(clf.intercept_)), dtype=jnp.float32
        ),
    )


def from_sklearn_calibrated(cal_clf) -> Tuple[LinearModel, SigmoidCalibration]:
    """Load sklearn CalibratedClassifierCV(prefit sigmoid) wrapping a
    linear estimator — the exact artifact the reference pickles
    (train.py:729-731)."""
    cc = cal_clf.calibrated_classifiers_[0]
    base = getattr(cc, "estimator", None) or getattr(cc, "base_estimator", None)
    # Unwrap FrozenEstimator (the sklearn >= 1.6 spelling of prefit).
    while base is not None and not hasattr(base, "coef_"):
        base = getattr(base, "estimator", None)
    model = from_sklearn_linear(base)
    a = [float(c.a_) for c in cc.calibrators]
    b = [float(c.b_) for c in cc.calibrators]
    return model, SigmoidCalibration(
        a=jnp.asarray(a, dtype=jnp.float32), b=jnp.asarray(b, dtype=jnp.float32)
    )


# --------------------------------------------------------------------------
# SGD training (sklearn-compatible dynamics, jitted scan)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SGDConfig:
    """Hyperparameters mirroring sklearn.linear_model.SGDClassifier
    (the reference's grid axes, train.py:356-367)."""

    alpha: float = 1e-4
    penalty: str = "l2"  # l1 | l2 | elasticnet
    l1_ratio: float = 0.15
    max_iter: int = 1000
    average: bool = False
    tol: float = 1e-3
    fit_intercept: bool = True


class SGDState(NamedTuple):
    coef: jax.Array  # (C, F)
    intercept: jax.Array  # (C,)
    t: jax.Array  # scalar step counter
    q: jax.Array  # (C, F) cumulative-L1 credit
    u: jax.Array  # scalar cumulative-L1 budget
    avg_coef: jax.Array
    avg_intercept: jax.Array


def _init_t(alpha: float) -> float:
    """sklearn's 'optimal' schedule initialization (Bottou heuristic)."""
    typw = np.sqrt(1.0 / np.sqrt(alpha))
    # dloss of log loss at (-typw, +1) has magnitude < 1, so eta0 = typw.
    eta0 = typw / max(1.0, 1.0 / (1.0 + np.exp(typw)))
    return 1.0 / (eta0 * alpha)


def sgd_init(n_classes: int, n_features: int, cfg: SGDConfig) -> SGDState:
    n_ova = 1 if n_classes == 2 else n_classes
    z = jnp.zeros((n_ova, n_features), dtype=jnp.float32)
    return SGDState(
        coef=z,
        intercept=jnp.zeros((n_ova,), dtype=jnp.float32),
        t=jnp.asarray(_init_t(cfg.alpha), dtype=jnp.float32),
        q=z,
        u=jnp.asarray(0.0, dtype=jnp.float32),
        avg_coef=z,
        avg_intercept=jnp.zeros((n_ova,), dtype=jnp.float32),
    )


@functools.lru_cache(maxsize=64)
def _make_epoch_fn(penalty: str, average: bool, n_classes: int):
    """Build a jitted one-epoch (full pass, per-sample updates) function.

    One-vs-all: every binary problem consumes the same sample stream in
    the same order, vectorized across the class axis — the accelerator-friendly
    layout for what sklearn runs as C sequential binary fits.

    alpha/l1_ratio/t0 are *traced* scalars, so one compiled program
    serves every hyperparameter combination of a grid search that
    shares (penalty, average, n_classes, data shape) — the grid's 35
    candidates compile ~4 programs instead of 35 (and the lru_cache
    keeps the returned jitted fn stable across calls).
    """
    make_update = _make_sample_update(penalty, average, n_classes)

    @jax.jit
    def epoch(state: SGDState, X, y, alpha, l1_ratio, t0) -> SGDState:
        state, _ = jax.lax.scan(
            make_update(alpha, l1_ratio, t0), state, (X, y)
        )
        return state

    return epoch


@functools.lru_cache(maxsize=64)
def _make_sample_update(penalty: str, average: bool, n_classes: int):
    """Shared one-sample sklearn-dynamics update builder."""
    use_l1 = penalty in ("l1", "elasticnet")
    n_ova = 1 if n_classes == 2 else n_classes

    def make_update(alpha, l1_ratio, t0):
        l2_scale = 1.0 - l1_ratio

        def sample_update(state: SGDState, xy):
            x, y = xy  # x: (F,), y: scalar int
            if n_ova == 1:
                y_ova = jnp.where(y == 1, 1.0, -1.0)[None]
            else:
                y_ova = jnp.where(jnp.arange(n_ova) == y, 1.0, -1.0)
            eta = 1.0 / (alpha * state.t)

            margin = (
                jnp.dot(state.coef, x, precision=jax.lax.Precision.HIGHEST)
                + state.intercept
            ) * y_ova  # (C,)
            # log-loss gradient wrt margin: -y / (1 + exp(margin))
            g = -y_ova / (1.0 + jnp.exp(jnp.clip(margin, -30.0, 30.0)))

            coef = state.coef
            # L2 shrink (applied before the gradient step, as sklearn
            # does via wscale).
            coef = coef * (1.0 - eta * alpha * l2_scale)
            coef = coef - eta * g[:, None] * x[None, :]
            intercept = state.intercept - eta * g

            q, u = state.q, state.u
            if use_l1:
                # Tsuruoka et al. cumulative L1 penalty.
                u = u + eta * alpha * l1_ratio
                z = coef
                coef = jnp.where(
                    z > 0,
                    jnp.maximum(0.0, z - (u + q)),
                    jnp.where(z < 0, jnp.minimum(0.0, z + (u - q)), z),
                )
                q = q + (coef - z)

            if average:
                # Uniform average over all steps seen so far.
                n_seen = state.t - t0 + 1.0
                w = 1.0 / n_seen
                avg_coef = state.avg_coef + w * (coef - state.avg_coef)
                avg_intercept = state.avg_intercept + w * (
                    intercept - state.avg_intercept
                )
            else:
                avg_coef, avg_intercept = state.avg_coef, state.avg_intercept

            return (
                SGDState(
                    coef, intercept, state.t + 1.0, q, u,
                    avg_coef, avg_intercept,
                ),
                None,
            )

        return sample_update

    return make_update


def sgd_fit(
    X: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    cfg: SGDConfig = SGDConfig(),
    epochs: Optional[int] = None,
    seed: int = 1234,
    state: Optional[SGDState] = None,
    shuffle: bool = True,
) -> SGDState:
    """Fit (or continue fitting) the OvA SGD classifier.

    With `state` given this is the online-learning / partial_fit path
    (reference train.py:409-416); otherwise a fresh fit. `epochs`
    defaults to the UNCAPPED sklearn heuristic max(1e6/n, 1000) —
    exactly the reference's online-learning iteration count
    (train.py:414). All epochs fuse into a handful of device
    dispatches (a `lax.scan` over a host-precomputed permutation
    table, chunked only to bound the table's memory), so the full
    heuristic is a wall-clock matter of seconds at reference scale
    rather than thousands of per-epoch dispatches.
    """
    X = jnp.asarray(X, dtype=jnp.float32)
    y = jnp.asarray(y, dtype=jnp.int32)
    n = X.shape[0]
    if epochs is None:
        epochs = int(max(np.ceil(10**6 / n), 1000))
    if state is None:
        state = sgd_init(n_classes, X.shape[1], cfg)
    l1_ratio = (
        cfg.l1_ratio if cfg.penalty == "elasticnet"
        else (1.0 if cfg.penalty == "l1" else 0.0)
    )
    fused = _make_many_epochs_fn(cfg.penalty, cfg.average, n_classes)
    state1 = jax.tree.map(lambda a: jnp.asarray(a)[None], state)
    a1 = jnp.asarray([cfg.alpha], jnp.float32)
    l1r1 = jnp.asarray([l1_ratio], jnp.float32)
    t01 = jnp.asarray([_init_t(cfg.alpha)], jnp.float32)
    rng = np.random.default_rng(seed)
    # Chunk the permutation table to ≤ ~64M indices so huge datasets
    # with the 1000-epoch heuristic never build a multi-GB table.
    max_rows = max(1, int(64_000_000 // max(n, 1)))
    done = 0
    while done < epochs:
        k = min(epochs - done, max_rows)
        if shuffle:
            perms = np.stack([rng.permutation(n) for _ in range(k)])
        else:
            perms = np.broadcast_to(np.arange(n), (k, n))
        state1 = fused(
            state1, X, y, jnp.asarray(perms, jnp.int32), a1, l1r1, t01
        )
        done += k
    return jax.tree.map(lambda a: a[0], state1)


def sgd_model(state: SGDState, cfg: SGDConfig) -> LinearModel:
    if cfg.average:
        return LinearModel(coef=state.avg_coef, intercept=state.avg_intercept)
    return LinearModel(coef=state.coef, intercept=state.intercept)


def sgd_fit_many(
    X: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    penalty: str,
    average: bool,
    alphas: Sequence[float],
    l1_ratios: Sequence[float],
    epochs: Optional[int] = None,
    seed: int = 1234,
    tol: Optional[float] = None,
    n_iter_no_change: int = 5,
) -> SGDState:
    """Train MANY hyperparameter candidates simultaneously via vmap.

    All candidates sharing (penalty, average) train in one device
    program with a leading candidate axis on the state: where sklearn's
    GridSearchCV runs n_candidates × n_folds sequential fits, the matrix units
    sweeps the whole candidate batch per sample step. Identical
    math/per-candidate results to sequential `sgd_fit` (same seed →
    same shuffles).

    With `tol`, each candidate early-stops sklearn-style: when its mean
    epoch training loss fails to improve on its best by more than tol
    for `n_iter_no_change` consecutive epochs, its state freezes while
    the rest continue (a `lax.while_loop` on device — still a single
    dispatch). One documented divergence from sklearn: the stop
    criterion aggregates the OvA classes' losses per candidate, where
    sklearn stops each binary problem independently; late-converging
    classes keep the whole candidate training slightly longer.

    Returns a batched SGDState whose leading axis indexes candidates
    (aligned with `alphas`/`l1_ratios`).
    """
    X = jnp.asarray(X, dtype=jnp.float32)
    y = jnp.asarray(y, dtype=jnp.int32)
    n = X.shape[0]
    if epochs is None:
        epochs = int(min(max(np.ceil(10**6 / n), 5), 300))
    alphas = np.asarray(alphas, np.float32)
    l1rs = np.asarray(l1_ratios, np.float32)
    t0s = np.asarray([_init_t(float(a)) for a in alphas], np.float32)
    n_cand = len(alphas)

    base = sgd_init(n_classes, X.shape[1], SGDConfig(penalty=penalty))
    state = SGDState(
        coef=jnp.zeros((n_cand,) + base.coef.shape, jnp.float32),
        intercept=jnp.zeros((n_cand,) + base.intercept.shape, jnp.float32),
        t=jnp.asarray(t0s),
        q=jnp.zeros((n_cand,) + base.q.shape, jnp.float32),
        u=jnp.zeros((n_cand,), jnp.float32),
        avg_coef=jnp.zeros((n_cand,) + base.coef.shape, jnp.float32),
        avg_intercept=jnp.zeros(
            (n_cand,) + base.intercept.shape, jnp.float32
        ),
    )
    # All epochs fuse into ONE device program: permutations precompute
    # host-side into an (epochs, n) table and the epoch loop runs on
    # device (one dispatch per fit-many call — essential when each
    # dispatch pays link latency, and faster everywhere).
    rng = np.random.default_rng(seed)
    perms = jnp.asarray(
        np.stack([rng.permutation(n) for _ in range(epochs)]), jnp.int32
    )
    args = (
        state, X, y, perms,
        jnp.asarray(alphas), jnp.asarray(l1rs), jnp.asarray(t0s),
    )
    if tol is None:
        fused = _make_many_epochs_fn(penalty, average, n_classes)
        return fused(*args)
    fused = _make_many_epochs_earlystop_fn(
        penalty, average, n_classes, float(tol), int(n_iter_no_change)
    )
    return fused(*args)


def sgd_fit_many_folds(
    Xs: jax.Array,
    ys: jax.Array,
    n_classes: int,
    penalty: str,
    average: bool,
    alphas: Sequence[float],
    l1_ratios: Sequence[float],
    epochs: Optional[int] = None,
    seed: int = 1234,
    tol: Optional[float] = None,
    n_iter_no_change: int = 5,
    mesh=None,
) -> SGDState:
    """sgd_fit_many over a leading FOLD axis: the whole cross-validation
    of one penalty group — every fold × every candidate — is a single
    device dispatch. Valid under vmap because the early-stop body is a
    no-op for lanes whose candidates have stopped.

    Args:
        Xs: (folds, n, F) stacked fold training sets (equal-size).
        ys: (folds, n) labels.
        mesh: optional jax Mesh — folds shard over its 'data' axis
            (fold fits are independent, so the sharded run is
            bit-identical to the single-device one and the grid scales
            with chips).

    Returns a batched SGDState with leading axes (folds, candidates).
    """
    Xs = jnp.asarray(Xs, jnp.float32)
    ys = jnp.asarray(ys, jnp.int32)
    n_folds_out = ys.shape[0]
    if mesh is not None:
        from radarml_tpu.parallel.mesh import shard_batch

        # Shardings must divide evenly: repeat the last fold up to a
        # device-count multiple (its extra copies are discarded below).
        ndev = int(mesh.devices.size)
        padf = (-Xs.shape[0]) % ndev
        if padf:
            Xs = jnp.concatenate([Xs, jnp.repeat(Xs[-1:], padf, 0)])
            ys = jnp.concatenate([ys, jnp.repeat(ys[-1:], padf, 0)])
        Xs, ys = shard_batch(mesh, Xs, ys)
    folds, n = ys.shape
    if epochs is None:
        epochs = int(min(max(np.ceil(10**6 / n), 5), 300))
    alphas_np = np.asarray(alphas, np.float32)
    l1rs = np.asarray(l1_ratios, np.float32)
    t0s = np.asarray([_init_t(float(a)) for a in alphas_np], np.float32)
    k = len(alphas_np)

    base = sgd_init(n_classes, Xs.shape[2], SGDConfig(penalty=penalty))
    lead = (folds, k)
    state = SGDState(
        coef=jnp.zeros(lead + base.coef.shape, jnp.float32),
        intercept=jnp.zeros(lead + base.intercept.shape, jnp.float32),
        t=jnp.broadcast_to(jnp.asarray(t0s), lead),
        q=jnp.zeros(lead + base.q.shape, jnp.float32),
        u=jnp.zeros(lead, jnp.float32),
        avg_coef=jnp.zeros(lead + base.coef.shape, jnp.float32),
        avg_intercept=jnp.zeros(lead + base.intercept.shape, jnp.float32),
    )
    rng = np.random.default_rng(seed)
    perms = jnp.asarray(
        np.stack([rng.permutation(n) for _ in range(epochs)]), jnp.int32
    )
    if tol is None:
        inner = _make_many_epochs_fn(penalty, average, n_classes)
    else:
        inner = _make_many_epochs_earlystop_fn(
            penalty, average, n_classes, float(tol), int(n_iter_no_change)
        )
    outer = jax.jit(
        jax.vmap(inner, in_axes=(0, 0, 0, None, None, None, None))
    )
    out = outer(
        state, Xs, ys, perms,
        jnp.asarray(alphas_np), jnp.asarray(l1rs), jnp.asarray(t0s),
    )
    if folds != n_folds_out:
        out = jax.tree.map(lambda a: a[:n_folds_out], out)
    return out


@functools.lru_cache(maxsize=64)
def _make_many_epochs_fn(penalty: str, average: bool, n_classes: int):
    epoch_fn = _make_epoch_fn(penalty, average, n_classes)

    @jax.jit
    def fused(state, X, y, perms, alphas, l1rs, t0s):
        many_epoch = jax.vmap(epoch_fn, in_axes=(0, None, None, 0, 0, 0))

        def body(st, perm):
            return many_epoch(st, X[perm], y[perm], alphas, l1rs, t0s), None

        state, _ = jax.lax.scan(body, state, perms)
        return state

    return fused


@functools.lru_cache(maxsize=64)
def _make_epoch_loss_fn(penalty: str, average: bool, n_classes: int):
    """Like _make_epoch_fn but also returns the epoch's summed log-loss
    (computed pre-update per sample, as sklearn's sumloss is)."""
    make_update = _make_sample_update(penalty, average, n_classes)
    n_ova = 1 if n_classes == 2 else n_classes

    def epoch_with_loss(state, X, y, alpha, l1_ratio, t0):
        # sklearn accumulates each sample's loss at the weights BEFORE
        # that sample's update (sumloss in _plain_sgd); fold the same
        # accumulation into the update scan.
        update = make_update(alpha, l1_ratio, t0)

        def step(carry, xy):
            st, sumloss = carry
            x, yv = xy
            if n_ova == 1:
                y_ova = jnp.where(yv == 1, 1.0, -1.0)[None]
            else:
                y_ova = jnp.where(jnp.arange(n_ova) == yv, 1.0, -1.0)
            margin = (
                jnp.dot(st.coef, x, precision=jax.lax.Precision.HIGHEST)
                + st.intercept
            ) * y_ova
            sumloss = sumloss + jnp.sum(jax.nn.softplus(-margin))
            st, _ = update(st, xy)
            return (st, sumloss), None

        (state, sumloss), _ = jax.lax.scan(
            step, (state, jnp.float32(0.0)), (X, y)
        )
        return state, sumloss

    return epoch_with_loss


@functools.lru_cache(maxsize=64)
def _make_many_epochs_earlystop_fn(
    penalty: str, average: bool, n_classes: int, tol: float,
    n_iter_no_change: int,
):
    epoch_loss_fn = _make_epoch_loss_fn(penalty, average, n_classes)

    @jax.jit
    def fused(state, X, y, perms, alphas, l1rs, t0s):
        many = jax.vmap(epoch_loss_fn, in_axes=(0, None, None, 0, 0, 0))
        n_epochs = perms.shape[0]
        n = X.shape[0]
        k = alphas.shape[0]

        def mask_tree(active, new, old):
            def m(a, b):
                shape = (k,) + (1,) * (a.ndim - 1)
                return jnp.where(active.reshape(shape), a, b)

            return jax.tree.map(m, new, old)

        def cond(carry):
            _, e, _, _, active = carry
            return (e < n_epochs) & jnp.any(active)

        def body(carry):
            st, e, best, stale, active = carry
            perm = perms[e]
            new_st, sumloss = many(st, X[perm], y[perm], alphas, l1rs, t0s)
            loss = sumloss / n
            st = mask_tree(active, new_st, st)
            # sklearn stopping: no improvement beyond tol for
            # n_iter_no_change consecutive epochs.
            no_improve = loss > best - tol
            stale = jnp.where(
                active & no_improve, stale + 1, jnp.where(active, 0, stale)
            )
            best = jnp.where(active, jnp.minimum(best, loss), best)
            active = active & (stale < n_iter_no_change)
            return st, e + 1, best, stale, active

        best0 = jnp.full((k,), jnp.inf, jnp.float32)
        stale0 = jnp.zeros((k,), jnp.int32)
        active0 = jnp.ones((k,), bool)
        state, *_ = jax.lax.while_loop(
            cond, body, (state, jnp.int32(0), best0, stale0, active0)
        )
        return state

    return fused
