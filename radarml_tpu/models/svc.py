"""Kernel SVM (SVC) family: matmul scoring + a jitted SMO dual solver.

JAX re-design of the reference's `svm.SVC(probability=True,
class_weight='balanced')` path (reference train.py:442-545,
predict.py:56-70). Nothing here wraps libsvm; the pieces are:

* **Scoring** — the RBF/linear kernel between queries and support
  vectors is one batched matmul (‖x−s‖² = ‖x‖² + ‖s‖² − 2x·s), and the
  one-vs-one pair decisions collapse into a second matmul against a
  host-precomputed (n_pairs, n_sv) coefficient matrix. `predict` is
  libsvm-style pairwise voting; `predict_proba` is per-pair Platt
  sigmoids coupled with the Wu–Lin–Weng (2004) second method.
* **Training** — a maximal-violating-pair SMO solver for the dual QP
  written as a `lax.while_loop`: O(n) vectorized gradient updates per
  iteration, vmapped across all one-vs-one pairs at once (shorter
  pairs are padded with zero-capacity box constraints, which the KKT
  conditions ignore). Class-balanced per-sample C as in
  `class_weight='balanced'`.
* **Interop** — `from_sklearn_svc` maps a fitted sklearn `SVC` into
  `SVCModel` for bit-parity serving of reference-trained pickles.

The solver reaches the same unique optimum as libsvm on the same QP
(convex; verified against sklearn in tests/test_svc.py); Platt
calibration uses a deterministic stratified 5-fold instead of libsvm's
unseeded internal CV, which is irreproducible by construction.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "SVCConfig",
    "SVCModel",
    "svc_fit",
    "from_sklearn_svc",
    "decision_function_ovo",
    "predict",
    "predict_proba",
]


# --------------------------------------------------------------------------
# Kernels
# --------------------------------------------------------------------------

def kernel_matrix(
    X: jax.Array, Y: jax.Array, kind: str, gamma: float
) -> jax.Array:
    """K(X, Y): (n, m) Gram matrix, true float32 (Precision.HIGHEST).

    XLA fuses the distance expansion and the `exp` into elementwise
    epilogues around the GEMM.
    """
    p = jax.lax.Precision.HIGHEST
    G = jnp.einsum("nf,mf->nm", X, Y, precision=p)
    if kind == "linear":
        return G
    if kind == "rbf":
        xx = jnp.einsum("nf,nf->n", X, X, precision=p)
        yy = jnp.einsum("mf,mf->m", Y, Y, precision=p)
        d2 = xx[:, None] + yy[None, :] - 2.0 * G
        return jnp.exp(-gamma * jnp.maximum(d2, 0.0))
    raise ValueError(f"unknown kernel {kind!r}")


# --------------------------------------------------------------------------
# Model container + scoring
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SVCModel:
    """Fitted OvO kernel SVM in the sklearn/libsvm layout.

    support_vectors: (n_sv, F); dual_coef: (k-1, n_sv) interleaved OvO
    coefficients; intercept: (n_pairs,); n_support: (k,) SV counts per
    class in class order; probA/probB: (n_pairs,) Platt parameters or
    None when fitted without probability.
    """

    support_vectors: jax.Array
    dual_coef: jax.Array
    intercept: jax.Array
    n_support: Tuple[int, ...]
    kernel: str = "rbf"
    gamma: float = 0.01
    probA: Optional[jax.Array] = None
    probB: Optional[jax.Array] = None

    @property
    def n_classes(self) -> int:
        return len(self.n_support)

    @property
    def pairs(self) -> Tuple[Tuple[int, int], ...]:
        k = self.n_classes
        return tuple((i, j) for i in range(k) for j in range(i + 1, k))

    @functools.cached_property
    def pair_coef(self) -> np.ndarray:
        """(n_pairs, n_sv) dense pairwise coefficient matrix.

        libsvm layout: SVs are grouped by class; for the pair (i, j)
        the decision uses dual_coef[j-1] over class-i SVs and
        dual_coef[i] over class-j SVs.
        """
        dual = np.asarray(self.dual_coef)
        n_sv = dual.shape[1]
        starts = np.concatenate([[0], np.cumsum(self.n_support)])
        W = np.zeros((len(self.pairs), n_sv), dtype=np.float32)
        for p, (i, j) in enumerate(self.pairs):
            si, ei = starts[i], starts[i + 1]
            sj, ej = starts[j], starts[j + 1]
            W[p, si:ei] = dual[j - 1, si:ei]
            W[p, sj:ej] = dual[i, sj:ej]
        return W


@functools.partial(jax.jit, static_argnames=("kernel",))
def _ovo_decision(X, sv, W, b, kernel, gamma):
    K = kernel_matrix(X, sv, kernel, gamma)  # (n, n_sv)
    p = jax.lax.Precision.HIGHEST
    return jnp.einsum("ns,ps->np", K, W, precision=p) + b[None, :]


def decision_function_ovo(model: SVCModel, X: jax.Array) -> jax.Array:
    """(n, n_pairs) pairwise decisions; positive favors the first class
    of the pair (sklearn `decision_function_shape='ovo'`)."""
    return _ovo_decision(
        jnp.asarray(X, jnp.float32),
        model.support_vectors,
        jnp.asarray(model.pair_coef),
        model.intercept,
        model.kernel,
        model.gamma,
    )


def predict(model: SVCModel, X: jax.Array) -> jax.Array:
    """libsvm pairwise voting; ties go to the lower class index."""
    dec = decision_function_ovo(model, X)
    k = model.n_classes
    votes = jnp.zeros((dec.shape[0], k), dtype=jnp.int32)
    for p, (i, j) in enumerate(model.pairs):
        win_i = dec[:, p] > 0
        votes = votes.at[:, i].add(win_i.astype(jnp.int32))
        votes = votes.at[:, j].add((~win_i).astype(jnp.int32))
    return jnp.argmax(votes, axis=1).astype(jnp.int32)


def _pairwise_prob_matrix(model: SVCModel, dec: jax.Array) -> jax.Array:
    """(n, k, k) matrix r with r[i,j] = P(class i | {i,j}) via Platt."""
    if model.probA is None:
        raise ValueError("model fitted without probability estimates")
    fApB = dec * model.probA[None, :] + model.probB[None, :]
    # Numerically-stable sigmoid: P(first class) = 1 / (1 + exp(fApB)).
    pij = jnp.where(
        fApB >= 0,
        jnp.exp(-fApB) / (1.0 + jnp.exp(-fApB)),
        1.0 / (1.0 + jnp.exp(fApB)),
    )
    eps = 1e-7
    pij = jnp.clip(pij, eps, 1.0 - eps)
    k = model.n_classes
    n = dec.shape[0]
    r = jnp.zeros((n, k, k), dtype=dec.dtype)
    for p, (i, j) in enumerate(model.pairs):
        r = r.at[:, i, j].set(pij[:, p])
        r = r.at[:, j, i].set(1.0 - pij[:, p])
    return r


def _couple_probabilities(r: jax.Array, max_iter: int = 100) -> jax.Array:
    """Wu–Lin–Weng (2004) second-method pairwise coupling.

    Solves min_p Σ_{i<j} (r_ji p_i − r_ij p_j)² over the simplex with
    the fixed-point iteration libsvm uses (Gauss–Seidel over classes).
    r: (n, k, k) → (n, k).
    """
    n, k, _ = r.shape
    Q = jnp.zeros((n, k, k), dtype=r.dtype)
    for t in range(k):
        # Q[t,t] = sum_{j != t} r[j,t]^2 ; Q[t,j] = -r[j,t] * r[t,j]
        diag = jnp.sum(jnp.where(
            jnp.arange(k)[None, :] == t, 0.0, r[:, :, t] ** 2
        ), axis=1)
        Q = Q.at[:, t, t].set(diag)
        for j in range(k):
            if j != t:
                Q = Q.at[:, t, j].set(-r[:, j, t] * r[:, t, j])

    p0 = jnp.full((n, k), 1.0 / k, dtype=r.dtype)

    def body(_, p):
        Qp = jnp.einsum("nkj,nj->nk", Q, p)
        pQp = jnp.einsum("nk,nk->n", p, Qp)
        # libsvm stops a sample once max_t |Qp_t − pᵀQp| < 0.005/k;
        # freezing converged samples reproduces that early exit.
        err = jnp.max(jnp.abs(Qp - pQp[:, None]), axis=1)
        active = err >= 0.005 / k

        def class_step(t, carry):
            p, Qp, pQp = carry
            diff = (-Qp[:, t] + pQp) / jnp.maximum(Q[:, t, t], 1e-12)
            diff = jnp.where(active, diff, 0.0)
            p_new = p.at[:, t].add(diff)
            scale = 1.0 / (1.0 + diff)
            pQp = (pQp + diff * (diff * Q[:, t, t] + 2.0 * Qp[:, t])) * scale**2
            Qp = (Qp + diff[:, None] * Q[:, t, :]) * scale[:, None]
            p_new = p_new * scale[:, None]
            return p_new, Qp, pQp

        p, Qp, pQp = jax.lax.fori_loop(
            0, k, lambda t, c: class_step(t, c), (p, Qp, pQp)
        )
        return p

    p = jax.lax.fori_loop(0, max_iter, body, p0)
    return p / jnp.sum(p, axis=1, keepdims=True)


def predict_proba(model: SVCModel, X: jax.Array) -> jax.Array:
    """(n, k) class probabilities (sklearn SVC.predict_proba math)."""
    dec = decision_function_ovo(model, X)
    r = _pairwise_prob_matrix(model, dec)
    return _couple_probabilities(r)


def from_sklearn_svc(clf) -> SVCModel:
    """Map a fitted sklearn.svm.SVC into SVCModel (serving parity for
    reference-trained pickles, reference predict.py:224-227)."""
    gamma = clf._gamma if hasattr(clf, "_gamma") else clf.gamma
    probA = getattr(clf, "probA_", None)
    probB = getattr(clf, "probB_", None)
    dual = np.asarray(clf.dual_coef_, np.float32)
    intercept = np.asarray(clf.intercept_, np.float32)
    if len(clf.n_support_) == 2:
        # sklearn stores the binary problem with the decision negated
        # (positive → classes_[1]); normalize to the internal OvO
        # convention (positive → first class of the pair) so scoring,
        # voting and Platt orientation are uniform across k.
        dual = -dual
        intercept = -intercept
    return SVCModel(
        support_vectors=jnp.asarray(clf.support_vectors_, jnp.float32),
        dual_coef=jnp.asarray(dual),
        intercept=jnp.asarray(intercept),
        n_support=tuple(int(v) for v in clf.n_support_),
        kernel=clf.kernel,
        gamma=float(gamma),
        probA=None if probA is None or len(probA) == 0 else jnp.asarray(probA, jnp.float32),
        probB=None if probB is None or len(probB) == 0 else jnp.asarray(probB, jnp.float32),
    )


# --------------------------------------------------------------------------
# SMO dual solver (maximal violating pair, vmapped over OvO pairs)
# --------------------------------------------------------------------------

class _SMOResult(NamedTuple):
    alpha: jax.Array  # (m,) box-constrained duals
    rho: jax.Array  # scalar; intercept = -rho
    n_iter: jax.Array


def _smo_kernel_solve(
    Q: jax.Array,  # (m, m) y_i y_j K_ij with zero-C padding rows/cols
    y: jax.Array,  # (m,) ±1 (padding arbitrary)
    C: jax.Array,  # (m,) per-sample box caps (0 for padding)
    eps: float,
    max_iter: int,
) -> _SMOResult:
    """Solve min ½αᵀQα − eᵀα, 0≤α≤C, yᵀα=0 by maximal-violating-pair SMO.

    Each iteration is O(m) vector work (two gradient rank-1 updates and
    two masked argmax reductions) — the libsvm inner loop re-shaped for
    the VPU. Padded entries have C=0, so they never enter the working
    set.
    """
    m = Q.shape[0]
    NEG = jnp.asarray(-1e30, Q.dtype)
    POS = jnp.asarray(1e30, Q.dtype)

    def cond(state):
        alpha, grad, it, gap = state
        return (it < max_iter) & (gap > eps)

    def body(state):
        alpha, grad, it, _ = state
        ygrad = -y * grad
        in_up = ((y > 0) & (alpha < C)) | ((y < 0) & (alpha > 0))
        in_low = ((y > 0) & (alpha > 0)) | ((y < 0) & (alpha < C))
        up_vals = jnp.where(in_up, ygrad, NEG)
        low_vals = jnp.where(in_low, ygrad, POS)
        i = jnp.argmax(up_vals)
        j = jnp.argmin(low_vals)
        gap = up_vals[i] - low_vals[j]

        yi, yj = y[i], y[j]
        Qii, Qjj, Qij = Q[i, i], Q[j, j], Q[i, j]
        ai, aj = alpha[i], alpha[j]
        Ci, Cj = C[i], C[j]

        same = yi == yj
        quad = jnp.where(same, Qii + Qjj - 2.0 * Qij, Qii + Qjj + 2.0 * Qij)
        quad = jnp.maximum(quad, 1e-12)
        # same-sign: alpha_i - delta, alpha_j + delta keeps the sum.
        delta_same = (grad[i] - grad[j]) / quad
        # diff-sign: alpha_i + delta, alpha_j + delta keeps the difference.
        delta_diff = (-grad[i] - grad[j]) / quad

        ai_new = jnp.where(same, ai - delta_same, ai + delta_diff)
        aj_new = jnp.where(same, aj + delta_same, aj + delta_diff)

        # Project back onto the box along the constraint line.
        s = ai + aj
        d = ai - aj

        def clip_same(ai_n):
            ai_c = jnp.clip(ai_n, jnp.maximum(0.0, s - Cj), jnp.minimum(Ci, s))
            return ai_c, s - ai_c

        def clip_diff(ai_n):
            ai_c = jnp.clip(ai_n, jnp.maximum(0.0, d), jnp.minimum(Ci, Cj + d))
            return ai_c, ai_c - d

        ai_s, aj_s = clip_same(ai_new)
        ai_d, aj_d = clip_diff(ai_new)
        ai_new = jnp.where(same, ai_s, ai_d)
        aj_new = jnp.where(same, aj_s, aj_d)

        grad = grad + Q[i, :] * (ai_new - ai) + Q[j, :] * (aj_new - aj)
        alpha = alpha.at[i].set(ai_new).at[j].set(aj_new)
        return alpha, grad, it + 1, gap

    alpha0 = jnp.zeros((m,), Q.dtype)
    grad0 = jnp.full((m,), -1.0, Q.dtype)
    alpha, grad, n_iter, _ = jax.lax.while_loop(
        cond, body, (alpha0, grad0, jnp.asarray(0), jnp.asarray(jnp.inf, Q.dtype))
    )

    # rho: average -y*grad over free SVs; else midpoint of the bounds.
    ygrad = -y * grad
    free = (alpha > 1e-12) & (alpha < C - 1e-12) & (C > 0)
    n_free = jnp.sum(free)
    in_up = ((y > 0) & (alpha < C)) | ((y < 0) & (alpha > 0))
    in_low = ((y > 0) & (alpha > 0)) | ((y < 0) & (alpha < C))
    ub = jnp.min(jnp.where(in_low, ygrad, POS))
    lb = jnp.max(jnp.where(in_up, ygrad, NEG))
    rho_free = jnp.sum(jnp.where(free, ygrad, 0.0)) / jnp.maximum(n_free, 1)
    rho = jnp.where(n_free > 0, rho_free, (ub + lb) / 2.0)
    return _SMOResult(alpha=alpha, rho=-rho, n_iter=n_iter)


# --------------------------------------------------------------------------
# Platt sigmoid fit (Lin–Weng–Keerthi Newton iteration)
# --------------------------------------------------------------------------

def platt_fit(dec: np.ndarray, y_pos: np.ndarray) -> Tuple[float, float]:
    """Fit P(y=1|dec) = 1/(1+exp(A*dec+B)) by regularized ML.

    Implements the Newton method with backtracking from Lin, Lin & Weng
    (2007), the algorithm libsvm's sigmoid_train uses, with the Platt
    prior-corrected targets.
    """
    dec = np.asarray(dec, np.float64)
    y_pos = np.asarray(y_pos, bool)
    prior1, prior0 = float(y_pos.sum()), float((~y_pos).sum())
    hi = (prior1 + 1.0) / (prior1 + 2.0)
    lo = 1.0 / (prior0 + 2.0)
    t = np.where(y_pos, hi, lo)

    A, B = 0.0, np.log((prior0 + 1.0) / (prior1 + 1.0))
    sigma = 1e-12

    def fval(A, B):
        fApB = dec * A + B
        return np.sum(
            np.where(
                fApB >= 0,
                t * fApB + np.log1p(np.exp(-fApB)),
                (t - 1.0) * fApB + np.log1p(np.exp(fApB)),
            )
        )

    f = fval(A, B)
    for _ in range(100):
        fApB = dec * A + B
        p = np.where(fApB >= 0, np.exp(-fApB) / (1 + np.exp(-fApB)),
                     1.0 / (1 + np.exp(fApB)))
        q = 1.0 - p
        d1 = t - p
        d2 = p * q
        g1 = float(np.sum(dec * d1))
        g2 = float(np.sum(d1))
        if abs(g1) < 1e-5 and abs(g2) < 1e-5:
            break
        h11 = float(np.sum(dec * dec * d2)) + sigma
        h22 = float(np.sum(d2)) + sigma
        h21 = float(np.sum(dec * d2))
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= 1e-10:
            newA, newB = A + step * dA, B + step * dB
            newf = fval(newA, newB)
            if newf < f + 1e-4 * step * gd:
                A, B, f = newA, newB, newf
                break
            step /= 2.0
        else:
            break
    return float(A), float(B)


# --------------------------------------------------------------------------
# Training driver
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SVCConfig:
    """Reference grid axes (train.py:472-477) + solver knobs."""

    C: float = 10.0
    kernel: str = "rbf"  # rbf | linear
    gamma: float = 0.01  # or "scale"-style value resolved by caller
    class_weight: Optional[str] = "balanced"
    probability: bool = True
    eps: float = 1e-3
    max_iter: int = 200_000
    prob_folds: int = 5
    seed: int = 1234


def _resolve_gamma(gamma, X) -> float:
    """sklearn gamma rule; X may be a numpy or (device) jax array."""
    if isinstance(gamma, str):
        if gamma == "scale":
            return float(1.0 / (X.shape[1] * X.var()))
        if gamma == "auto":
            return 1.0 / X.shape[1]
        raise ValueError(gamma)
    return float(gamma)


def _binary_weights(
    y: np.ndarray, classes: np.ndarray, class_weight: Optional[str]
) -> dict:
    if class_weight is None:
        return {int(c): 1.0 for c in classes}
    n = len(y)
    k = len(classes)
    return {
        int(c): n / (k * float((y == c).sum())) for c in classes
    }


def _fit_pair_batch(
    K_full: np.ndarray,
    y: np.ndarray,
    pairs: Sequence[Tuple[int, int]],
    class_idx: Sequence[np.ndarray],
    Cw: dict,
    C: float,
    eps: float,
    max_iter: int,
):
    """Solve all OvO pair QPs in one vmapped SMO call (padded)."""
    sizes = [len(class_idx[i]) + len(class_idx[j]) for i, j in pairs]
    m = max(sizes)
    nP = len(pairs)
    Qb = np.zeros((nP, m, m), np.float32)
    yb = np.ones((nP, m), np.float32)
    Cb = np.zeros((nP, m), np.float32)
    idxb = np.zeros((nP, m), np.int64)
    for p, (i, j) in enumerate(pairs):
        idx = np.concatenate([class_idx[i], class_idx[j]])
        s = len(idx)
        ypm = np.concatenate(
            [np.ones(len(class_idx[i])), -np.ones(len(class_idx[j]))]
        ).astype(np.float32)
        Ksub = K_full[np.ix_(idx, idx)]
        Qb[p, :s, :s] = ypm[:, None] * ypm[None, :] * Ksub
        yb[p, :s] = ypm
        Cb[p, :s] = np.where(ypm > 0, C * Cw[i], C * Cw[j])
        idxb[p, :s] = idx
    solver = jax.vmap(
        functools.partial(_smo_kernel_solve, eps=eps, max_iter=max_iter)
    )
    res = solver(jnp.asarray(Qb), jnp.asarray(yb), jnp.asarray(Cb))
    return res, idxb, sizes, yb


def svc_fit(
    X: np.ndarray,
    y: np.ndarray,
    cfg: SVCConfig = SVCConfig(),
) -> SVCModel:
    """Fit an OvO kernel SVM with the jitted SMO solver.

    Matches sklearn's SVC semantics: classes sorted, per-class
    balanced C, libsvm SV layout, rho→intercept sign, optional Platt
    probability calibration on deterministic stratified folds.
    """
    # A device-resident X (e.g. from process_samples(device=True))
    # stays on device: only the (small) Gram and dual solutions cross
    # back to host, never the feature matrix.
    Xd = jnp.asarray(X, jnp.float32)
    y = np.asarray(y)
    classes = np.unique(y)
    k = len(classes)
    y_enc = np.searchsorted(classes, y)
    gamma = _resolve_gamma(cfg.gamma, Xd)
    Cw = _binary_weights(y_enc, np.arange(k), cfg.class_weight)

    K_full = np.asarray(kernel_matrix(Xd, Xd, cfg.kernel, gamma))
    class_idx = [np.where(y_enc == c)[0] for c in range(k)]
    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]

    res, idxb, sizes, yb = _fit_pair_batch(
        K_full, y_enc, pairs, class_idx, Cw, cfg.C, cfg.eps, cfg.max_iter
    )
    alphas = np.asarray(res.alpha)
    rhos = np.asarray(res.rho)

    # Collect SVs: union over pairs of samples with alpha > 0, grouped
    # by class in libsvm layout.
    sv_coef = {}  # sample index -> per-opponent coef rows
    alpha_by_pair = []
    for p, (i, j) in enumerate(pairs):
        s = sizes[p]
        idx = idxb[p, :s]
        a = alphas[p, :s] * yb[p, :s]
        alpha_by_pair.append(dict(zip(idx.tolist(), a.tolist())))

    is_sv = np.zeros(len(y), bool)
    for p, (i, j) in enumerate(pairs):
        for sample, a in alpha_by_pair[p].items():
            if abs(a) > 1e-10:
                is_sv[sample] = True
    sv_order = []
    n_support = []
    for c in range(k):
        members = [s for s in class_idx[c] if is_sv[s]]
        sv_order.extend(members)
        n_support.append(len(members))
    sv_pos = {s: i for i, s in enumerate(sv_order)}
    n_sv = len(sv_order)

    dual = np.zeros((k - 1, n_sv), np.float32)
    # dual_coef row r of a class-c SV holds its coefficient against the
    # r-th *other* class (libsvm interleaved layout).
    for p, (i, j) in enumerate(pairs):
        for sample, a in alpha_by_pair[p].items():
            if sample not in sv_pos:
                continue
            c = y_enc[sample]
            opp = j if c == i else i
            row = opp if opp < c else opp - 1
            dual[row, sv_pos[sample]] = a

    intercept = -rhos

    model = SVCModel(
        support_vectors=jnp.take(
            Xd, jnp.asarray(np.asarray(sv_order, np.int32)), axis=0
        ),
        dual_coef=jnp.asarray(dual),
        intercept=jnp.asarray(intercept, jnp.float32),
        n_support=tuple(n_support),
        kernel=cfg.kernel,
        gamma=gamma,
    )

    if not cfg.probability:
        return model

    probA, probB = _fit_probabilities(
        Xd, y_enc, classes, pairs, class_idx, Cw, cfg, gamma, K_full=K_full
    )
    return dataclasses.replace(
        model,
        probA=jnp.asarray(probA, jnp.float32),
        probB=jnp.asarray(probB, jnp.float32),
    )


def _fit_probabilities(
    X, y_enc, classes, pairs, class_idx, Cw, cfg, gamma, K_full=None
):
    """Per-pair Platt parameters from stratified-CV decision values.

    Device-resident: all (pair × prob-fold) binary sub-fits reuse the
    already-computed full Gram (no feature re-transfer, no per-fit
    kernel recompute) and solve as ONE vmapped SMO dispatch; held-out
    decisions come straight from α against resident Gram rows. Fold
    assignment reproduces the previous per-pair shuffled round-robin
    exactly, so the fitted (A, B) match the sequential implementation
    up to solver tolerance.
    """
    rng = np.random.default_rng(cfg.seed)
    folds = cfg.prob_folds
    n = len(y_enc)
    if K_full is None:
        K_full = np.asarray(
            kernel_matrix(jnp.asarray(X), jnp.asarray(X), cfg.kernel, gamma)
        )
    K = jnp.asarray(K_full, jnp.float32)

    # --- host: build the padded (pair, fold) problem batch -----------
    per_pair = []  # (idx, y_pos, fold_of)
    problems = []  # (pair_id, fold, tr_global, ypm, cvals, te_global)
    for pi, (i, j) in enumerate(pairs):
        idx = np.concatenate([class_idx[i], class_idx[j]])
        y_pos = np.concatenate(
            [np.ones(len(class_idx[i]), bool),
             np.zeros(len(class_idx[j]), bool)]
        )
        perm = rng.permutation(len(idx))
        fold_of = np.empty(len(idx), int)
        # Stratified round-robin assignment after a shuffle.
        for label in (True, False):
            members = perm[y_pos[perm] == label]
            fold_of[members] = np.arange(len(members)) % folds
        per_pair.append((idx, y_pos, fold_of))
        for f in range(folds):
            tr_m = fold_of != f
            te_m = fold_of == f
            if len(np.unique(y_pos[tr_m])) < 2 or not te_m.any():
                continue
            n_tr = int(tr_m.sum())
            cnt_i = int((y_pos & tr_m).sum())
            cnt_j = n_tr - cnt_i
            # class_weight='balanced' on the sub-fit's train set.
            if cfg.class_weight == "balanced":
                wi, wj = n_tr / (2.0 * cnt_i), n_tr / (2.0 * cnt_j)
            else:
                wi = wj = 1.0
            ypm = np.where(y_pos[tr_m], 1.0, -1.0).astype(np.float32)
            cvals = cfg.C * np.where(ypm > 0, wi, wj).astype(np.float32)
            problems.append(
                (pi, f, idx[tr_m], ypm, cvals, idx[te_m])
            )

    if not problems:
        return (
            np.zeros(len(pairs)) - 1.0,
            np.zeros(len(pairs)),
        )

    m = max(len(p[2]) for p in problems)
    NP = len(problems)
    idxb = np.zeros((NP, m), np.int32)
    yb = np.ones((NP, m), np.float32)
    Cb = np.zeros((NP, m), np.float32)
    for q, (_pi, _f, tr, ypm, cvals, _te) in enumerate(problems):
        s = len(tr)
        idxb[q, :s] = tr
        yb[q, :s] = ypm
        Cb[q, :s] = cvals
    idxb_d = jnp.asarray(idxb)
    yb_d = jnp.asarray(yb)
    validb = jnp.asarray(Cb > 0)

    @jax.jit
    def solve_all(K):
        Ksub = K[idxb_d[:, :, None], idxb_d[:, None, :]]
        Ksub = jnp.where(validb[:, :, None] & validb[:, None, :], Ksub, 0.0)
        Qb = yb_d[:, :, None] * yb_d[:, None, :] * Ksub
        solver = jax.vmap(
            functools.partial(
                _smo_kernel_solve, eps=cfg.eps, max_iter=cfg.max_iter
            )
        )
        res = solver(Qb, yb_d, jnp.asarray(Cb))
        # Decisions for every sample; callers slice their test rows.
        coef = res.alpha * yb_d  # (NP, m)
        dec = (
            jnp.einsum(
                "qm,qmn->qn", coef, K[idxb_d],
                precision=jax.lax.Precision.HIGHEST,
            )
            - res.rho[:, None]
        )
        return dec

    dec_all = np.asarray(solve_all(K))  # (NP, n)

    # --- scatter decisions back per pair, fit Platt -------------------
    dec_by_pair = [np.zeros(len(p[0])) for p in per_pair]
    pos_of = [
        {g: q for q, g in enumerate(p[0])} for p in per_pair
    ]
    for q, (pi, _f, _tr, _ypm, _cv, te) in enumerate(problems):
        local = np.asarray([pos_of[pi][g] for g in te])
        dec_by_pair[pi][local] = dec_all[q][te]
    probA, probB = [], []
    for pi, (idx, y_pos, _fold_of) in enumerate(per_pair):
        A, B = platt_fit(dec_by_pair[pi], y_pos)
        probA.append(A)
        probB.append(B)
    return np.array(probA), np.array(probB)
