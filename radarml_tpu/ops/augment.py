"""Batched data augmentation: rotation, clipped zoom, sparse noise.

JAX re-design of the reference's two augmentation stacks — the
SVM-path `DataGenerator.augment` (reference train.py:85-213: per-sample
scipy `ndimage.rotate`, constant-size "clipped zoom", single-draw
sparse Gaussian noise, all clamped to [0, 1]) and the DNN/SGAN-path
`augment_data` (reference dnn.py:94-182, sgan.py:238-326: the same
chain applied in place on [-1, 1]-scaled data).

Design (not a port):

* **Rotation** keeps the image shape (`reshape=False`), so the cubic
  B-spline prefilter is a pair of static matmuls over the full plane;
  the rotated resample is then a 16-tap gather of spline coefficients
  at coordinates computed from a *traced* angle — one jitted program
  for any batch of per-sample random angles, no recompiles.
* **Clipped zoom** embeds data-dependent integer crop/pad arithmetic
  (`int(np.ceil(h / factor))` etc.), which would force dynamic shapes.
  But for any *fixed* factor the whole crop→spline-zoom→trim/pad chain
  is a linear separable operator `out = A @ img @ B.T`. So the zoom
  range is quantized to a palette of K factors, the (h, h) and (w, w)
  operators are precomputed on the host, and a batch applies per-sample
  gathered operators as two matmuls. K=64 over a ±0.3 range spaces
  factors ~1% apart — far below augmentation noise.
* **Noise** follows the reference exactly: a *single* scalar normal
  draw per plane, added to nonzero entries only (SVM path,
  train.py:148-156) or to every entry (DNN path, dnn.py:159-162).

Randomness is keyed JAX PRNG throughout (the reference uses unseeded
numpy generators, train.py:85, so its exact draws are irreproducible by
design; see SURVEY.md §7 hard part 3).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from radarml_tpu.ops.resample import (
    _prefilter_matrix,
    bspline_zoom_matrix,
    zoom_output_size,
)

__all__ = [
    "spline_coeffs2d",
    "bspline_sample2d",
    "rotate",
    "rotate_batch",
    "clipped_zoom_operator",
    "zoom_palette",
    "clipped_zoom_batch",
    "sparse_noise",
    "add_noise",
    "augment_multiview",
    "augment_samples",
]


# --------------------------------------------------------------------------
# Traced-coordinate cubic B-spline sampling
# --------------------------------------------------------------------------

def _bspline3_jnp(x: jax.Array) -> jax.Array:
    """Cubic B-spline basis, traced version of resample._bspline3."""
    x = jnp.abs(x)
    lo = 2.0 / 3.0 - x * x + 0.5 * x * x * x
    hi = ((2.0 - x) ** 3) / 6.0
    return jnp.where(x < 1.0, lo, jnp.where(x < 2.0, hi, 0.0))


def _mirror_index_jnp(j: jax.Array, n: int) -> jax.Array:
    """Whole-sample mirror reflection of integer indices into [0, n-1]."""
    if n == 1:
        return jnp.zeros_like(j)
    period = 2 * (n - 1)
    j = jnp.abs(j) % period
    return jnp.where(j > n - 1, period - j, j)


def spline_coeffs2d(plane: jax.Array) -> jax.Array:
    """Plane values → cubic B-spline coefficients (mirror boundary).

    The 2-D prefilter is separable: P_h @ plane @ P_w.T with the exact
    collocation-inverse matrices from ops/resample. Shapes are static,
    so the matrices are host-precomputed per (H, W).
    """
    h, w = plane.shape[-2], plane.shape[-1]
    ph = jnp.asarray(_prefilter_matrix(h), dtype=plane.dtype)
    pw = jnp.asarray(_prefilter_matrix(w), dtype=plane.dtype)
    p = jax.lax.Precision.HIGHEST
    out = jnp.einsum("ih,...hw->...iw", ph, plane, precision=p)
    return jnp.einsum("...iw,jw->...ij", out, pw, precision=p)


def bspline_sample2d(
    coeffs: jax.Array,
    rows: jax.Array,
    cols: jax.Array,
    cval: float = 0.0,
) -> jax.Array:
    """Evaluate a 2-D cubic B-spline at traced (row, col) coordinates.

    Args:
        coeffs: (H, W) spline coefficients from spline_coeffs2d.
        rows, cols: equally-shaped arrays of sample coordinates.
        cval: value for coordinates outside [0, H-1] x [0, W-1]
            (scipy constant-mode semantics, the rotate/zoom default).

    Returns:
        Array shaped like `rows` with interpolated values.
    """
    h, w = coeffs.shape
    r0 = jnp.floor(rows).astype(jnp.int32)
    c0 = jnp.floor(cols).astype(jnp.int32)
    out = jnp.zeros(rows.shape, dtype=coeffs.dtype)
    for dr in range(-1, 3):
        rj = r0 + dr
        wr = _bspline3_jnp(rows - rj.astype(rows.dtype))
        rj = _mirror_index_jnp(rj, h)
        row_gather = coeffs[rj]  # (..., W)
        for dc in range(-1, 3):
            cj = c0 + dc
            wc = _bspline3_jnp(cols - cj.astype(cols.dtype))
            cjm = _mirror_index_jnp(cj, w)
            vals = jnp.take_along_axis(
                row_gather, cjm[..., None], axis=-1
            )[..., 0]
            out = out + wr * wc * vals
    inside = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1)
    return jnp.where(inside, out, jnp.asarray(cval, dtype=coeffs.dtype))


# --------------------------------------------------------------------------
# Rotation (scipy ndimage.rotate reshape=False, order=3, constant mode)
# --------------------------------------------------------------------------

def rotate(plane: jax.Array, angle_deg: jax.Array) -> jax.Array:
    """Rotate one (H, W) plane about its center by a traced angle.

    Matches `ndimage.rotate(p, angle, reshape=False)` (reference
    train.py:88-95): output coordinate y maps to input coordinate
    R(angle) @ (y - center) + center with the scipy sign convention.
    """
    h, w = plane.shape
    coeffs = spline_coeffs2d(plane)
    theta = jnp.deg2rad(angle_deg).astype(plane.dtype)
    cos, sin = jnp.cos(theta), jnp.sin(theta)
    cr, cc = (h - 1) / 2.0, (w - 1) / 2.0
    rr, cc_grid = jnp.meshgrid(
        jnp.arange(h, dtype=plane.dtype),
        jnp.arange(w, dtype=plane.dtype),
        indexing="ij",
    )
    dy, dx = rr - cr, cc_grid - cc
    rows = cos * dy + sin * dx + cr
    cols = -sin * dy + cos * dx + cc
    return bspline_sample2d(coeffs, rows, cols)


@functools.partial(jax.jit)
def rotate_batch(planes: jax.Array, angles_deg: jax.Array) -> jax.Array:
    """vmap of `rotate` over a (B, H, W) stack with per-sample angles."""
    return jax.vmap(rotate)(planes, angles_deg)


# --------------------------------------------------------------------------
# Clipped zoom (constant output size) as a palette of linear operators
# --------------------------------------------------------------------------

def _zoom_axis_operator(n: int, factor: float) -> np.ndarray:
    """1-D linear operator of the reference's clipped_zoom along one axis.

    Composes the exact integer crop/zoom/pad/trim arithmetic of
    reference train.py:96-146 into an (n, n) matrix. Linear because
    every stage (crop, cubic-spline zoom, zero-pad, trim) is linear.
    """
    if factor == 1.0:
        return np.eye(n)
    if factor < 1.0:
        zn = int(np.round(n * factor))
        top = (n - zn) // 2
        # zoom of the full axis to size round(n * factor), pasted at top.
        zmat = bspline_zoom_matrix(n, zoom_output_size(n, factor))
        out = np.zeros((n, n))
        out[top : top + zmat.shape[0], :] = zmat[: n - top, :]
        return out
    # factor > 1: crop the center, zoom it up, trim to n.
    zn = int(np.ceil(n / factor))
    top = (n - zn) // 2
    crop = np.zeros((zn, n))
    crop[np.arange(zn), top + np.arange(zn)] = 1.0
    zoomed = bspline_zoom_matrix(zn, zoom_output_size(zn, factor))
    trim_top = (zoomed.shape[0] - n) // 2
    full = zoomed @ crop
    return full[trim_top : trim_top + n, :]


@functools.lru_cache(maxsize=1024)
def clipped_zoom_operator(
    shape: Tuple[int, int], factor: float
) -> Tuple[np.ndarray, np.ndarray]:
    """(row_op, col_op) pair: clipped_zoom(img) == row_op @ img @ col_op.T."""
    return (
        _zoom_axis_operator(shape[0], factor),
        _zoom_axis_operator(shape[1], factor),
    )


def zoom_palette(
    shape: Tuple[int, int],
    zoom_range: float,
    n_factors: int = 64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Precompute operators for quantized factors over [1-zr, 1+zr].

    Returns:
        (factors, row_ops, col_ops): (K,), (K, H, H), (K, W, W). A
        per-sample uniform factor draw becomes a uniform index draw.
    """
    factors = np.linspace(1.0 - zoom_range, 1.0 + zoom_range, n_factors)
    rows, cols = [], []
    for f in factors:
        r, c = clipped_zoom_operator(shape, float(f))
        rows.append(r)
        cols.append(c)
    return factors, np.stack(rows), np.stack(cols)


@jax.jit
def clipped_zoom_batch(
    planes: jax.Array,
    idx: jax.Array,
    row_ops: jax.Array,
    col_ops: jax.Array,
) -> jax.Array:
    """Apply per-sample palette operators to a (B, H, W) stack.

    idx: (B,) int32 palette indices (one shared factor per sample, as
    the reference shares one factor across projections of a sample).
    """
    r = row_ops[idx]  # (B, H, H)
    c = col_ops[idx]  # (B, W, W)
    p = jax.lax.Precision.HIGHEST
    out = jnp.einsum("bih,bhw->biw", r, planes, precision=p)
    return jnp.einsum("biw,bjw->bij", out, c, precision=p)


# --------------------------------------------------------------------------
# Noise
# --------------------------------------------------------------------------

def sparse_noise(
    planes: jax.Array, key: jax.Array, sd: float,
    lo: float = 0.0, hi: float = 1.0,
) -> jax.Array:
    """Add one scalar N(0, sd) draw per plane to nonzero entries only.

    Reference train.py:148-156: `qc[qc != 0] += rg.normal(scale=sd)` —
    a single broadcast scalar, preserving sparsity; clamped to [lo, hi].
    """
    b = planes.shape[0]
    draws = jax.random.normal(key, (b, 1, 1), dtype=planes.dtype) * sd
    out = jnp.where(planes != 0, planes + draws, planes)
    return jnp.clip(out, lo, hi)


def add_noise(
    planes: jax.Array, key: jax.Array, sd: float,
    lo: float = -1.0, hi: float = 1.0,
) -> jax.Array:
    """Add one scalar N(0, sd) draw per plane to every entry.

    Reference dnn.py:159-162 (`p += rng.normal(scale=sd)`), [-1,1] clamp.
    """
    b = planes.shape[0]
    draws = jax.random.normal(key, (b, 1, 1), dtype=planes.dtype) * sd
    return jnp.clip(planes + draws, lo, hi)


# --------------------------------------------------------------------------
# High-level augmentation pipelines
# --------------------------------------------------------------------------

def _clamped_rotate_batch(planes, angles, lo, hi):
    return jnp.clip(rotate_batch(planes, angles), lo, hi)


def augment_multiview(
    views: Tuple[np.ndarray, np.ndarray, np.ndarray],
    key: jax.Array,
    rotation_range: Optional[float] = 1.0,
    zoom_range: Optional[float] = 0.3,
    noise_sd: Optional[float] = 1.0,
    clamp: Tuple[float, float] = (-1.0, 1.0),
    n_zoom_factors: int = 64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DNN/SGAN-path in-place augmentation chain (dnn.py:94-182).

    Applies rotate → clipped-zoom → noise sequentially to each (B,H,W)
    projection stack: independent per-plane angles and noise draws, one
    shared zoom factor per sample across its three projections.
    """
    lo, hi = clamp
    out = []
    b = views[0].shape[0]
    kr, kz, kn = jax.random.split(key, 3)
    zoom_idx = jax.random.randint(kz, (b,), 0, n_zoom_factors)
    for v_i, v in enumerate(views):
        planes = jnp.asarray(v, dtype=jnp.float32)
        if rotation_range is not None:
            ka = jax.random.fold_in(kr, v_i)
            angles = jax.random.uniform(
                ka, (b,), minval=-rotation_range, maxval=rotation_range
            )
            planes = _clamped_rotate_batch(planes, angles, lo, hi)
        if zoom_range is not None:
            _, rows, cols = zoom_palette(
                planes.shape[1:], zoom_range, n_zoom_factors
            )
            planes = clipped_zoom_batch(
                planes, zoom_idx,
                jnp.asarray(rows, jnp.float32), jnp.asarray(cols, jnp.float32),
            )
            planes = jnp.clip(planes, lo, hi)
        if noise_sd is not None:
            planes = add_noise(
                planes, jax.random.fold_in(kn, v_i), noise_sd, lo, hi
            )
        out.append(np.asarray(planes))
    return tuple(out)


def augment_samples(
    views: Tuple[np.ndarray, np.ndarray, np.ndarray],
    labels: np.ndarray,
    key: jax.Array,
    rotation_range: Optional[float] = None,
    zoom_range: Optional[float] = None,
    noise_sd: Optional[float] = None,
    balance: bool = False,
    n_zoom_factors: int = 64,
    device: bool = False,
) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], np.ndarray]:
    """SVM-path generative augmentation (DataGenerator, train.py:34-213).

    For each input sample, *appends* one new sample per enabled
    transform (rotate / zoom / noise), replicated round(class_weight)
    times when balancing (majority_count / class_count). Data is in
    [0, 1]; all outputs clamp there. Returns the augmented samples only
    (the reference extends the training set with these).

    With `device=True` the augmented view stacks stay device-resident
    (each input view uploads once and replicates/gathers on device) —
    pair with features.process_views to keep the whole augment →
    featurize → fit loop off the host link.
    """
    labels = np.asarray(labels)
    if balance:
        vals, counts = np.unique(labels, return_counts=True)
        top = counts.max()
        weight = {int(v): top / c for v, c in zip(vals, counts)}
    else:
        weight = {int(v): 1.0 for v in np.unique(labels)}
    reps = np.array(
        [int(np.round(weight[int(y)])) for y in labels], dtype=np.int64
    )
    rep_idx = np.repeat(np.arange(len(labels)), reps)
    y_rep = labels[rep_idx]

    out_views = [[], [], []]
    out_labels = []
    b = len(rep_idx)
    if b == 0:
        empty = tuple(np.zeros((0,) + v.shape[1:], np.float32) for v in views)
        return empty, np.zeros((0,), labels.dtype)

    kr, kz, kn = jax.random.split(key, 3)
    # One upload (or zero, for already-device views) per view; the
    # replication gather runs on device.
    rep_idx_d = jnp.asarray(rep_idx)
    views_rep = tuple(
        jnp.take(jnp.asarray(v, dtype=jnp.float32), rep_idx_d, axis=0)
        for v in views
    )
    fetch = (lambda a: a) if device else np.asarray
    if rotation_range is not None:
        for v_i, planes in enumerate(views_rep):
            ka = jax.random.fold_in(kr, v_i)
            angles = jax.random.uniform(
                ka, (b,), minval=-rotation_range, maxval=rotation_range
            )
            out_views[v_i].append(
                fetch(_clamped_rotate_batch(planes, angles, 0.0, 1.0))
            )
        out_labels.append(y_rep)
    if zoom_range is not None:
        zoom_idx = jax.random.randint(kz, (b,), 0, n_zoom_factors)
        for v_i, planes in enumerate(views_rep):
            _, rows, cols = zoom_palette(
                planes.shape[1:], zoom_range, n_zoom_factors
            )
            zoomed = clipped_zoom_batch(
                planes, zoom_idx,
                jnp.asarray(rows, jnp.float32), jnp.asarray(cols, jnp.float32),
            )
            out_views[v_i].append(fetch(jnp.clip(zoomed, 0.0, 1.0)))
        out_labels.append(y_rep)
    if noise_sd is not None:
        for v_i, planes in enumerate(views_rep):
            noised = sparse_noise(
                planes, jax.random.fold_in(kn, v_i), noise_sd
            )
            out_views[v_i].append(fetch(noised))
        out_labels.append(y_rep)

    if not out_labels:
        empty = tuple(np.zeros((0,) + v.shape[1:], np.float32) for v in views)
        return empty, np.zeros((0,), labels.dtype)
    cat = jnp.concatenate if device else np.concatenate
    aug = tuple(cat(parts) for parts in out_views)
    return aug, np.concatenate(out_labels)
