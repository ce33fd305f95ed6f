"""Batched feature-vector construction from radar projections.

JAX equivalent of the reference's `common.process_samples`
(reference common.py:123-149): select the projections named by the
mask, zoom each to the training arena with the exact ndimage cubic
B-spline semantics, flatten, concatenate (xz | yz | xy order), and
optionally scale to [0, 1] by RADAR_MAX.

Where the reference loops samples in Python and calls scipy per plane,
this builds the interpolation matrices once (see ops/resample.py) and
runs the whole batch as three matmul pairs + one concat inside a
single jitted program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from radarml_tpu.core.arena import RADAR_MAX, Arena, ProjMask, ProjZoom
from radarml_tpu.ops.resample import spline_zoom_pair


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Static description of the projection→feature transformation."""

    xz_shape: Tuple[int, int]
    yz_shape: Tuple[int, int]
    xy_shape: Tuple[int, int]
    proj_mask: ProjMask = ProjMask(True, True, True)
    proj_zoom: ProjZoom = ProjZoom((1.0, 1.0), (1.0, 1.0), (1.0, 1.0))
    scale: bool = False

    @staticmethod
    def for_arena(
        arena: Arena,
        proj_mask: ProjMask = ProjMask(True, True, True),
        proj_zoom: ProjZoom = ProjZoom((1.0, 1.0), (1.0, 1.0), (1.0, 1.0)),
        scale: bool = False,
    ) -> "FeatureSpec":
        return FeatureSpec(
            xz_shape=arena.xz_shape,
            yz_shape=arena.yz_shape,
            xy_shape=arena.xy_shape,
            proj_mask=proj_mask,
            proj_zoom=proj_zoom,
            scale=scale,
        )

    @property
    def plane_out_shapes(self) -> Tuple[Tuple[int, int], ...]:
        outs = []
        for shape, zoom, keep in zip(
            (self.xz_shape, self.yz_shape, self.xy_shape),
            self.proj_zoom,
            self.proj_mask,
        ):
            if not keep:
                continue
            _, _, out_shape = spline_zoom_pair(tuple(shape), tuple(zoom))
            outs.append(out_shape)
        return tuple(outs)

    @property
    def feature_length(self) -> int:
        return sum(h * w for h, w in self.plane_out_shapes)


def predict_zoom(train_arena: Arena, scan_arena: Arena) -> ProjZoom:
    """Zoom factors mapping a scan arena into the training arena.

    Mirror of the reference's `calc_proj_zoom` (predict.py:34-54): per
    axis, factor = train_size / scan_size, composed per projection with
    the (row, col) layout of each plane — xz rows are theta (x), yz
    rows are phi (y), both with r columns; xy is (theta, phi).
    """
    zx = train_arena.size_x / scan_arena.size_x
    zy = train_arena.size_y / scan_arena.size_y
    zz = train_arena.size_z / scan_arena.size_z
    return ProjZoom(xz=(zx, zz), yz=(zy, zz), xy=(zx, zy))


@functools.lru_cache(maxsize=64)
def make_feature_fn(
    spec: FeatureSpec,
) -> Callable[[jax.Array, jax.Array, jax.Array], jax.Array]:
    """Build a jitted (xz, yz, xy) batch → (B, F) feature function.

    Inputs are (B, H, W) stacks of each projection at its native scan
    shape; the output is the (B, feature_length) matrix the classifiers
    consume, matching the reference feature layout bit-for-bit (within
    float32) so pickled-reference-model predictions reproduce.

    Cached per FeatureSpec (which is hashable and fully determines the
    program): repeated `process_samples`/`process_views` calls — e.g.
    the per-epoch augment loop in apps/train.py — reuse ONE traced
    function instead of re-tracing a fresh `@jax.jit` closure each
    call (the persistent compile cache hides XLA recompiles but not
    tracing cost).
    """
    mats = []
    for shape, zoom, keep in zip(
        (spec.xz_shape, spec.yz_shape, spec.xy_shape), spec.proj_zoom, spec.proj_mask
    ):
        if not keep:
            mats.append(None)
            continue
        row_mat, col_mat, _ = spline_zoom_pair(tuple(shape), tuple(zoom))
        mats.append((np.asarray(row_mat), np.asarray(col_mat)))

    scale = spec.scale

    @jax.jit
    def feature_fn(xz: jax.Array, yz: jax.Array, xy: jax.Array) -> jax.Array:
        planes = []
        for batch, mat in zip((xz, yz, xy), mats):
            if mat is None:
                continue
            row_mat = jnp.asarray(mat[0], dtype=batch.dtype)
            col_mat = jnp.asarray(mat[1], dtype=batch.dtype)
            p = jax.lax.Precision.HIGHEST
            out = jnp.einsum("oh,bhw->bow", row_mat, batch, precision=p)
            out = jnp.einsum("bow,pw->bop", out, col_mat, precision=p)
            planes.append(out.reshape(out.shape[0], -1))
        feats = jnp.concatenate(planes, axis=1)
        if scale:
            feats = feats / RADAR_MAX
        return feats

    return feature_fn


def process_samples(
    samples: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    proj_mask: ProjMask = ProjMask(True, True, True),
    proj_zoom: ProjZoom = ProjZoom((1.0, 1.0), (1.0, 1.0), (1.0, 1.0)),
    scale: bool = False,
    device: bool = False,
) -> np.ndarray:
    """Drop-in batched equivalent of reference common.process_samples.

    Accepts the reference's list-of-(xz, yz, xy) sample format and
    returns the (N, F) feature matrix. All samples must share plane
    shapes (true for any single-arena dataset); the batch then runs as
    one device program instead of N scipy calls.

    With `device=True` the matrix stays device-resident (a jax array)
    for consumers that keep computing on it — the grid searches, the
    model fits — so multi-MB feature matrices never cross the
    device→host link just to be uploaded again.
    """
    xz = np.stack([np.asarray(s[0], dtype=np.float32) for s in samples])
    yz = np.stack([np.asarray(s[1], dtype=np.float32) for s in samples])
    xy = np.stack([np.asarray(s[2], dtype=np.float32) for s in samples])
    return process_views(
        xz, yz, xy,
        proj_mask=proj_mask, proj_zoom=proj_zoom, scale=scale, device=device,
    )


def process_views(
    xz,
    yz,
    xy,
    proj_mask: ProjMask = ProjMask(True, True, True),
    proj_zoom: ProjZoom = ProjZoom((1.0, 1.0), (1.0, 1.0), (1.0, 1.0)),
    scale: bool = False,
    device: bool = True,
):
    """`process_samples` for already-batched (B, H, W) view stacks.

    Accepts host or device stacks (e.g. augment_samples(device=True)
    output) without the per-sample list detour, so a device-resident
    augment → featurize chain involves zero host transfers.
    """
    norm_zoom = ProjZoom(*[
        tuple(float(v) for v in np.atleast_1d(z)[:2]) if np.ndim(z)
        else (float(z), float(z))
        for z in proj_zoom
    ])
    spec = FeatureSpec(
        xz_shape=tuple(int(s) for s in xz.shape[1:]),
        yz_shape=tuple(int(s) for s in yz.shape[1:]),
        xy_shape=tuple(int(s) for s in xy.shape[1:]),
        proj_mask=ProjMask(*(bool(m) for m in proj_mask)),
        proj_zoom=norm_zoom,
        scale=bool(scale),
    )
    fn = make_feature_fn(spec)
    out = fn(
        jnp.asarray(xz, jnp.float32),
        jnp.asarray(yz, jnp.float32),
        jnp.asarray(xy, jnp.float32),
    )
    return out if device else np.asarray(out)
