"""Multi-view preprocessing for the CNN / SGAN families.

Re-design of the reference's `preprocess_data` (dnn.py:185-277 and the
128×128 SGAN variant sgan.py:617-727): scale [0, RADAR_MAX] → [-1, 1],
optionally augment, bicubic-resize every projection to a common square
(PIL-parity matrices as matmuls instead of a per-sample PIL loop),
stack to (N, H, W, 3) with channel order (xz, yz, xy), shuffle with the
seeded generator, and split.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from radarml_tpu.core.arena import RADAR_MAX
from radarml_tpu.data.balance import balance_classes
from radarml_tpu.data.labels import LabelEncoder, class_weights
from radarml_tpu.data.store import Sample, stack_samples
from radarml_tpu.ops.resample import bicubic_pair

logger = logging.getLogger(__name__)

RANDOM_SEED = 1234


def scale_to_unit_interval(planes: np.ndarray) -> np.ndarray:
    """[0, RADAR_MAX] → [0, 1] (the SVM-path convention, train.py:667)."""
    return planes / RADAR_MAX


def scale_to_symmetric(planes):
    """[0, RADAR_MAX] → [-1, 1] (the DNN/SGAN convention, dnn.py:202)."""
    half = RADAR_MAX / 2.0
    return (planes - half) / half


def unscale_from_symmetric(planes):
    """[-1, 1] → [0, RADAR_MAX] (sgan.py:464)."""
    return RADAR_MAX * (planes + 1.0) / 2.0


def resize_views(
    xz: np.ndarray,
    yz: np.ndarray,
    xy: np.ndarray,
    rescale: Tuple[int, int],
) -> jax.Array:
    """Bicubic-resize three (N, H, W) stacks and stack to (N, h, w, 3)."""
    p = jax.lax.Precision.HIGHEST

    def one(batch: np.ndarray) -> jax.Array:
        r, c = bicubic_pair(batch.shape[1:], rescale)
        b = jnp.asarray(batch, dtype=jnp.float32)
        out = jnp.einsum("oh,bhw->bow", jnp.asarray(r, jnp.float32), b, precision=p)
        return jnp.einsum("bow,pw->bop", out, jnp.asarray(c, jnp.float32), precision=p)

    return jnp.stack([one(xz), one(yz), one(xy)], axis=-1)


def preprocess_multiview(
    samples: Sequence[Sample],
    labels: Sequence[str],
    rescale: Tuple[int, int],
    train_split: float = 0.8,
    sup_mask: Optional[Sequence[bool]] = None,
    balance: bool = False,
    augment_fn=None,
    augment_mode: str = "replace",
    augment_copies: int = 1,
    seed: int = RANDOM_SEED,
    device: bool = False,
):
    """Full multi-view preprocessing pipeline.

    Args:
        samples: reference-format [(xz, yz, xy), ...] in [0, RADAR_MAX].
        labels: string labels.
        rescale: target (H, W) — (80, 80) for the CNN, (128, 128) SGAN.
        train_split: leading fraction for training after shuffle.
        sup_mask: optional per-sample supervised flags (SGAN).
        balance: balance the training set by upsampling (SGAN path).
        augment_fn: optional callable (views_stack, rng) → views_stack
            applied after scaling, before resize.
        augment_mode: "replace" mirrors the reference exactly — every
            sample (including what becomes validation data) is
            REPLACED by its augmented version before the split
            (dnn.py:207-209 augments the whole scaled list in place).
            "train_concat" is the quality-oriented recipe the
            reference lacks: the validation set stays clean, and
            `augment_copies` augmented copies of the training samples
            are APPENDED to the clean training set, so augmentation
            only ever adds information.
        augment_copies: number of augmented training-set copies to
            append in "train_concat" mode; 0 appends nothing (the
            clean-validation split logic still applies).
        device: keep the resized view tensors device-resident (jax
            arrays) — the CNN/SGAN trainers consume them on device
            anyway, and the (N, h, w, 3) stack is the largest tensor in
            the whole flow (~177 MB at reference SGAN scale), so never
            fetching it avoids the most expensive host round trip in
            the framework.

    Returns:
        dict with X_train, y_train, X_val, y_val, n_classes, w_classes,
        label_encoder, and (when sup_mask given) sup_train.
    """
    xz, yz, xy = stack_samples(samples)
    xz, yz, xy = map(scale_to_symmetric, (xz, yz, xy))

    if augment_mode not in ("replace", "train_concat"):
        raise ValueError(f"unknown augment_mode: {augment_mode!r}")
    if augment_copies < 0:
        raise ValueError(
            f"augment_copies must be >= 0, got {augment_copies}"
        )
    rng = np.random.default_rng(seed)
    if augment_fn is not None and augment_mode == "replace":
        xz, yz, xy = augment_fn((xz, yz, xy), rng)

    le, encoded = LabelEncoder.fit_transform(list(labels))
    w_classes = class_weights(encoded)
    n_classes = len(le.classes_)
    logger.info("Found %d classes and %d samples", n_classes, len(labels))

    views = resize_views(xz, yz, xy, rescale)
    if not device:
        views = np.asarray(views, dtype=np.float32)

    idx = np.arange(views.shape[0])
    rng.shuffle(idx)
    if device:
        views = jnp.take(views, jnp.asarray(idx), axis=0)
    else:
        views = views[idx]
    encoded = encoded[idx]
    sup = np.asarray(sup_mask, dtype=bool)[idx] if sup_mask is not None else None

    split = min(int(views.shape[0] * train_split), views.shape[0])
    X_train, y_train = views[:split], encoded[:split]
    X_val, y_val = views[split:], encoded[split:]

    if augment_fn is not None and augment_mode == "train_concat":
        # Augment only the TRAINING originals (at raw resolution, so
        # the spatial transforms act on full detail) and append the
        # resized copies to the clean training set; validation data is
        # never touched.
        tr_idx = idx[:split]
        xs, ys = [X_train], [y_train]
        for _ in range(augment_copies):
            a_xz, a_yz, a_xy = augment_fn(
                (xz[tr_idx], yz[tr_idx], xy[tr_idx]), rng
            )
            aug = resize_views(
                np.asarray(a_xz), np.asarray(a_yz), np.asarray(a_xy),
                rescale,
            )
            xs.append(aug if device else np.asarray(aug, np.float32))
            ys.append(y_train)
        if X_val.size == 0:
            # Preserve the clean-train fallback (sgan.py:722-723)
            # BEFORE growth so validation never sees augmented copies.
            X_val, y_val = X_train, y_train
        if sup is not None:
            # Augmented copies inherit their originals' supervised
            # flags; keep the train/val slicing consistent below.
            sup = np.concatenate(
                [sup[:split]] * len(ys) + [sup[split:]]
            )
        cat = jnp.concatenate if device else np.concatenate
        X_train = cat(xs, axis=0)
        y_train = np.concatenate(ys, axis=0)
        split = int(y_train.shape[0])
    out = {
        "n_classes": n_classes,
        "w_classes": w_classes,
        "label_encoder": le,
    }

    if sup is not None:
        sup_train = sup[:split]
        if balance:
            X_train, y_train, sup_train = balance_classes(
                y_train, X_train, sup_mask=sup_train, shuffle=True,
                shuffle_rng=rng,
            )
        # Empty validation set falls back to the pre-balanced train set
        # (sgan.py:722-723).
        if X_val.size == 0:
            X_val, y_val = views[:split], encoded[:split]
        out["sup_train"] = sup_train
    elif balance:
        y_train, X_train = balance_classes(y_train, X_train)

    out.update(
        X_train=X_train, y_train=y_train, X_val=X_val, y_val=y_val
    )
    return out
