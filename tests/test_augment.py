"""Augmentation op parity vs scipy.ndimage semantics.

The reference augments with `ndimage.rotate(reshape=False)`, a
constant-size clipped zoom built on `ndimage.zoom`, and single-draw
Gaussian noise (reference train.py:85-213, dnn.py:94-182). These tests
check the batched JAX formulations against scipy ground truth computed
directly in the test (fixed parameters; the random-draw policies are
keyed-PRNG by design and are checked structurally).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import ndimage

from radarml_tpu.ops import augment


def _ref_clipped_zoom(img, zoom_factor):
    """Independent scipy implementation of the reference's clipped zoom
    semantics (constant output size via crop/pad, train.py:96-146)."""
    h, w = img.shape[:2]
    if zoom_factor < 1:
        zh = int(np.round(h * zoom_factor))
        zw = int(np.round(w * zoom_factor))
        top = (h - zh) // 2
        left = (w - zw) // 2
        out = np.zeros_like(img)
        out[top:top + zh, left:left + zw] = ndimage.zoom(
            img, (zoom_factor, zoom_factor)
        )
        return out
    if zoom_factor > 1:
        zh = int(np.ceil(h / zoom_factor))
        zw = int(np.ceil(w / zoom_factor))
        top = (h - zh) // 2
        left = (w - zw) // 2
        out = ndimage.zoom(
            img[top:top + zh, left:left + zw], (zoom_factor, zoom_factor)
        )
        trim_top = (out.shape[0] - h) // 2
        trim_left = (out.shape[1] - w) // 2
        return out[trim_top:trim_top + h, trim_left:trim_left + w]
    return img


@pytest.mark.parametrize("angle", [-10.0, -1.0, 0.0, 0.7, 5.0, 33.0])
def test_rotate_matches_scipy(rng, angle):
    img = rng.random((22, 176)).astype(np.float64)
    want = ndimage.rotate(img, angle, reshape=False)
    got = np.asarray(augment.rotate(jnp.asarray(img), jnp.asarray(angle)))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_rotate_batch_per_sample_angles(rng):
    imgs = rng.random((4, 31, 40)).astype(np.float64)
    angles = np.array([-3.0, 0.0, 1.5, 12.0])
    got = np.asarray(augment.rotate_batch(jnp.asarray(imgs), jnp.asarray(angles)))
    for i in range(4):
        want = ndimage.rotate(imgs[i], angles[i], reshape=False)
        np.testing.assert_allclose(got[i], want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("factor", [0.7, 0.85, 1.0, 1.12, 1.3])
@pytest.mark.parametrize("shape", [(22, 176), (31, 176), (22, 31)])
def test_clipped_zoom_operator_matches_reference_formula(rng, factor, shape):
    img = rng.random(shape).astype(np.float64)
    want = _ref_clipped_zoom(img, factor)
    r, c = augment.clipped_zoom_operator(shape, factor)
    got = r @ img @ c.T
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_clipped_zoom_batch_gathers_palette(rng):
    shape = (22, 31)
    imgs = rng.random((5,) + shape).astype(np.float32)
    factors, rows, cols = augment.zoom_palette(shape, 0.3, n_factors=8)
    idx = np.array([0, 3, 4, 7, 2], dtype=np.int32)
    got = np.asarray(
        augment.clipped_zoom_batch(
            jnp.asarray(imgs), jnp.asarray(idx),
            jnp.asarray(rows, jnp.float32), jnp.asarray(cols, jnp.float32),
        )
    )
    for b in range(5):
        want = _ref_clipped_zoom(imgs[b].astype(np.float64), factors[idx[b]])
        np.testing.assert_allclose(got[b], want, atol=1e-4)


def test_sparse_noise_preserves_sparsity_and_clamps(rng):
    planes = rng.random((6, 10, 12)).astype(np.float32)
    planes[planes < 0.5] = 0.0
    out = np.asarray(
        augment.sparse_noise(jnp.asarray(planes), jax.random.PRNGKey(0), sd=0.5)
    )
    # zeros stay zero; nonzeros shift by one shared scalar per plane.
    assert np.all(out[planes == 0] == 0)
    assert out.min() >= 0.0 and out.max() <= 1.0
    for b in range(6):
        nz = planes[b] != 0
        deltas = out[b][nz] - planes[b][nz]
        unclamped = (out[b][nz] > 0) & (out[b][nz] < 1)
        if unclamped.sum() > 1:
            assert np.allclose(
                deltas[unclamped], deltas[unclamped][0], atol=1e-6
            )


def test_add_noise_shifts_everything(rng):
    planes = (rng.random((3, 8, 8)).astype(np.float32) - 0.5) * 2
    out = np.asarray(
        augment.add_noise(jnp.asarray(planes), jax.random.PRNGKey(1), sd=0.3)
    )
    assert out.min() >= -1.0 and out.max() <= 1.0
    assert not np.allclose(out, planes)


def test_augment_samples_counts_and_balance(rng):
    # 3 samples of class 0, 1 of class 1 → balance weight 3 for class 1.
    views = tuple(rng.random((4, 12, 16)).astype(np.float32) for _ in range(3))
    labels = np.array([0, 0, 0, 1])
    (axz, ayz, axy), ay = augment.augment_samples(
        views, labels, jax.random.PRNGKey(2),
        rotation_range=5.0, zoom_range=0.2, noise_sd=0.1, balance=True,
    )
    # replication: class0 ×1 each, class1 ×3 → 6 replicated samples,
    # ×3 transforms = 18 augmented samples.
    assert len(ay) == 18
    assert axz.shape == (18, 12, 16)
    assert (ay == 1).sum() == 9
    assert axz.min() >= 0.0 and axz.max() <= 1.0


def test_augment_multiview_roundtrip_shapes(rng):
    views = tuple(
        (rng.random((5, 16, 20)).astype(np.float32) - 0.5) * 2 for _ in range(3)
    )
    out = augment.augment_multiview(
        views, jax.random.PRNGKey(3),
        rotation_range=1.0, zoom_range=0.3, noise_sd=0.2,
    )
    assert all(o.shape == v.shape for o, v in zip(out, views))
    assert all(o.min() >= -1.0 and o.max() <= 1.0 for o in out)


def test_augment_samples_device_matches_host():
    """device=True produces the same augmented stacks as the host path
    (same keys → same transforms), as device-resident jax arrays."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from radarml_tpu.ops.augment import augment_samples

    rng = np.random.default_rng(9)
    views = tuple(
        rng.random((6, h, w)).astype(np.float32)
        for h, w in ((22, 176), (31, 176), (22, 31))
    )
    y = np.array([0, 0, 1, 1, 2, 2])
    key = jax.random.PRNGKey(42)
    host, yh = augment_samples(
        views, y, key, rotation_range=10.0, zoom_range=0.25, noise_sd=0.15,
        balance=True,
    )
    dev, yd = augment_samples(
        views, y, key, rotation_range=10.0, zoom_range=0.25, noise_sd=0.15,
        balance=True, device=True,
    )
    np.testing.assert_array_equal(yh, yd)
    for a, b in zip(host, dev):
        assert isinstance(b, jax.Array)
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)


def test_process_views_matches_process_samples():
    import numpy as np

    from radarml_tpu.ops.features import process_samples, process_views

    rng = np.random.default_rng(10)
    samples = [
        (
            rng.random((22, 176)).astype(np.float32),
            rng.random((31, 176)).astype(np.float32),
            rng.random((22, 31)).astype(np.float32),
        )
        for _ in range(5)
    ]
    xz = np.stack([s[0] for s in samples])
    yz = np.stack([s[1] for s in samples])
    xy = np.stack([s[2] for s in samples])
    a = process_samples(samples, scale=True)
    b = process_views(xz, yz, xy, scale=True, device=False)
    np.testing.assert_array_equal(a, b)
