"""Feature-builder parity vs a reference-formula numpy oracle.

Oracle re-derives common.process_samples (common.py:123-149) with
scipy, then the batched JAX path must match to float32 tolerance.
"""

import numpy as np
import pytest
from scipy import ndimage

from radarml_tpu.core.arena import DEFAULT_ARENA, RADAR_MAX, ProjMask, ProjZoom
from radarml_tpu.ops.features import (
    FeatureSpec,
    make_feature_fn,
    predict_zoom,
    process_samples,
)


def ref_process_samples(samples, proj_mask, proj_zoom, scale):
    def make(t):
        wanted = tuple(
            ndimage.zoom(p, proj_zoom[i]) for i, p in enumerate(t) if proj_mask[i]
        )
        concat = np.concatenate(wanted, axis=None)
        return concat / RADAR_MAX if scale else concat

    return np.array([make(t) for t in samples])


def make_samples(rng, n=8):
    return [
        (
            rng.random((22, 176)).astype(np.float32) * 255,
            rng.random((31, 176)).astype(np.float32) * 255,
            rng.random((22, 31)).astype(np.float32) * 255,
        )
        for _ in range(n)
    ]


@pytest.mark.parametrize("mask", [(True, True, True), (True, False, True), (False, False, True)])
@pytest.mark.parametrize("scale", [False, True])
def test_process_samples_parity(mask, scale, rng):
    samples = make_samples(rng)
    zoom = ProjZoom((1.0, 1.0), (1.0, 1.0), (1.0, 1.0))
    got = process_samples(samples, ProjMask(*mask), zoom, scale)
    want = ref_process_samples(samples, mask, [[1.0, 1.0]] * 3, scale)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5)


def test_process_samples_with_zoom(rng):
    samples = make_samples(rng, n=4)
    zoom = ProjZoom((2.0, 0.5), (0.8, 1.1), (1.5, 1.5))
    got = process_samples(samples, ProjMask(True, True, True), zoom, scale=True)
    want = ref_process_samples(
        samples, (True, True, True),
        [[2.0, 0.5], [0.8, 1.1], [1.5, 1.5]], True,
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)


def test_feature_length_default_arena():
    spec = FeatureSpec.for_arena(DEFAULT_ARENA)
    assert spec.feature_length == 10010


def test_predict_zoom_identity():
    z = predict_zoom(DEFAULT_ARENA, DEFAULT_ARENA)
    assert z == ProjZoom((1.0, 1.0), (1.0, 1.0), (1.0, 1.0))


def test_feature_fn_jit_batched(rng):
    spec = FeatureSpec.for_arena(DEFAULT_ARENA, scale=True)
    fn = make_feature_fn(spec)
    xz = rng.random((32, 22, 176)).astype(np.float32)
    yz = rng.random((32, 31, 176)).astype(np.float32)
    xy = rng.random((32, 22, 31)).astype(np.float32)
    out = fn(xz, yz, xy)
    assert out.shape == (32, 10010)
    # Scaling puts [0,1) inputs into [0, 1/255).
    assert float(np.max(np.asarray(out))) < 1.0 / 100


def test_process_samples_device_matches_host():
    """device=True returns the same matrix as the default host path,
    as a device-resident jax array (no host round trip), and the
    balancer gathers it on device."""
    import jax
    import numpy as np

    from radarml_tpu.data.balance import balance_classes
    from radarml_tpu.ops.features import process_samples

    rng = np.random.default_rng(5)
    samples = [
        (
            rng.random((22, 176)).astype(np.float32),
            rng.random((31, 176)).astype(np.float32),
            rng.random((22, 31)).astype(np.float32),
        )
        for _ in range(12)
    ]
    host = process_samples(samples, scale=True)
    dev = process_samples(samples, scale=True, device=True)
    assert isinstance(dev, jax.Array)
    np.testing.assert_array_equal(host, np.asarray(dev))

    y = np.array([0] * 7 + [1] * 5)
    yb_h, Fb_h = balance_classes(y, host)
    yb_d, Fb_d = balance_classes(y, dev)
    assert isinstance(Fb_d, jax.Array)
    np.testing.assert_array_equal(yb_h, yb_d)
    np.testing.assert_array_equal(Fb_h, np.asarray(Fb_d))


def test_make_feature_fn_cached_across_calls():
    """Repeated process_views calls with equal geometry reuse ONE
    traced function (no per-call re-trace)."""
    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.ops.features import FeatureSpec, make_feature_fn

    spec_a = FeatureSpec.for_arena(DEFAULT_ARENA, scale=True)
    spec_b = FeatureSpec.for_arena(DEFAULT_ARENA, scale=True)
    assert make_feature_fn(spec_a) is make_feature_fn(spec_b)
    spec_c = FeatureSpec.for_arena(DEFAULT_ARENA, scale=False)
    assert make_feature_fn(spec_a) is not make_feature_fn(spec_c)


def test_process_views_hits_feature_fn_cache():
    import numpy as np

    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.ops.features import make_feature_fn, process_views

    make_feature_fn.cache_clear()
    a = DEFAULT_ARENA
    xz = np.zeros((2,) + a.xz_shape, np.float32)
    yz = np.zeros((2,) + a.yz_shape, np.float32)
    xy = np.zeros((2,) + a.xy_shape, np.float32)
    process_views(xz, yz, xy, device=False)
    process_views(xz, yz, xy, device=False)
    info = make_feature_fn.cache_info()
    assert info.misses == 1 and info.hits >= 1
