"""End-to-end predict pipeline vs a reference-formula host oracle."""

import numpy as np
from scipy import ndimage

from radarml_tpu.core.arena import DEFAULT_ARENA, RADAR_MAX, ProjMask
from radarml_tpu.data.synthetic import make_dataset, make_scan_batch
from radarml_tpu.data.labels import LabelEncoder
from radarml_tpu.ops.features import process_samples
from radarml_tpu.models.linear import (
    SGDConfig,
    calibrate_ovr,
    sgd_fit,
    sgd_model,
)
from radarml_tpu.models.pipeline import UNKNOWN, RadarPredictor, pad_targets


def ref_indices(a, x, y, z):
    r = np.sqrt(x**2 + y**2 + z**2)
    phi = np.rad2deg(np.arctan2(y, z))
    theta = np.rad2deg(np.arcsin(x / r))
    i = int((theta - a.theta_min) * (a.size_x - 1) / (a.theta_max - a.theta_min))
    j = int((phi - a.phi_min) * (a.size_y - 1) / (a.phi_max - a.phi_min))
    k = int((r - a.r_min) * (a.size_z - 1) / (a.r_max - a.r_min))
    return i, j, k


def train_demo_model():
    samples, labels = make_dataset(150, seed=11)
    le, y = LabelEncoder.fit_transform(labels)
    X = process_samples(samples, scale=True).astype(np.float32)
    cfg = SGDConfig(alpha=1e-5)
    state = sgd_fit(X[:120], y[:120], n_classes=len(le.classes_), cfg=cfg, epochs=30)
    model = sgd_model(state, cfg)
    calib = calibrate_ovr(model, X[120:], y[120:])
    return model, calib, le


def test_predictor_classifies_planted_targets():
    model, calib, le = train_demo_model()
    predictor = RadarPredictor(
        train_arena=DEFAULT_ARENA,
        scan_arena=DEFAULT_ARENA,
        model=model,
        calibration=calib,
        min_proba=0.5,
    )
    cubes, targets = make_scan_batch(16, seed=77)
    xyz, valid = pad_targets([[(t.x, t.y, t.z)] for t in targets], max_targets=4)
    pred, best_p, proba = predictor(cubes, xyz, valid)
    pred = np.asarray(pred)
    best_p = np.asarray(best_p)
    # Padded slots must be UNKNOWN.
    assert (pred[:, 1:] == UNKNOWN).all()
    want = np.array([list(le.classes_).index(t.label) for t in targets])
    got = pred[:, 0]
    known = got != UNKNOWN
    acc = float((got[known] == want[known]).mean())
    assert known.mean() > 0.5
    assert acc > 0.7, (got, want)


def test_predictor_feature_path_matches_host_oracle():
    """The sliced+zoomed+scaled features inside the predictor must equal
    the reference pipeline's process_samples(scale=True) on host-sliced
    projections (predict.py:98-116)."""
    model, calib, le = train_demo_model()
    a = DEFAULT_ARENA
    predictor = RadarPredictor(
        train_arena=a, scan_arena=a, model=model, calibration=calib, min_proba=0.0
    )
    cubes, targets = make_scan_batch(4, seed=5)
    # Jitter targets off exact grid nodes: a position that lands on a
    # cell boundary is discretization-ambiguous between float32 (device)
    # and float64 (oracle) index math, which is not a real parity gap.
    jit_rng = np.random.default_rng(0)
    jittered = [
        (t.x + jit_rng.uniform(0.5, 1.5), t.y + jit_rng.uniform(0.5, 1.5),
         t.z + jit_rng.uniform(0.5, 1.5))
        for t in targets
    ]
    xyz, valid = pad_targets([[p] for p in jittered], max_targets=1)
    _, _, proba = predictor(cubes, xyz, valid)

    # Host oracle per scan.
    import jax.numpy as jnp
    from radarml_tpu.models.linear import predict_proba_calibrated

    for b, p in enumerate(jittered):
        i, j, k = ref_indices(a, *p)
        yz = cubes[b, i, :, :]
        xz = cubes[b, :, j, :]
        xy = cubes[b, :, :, k]
        feats = process_samples([(xz, yz, xy)], scale=True)
        want = np.asarray(
            predict_proba_calibrated(model, calib, jnp.asarray(feats))
        )[0]
        got = np.asarray(proba)[b, 0]
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_predictor_proj_mask_subset():
    samples, labels = make_dataset(60, seed=2)
    le, y = LabelEncoder.fit_transform(labels)
    mask = ProjMask(xz=True, yz=False, xy=True)
    X = process_samples(samples, proj_mask=mask, scale=True).astype(np.float32)
    cfg = SGDConfig(alpha=1e-5)
    state = sgd_fit(X, y, n_classes=3, cfg=cfg, epochs=20)
    model = sgd_model(state, cfg)
    predictor = RadarPredictor(
        train_arena=DEFAULT_ARENA,
        scan_arena=DEFAULT_ARENA,
        model=model,
        proj_mask=mask,
        min_proba=0.0,
    )
    cubes, targets = make_scan_batch(4, seed=6)
    xyz, valid = pad_targets([[(t.x, t.y, t.z)] for t in targets], max_targets=1)
    pred, _, _ = predictor(cubes, xyz, valid)
    assert np.asarray(pred).shape == (4, 1)


def test_fast_folded_mode_matches_exact(rng):
    """The folded-template path is algebraically identical to the
    exact path; decisions agree to float tolerance and predictions
    (argmax + threshold) agree exactly on non-marginal probabilities."""
    import jax.numpy as jnp

    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
    from radarml_tpu.models.pipeline import RadarPredictor

    n_classes = 3
    F = DEFAULT_ARENA.feature_length
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(n_classes, F)) * 0.01, jnp.float32),
        intercept=jnp.asarray(rng.normal(size=(n_classes,)), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((n_classes,), jnp.float32),
        b=jnp.zeros((n_classes,), jnp.float32),
    )
    kw = dict(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=model, calibration=calib, min_proba=0.5,
    )
    exact = RadarPredictor(mode="exact", **kw)
    fast = RadarPredictor(mode="fast", **kw)

    B, T = 4, 3
    cubes = jnp.asarray(
        rng.random((B,) + DEFAULT_ARENA.grid_shape) * 255, jnp.float32
    )
    xyz = jnp.asarray(rng.uniform(-30, 30, size=(B, T, 3)), jnp.float32)
    xyz = xyz.at[..., 2].set(jnp.abs(xyz[..., 2]) + 60.0)
    valid = jnp.asarray(rng.random((B, T)) > 0.3)

    pe, pbe, proba_e = exact(cubes, xyz, valid)
    pf, pbf, proba_f = fast(cubes, xyz, valid)
    import numpy as np

    np.testing.assert_allclose(
        np.asarray(proba_f), np.asarray(proba_e), atol=2e-4
    )
    np.testing.assert_array_equal(np.asarray(pf), np.asarray(pe))


def test_fast_bfloat16_matches_exact(rng):
    """fast mode over a bfloat16 stream == exact path.

    Cubes are integer-valued like the real sensor's 8-bit raw image
    (reference predict.py:90-91), which bfloat16 holds exactly.
    """
    import jax.numpy as jnp
    import numpy as np

    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
    from radarml_tpu.models.pipeline import RadarPredictor

    n_classes = 3
    F = DEFAULT_ARENA.feature_length
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(n_classes, F)) * 0.01, jnp.float32),
        intercept=jnp.asarray(rng.normal(size=(n_classes,)), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((n_classes,), jnp.float32),
        b=jnp.zeros((n_classes,), jnp.float32),
    )
    kw = dict(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=model, calibration=calib, min_proba=0.5,
    )
    exact = RadarPredictor(mode="exact", **kw)
    fast = RadarPredictor(mode="fast", cube_dtype="bfloat16", **kw)

    B, T = 3, 2
    cubes = jnp.asarray(
        np.rint(rng.random((B,) + DEFAULT_ARENA.grid_shape) * 255),
        jnp.float32,
    )
    xyz = jnp.asarray(rng.uniform(-30, 30, size=(B, T, 3)), jnp.float32)
    xyz = xyz.at[..., 2].set(jnp.abs(xyz[..., 2]) + 60.0)
    valid = jnp.ones((B, T), dtype=bool)

    pe, _, proba_e = exact(cubes, xyz, valid)
    pp, _, proba_p = fast(cubes, xyz, valid)
    np.testing.assert_allclose(
        np.asarray(proba_p), np.asarray(proba_e), atol=2e-4
    )
    np.testing.assert_array_equal(np.asarray(pp), np.asarray(pe))


def test_fast_bf16_ingest_matches_f32(rng):
    """bf16 scan ingest (lossless for 8-bit radar data) == f32 fast path."""
    import jax.numpy as jnp
    import numpy as np

    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
    from radarml_tpu.models.pipeline import RadarPredictor

    n_classes = 3
    F = DEFAULT_ARENA.feature_length
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(n_classes, F)) * 0.01, jnp.float32),
        intercept=jnp.asarray(rng.normal(size=(n_classes,)), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((n_classes,), jnp.float32),
        b=jnp.zeros((n_classes,), jnp.float32),
    )
    kw = dict(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=model, calibration=calib, min_proba=0.5,
    )
    f32 = RadarPredictor(mode="fast", **kw)
    bf16 = RadarPredictor(mode="fast", cube_dtype="bfloat16", **kw)

    B, T = 4, 3
    cubes = np.rint(rng.random((B,) + DEFAULT_ARENA.grid_shape) * 255).astype(
        np.float32
    )
    xyz = jnp.asarray(rng.uniform(-30, 30, size=(B, T, 3)), jnp.float32)
    xyz = xyz.at[..., 2].set(jnp.abs(xyz[..., 2]) + 60.0)
    valid = jnp.ones((B, T), dtype=bool)

    pf, _, proba_f = f32(cubes, xyz, valid)
    pb, _, proba_b = bf16(cubes, xyz, valid)
    # The f32 cast fuses after a lossless bf16 read: same math.
    np.testing.assert_allclose(
        np.asarray(proba_b), np.asarray(proba_f), atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(pb), np.asarray(pf))


def test_fast_uint8_ingest_matches_f32(rng):
    """uint8 scan ingest (lossless for integer 0..255 radar data) ==
    f32 fast path; the removed "pallas" mode is an unknown mode."""
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
    from radarml_tpu.models.pipeline import RadarPredictor

    n_classes = 3
    F = DEFAULT_ARENA.feature_length
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(n_classes, F)) * 0.01, jnp.float32),
        intercept=jnp.asarray(rng.normal(size=(n_classes,)), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((n_classes,), jnp.float32),
        b=jnp.zeros((n_classes,), jnp.float32),
    )
    kw = dict(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=model, calibration=calib, min_proba=0.5,
    )
    f32 = RadarPredictor(mode="fast", **kw)
    u8 = RadarPredictor(mode="fast", cube_dtype="uint8", **kw)
    with pytest.raises(ValueError, match="unknown mode"):
        RadarPredictor(mode="pallas", cube_dtype="uint8", **kw)

    B, T = 4, 3
    cubes = np.rint(rng.random((B,) + DEFAULT_ARENA.grid_shape) * 255).astype(
        np.float32
    )
    xyz = jnp.asarray(rng.uniform(-30, 30, size=(B, T, 3)), jnp.float32)
    xyz = xyz.at[..., 2].set(jnp.abs(xyz[..., 2]) + 60.0)
    valid = jnp.ones((B, T), dtype=bool)

    pf, _, proba_f = f32(cubes, xyz, valid)
    pu, _, proba_u = u8(cubes, xyz, valid)
    np.testing.assert_allclose(
        np.asarray(proba_u), np.asarray(proba_f), atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(pu), np.asarray(pf))


def test_cross_arena_zoom_exact_fast_parity_and_oracle():
    """A scan arena coarser than the training arena flows through the
    predictor with per-plane zoom (reference calc_proj_zoom,
    predict.py:34-54): exact and fast modes agree with each other and
    with the host-side process_samples oracle."""
    import jax.numpy as jnp
    import numpy as np

    from radarml_tpu.core.arena import Arena, DEFAULT_ARENA
    from radarml_tpu.models.linear import (
        LinearModel,
        SigmoidCalibration,
        predict_proba_calibrated,
    )
    from radarml_tpu.models.pipeline import RadarPredictor, pad_targets
    from radarml_tpu.ops.features import predict_zoom, process_samples

    rng = np.random.default_rng(11)
    train = DEFAULT_ARENA
    scan = Arena(r_res=5.0, theta_res=6.0, phi_res=3.0)  # 15x21x70 cube
    assert scan.grid_shape != train.grid_shape

    C = 3
    model = LinearModel(
        coef=jnp.asarray(
            rng.normal(size=(C, train.feature_length)) * 0.01, jnp.float32
        ),
        intercept=jnp.zeros((C,), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((C,), jnp.float32), b=jnp.zeros((C,), jnp.float32)
    )
    kw = dict(train_arena=train, scan_arena=scan, model=model,
              calibration=calib, min_proba=0.0)
    exact = RadarPredictor(mode="exact", **kw)
    fast = RadarPredictor(mode="fast", **kw)

    cubes = np.rint(
        rng.random((3,) + scan.grid_shape) * 255
    ).astype(np.float32)
    pts = [(4.3, 3.7, 95.2), (-8.1, 2.2, 140.6), (0.6, -5.9, 210.3)]
    xyz, valid = pad_targets([[p] for p in pts], max_targets=1)

    _, _, proba_e = exact(cubes, xyz, valid)
    _, _, proba_f = fast(cubes, xyz, valid)
    np.testing.assert_allclose(
        np.asarray(proba_e), np.asarray(proba_f), atol=2e-5
    )

    # Host oracle: slice at clamped indices, zoom into the training
    # arena via predict_zoom factors, score, calibrate.
    zoom = predict_zoom(train, scan)
    for b, (x, y, z) in enumerate(pts):
        i, j, k = (
            int(np.asarray(v))
            for v in scan.clamped_matrix_indices(
                jnp.float32(x), jnp.float32(y), jnp.float32(z)
            )
        )
        sample = (cubes[b][:, j, :], cubes[b][i, :, :], cubes[b][:, :, k])
        feats = process_samples([sample], proj_zoom=zoom, scale=True)
        assert feats.shape[1] == train.feature_length
        want = np.asarray(
            predict_proba_calibrated(model, calib, jnp.asarray(feats))
        )[0]
        np.testing.assert_allclose(
            np.asarray(proba_e)[b, 0], want, atol=2e-5
        )


def test_higher_resolution_arena_scales_through_fast_mode():
    """The scaling axis of this problem is arena resolution (SURVEY §5):
    a 2x-finer range axis flows through the folded fast path with no
    code changes."""
    import jax.numpy as jnp
    import numpy as np

    from radarml_tpu.core.arena import Arena
    from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
    from radarml_tpu.models.pipeline import RadarPredictor, pad_targets

    rng = np.random.default_rng(12)
    hi = Arena(r_res=1.0)  # 22x31x350 cube, feature length 22*350+31*350+22*31
    C = 3
    model = LinearModel(
        coef=jnp.asarray(
            rng.normal(size=(C, hi.feature_length)) * 0.01, jnp.float32
        ),
        intercept=jnp.zeros((C,), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((C,), jnp.float32), b=jnp.zeros((C,), jnp.float32)
    )
    predictor = RadarPredictor(
        train_arena=hi, scan_arena=hi, model=model, calibration=calib,
        min_proba=0.0, mode="fast", cube_dtype="uint8",
    )
    cubes = np.rint(rng.random((2,) + hi.grid_shape) * 255).astype(np.float32)
    xyz, valid = pad_targets([[(1.0, 1.0, 100.0)], [(0.0, 2.0, 250.0)]], 2)
    pred, best_p, proba = predictor(cubes, xyz, valid)
    assert proba.shape == (2, 2, C)
    assert np.all(np.isfinite(np.asarray(proba)))


def test_fast_mode_with_masked_projection_matches_exact(rng):
    """The folded templates honor a partial ProjMask (reference
    --proj_mask, train.py:584-588): masked fast == masked exact."""
    import jax.numpy as jnp

    from radarml_tpu.core.arena import DEFAULT_ARENA, ProjMask
    from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
    from radarml_tpu.models.pipeline import RadarPredictor, pad_targets
    from radarml_tpu.ops.features import FeatureSpec

    mask = ProjMask(xz=True, yz=False, xy=True)
    F = FeatureSpec.for_arena(DEFAULT_ARENA, proj_mask=mask).feature_length
    n_classes = 3
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(n_classes, F)) * 0.01, jnp.float32),
        intercept=jnp.asarray(rng.normal(size=(n_classes,)), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((n_classes,), jnp.float32),
        b=jnp.zeros((n_classes,), jnp.float32),
    )
    kw = dict(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=model, calibration=calib, proj_mask=mask, min_proba=0.0,
    )
    exact = RadarPredictor(mode="exact", **kw)
    fast = RadarPredictor(mode="fast", **kw)

    cubes = np.rint(
        rng.random((3,) + DEFAULT_ARENA.grid_shape) * 255
    ).astype(np.float32)
    xyz, valid = pad_targets(
        [[(2.2, 1.1, 95.0)], [(-7.3, 0.4, 150.0)], [(0.0, 3.3, 220.0)]],
        max_targets=2,
    )
    _, _, pe = exact(cubes, xyz, valid)
    _, _, pf = fast(cubes, xyz, valid)
    np.testing.assert_allclose(np.asarray(pe), np.asarray(pf), atol=2e-5)


def test_fast_int8_quantized_ingest_matches_f32(rng):
    """int8 wire format (value-128, lossless for 0..255 radar data)
    scored by error-compensated s8xs8->s32 quantized templates ==
    f32 fast path to ~1e-4 proba; uint8/float32/int8 inputs all encode
    to the identical device stream."""
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
    from radarml_tpu.models.pipeline import RadarPredictor, encode_int8_cubes

    n_classes = 3
    F = DEFAULT_ARENA.feature_length
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(n_classes, F)) * 0.01, jnp.float32),
        intercept=jnp.asarray(rng.normal(size=(n_classes,)), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((n_classes,), jnp.float32),
        b=jnp.zeros((n_classes,), jnp.float32),
    )
    kw = dict(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=model, calibration=calib, min_proba=0.5,
    )
    f32 = RadarPredictor(mode="fast", **kw)
    i8 = RadarPredictor(mode="fast", cube_dtype="int8", **kw)
    with pytest.raises(ValueError, match="unknown mode"):
        RadarPredictor(mode="pallas", cube_dtype="int8", **kw)

    B, T = 4, 3
    cubes = np.rint(rng.random((B,) + DEFAULT_ARENA.grid_shape) * 255).astype(
        np.float32
    )
    xyz = jnp.asarray(rng.uniform(-30, 30, size=(B, T, 3)), jnp.float32)
    xyz = xyz.at[..., 2].set(jnp.abs(xyz[..., 2]) + 60.0)
    valid = jnp.ones((B, T), dtype=bool)

    pf, _, proba_f = f32(cubes, xyz, valid)
    pi, _, proba_i = i8(cubes, xyz, valid)
    np.testing.assert_allclose(
        np.asarray(proba_i), np.asarray(proba_f), atol=2e-4
    )
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(pf))

    # Encoding equivalence across input dtypes (u8 path is a zero-copy
    # xor reinterpret; already-int8 passes through untouched).
    enc_f = np.asarray(encode_int8_cubes(cubes))
    enc_u = np.asarray(encode_int8_cubes(cubes.astype(np.uint8)))
    enc_i = np.asarray(encode_int8_cubes(enc_f))
    np.testing.assert_array_equal(enc_f, enc_u)
    np.testing.assert_array_equal(enc_f, enc_i)
    assert enc_f.dtype == np.int8


def test_int8_ingest_exact_and_neural_modes_decode(rng):
    """exact mode and the neural serving path both decode the int8
    wire shift, matching their f32 results bit-for-bit."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.models.linear import LinearModel
    from radarml_tpu.models.pipeline import NeuralClassifier, RadarPredictor

    n_classes = 3
    F = DEFAULT_ARENA.feature_length
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(n_classes, F)) * 0.01, jnp.float32),
        intercept=jnp.zeros((n_classes,), jnp.float32),
    )
    B, T = 2, 2
    cubes = np.rint(rng.random((B,) + DEFAULT_ARENA.grid_shape) * 255).astype(
        np.float32
    )
    xyz = jnp.asarray(rng.uniform(-20, 20, size=(B, T, 3)), jnp.float32)
    xyz = xyz.at[..., 2].set(jnp.abs(xyz[..., 2]) + 60.0)
    valid = jnp.ones((B, T), dtype=bool)

    kw = dict(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
              model=model, min_proba=0.0)
    for mode in ("exact",):
        a = RadarPredictor(mode=mode, **kw)
        b = RadarPredictor(mode=mode, cube_dtype="int8", **kw)
        _, _, pa = a(cubes, xyz, valid)
        _, _, pb = b(cubes, xyz, valid)
        np.testing.assert_allclose(
            np.asarray(pb), np.asarray(pa), atol=1e-6
        )

    w = jnp.asarray(rng.normal(size=(10 * 10 * 3, n_classes)) * 0.1,
                    jnp.float32)
    nc = NeuralClassifier(
        apply=lambda v: v.reshape(v.shape[0], -1) @ w,
        rescale=(10, 10), n_classes=n_classes,
    )
    kn = dict(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
              model=nc, min_proba=0.0)
    a = RadarPredictor(**kn)
    b = RadarPredictor(cube_dtype="int8", **kn)
    _, _, pa = a(cubes, xyz, valid)
    _, _, pb = b(cubes, xyz, valid)
    np.testing.assert_allclose(np.asarray(pb), np.asarray(pa), atol=1e-5)


def test_unknown_mode_is_rejected():
    """Removed or misspelled modes fail loudly instead of silently
    building the exact path."""
    import jax.numpy as jnp
    import pytest

    from radarml_tpu.models.linear import LinearModel

    F = DEFAULT_ARENA.feature_length
    model = LinearModel(coef=jnp.zeros((3, F)), intercept=jnp.zeros((3,)))
    for mode in ("pallas", "Fast", ""):
        with pytest.raises(ValueError, match="unknown mode"):
            RadarPredictor(train_arena=DEFAULT_ARENA,
                           scan_arena=DEFAULT_ARENA, model=model, mode=mode)
