"""Two-pass int8 kernel (ops/pallas_i8_score) + fused predictor mode.

The kernel is exact integer arithmetic (s8 inputs, s32 accumulation),
so parity with the fast int8 path is decision-identical by
construction; these tests run it in interpret mode on CPU against an
int64 numpy oracle and against mode="fast"/cube_dtype="int8". The
compiled Triton kernel runs only on the card: `test_kernel_on_card`
(marked gpu) skips here, and chip_smoke.py runs the same check there.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radarml_tpu.core.arena import DEFAULT_ARENA, ProjMask
from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
from radarml_tpu.models.pipeline import RadarPredictor
from radarml_tpu.ops import pallas_i8_score
from radarml_tpu.ops.pallas_i8_score import (
    build_table_weights,
    tables_i8,
)


def _templates(rng, X, Y, Z, C2):
    return [
        rng.integers(-127, 128, shape).astype(np.int8)
        for shape in ((C2, X, Z), (C2, Y, Z), (C2, X, Y))
    ]


def _oracle(q, cubes):
    """int64 einsums: (m1 (B,C2,Y), m2 (B,C2,X), m3 (B,C2,Z))."""
    v = np.asarray(cubes).astype(np.int64)
    return (
        np.einsum("cxz,bxyz->bcy", q[0].astype(np.int64), v),
        np.einsum("cyz,bxyz->bcx", q[1].astype(np.int64), v),
        np.einsum("cxy,bxyz->bcz", q[2].astype(np.int64), v),
    )


@pytest.mark.parametrize(
    "dims,C2,B",
    [
        ((5, 7, 9), 4, 3),        # everything below one tile
        ((4, 16, 32), 6, 2),      # Y and Z already powers of two
        ((6, 17, 33), 6, 4),      # Y, Z one past a power of two
        ((3, 35, 40), 6, 1),      # Y > 32: Yp = 64; batch 1
        ((2, 5, 200), 4, 2),      # Z > _Z_CHUNK: two z chunks
        ((9, 12, 130), 18, 2),    # C2 > 16: padded dot rows = 32
        ((22, 31, 176), 6, 1),    # the reference arena, batch 1
        ((22, 31, 176), 6, 3),    # the reference arena
        ((22, 31, 176), 2, 2),    # one class pair (C2 < 8)
    ],
)
def test_kernel_tables_match_int64_oracle(rng, dims, C2, B):
    X, Y, Z = dims
    q = _templates(rng, X, Y, Z, C2)
    w = build_table_weights([(t, None, None, None) for t in q], dims)
    cubes = rng.integers(-128, 128, (B,) + dims).astype(np.int8)
    got = tables_i8(jnp.asarray(cubes), w, interpret=True)
    for g, want in zip(got, _oracle(q, cubes)):
        assert g.dtype == jnp.int32 and g.shape == want.shape
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64), want)


@pytest.mark.parametrize("masked", [0, 1, 2])
def test_kernel_masked_plane_is_zero(rng, masked):
    """A masked plane (None) gets zero weights → an all-zero table; the
    other two stay exact."""
    dims = (5, 7, 9)
    q = _templates(rng, *dims, 4)
    quant = [None if i == masked else (t, None, None, None)
             for i, t in enumerate(q)]
    w = build_table_weights(quant, dims)
    cubes = rng.integers(-128, 128, (2,) + dims).astype(np.int8)
    got = tables_i8(jnp.asarray(cubes), w, interpret=True)
    for i, (g, want) in enumerate(zip(got, _oracle(q, cubes))):
        if i == masked:
            assert not np.asarray(g).any()
        else:
            np.testing.assert_array_equal(np.asarray(g), want)


def test_weight_layout_pads_to_triton_tiles(rng):
    """Reference arena: C2=6 pads to 16 dot rows, Y=31 to 32, Z=176 to
    the _Z_CHUNK multiple, the flat Y·Z axis to the _K_CHUNK multiple."""
    dims = (22, 31, 176)
    q = _templates(rng, *dims, 6)
    w = build_table_weights([(t, None, None, None) for t in q], dims)
    assert w.w1.shape == (22, 16, 256)
    assert w.w2.shape == (16, 11 * 512)  # 31·176 = 5456 → 5632
    assert w.w3.shape == (22, 16, 32)
    assert w.dims == (22, 31, 176, 6)
    # pads are zero, so padded rows and columns contribute nothing
    assert not np.asarray(w.w1)[:, 6:].any()
    assert not np.asarray(w.w1)[:, :, 176:].any()
    assert not np.asarray(w.w2)[:, 31 * 176:].any()
    assert not np.asarray(w.w3)[:, :, 31:].any()


def test_wrapper_rejects_bad_inputs(rng):
    dims = (5, 7, 9)
    q = _templates(rng, *dims, 4)
    quant = [(t, None, None, None) for t in q]
    w = build_table_weights(quant, dims)
    with pytest.raises(ValueError, match="int8"):
        tables_i8(jnp.zeros((1,) + dims, jnp.float32), w,
                          interpret=True)
    with pytest.raises(ValueError, match=r"\(B, 5, 7, 9\)"):
        tables_i8(jnp.zeros((1, 5, 7, 8), jnp.int8), w,
                          interpret=True)
    with pytest.raises(ValueError, match="plane"):
        build_table_weights([None, None, None], dims)


class _SpyCall:
    """Stands in for pl.pallas_call: records its keyword arguments and
    returns zero tables of the declared shapes."""

    def __init__(self):
        self.kwargs = None

    def __call__(self, kernel, **kwargs):
        self.kwargs = kwargs

        def run(*args):
            return tuple(jnp.zeros(s.shape, s.dtype)
                         for s in kwargs["out_shape"])

        return run


@pytest.fixture
def gpu_backend(monkeypatch):
    """A patched "gpu" backend with pallas_call replaced by a spy."""
    spy = _SpyCall()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(pallas_i8_score.pl, "pallas_call", spy)
    return spy


def test_gpu_call_names_triton_and_sets_no_interpret(rng, gpu_backend):
    dims = (5, 7, 9)
    q = _templates(rng, *dims, 4)
    w = build_table_weights([(t, None, None, None) for t in q], dims)
    tables_i8(jnp.zeros((2,) + dims, jnp.int8), w)
    kw = gpu_backend.kwargs
    assert kw["backend"] == "triton"
    assert kw["interpret"] is False
    assert kw["grid"] == (2,)
    assert kw["name"] == "radar_i8_tables"


def test_fused_predictor_never_derives_interpret(rng, gpu_backend):
    """A fused predictor built without interpret=True compiles the
    kernel for the GPU whatever the backend says — no hidden fallback
    to the interpreter."""
    fused = RadarPredictor(mode="fused", **_linear_fixture(rng))
    assert fused.interpret is False
    cubes, xyz, valid = _scan_fixture(rng, B=2, T=1)
    fused(cubes, xyz, valid)
    assert gpu_backend.kwargs["interpret"] is False
    assert gpu_backend.kwargs["backend"] == "triton"


@pytest.mark.gpu
def test_kernel_on_card(rng):
    """The compiled Triton kernel at the reference arena vs the oracle."""
    try:
        dev = jax.devices("cuda")[0]
    except RuntimeError:
        pytest.skip("no CUDA device (chip_smoke.py runs this on the card)")
    dims = DEFAULT_ARENA.grid_shape
    q = _templates(rng, *dims, 6)
    w = build_table_weights([(t, None, None, None) for t in q], dims)
    cubes = rng.integers(-128, 128, (64,) + dims).astype(np.int8)
    got = tables_i8(jax.device_put(cubes, dev), w)
    for g, want in zip(got, _oracle(q, cubes)):
        np.testing.assert_array_equal(np.asarray(g), want)


def _linear_fixture(rng, n_classes=3):
    F = DEFAULT_ARENA.feature_length
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(n_classes, F)) * 0.01, jnp.float32),
        intercept=jnp.asarray(rng.normal(size=(n_classes,)), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((n_classes,), jnp.float32),
        b=jnp.zeros((n_classes,), jnp.float32),
    )
    return dict(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=model, calibration=calib, min_proba=0.5,
    )


def _scan_fixture(rng, B=4, T=3):
    cubes = np.rint(
        rng.random((B,) + DEFAULT_ARENA.grid_shape) * 255
    ).astype(np.float32)
    xyz = jnp.asarray(rng.uniform(-30, 30, size=(B, T, 3)), jnp.float32)
    xyz = xyz.at[..., 2].set(jnp.abs(xyz[..., 2]) + 60.0)
    return cubes, xyz, jnp.ones((B, T), dtype=bool)


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("T", [1, 3, 5])
def test_fused_mode_matches_fast_int8(rng, B, T):
    """fused == fast+int8 decisions/probas (same quantized templates,
    both exact integer table arithmetic) over batch × targets."""
    kw = _linear_fixture(rng)
    fast = RadarPredictor(mode="fast", cube_dtype="int8", **kw)
    fused = RadarPredictor(mode="fused", interpret=True, **kw)
    assert fused.cube_dtype == "int8"
    cubes, xyz, valid = _scan_fixture(rng, B=B, T=T)
    valid = valid.at[0, -1].set(False)

    pf, bf, proba_f = fast(cubes, xyz, valid)
    pk, bk, proba_k = fused(cubes, xyz, valid)
    np.testing.assert_array_equal(np.asarray(pk), np.asarray(pf))
    np.testing.assert_allclose(
        np.asarray(proba_k), np.asarray(proba_f), atol=1e-6
    )
    assert proba_k.shape == proba_f.shape == (B, T, 3)
    assert int(pk[0, -1]) == -1  # invalid slot → UNKNOWN


@pytest.mark.parametrize(
    "mask",
    [ProjMask(True, False, True), ProjMask(False, True, True),
     ProjMask(True, True, False)],
)
def test_fused_mode_masked_plane(rng, mask):
    kw = _linear_fixture(rng)
    F = sum(
        s[0] * s[1]
        for s, keep in zip(
            (DEFAULT_ARENA.xz_shape, DEFAULT_ARENA.yz_shape,
             DEFAULT_ARENA.xy_shape),
            mask,
        )
        if keep
    )
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(3, F)) * 0.01, jnp.float32),
        intercept=jnp.zeros((3,), jnp.float32),
    )
    kw.update(model=model, calibration=None, proj_mask=mask)
    fast = RadarPredictor(mode="fast", cube_dtype="int8", **kw)
    fused = RadarPredictor(mode="fused", interpret=True, **kw)
    cubes, xyz, valid = _scan_fixture(rng)
    pf, _, proba_f = fast(cubes, xyz, valid)
    pk, _, proba_k = fused(cubes, xyz, valid)
    np.testing.assert_array_equal(np.asarray(pk), np.asarray(pf))
    np.testing.assert_allclose(
        np.asarray(proba_k), np.asarray(proba_f), atol=1e-6
    )


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_fused_mesh_matches_single_device(rng, n_dev):
    """Mesh-sharded fused scoring (shard_map around the kernel)
    reproduces the single-device fused path exactly."""
    kw = _linear_fixture(rng)
    mesh = jax.make_mesh((n_dev,), ("data",),
                         devices=jax.devices()[:n_dev])
    single = RadarPredictor(mode="fused", interpret=True, **kw)
    sharded = RadarPredictor(mode="fused", interpret=True, mesh=mesh, **kw)
    cubes, xyz, valid = _scan_fixture(rng, B=2 * n_dev, T=2)

    p1, b1, pr1 = single(cubes, xyz, valid)
    p2, b2, pr2 = sharded(cubes, xyz, valid)
    np.testing.assert_array_equal(np.asarray(p2), np.asarray(p1))
    np.testing.assert_array_equal(np.asarray(pr2), np.asarray(pr1))


def test_fused_mode_validation(rng):
    kw = _linear_fixture(rng)
    # every requested stream dtype resolves to the int8 stream (all
    # are lossless for 8-bit radar cubes) — the serve CLI's default
    # bfloat16 must not crash mode=fused
    for dt in ("uint8", "bfloat16", "float32"):
        assert RadarPredictor(
            mode="fused", cube_dtype=dt, **kw
        ).cube_dtype == "int8"
    from radarml_tpu.models.svc import SVCModel

    svc = SVCModel(
        support_vectors=jnp.zeros((2, 4)), dual_coef=jnp.zeros((1, 2)),
        intercept=jnp.zeros((1,)), n_support=(1, 1), kernel="rbf",
        gamma=0.1,
    )
    with pytest.raises(ValueError, match="linear"):
        RadarPredictor(**{**kw, "model": svc}, mode="fused")
