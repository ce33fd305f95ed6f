"""AOT serving artifacts: export → file → load → bit parity."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from radarml_tpu.core.arena import DEFAULT_ARENA
from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
from radarml_tpu.models.pipeline import RadarPredictor, pad_targets
from radarml_tpu.serving import export_predictor, load_serving_artifact


@pytest.fixture(scope="module")
def predictor():
    rng = np.random.default_rng(0)
    C, F = 3, DEFAULT_ARENA.feature_length
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(C, F)) * 0.01, jnp.float32),
        intercept=jnp.zeros((C,), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((C,), jnp.float32), b=jnp.zeros((C,), jnp.float32)
    )
    return RadarPredictor(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=model, calibration=calib, mode="fast", cube_dtype="uint8",
    )


def test_export_roundtrip_bit_parity_and_symbolic_batch(tmp_path, predictor):
    path = str(tmp_path / "serving.rmlx")
    meta = export_predictor(predictor, path, max_targets=4)
    assert meta["format"].startswith("radarml_tpu.serving_export")

    art = load_serving_artifact(path)
    assert art.cube_dtype == "uint8"
    assert art.max_targets == 4

    rng = np.random.default_rng(1)
    # Two different batch sizes through ONE artifact (symbolic batch).
    for B in (2, 7):
        cubes = np.rint(
            rng.random((B,) + DEFAULT_ARENA.grid_shape) * 255
        ).astype(np.float32)
        xyz, valid = pad_targets(
            [[(5.0, 5.0, 100.0 + 3 * b)] for b in range(B)], max_targets=4
        )
        pred_live = predictor(cubes, xyz, valid)
        pred_art = art(cubes, xyz, valid)
        np.testing.assert_array_equal(
            np.asarray(pred_live[0]), np.asarray(pred_art[0])
        )
        np.testing.assert_allclose(
            np.asarray(pred_live[2]), np.asarray(pred_art[2]), atol=1e-6
        )


def test_v2_container_is_pickle_free_and_v1_still_loads(tmp_path, predictor):
    """v3 = MAGIC + JSON line (with the program's signature) + the
    portable StableHLO bytes (no unpickler, no flatbuffers on load); the
    v2 container (jax.export's own serialization) and the legacy v1
    pickle container keep loading."""
    import json
    import pickle

    from radarml_tpu.serving.export import (
        FORMAT_V1,
        FORMAT_V2,
        MAGIC,
        _exported,
    )

    path = str(tmp_path / "serving.rmlx")
    export_predictor(predictor, path, max_targets=4)
    raw = open(path, "rb").read()
    assert raw.startswith(MAGIC)
    head, _, blob = raw[len(MAGIC):].partition(b"\n")
    meta = json.loads(head.decode("utf-8"))  # header is plain JSON
    assert meta["format"].endswith(".v3")
    assert meta["exported"]["platforms"] == meta["platforms"]
    # jax.export's serializer accepts the rebuilt program unchanged
    blob = _exported(meta.pop("exported"), blob).serialize()
    v2 = tmp_path / "serving_v2.rmlx"
    with open(v2, "wb") as fp:
        fp.write(MAGIC + json.dumps({**meta, "format": FORMAT_V2}).encode()
                 + b"\n" + blob)

    # Re-wrap the same program as a legacy v1 pickle artifact: loading
    # it requires an explicit opt-in (the unpickler runs), and the
    # default refuses.
    v1 = tmp_path / "serving_v1.pickle"
    with open(v1, "wb") as fp:
        pickle.dump({**meta, "format": FORMAT_V1, "blob": blob}, fp)
    with pytest.raises(ValueError, match="allow_v1_pickle"):
        load_serving_artifact(str(v1))
    art = load_serving_artifact(str(v1), allow_v1_pickle=True)

    rng = np.random.default_rng(2)
    cubes = np.rint(
        rng.random((3,) + DEFAULT_ARENA.grid_shape) * 255
    ).astype(np.float32)
    xyz, valid = pad_targets([[(5.0, 5.0, 100.0)]] * 3, max_targets=4)
    np.testing.assert_array_equal(
        np.asarray(load_serving_artifact(path)(cubes, xyz, valid)[0]),
        np.asarray(art(cubes, xyz, valid)[0]),
    )
    np.testing.assert_array_equal(
        np.asarray(load_serving_artifact(str(v2))(cubes, xyz, valid)[0]),
        np.asarray(art(cubes, xyz, valid)[0]),
    )


def test_load_rejects_non_artifact(tmp_path):
    bogus = tmp_path / "bogus.pickle"
    import pickle

    with open(bogus, "wb") as fp:
        pickle.dump({"format": "something_else"}, fp)
    with pytest.raises(ValueError):
        load_serving_artifact(str(bogus))


def test_serve_cli_export_and_artifact_serving(tmp_path, predictor):
    """The serve CLI exports an artifact and serves from it."""
    import pickle

    from radarml_tpu.apps import serve as serve_app
    from radarml_tpu.apps.common_cli import save_label_encoder, save_model
    from radarml_tpu.data.labels import LabelEncoder

    model_path = str(tmp_path / "svm.pickle")
    le_path = str(tmp_path / "le.pickle")
    save_model(
        model_path, "linear",
        coef=np.asarray(predictor.model.coef),
        intercept=np.asarray(predictor.model.intercept),
        calib_a=np.asarray(predictor.calibration.a),
        calib_b=np.asarray(predictor.calibration.b),
        classes=["cat", "dog", "person"],
    )
    save_label_encoder(
        le_path, LabelEncoder(classes_=["cat", "dog", "person"])
    )
    art_path = str(tmp_path / "serving.rmlx")
    out = serve_app.main([
        "--svm_model", model_path, "--label_encoder", le_path,
        "--cube_dtype", "uint8", "--export_serving", art_path,
    ])
    assert out == {"exported": art_path}

    stats = serve_app.main([
        "--label_encoder", le_path, "--serving_artifact", art_path,
        "--duration", "1.5", "--scan_period", "0.02", "--max_batch", "8",
    ])
    assert stats["processed"] > 0


def test_cuda_and_cpu_export_serves_on_cpu(tmp_path, predictor):
    """The serve CLI's non-fused export lowers for ("cuda", "cpu"): one
    artifact serves on the GPU and, here, on the CPU, bit-identically
    to the live predictor."""
    path = str(tmp_path / "cuda_cpu.rmlx")
    meta = export_predictor(predictor, path, max_targets=4,
                            platforms=("cuda", "cpu"))
    assert meta["platforms"] == ["cuda", "cpu"]
    art = load_serving_artifact(path)
    assert art.platforms == ("cuda", "cpu")

    rng = np.random.default_rng(5)
    cubes = np.rint(
        rng.random((3,) + DEFAULT_ARENA.grid_shape) * 255
    ).astype(np.float32)
    xyz, valid = pad_targets(
        [[(1.0 * b, -2.0, 90.0 + 3 * b)] for b in range(3)], max_targets=4
    )
    want = predictor(cubes, jnp.asarray(xyz), jnp.asarray(valid))
    got = art(cubes, xyz, valid)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g))


def test_int8_artifact_roundtrip_and_encode_host(tmp_path, predictor):
    """An int8-stream export serves canonical f32/u8 cubes correctly:
    __call__ applies the value-128 wire encoding (a straight int8 cast
    of 0..255 would overflow) and encode_host narrows on host."""
    p_i8 = RadarPredictor(
        train_arena=predictor.train_arena, scan_arena=predictor.scan_arena,
        model=predictor.model, calibration=predictor.calibration,
        mode="fast", cube_dtype="int8", min_proba=predictor.min_proba,
    )
    path = str(tmp_path / "serving_i8.rmlx")
    export_predictor(p_i8, path, max_targets=4)
    art = load_serving_artifact(path)
    assert art.cube_dtype == "int8"

    rng = np.random.default_rng(2)
    B = 3
    cubes = np.rint(
        rng.random((B,) + DEFAULT_ARENA.grid_shape) * 255
    ).astype(np.float32)
    xyz, valid = pad_targets(
        [[(2.0 * b, -b, 95.0 + 4 * b)] for b in range(B)], max_targets=4
    )
    want = np.asarray(p_i8(cubes, xyz, valid)[2])
    for feed in (cubes, cubes.astype(np.uint8), art.encode_host(cubes)):
        got = np.asarray(art(feed, xyz, valid)[2])
        np.testing.assert_allclose(got, want, atol=1e-6)
    assert art.encode_host(cubes).dtype == np.int8


def test_fused_artifact_static_batch_roundtrip(tmp_path, predictor):
    """mode='fused' exports bake a static batch (the kernel's grid is
    the scan batch) and reproduce the live fused predictor bit-for-bit."""
    import dataclasses

    fused = dataclasses.replace(
        predictor, mode="fused", cube_dtype="float32", interpret=True
    )
    path = str(tmp_path / "fused.rmlx")
    with pytest.raises(ValueError, match="static batch"):
        export_predictor(fused, path, max_targets=3)
    meta = export_predictor(fused, path, max_targets=3, batch=4)
    assert meta["batch"] == 4

    art = load_serving_artifact(path)
    assert art.mode == "fused" and art.batch == 4

    rng = np.random.default_rng(2)
    cubes = np.rint(
        rng.random((4,) + DEFAULT_ARENA.grid_shape) * 255
    ).astype(np.float32)
    xyz, valid = pad_targets(
        [[(1.0, 2.0, 80.0)]] * 4, max_targets=3
    )
    want = fused(cubes, jnp.asarray(xyz), jnp.asarray(valid))
    got = art(cubes, xyz, valid)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g))

    # Smaller batches pad up to the baked shape inside the artifact
    # (the unary gRPC path and warmup run batch 1); larger ones raise.
    got1 = art(cubes[:1], xyz[:1], valid[:1])
    for w, g in zip(want, got1):
        np.testing.assert_array_equal(np.asarray(w)[:1], np.asarray(g))
    big = np.concatenate([cubes, cubes])
    xyz2 = np.concatenate([xyz, xyz])
    valid2 = np.concatenate([valid, valid])
    with pytest.raises(ValueError, match="chunks"):
        art(big, xyz2, valid2)


def test_exported_fields_match_the_v3_loader():
    """The v3 loader rebuilds jax.export.Exported field by field; a JAX
    upgrade that changes those fields must fail here, not in serving."""
    import dataclasses

    from jax import export as jexport

    from radarml_tpu.serving.export import _EXPORTED_FIELDS

    fields = tuple(f.name for f in dataclasses.fields(jexport.Exported))
    assert fields == _EXPORTED_FIELDS


@pytest.mark.parametrize("mode", ["fused", "fast"])
def test_artifact_versions_gate_kernel_artifacts(tmp_path, predictor, mode):
    """The metadata records the exporting jax/jaxlib. A fused artifact
    (a Triton custom call, no cross-version promise) refuses to load
    under other versions; a plain StableHLO artifact still loads."""
    import dataclasses
    import json

    import jaxlib

    from radarml_tpu.serving.export import MAGIC

    p = dataclasses.replace(predictor, mode=mode, interpret=mode == "fused")
    path = str(tmp_path / f"{mode}.rmlx")
    meta = export_predictor(p, path, max_targets=2, batch=2)
    assert meta["versions"] == {"jax": jax.__version__,
                                "jaxlib": jaxlib.__version__}
    assert bool(meta["exported"]["disabled_custom_calls"]) == (mode == "fused")
    load_serving_artifact(path)  # same versions: loads

    head, _, blob = open(path, "rb").read()[len(MAGIC):].partition(b"\n")
    other = {**json.loads(head), "versions": {"jax": "0.0.0",
                                              "jaxlib": "0.0.0"}}
    moved = tmp_path / f"{mode}_other.rmlx"
    moved.write_bytes(MAGIC + json.dumps(other).encode() + b"\n" + blob)
    if mode == "fused":
        with pytest.raises(ValueError, match="re-export"):
            load_serving_artifact(str(moved))
    else:
        assert load_serving_artifact(str(moved)).mode == "fast"
