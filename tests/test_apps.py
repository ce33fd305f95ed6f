"""CLI apps: train → predict → capture → visualize, hardware-free."""

import os
import pickle

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("apps")
    cwd = os.getcwd()
    os.chdir(d)
    yield d
    os.chdir(cwd)


@pytest.fixture(scope="module")
def trained(workdir):
    from radarml_tpu.apps import train as train_app

    out = train_app.main(
        [
            "--synthetic", "45",
            "--datasets", "ds.pickle",
            "--grid_epochs", "8",
            "--folds", "3",
        ]
    )
    return out


def test_train_app_artifacts(workdir, trained):
    assert os.path.exists("train-results/svm_radar_classifier.pickle")
    assert os.path.exists("train-results/radar_labels.pickle")
    assert os.path.exists("train-results/svm_cm.png")
    assert os.path.exists("train-results/train.log")
    with open("train-results/svm_radar_classifier.pickle", "rb") as fp:
        obj = pickle.load(fp)
    assert obj["format"] == "radarml_tpu.v1" and obj["kind"] == "linear"
    assert 0.0 <= trained["metrics"]["accuracy"] <= 1.0


def test_predict_app_runs(workdir, trained):
    from radarml_tpu.apps import predict as predict_app

    results = predict_app.main(
        ["--num_scans", "4", "--min_proba", "0.0", "--logging_level", "info"]
    )
    assert results  # at least one target classified
    names = {n for n, _ in results}
    assert names <= {"person", "dog", "cat", "Unknown"}
    for _, p in results:
        assert 0.0 <= p <= 1.0


def test_predict_app_fused_mode(workdir, trained, interpret_fused):
    """--mode fused drives the two-pass int8 kernel end-to-end
    (interpret mode on CPU) through the CLI batch loop."""
    from radarml_tpu.apps import predict as predict_app

    results = predict_app.main(
        ["--num_scans", "4", "--batch_scans", "2", "--mode", "fused",
         "--min_proba", "0.0"]
    )
    assert results
    names = {n for n, _ in results}
    assert names <= {"person", "dog", "cat", "Unknown"}


def test_capture_and_visualize_apps(workdir):
    from radarml_tpu.apps import ground_truth_samples as gts_app
    from radarml_tpu.apps import visualize as vis_app

    n = gts_app.main(
        [
            "--num_samples", "3",
            "--max_scans", "30",
            "--dataset", "captured.pickle",
        ]
    )
    assert n == 3
    with open("captured.pickle", "rb") as fp:
        data = pickle.load(fp)
    assert len(data["labels"]) == 3

    # append semantics: capturing again grows the same pickle
    n2 = gts_app.main(
        [
            "--num_samples", "2",
            "--max_scans", "30",
            "--dataset", "captured.pickle",
            "--driver_seed", "7",
        ]
    )
    with open("captured.pickle", "rb") as fp:
        data = pickle.load(fp)
    assert len(data["labels"]) == 3 + n2

    vis_app.main(["--dataset", "captured.pickle", "--out_png", "s.png"])
    assert os.path.getsize("s.png") > 10_000


def test_model_artifact_round_trip_svc(workdir):
    """SVC-kind artifacts load back into a scoring model."""
    from radarml_tpu.apps.common_cli import load_model, save_model
    from radarml_tpu.models import svc as jsvc

    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 8)).astype(np.float32)
    y = np.arange(60) % 2
    X[y == 1] += 2.0
    model = jsvc.svc_fit(
        X, y, jsvc.SVCConfig(C=1.0, gamma=0.1, probability=True)
    )
    save_model(
        "svc.pickle", "svc",
        support_vectors=np.asarray(model.support_vectors),
        dual_coef=np.asarray(model.dual_coef),
        intercept=np.asarray(model.intercept),
        n_support=list(model.n_support),
        kernel=model.kernel, gamma=model.gamma,
        probA=np.asarray(model.probA), probB=np.asarray(model.probB),
        classes=["a", "b"],
    )
    loaded, calib = load_model("svc.pickle")
    assert calib is None
    np.testing.assert_allclose(
        np.asarray(jsvc.predict_proba(loaded, X[:5])),
        np.asarray(jsvc.predict_proba(model, X[:5])),
        atol=1e-6,
    )


def test_train_app_online_learning_continues_model(workdir, trained):
    """--online_learn loads the saved model and continues fitting
    without overwriting the label encoder (reference train.py:409-416,
    733-737)."""
    import time

    from radarml_tpu.apps import train as train_app

    le_mtime = os.path.getmtime("train-results/radar_labels.pickle")
    time.sleep(0.05)
    out = train_app.main(
        [
            "--online_learn",
            "--datasets", "ds.pickle",
            "--grid_epochs", "3",
            "--folds", "3",
        ]
    )
    assert out["kind"] == "linear"
    # label encoder untouched after online learning
    assert os.path.getmtime("train-results/radar_labels.pickle") == le_mtime
    # model artifact refreshed
    with open("train-results/svm_radar_classifier.pickle", "rb") as fp:
        obj = pickle.load(fp)
    assert obj["kind"] == "linear"


def test_train_app_augment_epochs(workdir):
    from radarml_tpu.apps import train as train_app

    out = train_app.main(
        [
            "--synthetic", "30",
            "--datasets", "ds_aug.pickle",
            "--grid_epochs", "3",
            "--folds", "3",
            "--epochs", "1",
        ]
    )
    assert out["kind"] == "linear"
    assert 0.0 <= out["metrics"]["accuracy"] <= 1.0


def test_train_app_save_augmented_dumps_reference_schema(workdir):
    """--save_augmented writes batch_{epoch}_{pos}.pickle files with the
    reference DataGenerator.flow schema (train.py:58-67, 209-212):
    {'x_batch': [(xz, yz, xy), ...] in [0, 1], 'y_batch': labels}."""
    from radarml_tpu.apps import train as train_app

    train_app.main(
        [
            "--synthetic", "30",
            "--datasets", "ds_save_aug.pickle",
            "--grid_epochs", "3",
            "--folds", "3",
            "--epochs", "1",
            "--save_augmented", "aug_dump",
        ]
    )
    files = sorted(os.listdir("aug_dump"))
    assert files and all(
        f.startswith("batch_0_") and f.endswith(".pickle") for f in files
    )
    with open(os.path.join("aug_dump", files[0]), "rb") as fp:
        d = pickle.load(fp)
    assert set(d) == {"x_batch", "y_batch"}
    assert len(d["x_batch"]) == len(d["y_batch"]) > 0
    views = d["x_batch"][0]
    assert len(views) == 3
    for v in views:
        assert v.ndim == 2
        assert 0.0 <= float(v.min()) and float(v.max()) <= 1.0


def test_serve_app_streams_detections(workdir, trained):
    from radarml_tpu.apps import serve as serve_app

    stats = serve_app.main(
        [
            "--duration", "3",
            "--mode", "fast",
            "--min_proba", "0.0",
            "--max_batch", "8",
            "--driver", "synthetic",
        ]
    )
    assert stats["processed"] > 0
    assert stats["latency_p50_ms"] > 0


def test_platform_flag_applies_at_parse_time():
    """--platform must take effect during parse_args — before any app
    touches a device (jax.config must be set before the backend
    initializes)."""
    import argparse

    import jax

    from radarml_tpu.apps.common_cli import add_common_flags

    p = argparse.ArgumentParser()
    add_common_flags(p)
    args = p.parse_args(["--platform", "cpu"])
    assert args.platform == "cpu"
    assert jax.config.jax_platforms == "cpu"
    assert p.parse_args([]).platform == ""  # default: leave the backend


def test_serve_app_mode_fused_default_dtype(workdir, trained, interpret_fused):
    """serve --mode fused must work with the CLI's DEFAULT --cube_dtype
    (bfloat16): the fused wire format is int8 regardless, and every
    requested dtype resolves to it instead of raising."""
    from radarml_tpu.apps import serve as serve_app

    stats = serve_app.main(
        [
            "--duration", "2",
            "--mode", "fused",
            "--min_proba", "0.0",
            "--max_batch", "8",
            "--driver", "synthetic",
        ]
    )
    assert stats["processed"] > 0


def test_predict_app_derived_targets(workdir, trained):
    from radarml_tpu.apps import predict as predict_app

    results = predict_app.main(
        [
            "--num_scans", "3",
            "--min_proba", "0.0",
            "--derived_targets",
        ]
    )
    assert len(results) >= 3  # one derived target per scan


def test_model_summary_util():
    import jax.numpy as jnp

    from radarml_tpu.utils.summary import model_summary

    params = {"dense": {"kernel": jnp.zeros((4, 8)), "bias": jnp.zeros((8,))},
              "head": {"kernel": jnp.zeros((8, 3))}}
    text = model_summary(params, title="tiny")
    assert "# tiny" in text
    assert "dense/kernel" in text and "(4, 8)" in text
    assert "total parameters: 64" in text  # 32 + 8 + 24


def test_dnn_app_writes_model_and_summary(workdir):
    from radarml_tpu.apps import dnn as dnn_app

    out = dnn_app.main([
        "--synthetic", "24", "--epochs", "2", "--batch_size", "8",
        "--results_dir", str(workdir / "dnn-results"),
    ])
    assert os.path.exists(out["model_path"])
    summary_path = workdir / "dnn-results" / "c_model_summary.txt"
    assert summary_path.exists()
    text = summary_path.read_text()
    assert "MultiViewCNN" in text and "total parameters:" in text
    # plot_model-equivalent PNG beside the checkpoint (ref dnn.py:426-427)
    png = workdir / "dnn-results" / "dnn_model.png"
    assert png.exists() and png.stat().st_size > 5_000


def test_plot_model_png_renders_param_tree(tmp_path):
    import jax.numpy as jnp

    from radarml_tpu.utils.summary import plot_model_png

    params = {
        "conv": {"kernel": jnp.zeros((3, 3, 1, 8)), "bias": jnp.zeros((8,))},
        "head": {"kernel": jnp.zeros((8, 3))},
    }
    out = tmp_path / "model.png"
    plot_model_png(str(out), params, title="tiny")
    assert out.exists() and out.stat().st_size > 5_000


def test_driver_flags_threshold_and_mti(workdir, trained, monkeypatch):
    """--threshold / --mti are first-class session config (reference
    predict.py:203-213 SetThreshold + SetDynamicImageFilter): the values
    reach the driver, and --mti=false runs the explicit calibration loop
    before the scan loop (reference common.py:82-91 via predict.py:211)."""
    import argparse

    from radarml_tpu.apps import predict as predict_app
    from radarml_tpu.apps.common_cli import add_driver_flags, build_driver
    from radarml_tpu.drivers import base as driver_base

    p = argparse.ArgumentParser()
    add_driver_flags(p)
    args = p.parse_args(["--threshold", "7.5", "--mti", "false"])
    driver = build_driver(args)
    assert driver.threshold == 7.5 and driver.mti is False
    assert build_driver(p.parse_args([])).threshold == 5.0  # reference default

    calibrated = []
    real_calibrate = driver_base.calibrate

    def spying_calibrate(d, max_triggers=100):
        n = real_calibrate(d, max_triggers)
        calibrated.append(n)
        return n

    monkeypatch.setattr(driver_base, "calibrate", spying_calibrate)
    results = predict_app.main(
        ["--num_scans", "2", "--min_proba", "0.0", "--mti", "false"]
    )
    assert results
    assert calibrated and calibrated[0] > 0  # calibration loop actually ran

    calibrated.clear()
    predict_app.main(["--num_scans", "2", "--min_proba", "0.0"])
    assert not calibrated  # MTI on (default): no calibration pass


def test_predict_app_cross_scan_arena(workdir, trained):
    """--scan_arena: the CLI serves scans from a HIGHER-resolution arena
    than the model was trained on (reference predict.py:34-54), and its
    predictions match the library cross-arena predictor fed the very
    same driver scans."""
    import jax.numpy as jnp

    from radarml_tpu.apps import predict as predict_app
    from radarml_tpu.apps.common_cli import load_label_encoder, load_model
    from radarml_tpu.core.arena import Arena, DEFAULT_ARENA
    from radarml_tpu.drivers import RadarSession, SyntheticRadar
    from radarml_tpu.models.pipeline import (
        RadarPredictor,
        UNKNOWN,
        pad_targets,
    )

    arena_spec = "10,360,1,-42,42,2,-30,30,2"  # finer r and theta
    scan_arena = Arena(r_res=1.0, theta_res=2.0)
    assert scan_arena.grid_shape != DEFAULT_ARENA.grid_shape

    results = predict_app.main(
        [
            "--num_scans", "4",
            "--min_proba", "0.0",
            "--scan_arena", arena_spec,
            "--driver_seed", "77",
        ]
    )
    assert results, "cross-arena CLI produced no classifications"

    # Oracle: same seed → same synthetic scans; library predictor with
    # scan_arena set must reproduce the CLI's outputs exactly.
    model, calib = load_model("train-results/svm_radar_classifier.pickle")
    le = load_label_encoder("train-results/radar_labels.pickle")
    predictor = RadarPredictor(
        train_arena=DEFAULT_ARENA, scan_arena=scan_arena,
        model=model, calibration=calib, min_proba=0.0,
    )
    driver = SyntheticRadar(arena=scan_arena, seed=77, max_targets=2)
    expected = []
    with RadarSession(driver) as radar:
        for _ in range(4):
            radar.trigger()
            targets = radar.get_sensor_targets()
            if not targets:
                continue
            cube = radar.get_raw_image()
            xyz, valid = pad_targets(
                [[(t.x, t.y, t.z) for t in targets]], max_targets=4
            )
            pred, proba, _ = predictor(
                jnp.asarray(cube)[None], xyz, valid
            )
            pred, proba = np.asarray(pred)[0], np.asarray(proba)[0]
            for t in range(valid.shape[1]):
                if valid[0, t]:
                    name = ("Unknown" if pred[t] == UNKNOWN
                            else le.classes_[int(pred[t])])
                    expected.append((name, float(proba[t])))
    assert len(results) == len(expected)
    for (n1, p1), (n2, p2) in zip(results, expected):
        assert n1 == n2
        np.testing.assert_allclose(p1, p2, atol=1e-6)


def test_predict_app_pins_batch_shape(workdir, trained, monkeypatch):
    """Partial batches (scans whose target list is empty are dropped)
    must pad to --batch_scans with valid=False rows so every classify
    call runs the ONE program shape the startup gate vouched for — a
    partial size would compile a different (ungated) program per
    distinct count."""
    from radarml_tpu.apps import predict as predict_app
    from radarml_tpu.models import pipeline as pipeline_mod

    shapes = []
    real_predictor = pipeline_mod.RadarPredictor

    class Spy:
        __dataclass_fields__ = real_predictor.__dataclass_fields__

        def __init__(self, *a, **k):
            self._p = real_predictor(*a, **k)

        def __call__(self, cubes, xyz, valid):
            shapes.append((cubes.shape[0], bool(valid.all())))
            return self._p(cubes, xyz, valid)

    class FlakyTargets:
        """Wraps the session driver: every other scan has no targets."""

        def __init__(self, inner):
            self._inner = inner
            self._n = 0

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def get_sensor_targets(self):
            self._n += 1
            if self._n % 2 == 0:
                return []
            return self._inner.get_sensor_targets()

    real_build = predict_app.build_driver
    monkeypatch.setattr(predict_app, "RadarPredictor", Spy)
    monkeypatch.setattr(
        predict_app, "build_driver",
        lambda *a, **k: FlakyTargets(real_build(*a, **k)),
    )
    results = predict_app.main(
        ["--num_scans", "4", "--batch_scans", "4", "--min_proba", "0.0"]
    )
    assert results  # the real scans still classify
    assert shapes, "predictor never called"
    # every call ran at exactly batch_scans, with padding rows invalid
    assert all(b == 4 for b, _ in shapes)
    assert any(not all_valid for _, all_valid in shapes)
