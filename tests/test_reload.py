"""Model hot-reload: the serving loop swaps models without restart."""

import threading
import time

import numpy as np
import pytest

from radarml_tpu.core.arena import DEFAULT_ARENA
from radarml_tpu.serving.reload import ModelReloader


def test_reloader_detects_change_and_swaps(tmp_path):
    path = tmp_path / "artifact.bin"
    path.write_bytes(b"v1")
    swapped = []
    r = ModelReloader(
        str(path), build=lambda: path.read_bytes(),
        on_swap=swapped.append, poll_s=0.1,
    )
    r.start()
    time.sleep(0.3)
    path.write_bytes(b"v2")
    deadline = time.time() + 10
    while not swapped and time.time() < deadline:
        time.sleep(0.1)
    r.stop()
    r.join(timeout=5)
    assert swapped == [b"v2"]
    assert r.reloads == 1


def test_reloader_survives_bad_artifact(tmp_path):
    path = tmp_path / "artifact.bin"
    path.write_bytes(b"v1")
    calls = []

    def build():
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("corrupt")
        return "good"

    swapped = []
    r = ModelReloader(str(path), build, swapped.append, poll_s=0.1)
    r.start()
    time.sleep(0.3)
    path.write_bytes(b"v2")  # triggers the failing build
    deadline = time.time() + 10
    while r.failures == 0 and time.time() < deadline:
        time.sleep(0.1)
    path.write_bytes(b"v3")  # second change: build succeeds
    deadline = time.time() + 10
    while not swapped and time.time() < deadline:
        time.sleep(0.1)
    r.stop()
    r.join(timeout=5)
    assert r.failures == 1
    assert swapped == ["good"]


def test_reloader_backs_off_on_repeated_failures(tmp_path):
    """A deterministically bad artifact must not spin build() every
    poll — build can involve a 30-90 s compile. Retries continue (a
    transient race heals) but on a doubling backoff."""
    path = tmp_path / "artifact.bin"
    path.write_bytes(b"v1")
    calls = []

    def build():
        calls.append(time.time())
        raise ValueError("always corrupt")

    r = ModelReloader(str(path), build, lambda _: None, poll_s=0.05)
    r.start()
    time.sleep(0.2)
    path.write_bytes(b"v2")  # triggers the always-failing build
    time.sleep(1.5)
    r.stop()
    r.join(timeout=5)
    # no-backoff would attempt ~25+ builds in 1.5 s at poll 0.05
    assert 2 <= len(calls) <= 10, calls
    # and the reloader still retried rather than giving up after one
    assert r.failures == len(calls)


def test_serve_cli_hot_reload_fused_artifact(tmp_path, interpret_fused):
    """Hot reload of a mode='fused' AOT artifact mid-serve: the baked
    static batch must warm (batch 1 pads up inside ServingArtifact),
    the re-export replaces the file atomically, and predictions flip
    class without a restart — the production pairing of the headline
    serving mode with the headline durability feature."""
    from radarml_tpu.apps import serve as serve_app
    from radarml_tpu.apps.common_cli import save_label_encoder, save_model
    from radarml_tpu.data.labels import LabelEncoder

    # Small scan arena (7x7x26 grid) keeps the interpret-mode kernel
    # cheap; the training arena stays DEFAULT (cross-arena zoom).
    arena_flag = "10,60,2,-42,42,14,-30,30,10"
    C, F = 3, DEFAULT_ARENA.feature_length
    model_path = str(tmp_path / "svm.pickle")
    art_path = str(tmp_path / "fused.rmlx")
    le_path = str(tmp_path / "le.pickle")
    save_label_encoder(le_path, LabelEncoder(classes_=["cat", "dog", "person"]))

    def export_model(boost_class):
        intercept = np.full((C,), -5.0, np.float32)
        intercept[boost_class] = 5.0
        save_model(
            model_path, "linear",
            coef=np.zeros((C, F), np.float32),
            intercept=intercept,
            calib_a=-np.ones((C,), np.float32),
            calib_b=np.zeros((C,), np.float32),
            classes=["cat", "dog", "person"],
        )
        out = serve_app.main([
            "--svm_model", model_path, "--label_encoder", le_path,
            "--mode", "fused", "--max_batch", "4",
            "--scan_arena", arena_flag,
            "--export_serving", art_path,
        ])
        assert out == {"exported": art_path}

    export_model(0)

    labels_seen = []
    out = {}

    def run():
        out["res"] = serve_app.main([
            "--label_encoder", le_path,
            "--serving_artifact", art_path,
            "--scan_arena", arena_flag,
            "--duration", "20", "--scan_period", "0.05",
            "--max_batch", "4", "--min_proba", "0.0",
            "--reload_poll", "0.3", "--log_detections",
        ])

    import logging

    class Grab(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "target" in msg and "(" in msg:
                for name in ("cat", "dog", "person"):
                    if f" {name} " in msg:
                        labels_seen.append(name)

    grab = Grab()
    logging.getLogger("radarml_tpu.apps.serve").addHandler(grab)
    try:
        th = threading.Thread(target=run)
        th.start()
        deadline = time.time() + 15
        while "cat" not in labels_seen and time.time() < deadline:
            time.sleep(0.2)
        export_model(2)  # atomic re-export: swap to always-person
        th.join(timeout=120)
        assert not th.is_alive()
    finally:
        logging.getLogger("radarml_tpu.apps.serve").removeHandler(grab)

    assert out["res"]["model_reloads"] >= 1
    assert "cat" in labels_seen  # before reload
    assert "person" in labels_seen  # after reload


def test_serve_cli_hot_reload_swaps_predictions(tmp_path):
    """Rewrite the model mid-serve; the loop's predictions flip class
    without a restart."""
    from radarml_tpu.apps import serve as serve_app
    from radarml_tpu.apps.common_cli import save_label_encoder, save_model
    from radarml_tpu.data.labels import LabelEncoder

    C, F = 3, DEFAULT_ARENA.feature_length

    def write_model(boost_class):
        # Intercept-only model: always predicts boost_class confidently.
        intercept = np.full((C,), -5.0, np.float32)
        intercept[boost_class] = 5.0
        save_model(
            str(tmp_path / "svm.pickle"), "linear",
            coef=np.zeros((C, F), np.float32),
            intercept=intercept,
            calib_a=-np.ones((C,), np.float32),
            calib_b=np.zeros((C,), np.float32),
            classes=["cat", "dog", "person"],
        )

    write_model(0)
    le_path = str(tmp_path / "le.pickle")
    save_label_encoder(le_path, LabelEncoder(classes_=["cat", "dog", "person"]))

    labels_seen = []
    out = {}

    # Use the library path so we can hook detections.
    def run():
        import radarml_tpu.apps.serve as s

        orig_main = s.main
        out["res"] = orig_main([
            "--svm_model", str(tmp_path / "svm.pickle"),
            "--label_encoder", le_path,
            "--duration", "14", "--scan_period", "0.05",
            "--max_batch", "4", "--min_proba", "0.0",
            "--reload_poll", "0.3", "--log_detections",
        ])

    # Capture predicted labels via the logger.
    import logging

    class Grab(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "target" in msg and "(" in msg:
                for name in ("cat", "dog", "person"):
                    if f" {name} " in msg:
                        labels_seen.append(name)

    grab = Grab()
    logging.getLogger("radarml_tpu.apps.serve").addHandler(grab)
    try:
        th = threading.Thread(target=run)
        th.start()
        time.sleep(5)  # model A serving
        write_model(2)  # swap to always-person
        th.join(timeout=90)
        assert not th.is_alive()
    finally:
        logging.getLogger("radarml_tpu.apps.serve").removeHandler(grab)

    assert out["res"]["model_reloads"] >= 1
    assert "cat" in labels_seen  # before reload
    assert "person" in labels_seen  # after reload
