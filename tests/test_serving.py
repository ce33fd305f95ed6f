"""Streaming serving runtime: batching, drops, detections, stats."""

import time

import numpy as np
import jax.numpy as jnp
import pytest

from radarml_tpu.core.arena import DEFAULT_ARENA
from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
from radarml_tpu.models.pipeline import RadarPredictor
from radarml_tpu.serving import (
    StreamConfig,
    StreamingClassifier,
    driver_scan_source,
)


@pytest.fixture(scope="module")
def predictor(rng_module):
    n_classes, F = 3, DEFAULT_ARENA.feature_length
    model = LinearModel(
        coef=jnp.asarray(
            rng_module.normal(size=(n_classes, F)) * 0.01, jnp.float32
        ),
        intercept=jnp.zeros((n_classes,), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((n_classes,), jnp.float32),
        b=jnp.zeros((n_classes,), jnp.float32),
    )
    return RadarPredictor(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=model, calibration=calib, min_proba=0.0, mode="fast",
    )


@pytest.fixture(scope="module")
def rng_module():
    return np.random.default_rng(1234)


def test_streaming_classifies_synthetic_driver(predictor):
    from radarml_tpu.drivers import RadarSession, SyntheticRadar

    driver = SyntheticRadar(arena=DEFAULT_ARENA, seed=5)
    events = []
    svc = StreamingClassifier(
        predictor,
        StreamConfig(max_batch=8, max_wait_s=0.02),
        on_detection=events.append,
    )
    with RadarSession(driver) as d:
        svc.start(driver_scan_source(d))
        deadline = time.time() + 20
        while svc.processed < 10 and time.time() < deadline:
            time.sleep(0.1)
        svc.stop()
    assert svc.processed >= 10
    assert events, "no detections emitted"
    stats = svc.stats()
    assert stats["latency_p50_ms"] > 0
    assert stats["mean_batch"] >= 1
    for e in events[:5]:
        assert -1 <= e.label_index < 3
        assert 0.0 <= e.proba <= 1.0


def test_queue_drops_when_consumer_stalls(predictor):
    """A firehose source against a tiny queue must drop, not block."""
    cube = np.zeros(DEFAULT_ARENA.grid_shape, np.float32)

    def firehose():
        return cube, [(0.0, 0.0, 100.0)]

    svc = StreamingClassifier(
        predictor, StreamConfig(max_batch=4, max_wait_s=0.001, queue_depth=4)
    )
    # Stall the consumer by not starting the predict thread: run ingest
    # only for a bounded burst.
    import threading

    svc._stop.clear()
    t = threading.Thread(target=svc._ingest_loop, args=(firehose,), daemon=True)
    t.start()
    time.sleep(0.2)
    svc._stop.set()
    t.join(2)
    assert svc.dropped > 0
    assert svc._q.qsize() <= 4


def test_ingest_survives_source_errors(predictor):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("sensor hiccup")
        cube = np.zeros(DEFAULT_ARENA.grid_shape, np.float32)
        return cube, [(0.0, 0.0, 100.0)]

    svc = StreamingClassifier(predictor, StreamConfig(max_batch=2,
                                                      max_wait_s=0.01))
    svc.start(flaky)
    deadline = time.time() + 15
    while svc.processed < 2 and time.time() < deadline:
        time.sleep(0.05)
    svc.stop()
    assert svc.processed >= 2  # recovered after errors
    assert len(calls) >= 3


def test_multi_sensor_ingest(predictor):
    """A fleet of sources multiplexes onto one shared batcher."""
    cube = np.zeros(DEFAULT_ARENA.grid_shape, np.float32)

    def make_source(sensor_id):
        def src():
            time.sleep(0.01)
            return cube, [(float(sensor_id), 0.0, 100.0)]
        return src

    svc = StreamingClassifier(predictor, StreamConfig(max_batch=8,
                                                      max_wait_s=0.02))
    svc.start([make_source(i) for i in range(3)])
    deadline = time.time() + 15
    while svc.processed < 12 and time.time() < deadline:
        time.sleep(0.05)
    svc.stop()
    assert svc.processed >= 12
    # sequence numbers unique across sensors
    assert svc._seq >= svc.processed


def test_predict_loop_survives_predictor_exceptions():
    """A raising predictor (or callback) is counted + retried instead
    of silently killing the predict thread."""
    import time

    import numpy as np

    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.serving import StreamConfig, StreamingClassifier

    calls = {"n": 0}

    def flaky_predictor(cubes, xyz, valid):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("transient device error")
        import jax.numpy as jnp

        B, T = valid.shape
        return (
            jnp.zeros((B, T), jnp.int32),
            jnp.ones((B, T), jnp.float32),
            jnp.ones((B, T, 3), jnp.float32) / 3,
        )

    got = []
    svc = StreamingClassifier(
        flaky_predictor,
        StreamConfig(max_batch=2, max_wait_s=0.01, queue_depth=8),
        on_detection=got.append,
    )

    seq = {"i": 0}

    def source():
        seq["i"] += 1
        time.sleep(0.02)
        cube = np.zeros(DEFAULT_ARENA.grid_shape, np.float32)
        return cube, [(0.0, 0.0, 100.0)]

    svc.start(source)
    deadline = time.time() + 15
    while time.time() < deadline and not got:
        time.sleep(0.1)
    svc.stop()
    stats = svc.stats()
    assert stats["predict_errors"] >= 2
    assert got, "service never recovered after predictor exceptions"


def test_stats_memory_bounded(predictor):
    """Long-running stats stay memory-flat: percentile/batch windows
    are bounded deques; counts/mean_batch remain all-time."""
    import queue

    from radarml_tpu.serving.stream import Scan

    svc = StreamingClassifier(
        predictor, StreamConfig(max_batch=2, max_wait_s=0.05, stats_window=16),
    )
    cube = np.zeros(DEFAULT_ARENA.grid_shape, np.float32)
    n_batches = 100
    for b in range(n_batches):
        for i in range(2):
            svc._q.put_nowait(
                Scan(cube, [(0.0, 0.0, 100.0)], time.perf_counter(), 2 * b + i)
            )
        svc._predict_once()
    assert svc.processed == 2 * n_batches
    assert len(svc.latencies_ms) == 16  # bounded, not 200
    assert len(svc.batches) == 16
    stats = svc.stats()
    assert stats["mean_batch"] == 2.0  # all-time mean, not window mean
    assert stats["processed"] == 2 * n_batches
    with pytest.raises(queue.Empty):
        svc._q.get_nowait()


def test_streaming_narrow_ingest_matches_f32(predictor, rng_module):
    """An 8-bit-stream predictor gets canonical-u8 queued scans (1
    B/voxel from ingest on) and emits the same detections as the f32
    predictor on integer-valued cubes."""
    fast_u8 = RadarPredictor(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=predictor.model, calibration=predictor.calibration,
        min_proba=0.0, mode="fast", cube_dtype="uint8",
    )
    rng = np.random.default_rng(77)
    scans = [
        (
            np.rint(rng.random(DEFAULT_ARENA.grid_shape) * 255).astype(
                np.float32
            ),
            [(2.0 * i, -1.0, 100.0 + 5 * i)],
        )
        for i in range(6)
    ]

    def run(p, stream=scans):
        events = []
        it = iter(stream)
        svc = StreamingClassifier(
            p, StreamConfig(max_batch=4, max_wait_s=0.02),
            on_detection=events.append,
        )
        svc.start(lambda: next(it, None))
        deadline = time.time() + 60
        while svc.processed < len(stream) and time.time() < deadline:
            time.sleep(0.05)
        svc.stop()
        assert svc.processed >= len(stream), (
            f"stream drained {svc.processed}/{len(stream)} before deadline"
        )
        return {(e.seq, e.target_index): (e.label_index, round(e.proba, 5))
                for e in events}

    got_u8 = run(fast_u8)
    got_f32 = run(predictor)
    assert got_u8 == got_f32 and len(got_u8) == len(scans)

    # fused mode streams through the same loop (canonical-u8 queue)
    # with identical decisions. Small scan arena keeps the
    # interpret-mode kernel cheap; full-arena parity is proven in
    # tests/test_pallas_i8.py, so the streaming leg only needs to
    # prove the LOOP plumbing.
    from radarml_tpu.core.arena import Arena

    small = Arena(r_max=60.0, theta_res=14.0, phi_res=10.0)  # 7x7x26
    n_classes = 3
    s_model = LinearModel(
        coef=jnp.asarray(
            rng_module.normal(size=(n_classes, small.feature_length)) * 0.01,
            jnp.float32,
        ),
        intercept=jnp.zeros((n_classes,), jnp.float32),
    )
    s_calib = SigmoidCalibration(
        a=-jnp.ones((n_classes,), jnp.float32),
        b=jnp.zeros((n_classes,), jnp.float32),
    )
    small_scans = [
        (
            np.rint(rng.random(small.grid_shape) * 255).astype(np.float32),
            [(2.0 * i, -1.0, 20.0 + 3 * i)],
        )
        for i in range(6)
    ]
    small_f32 = RadarPredictor(
        train_arena=small, scan_arena=small, model=s_model,
        calibration=s_calib, min_proba=0.0, mode="fast",
    )
    fused = RadarPredictor(
        train_arena=small, scan_arena=small, model=s_model,
        calibration=s_calib, min_proba=0.0, mode="fused",
        interpret=True,
    )
    # pre-compile the (max_batch, T) program so the stream's deadline
    # never races an interpret-mode compile on a loaded host
    warm = np.zeros((4,) + small.grid_shape, np.float32)
    wx = np.zeros((4, 1, 3), np.float32)
    wv = np.ones((4, 1), bool)
    np.asarray(fused(warm, wx, wv)[0])
    got_small = run(small_f32, small_scans)
    got_fused = run(fused, small_scans)
    assert set(got_fused) == set(got_small) and len(got_fused) == len(
        small_scans
    )
    assert all(
        got_fused[k][0] == got_small[k][0] for k in got_small
    )  # same labels; probas differ only by template quantization
