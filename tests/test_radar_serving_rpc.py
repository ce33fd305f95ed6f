"""gRPC radar-serving endpoint: wire round trip, parity, error paths."""

import numpy as np
import jax.numpy as jnp
import pytest

from radarml_tpu.core.arena import DEFAULT_ARENA
from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
from radarml_tpu.models.pipeline import RadarPredictor, pad_targets
from radarml_tpu.rpc import (
    RadarServingClient,
    RadarServingError,
    RadarServingServer,
)


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(0)
    C, F = 3, DEFAULT_ARENA.feature_length
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(C, F)) * 0.01, jnp.float32),
        intercept=jnp.zeros((C,), jnp.float32),
    )
    calib = SigmoidCalibration(
        a=-jnp.ones((C,), jnp.float32), b=jnp.zeros((C,), jnp.float32)
    )
    predictor = RadarPredictor(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=model, calibration=calib, mode="fast", min_proba=0.0,
    )
    server = RadarServingServer(
        predictor, classes=["cat", "dog", "person"],
        grid_shape=DEFAULT_ARENA.grid_shape,
    ).start()
    client = RadarServingClient(f"127.0.0.1:{server.port}")
    yield predictor, server, client
    client.close()
    server.stop()


def test_classify_round_trip_matches_local(served):
    predictor, server, client = served
    rng = np.random.default_rng(1)
    cube = np.rint(
        rng.random(DEFAULT_ARENA.grid_shape) * 255
    ).astype(np.float32)
    targets = [(5.0, 5.0, 100.0), (-10.0, 3.0, 150.0)]

    dets = client.classify(cube, targets, dtype="uint8")
    assert len(dets) == 2

    xyz, valid = pad_targets([targets], max_targets=4)
    pred, best_p, proba = predictor(cube[None], xyz, valid)
    proba = np.asarray(proba)[0]
    for t, det in enumerate(dets):
        assert det.target_index == t
        np.testing.assert_allclose(
            np.asarray(det.class_probas), proba[t], atol=1e-6
        )
        assert det.label in ("cat", "dog", "person", "")


def test_float32_transport_and_config(served):
    predictor, server, client = served
    rng = np.random.default_rng(2)
    cube = rng.random(DEFAULT_ARENA.grid_shape).astype(np.float32) * 255
    dets = client.classify(cube, [(0.0, 0.0, 90.0)], dtype="float32")
    assert len(dets) == 1

    cfg = client.get_config()
    assert tuple(cfg.grid_shape) == DEFAULT_ARENA.grid_shape
    assert list(cfg.classes) == ["cat", "dog", "person"]
    assert cfg.mode == "fast"


def test_bad_request_raises(served):
    predictor, server, client = served
    import radarml_tpu.rpc.radar_serving_pb2 as pb

    with pytest.raises(Exception):
        bad = pb.ScanRequest(cube=b"123", dtype="uint8", shape=[2, 2, 2, 7])
        client._classify(bad, timeout=5)


def test_serve_cli_grpc_mode(tmp_path):
    """serve --grpc_port serves the endpoint for --duration and exits."""
    import threading
    import time as _time

    from radarml_tpu.apps import serve as serve_app
    from radarml_tpu.apps.common_cli import save_label_encoder, save_model
    from radarml_tpu.data.labels import LabelEncoder

    rng = np.random.default_rng(3)
    C, F = 3, DEFAULT_ARENA.feature_length
    model_path = str(tmp_path / "svm.pickle")
    save_model(
        model_path, "linear",
        coef=rng.normal(size=(C, F)).astype(np.float32) * 0.01,
        intercept=np.zeros((C,), np.float32),
        calib_a=-np.ones((C,), np.float32),
        calib_b=np.zeros((C,), np.float32),
        classes=["cat", "dog", "person"],
    )
    le_path = str(tmp_path / "le.pickle")
    save_label_encoder(le_path, LabelEncoder(classes_=["cat", "dog", "person"]))

    out = {}

    def run():
        out["res"] = serve_app.main([
            "--svm_model", model_path, "--label_encoder", le_path,
            "--grpc_port", "0", "--duration", "4", "--min_proba", "0.0",
        ])

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert out["res"]["grpc_port"] > 0


def test_grpc_serving_from_aot_artifact(tmp_path, served):
    """AOT artifact + gRPC endpoint compose: same wire answers."""
    from radarml_tpu.serving import export_predictor, load_serving_artifact

    predictor, _server, _client = served
    path = str(tmp_path / "serving.rmlx")
    export_predictor(predictor, path, max_targets=3)
    art = load_serving_artifact(path)

    server = RadarServingServer(
        art, classes=["cat", "dog", "person"],
        grid_shape=art.grid_shape, max_targets=art.max_targets,
    ).start()
    client = RadarServingClient(f"127.0.0.1:{server.port}")
    try:
        rng = np.random.default_rng(7)
        cube = np.rint(
            rng.random(DEFAULT_ARENA.grid_shape) * 255
        ).astype(np.float32)
        targets = [(2.0, -1.0, 110.0)]
        via_art = client.classify(cube, targets, dtype="uint8")
        via_live = _client.classify(cube, targets, dtype="uint8")
        assert len(via_art) == len(via_live) == 1
        np.testing.assert_allclose(
            np.asarray(via_art[0].class_probas),
            np.asarray(via_live[0].class_probas),
            atol=1e-6,
        )
    finally:
        client.close()
        server.stop()


def test_subscribe_receives_published_detections(served):
    import threading
    import time as _time

    predictor, server, client = served
    got = []

    def consume():
        for ev in client.subscribe(timeout_s=8):
            got.append((ev.seq, ev.label, round(ev.proba, 3)))
            if len(got) >= 3:
                break

    th = threading.Thread(target=consume)
    th.start()
    _time.sleep(0.5)  # let the stream register
    for i in range(3):
        server.publish(i, 0, "dog", 0.9 + 0.01 * i, latency_ms=1.0)
        _time.sleep(0.05)
    th.join(timeout=10)
    assert not th.is_alive()
    assert [g[0] for g in got] == [0, 1, 2]
    assert all(g[1] == "dog" for g in got)


def test_serve_cli_grpc_publish_mode(tmp_path):
    """--grpc_port + --grpc_publish runs the sensor loop AND streams
    its detections to a subscriber."""
    import json
    import re
    import subprocess
    import sys
    import threading
    import time as _time

    from radarml_tpu.apps import serve as serve_app
    from radarml_tpu.apps.common_cli import save_label_encoder, save_model
    from radarml_tpu.data.labels import LabelEncoder

    rng = np.random.default_rng(5)
    C, F = 3, DEFAULT_ARENA.feature_length
    model_path = str(tmp_path / "svm.pickle")
    save_model(
        model_path, "linear",
        coef=rng.normal(size=(C, F)).astype(np.float32) * 0.01,
        intercept=np.zeros((C,), np.float32),
        calib_a=-np.ones((C,), np.float32),
        calib_b=np.zeros((C,), np.float32),
        classes=["cat", "dog", "person"],
    )
    le_path = str(tmp_path / "le.pickle")
    save_label_encoder(le_path, LabelEncoder(classes_=["cat", "dog", "person"]))

    out = {}

    def run():
        out["res"] = serve_app.main([
            "--svm_model", model_path, "--label_encoder", le_path,
            "--grpc_port", "50917", "--grpc_publish",
            "--duration", "6", "--scan_period", "0.05",
            "--max_batch", "4", "--min_proba", "0.0",
        ])

    th = threading.Thread(target=run)
    th.start()
    events = []

    def consume():
        # Connect once the fixed port is up; tolerate early refusal.
        client = RadarServingClient("127.0.0.1:50917", timeout_s=20)
        deadline = _time.time() + 20
        while _time.time() < deadline and not events:
            try:
                for ev in client.subscribe(timeout_s=6):
                    events.append(ev)
                    if len(events) >= 2:
                        return
            except Exception:
                _time.sleep(0.5)
        client.close()

    sub = threading.Thread(target=consume)
    sub.start()
    th.join(timeout=90)
    sub.join(timeout=30)
    assert not th.is_alive()
    assert out["res"]["processed"] > 0
    assert len(events) >= 1  # the local loop's detections reached the wire


def test_get_stats_counts_requests_and_events(served):
    predictor, server, client = served
    before = client.get_stats()
    rng = np.random.default_rng(8)
    cube = np.rint(
        rng.random(DEFAULT_ARENA.grid_shape) * 255
    ).astype(np.float32)
    client.classify(cube, [(0.0, 0.0, 100.0)], dtype="uint8")
    server.publish(99, 0, "cat", 0.8)
    after = client.get_stats()
    assert after.classify_requests == before.classify_requests + 1
    assert after.events_published == before.events_published + 1
    assert after.uptime_s > 0


def test_dynamic_batching_coalesces_and_matches(served):
    """Concurrent Classify calls on a batching server coalesce into
    fewer device batches and return the same answers as the unbatched
    server."""
    import threading
    import time

    predictor, _server, plain_client = served

    class HeldPredictor:
        """The served predictor with each device call held 0.2 s, so
        the other requests are queued while the first batch runs —
        however fast the backend (or a warm compile cache) is."""

        def __getattr__(self, name):
            return getattr(predictor, name)

        def __call__(self, *args):
            time.sleep(0.2)
            return predictor(*args)

    batched = RadarServingServer(
        HeldPredictor(), classes=["cat", "dog", "person"],
        grid_shape=DEFAULT_ARENA.grid_shape,
        # One leader slot forces the other concurrent requests to
        # queue behind the first batch, so coalescing is deterministic.
        batch_window_ms=80.0, batch_size=4, max_concurrent_batches=1,
    ).start()
    client = RadarServingClient(f"127.0.0.1:{batched.port}", timeout_s=30)
    try:
        rng = np.random.default_rng(9)
        cubes = [
            np.rint(rng.random(DEFAULT_ARENA.grid_shape) * 255).astype(
                np.float32
            )
            for _ in range(4)
        ]
        targets = [(1.0 * i, -1.0 * i, 90.0 + 10 * i) for i in range(4)]

        results = [None] * 4

        def call(i):
            results[i] = client.classify(cubes[i], [targets[i]], dtype="uint8")

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert all(r is not None for r in results)

        # Same answers as the unbatched server, request by request.
        for i in range(4):
            want = plain_client.classify(cubes[i], [targets[i]], dtype="uint8")
            np.testing.assert_allclose(
                np.asarray(results[i][0].class_probas),
                np.asarray(want[0].class_probas),
                atol=1e-6,
            )

        stats = client.get_stats()
        assert stats.classify_requests == 4
        assert 1 <= stats.classify_batches < 4  # coalescing happened
    finally:
        client.close()
        batched.stop()


def test_adaptive_batching_lone_request_skips_window(served):
    """The coalescing window engages only under evident concurrency: a
    lone Classify on a batching server with an absurd 5 s window must
    return in well under the window (SERVING_BENCH r03 showed a fixed
    window pessimizing every operating point; the adaptive policy makes
    batching free when unloaded)."""
    import time as _time

    predictor, _server, _plain = served
    batched = RadarServingServer(
        predictor, classes=["cat", "dog", "person"],
        grid_shape=DEFAULT_ARENA.grid_shape,
        batch_window_ms=5000.0, batch_size=4,
    ).start()
    client = RadarServingClient(f"127.0.0.1:{batched.port}", timeout_s=30)
    try:
        rng = np.random.default_rng(11)
        cube = np.rint(rng.random(DEFAULT_ARENA.grid_shape) * 255).astype(
            np.float32
        )
        # warm the compiled (batch_size, T) program out of the timing
        client.classify(cube, [(0.0, 0.0, 90.0)], dtype="uint8")
        t0 = _time.perf_counter()
        dets = client.classify(cube, [(1.0, -1.0, 110.0)], dtype="uint8")
        elapsed = _time.perf_counter() - t0
        assert len(dets) == 1
        assert elapsed < 2.5, (
            f"lone request took {elapsed:.2f}s — the 5s window leaked "
            "into the unloaded path"
        )
        stats = client.get_stats()
        assert stats.classify_batches == 2  # one per lone request
    finally:
        client.close()
        batched.stop()


def test_batch_buckets_bound_program_shapes(served):
    """The batcher pads to power-of-two bucket shapes ≤ batch_size
    (transfer bytes and FLOPs track load, not the static maximum), and
    a partial burst through a bucketed server matches the unbatched
    answers."""
    import threading

    predictor, _server, plain_client = served
    batched = RadarServingServer(
        predictor, classes=["cat", "dog", "person"],
        grid_shape=DEFAULT_ARENA.grid_shape,
        batch_window_ms=50.0, batch_size=16,
    )
    assert batched.batch_buckets == (1, 2, 4, 8, 16)
    assert batched._bucket(1) == 1
    assert batched._bucket(3) == 4
    assert batched._bucket(16) == 16
    # Non-power-of-two batch_size keeps itself as the top bucket.
    odd = RadarServingServer(
        predictor, classes=["cat"], grid_shape=DEFAULT_ARENA.grid_shape,
        batch_window_ms=1.0, batch_size=6,
    )
    assert odd.batch_buckets == (1, 2, 4, 6)
    assert odd._bucket(5) == 6

    batched.start()
    client = RadarServingClient(f"127.0.0.1:{batched.port}", timeout_s=30)
    try:
        rng = np.random.default_rng(13)
        cubes = [
            np.rint(rng.random(DEFAULT_ARENA.grid_shape) * 255).astype(
                np.float32
            )
            for _ in range(3)
        ]
        results = [None] * 3

        def call(i):
            results[i] = client.classify(
                cubes[i], [(1.0 * i, 0.0, 100.0)], dtype="uint8"
            )

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert all(r is not None for r in results)
        for i in range(3):
            want = plain_client.classify(
                cubes[i], [(1.0 * i, 0.0, 100.0)], dtype="uint8"
            )
            np.testing.assert_allclose(
                np.asarray(results[i][0].class_probas),
                np.asarray(want[0].class_probas),
                atol=1e-6,
            )
    finally:
        client.close()
        batched.stop()


def test_client_retries_transient_unavailable(served):
    """The client retries UNAVAILABLE with backoff: a call made while
    the server is briefly down succeeds once it returns."""
    import threading
    import time as _time

    predictor, _server, _client = served
    # Fixed port so the re-started server is reachable at the same addr.
    s1 = RadarServingServer(
        predictor, classes=["cat", "dog", "person"],
        grid_shape=DEFAULT_ARENA.grid_shape, port=50931,
    ).start()
    # Generous retry budget: under a loaded 1-core host the restart
    # thread can be starved well past its nominal sleep.
    client = RadarServingClient(
        "127.0.0.1:50931", timeout_s=10, retries=7, backoff_s=0.3
    )
    try:
        cfg = client.get_config()
        assert list(cfg.classes) == ["cat", "dog", "person"]
        s1.stop(grace=0)

        def bring_back():
            _time.sleep(0.5)
            RadarServingServer(
                predictor, classes=["cat", "dog", "person"],
                grid_shape=DEFAULT_ARENA.grid_shape, port=50931,
            ).start()

        th = threading.Thread(target=bring_back)
        th.start()
        cfg2 = client.get_config()  # retried through the downtime
        th.join()
        assert list(cfg2.classes) == ["cat", "dog", "person"]
    finally:
        client.close()


def test_stop_drains_inflight_batched_requests():
    """stop() must not leave batched Classify handlers blocked forever:
    in-flight/straggler requests fail fast instead of hanging."""
    import threading
    import time

    rng = np.random.default_rng(9)
    C, F = 3, DEFAULT_ARENA.feature_length
    model = LinearModel(
        coef=jnp.asarray(rng.normal(size=(C, F)) * 0.01, jnp.float32),
        intercept=jnp.zeros((C,), jnp.float32),
    )
    predictor = RadarPredictor(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
        model=model, min_proba=0.0, mode="fast",
    )
    server = RadarServingServer(
        predictor, classes=["a", "b", "c"],
        grid_shape=DEFAULT_ARENA.grid_shape,
        batch_window_ms=300.0, batch_size=8,
    ).start()
    client = RadarServingClient(f"127.0.0.1:{server.port}",
                                timeout_s=15.0, retries=0)
    cube = np.zeros(DEFAULT_ARENA.grid_shape, np.float32)
    outcomes = []

    def call():
        try:
            outcomes.append(("ok", client.classify(cube, [(0, 0, 100.0)])))
        except Exception as e:
            outcomes.append(("err", e))

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)  # let requests land in the batcher window
    server.stop()
    for t in threads:
        t.join(timeout=20.0)
        assert not t.is_alive(), "Classify handler hung across stop()"
    assert len(outcomes) == 4
    client.close()


def test_int8_wire_transport_matches_uint8(served):
    """int8 ScanRequest (value-128 wire format) produces the same
    detections as the uint8 transport of the same cube."""
    predictor, server, client = served
    rng = np.random.default_rng(4)
    cube = np.rint(
        rng.random(DEFAULT_ARENA.grid_shape) * 255
    ).astype(np.float32)
    targets = [(2.0, -4.0, 120.0)]
    d_u8 = client.classify(cube, targets, dtype="uint8")
    d_i8 = client.classify(cube, targets, dtype="int8")
    assert len(d_i8) == len(d_u8) == 1
    np.testing.assert_allclose(
        np.asarray(d_i8[0].class_probas),
        np.asarray(d_u8[0].class_probas), atol=1e-6,
    )
    assert d_i8[0].label == d_u8[0].label


@pytest.mark.parametrize("stream_dtype", ["uint8", "int8"])
@pytest.mark.parametrize("batched", [False, True])
def test_narrow_stream_predictor_serves_all_wire_dtypes(
    served, stream_dtype, batched
):
    """A predictor with an 8-bit device stream serves u8/i8/f32 wires
    identically to the local call: the server decodes the wire to
    canonical u8 and narrows via predictor.encode_host (no float32
    round trip), on both the unbatched and the dynamic-batching path."""
    base, _server, _client = served
    predictor = RadarPredictor(
        train_arena=base.train_arena, scan_arena=base.scan_arena,
        model=base.model, calibration=base.calibration,
        mode="fast", min_proba=0.0, cube_dtype=stream_dtype,
    )
    server = RadarServingServer(
        predictor, classes=["cat", "dog", "person"],
        grid_shape=DEFAULT_ARENA.grid_shape,
        batch_window_ms=20.0 if batched else 0.0, batch_size=4,
    ).start()
    client = RadarServingClient(f"127.0.0.1:{server.port}", timeout_s=30)
    try:
        rng = np.random.default_rng(6)
        cube = np.rint(
            rng.random(DEFAULT_ARENA.grid_shape) * 255
        ).astype(np.float32)
        targets = [(3.0, 1.0, 110.0), (-6.0, 2.0, 140.0)]
        xyz, valid = pad_targets([targets], max_targets=4)
        want = np.asarray(predictor(cube[None], xyz, valid)[2])[0]
        for wire in ("uint8", "int8", "float32"):
            dets = client.classify(cube, targets, dtype=wire)
            assert len(dets) == 2, wire
            for t, det in enumerate(dets):
                np.testing.assert_allclose(
                    np.asarray(det.class_probas), want[t], atol=1e-6,
                    err_msg=f"wire={wire} target={t}",
                )
    finally:
        client.close()
        server.stop()


def test_classify_stream_matches_unary_in_order(served):
    """ClassifyStream returns per-scan detections identical to unary
    Classify, in request order, with fewer device batches than
    requests (server-side coalescing)."""
    predictor, server, client = served
    rng = np.random.default_rng(11)
    scans = [
        (
            np.rint(rng.random(DEFAULT_ARENA.grid_shape) * 255).astype(
                np.float32
            ),
            [(1.0 * i, -2.0, 90.0 + 6 * i), (0.0, 3.0, 150.0)][: 1 + i % 2],
        )
        for i in range(10)
    ]
    stats0 = client.get_stats()
    streamed = list(client.classify_stream(iter(scans), dtype="uint8"))
    stats1 = client.get_stats()

    assert len(streamed) == len(scans)
    for (cube, targets), dets in zip(scans, streamed):
        want = client.classify(cube, targets, dtype="uint8")
        assert len(dets) == len(want) == len(targets)
        for d, w in zip(dets, want):
            assert d.target_index == w.target_index
            assert d.label == w.label
            np.testing.assert_allclose(
                np.asarray(d.class_probas),
                np.asarray(w.class_probas), atol=1e-6,
            )

    reqs = stats1.classify_requests - stats0.classify_requests
    batches = stats1.classify_batches - stats0.classify_batches
    assert reqs >= len(scans)  # the 10 streamed (+ unary checks after)
    assert 1 <= batches <= len(scans)


def test_concurrent_classify_streams_do_not_cross(served):
    """Several ClassifyStream calls running at once (the serving-bench
    multi-client scenario) must each get their OWN scans' detections
    back, in order — the server-side batcher coalesces scans from
    different streams into shared padded device batches, and a
    slot-accounting bug would hand one stream another's rows."""
    import threading

    predictor, server, client = served
    rng = np.random.default_rng(23)
    n_streams, n_scans = 3, 12
    per_stream = []
    for s in range(n_streams):
        scans = [
            (
                np.rint(rng.random(DEFAULT_ARENA.grid_shape) * 255).astype(
                    np.float32
                ),
                # distinct target counts per stream exercise padding
                [(1.0 * s, -2.0, 90.0 + 5 * i), (0.0, 3.0, 150.0)][
                    : 1 + (s + i) % 2
                ],
            )
            for i in range(n_scans)
        ]
        per_stream.append(scans)

    results = [None] * n_streams
    errors = []

    def run(s):
        own = RadarServingClient(f"127.0.0.1:{server.port}")
        try:
            results[s] = list(
                own.classify_stream(iter(per_stream[s]), dtype="uint8")
            )
        except Exception as e:  # pragma: no cover - surfaced by assert
            errors.append((s, e))
        finally:
            own.close()

    threads = [
        threading.Thread(target=run, args=(s,)) for s in range(n_streams)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors

    for s, scans in enumerate(per_stream):
        assert results[s] is not None and len(results[s]) == n_scans
        for (cube, targets), dets in zip(scans, results[s]):
            want = client.classify(cube, targets, dtype="uint8")
            assert len(dets) == len(want) == len(targets)
            for d, w in zip(dets, want):
                assert d.target_index == w.target_index
                assert d.label == w.label
                np.testing.assert_allclose(
                    np.asarray(d.class_probas),
                    np.asarray(w.class_probas), atol=1e-6,
                )


def test_classify_stream_aborts_on_bad_cube(served):
    predictor, server, client = served
    good = np.zeros(DEFAULT_ARENA.grid_shape, np.float32)
    bad = np.zeros((2, 2, 2), np.float32)
    with pytest.raises(RadarServingError):
        list(
            client.classify_stream(
                iter([(good, [(0.0, 0.0, 100.0)]),
                      (bad, [(0.0, 0.0, 100.0)])]),
                dtype="uint8",
            )
        )


def test_classify_stream_abort_releases_reader_thread(served):
    """A mid-stream abort must not leak the reader thread: with more
    queued requests than the handler ever drains (queue bound 4·B),
    the reader would previously block forever on q.put."""
    import threading
    import time as _time

    predictor, server, client = served
    good = np.zeros(DEFAULT_ARENA.grid_shape, np.float32)
    bad = np.zeros((2, 2, 2), np.float32)
    tgt = [(0.0, 0.0, 100.0)]
    # bad cube FIRST, then far more requests than 4*batch_size: the
    # handler aborts on decode while the reader is still feeding.
    scans = [(bad, tgt)] + [(good, tgt)] * 200
    with pytest.raises(RadarServingError):
        list(client.classify_stream(iter(scans), dtype="uint8"))

    deadline = _time.time() + 10.0
    while _time.time() < deadline:
        readers = [
            t for t in threading.enumerate()
            if t.name == "rpc-stream-reader" and t.is_alive()
        ]
        if not readers:
            break
        _time.sleep(0.1)
    assert not readers, "stream reader thread leaked after abort"

    # the server stays healthy for subsequent calls
    assert len(client.classify(good, tgt, dtype="uint8")) == 1
