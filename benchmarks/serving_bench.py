"""End-to-end serving bench: gRPC Classify + the native streaming loop.

Measures the two production surfaces the round-2 verdict called
unmeasured:

(a) loopback gRPC Classify — uint8 (or int8/float32) cubes at 1/4/16
    concurrent clients, with and without server-side dynamic batching
    (`--grpc_batch_window_ms` in the serve CLI). Reports scans/s,
    p50/p95 end-to-end latency, and the coalescing ratio
    (classify_requests / classify_batches) per scenario.
(b) StreamingClassifier fed by the native C++ ring-buffer source at an
    unthrottled scan period — the local sensor loop with the sensor
    cadence removed, i.e. the loop's own ceiling.

Baseline: the reference's whole serving story is a ~5 scans/s local
loop on a Raspberry Pi (reference README.md:48); it has no network
endpoint at all (predict.py:119-121 logs to a file).

One process drives one device: the server, its clients and the
streaming loop all run here, and no child process touches JAX.

Run from the repo root:  python benchmarks/serving_bench.py
Writes the full artifact to --out (gitignored chiprun_out/ by default)
and prints one JSON summary line.
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

# Runnable as `python benchmarks/serving_bench.py` from the repo root.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _build_predictor(dtype: str, batch_sizes, mode: str = "fast"):
    import jax
    import jax.numpy as jnp

    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.models.linear import LinearModel, SigmoidCalibration
    from radarml_tpu.models.pipeline import RadarPredictor

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
        model=model, calibration=calib, mode=mode,
        cube_dtype=("int8" if mode == "fused" else dtype),
        min_proba=0.0,
    )
    # Pre-compile every program shape the scenarios will hit so the
    # timed phases never stall on a compile.
    for b in sorted(set(batch_sizes)):
        cubes = np.zeros((b,) + DEFAULT_ARENA.grid_shape, np.float32)
        xyz = np.tile(
            np.array([0.0, 0.0, 100.0], np.float32), (b, 4, 1)
        )
        valid = np.ones((b, 4), bool)
        jax.block_until_ready(predictor(cubes, xyz, valid))
    return predictor


def _grpc_scenario(
    predictor, dtype: str, n_clients: int, window_ms: float,
    duration_s: float, batch_size: int,
):
    """One (clients, window) cell: fresh server, deadline-driven load."""
    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.rpc import RadarServingClient, RadarServingServer

    server = RadarServingServer(
        predictor, classes=["cat", "dog", "person"],
        grid_shape=DEFAULT_ARENA.grid_shape,
        batch_window_ms=window_ms, batch_size=batch_size,
        max_workers=n_clients + 4,
    ).start()
    addr = f"127.0.0.1:{server.port}"

    rng = np.random.default_rng(7)
    cube = np.rint(
        rng.random(DEFAULT_ARENA.grid_shape) * 255
    ).astype(np.float32)
    targets = [(5.0, 5.0, 100.0), (-10.0, 3.0, 150.0)]

    # Warm the wire + (for the batched path) the batcher's program.
    warm = RadarServingClient(addr, timeout_s=120.0)
    for _ in range(3):
        warm.classify(cube, targets, dtype=dtype)

    stats0 = warm.get_stats()
    latencies = [[] for _ in range(n_clients)]
    start_evt = threading.Event()
    deadline = [0.0]

    errors = [None] * n_clients

    def run(i):
        # Same honesty rule as the stream scenario: a dying client
        # must be visible in the record, not a silent rate deflation.
        try:
            client = RadarServingClient(addr, timeout_s=120.0, retries=0)
            my = latencies[i]
            start_evt.wait()
            while time.perf_counter() < deadline[0]:
                t0 = time.perf_counter()
                client.classify(cube, targets, dtype=dtype)
                my.append((time.perf_counter() - t0) * 1e3)
            client.close()
        except Exception as e:
            errors[i] = f"{type(e).__name__}: {str(e)[:120]}"

    threads = [
        threading.Thread(target=run, args=(i,), daemon=True)
        for i in range(n_clients)
    ]
    for t in threads:
        t.start()
    t_start = time.perf_counter()
    deadline[0] = t_start + duration_s
    start_evt.set()
    for i, t in enumerate(threads):
        t.join(timeout=duration_s + 120.0)
        if t.is_alive() and errors[i] is None:
            errors[i] = "client thread hung past join timeout"
    wall = time.perf_counter() - t_start

    stats1 = warm.get_stats()
    warm.close()
    server.stop()

    reqs = stats1.classify_requests - stats0.classify_requests
    batches = stats1.classify_batches - stats0.classify_batches
    nonempty = [np.asarray(l) for l in latencies if l]
    if not nonempty:
        # No request completed inside the window (a device stall, or a
        # duration shorter than one round-trip): report the scenario
        # as failed instead of crashing the whole bench matrix.
        return {
            "clients": n_clients,
            "batch_window_ms": window_ms,
            "requests": int(reqs),
            "error": f"no request completed within {duration_s}s",
        }
    lat = np.concatenate(nonempty)
    failed = {str(i): e for i, e in enumerate(errors) if e}
    return {
        "clients": n_clients,
        "batch_window_ms": window_ms,
        "requests": int(reqs),
        "scans_per_sec": round(len(lat) / wall, 1),
        "p50_ms": round(float(np.percentile(lat, 50)), 2),
        "p95_ms": round(float(np.percentile(lat, 95)), 2),
        "coalesce_ratio": round(reqs / batches, 2) if batches else None,
        **({"client_errors": failed} if failed else {}),
    }


def _grpc_stream_scenario(
    predictor, dtype: str, duration_s: float, batch_size: int,
    n_clients: int = 1,
):
    """ClassifyStream: continuous request stream(s), server-side batch
    coalescing — amortizes per-RPC overhead entirely. With
    n_clients > 1, that many independent streams run concurrently
    (each its own channel and call), exercising the server's
    padding/bucket logic across interleaved streams."""
    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.rpc import RadarServingClient, RadarServingServer

    server = RadarServingServer(
        predictor, classes=["cat", "dog", "person"],
        grid_shape=DEFAULT_ARENA.grid_shape,
        batch_size=batch_size, max_workers=n_clients + 4,
    ).start()
    addr = f"127.0.0.1:{server.port}"
    warm = RadarServingClient(addr, timeout_s=duration_s + 120.0)
    rng = np.random.default_rng(3)
    cube = np.rint(
        rng.random(DEFAULT_ARENA.grid_shape) * 255
    ).astype(np.float32)
    targets = [(5.0, 5.0, 100.0), (-10.0, 3.0, 150.0)]

    # Warm the (batch_size, T) program + the wire.
    list(warm.classify_stream(iter([(cube, targets)] * 3), dtype=dtype))

    stats0 = warm.get_stats()
    counts = [0] * n_clients
    start_evt = threading.Event()
    deadline = [0.0]

    errors = [None] * n_clients

    def run(i):
        # A client thread that dies (transient RPC error) must show up
        # in the record, not silently contribute counts[i]=0 and
        # deflate scans_per_sec while the server-side stats deltas
        # still include its work.
        try:
            client = RadarServingClient(addr, timeout_s=duration_s + 120.0)
            start_evt.wait()

            def scans():
                while time.perf_counter() < deadline[0]:
                    yield (cube, targets)

            counts[i] = sum(
                1 for _ in client.classify_stream(scans(), dtype=dtype)
            )
            client.close()
        except Exception as e:
            errors[i] = f"{type(e).__name__}: {str(e)[:120]}"

    threads = [
        threading.Thread(target=run, args=(i,), daemon=True)
        for i in range(n_clients)
    ]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    deadline[0] = t0 + duration_s
    start_evt.set()
    for i, t in enumerate(threads):
        t.join(timeout=duration_s + 120.0)
        if t.is_alive() and errors[i] is None:
            errors[i] = "client thread hung past join timeout"
    wall = time.perf_counter() - t0
    stats1 = warm.get_stats()
    warm.close()
    server.stop()

    n = sum(counts)
    reqs = stats1.classify_requests - stats0.classify_requests
    batches = stats1.classify_batches - stats0.classify_batches
    failed = {str(i): e for i, e in enumerate(errors) if e}
    return {
        "clients": n_clients,
        "transport": "ClassifyStream",
        "requests": int(n),
        "scans_per_sec": round(n / wall, 1),
        "coalesce_ratio": round(reqs / batches, 2) if batches else None,
        **({"client_errors": failed} if failed else {}),
    }


def _streaming_scenario(predictor, duration_s: float, max_batch: int):
    """Native C++ source, unthrottled, into the local sensor loop."""
    import jax

    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.drivers import NativeScanSource
    from radarml_tpu.serving import (
        StreamConfig,
        StreamingClassifier,
        native_scan_source,
    )

    # Warm the loop's padded program shape.
    cubes = np.zeros((max_batch,) + DEFAULT_ARENA.grid_shape, np.float32)
    xyz = np.tile(
        np.array([0.0, 0.0, 100.0], np.float32), (max_batch, 4, 1)
    )
    valid = np.ones((max_batch, 4), bool)
    jax.block_until_ready(predictor(cubes, xyz, valid))

    svc = StreamingClassifier(
        predictor,
        StreamConfig(
            max_batch=max_batch, max_wait_s=0.005,
            queue_depth=2 * max_batch,
        ),
    )
    src = NativeScanSource(
        arena=DEFAULT_ARENA, capacity=2 * max_batch, seed=11,
        scan_period_us=0.0,
    )
    src.start()
    svc.start(native_scan_source(src, DEFAULT_ARENA))
    time.sleep(duration_s)
    stats = svc.stats()
    produced = src.produced
    svc.stop()
    src.close()
    return {
        "duration_s": duration_s,
        "scans_per_sec": round(stats["processed"] / duration_s, 1),
        "produced_per_sec": round(produced / duration_s, 1),
        "dropped": int(stats["dropped"]),
        "mean_batch": round(stats["mean_batch"], 1),
        "p50_ms": round(stats["latency_p50_ms"], 2),
        "p95_ms": round(stats["latency_p95_ms"], 2),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="uint8",
                    choices=["uint8", "int8", "float32"])
    ap.add_argument("--mode", default="fast", choices=["fast", "fused"],
                    help="scoring path; fused streams int8 regardless "
                         "of --dtype (wire stays uint8-narrow either way)")
    ap.add_argument("--duration", type=float, default=8.0,
                    help="seconds of load per scenario")
    ap.add_argument("--clients", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--windows", type=float, nargs="+", default=[0.0, 10.0],
                    help="grpc batch windows (ms); 0 = no batching")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--stream_batch", type=int, default=64)
    ap.add_argument("--stream_clients", type=int, nargs="+",
                    default=[1, 4, 16],
                    help="concurrent ClassifyStream calls per scenario")
    ap.add_argument("--out", default="chiprun_out/serving_bench.json")
    ap.add_argument("--platform", default="",
                    help="JAX backend to run on (an explicit choice; "
                         "default: JAX's own)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from radarml_tpu.apps.common_cli import enable_compile_cache

    enable_compile_cache()

    # The server's batcher pads to power-of-two buckets ≤ batch_size;
    # precompile every bucket so timed phases never absorb a compile.
    buckets = [
        1 << i
        for i in range(int(args.batch_size).bit_length())
        if (1 << i) < args.batch_size
    ] + [args.batch_size]
    predictor = _build_predictor(
        args.dtype, [1, *buckets, args.stream_batch], args.mode
    )

    scenarios = []
    for window in args.windows:
        for n in args.clients:
            s = _grpc_scenario(
                predictor, args.dtype, n, window,
                args.duration, args.batch_size,
            )
            scenarios.append(s)
            # progress to stderr: stdout stays one JSON line (CLAUDE.md
            # bench.py contract — this runs as `bench.py --serving`)
            print(f"# grpc {s}", file=sys.stderr, flush=True)

    for n in args.stream_clients:
        grpc_stream = _grpc_stream_scenario(
            predictor, args.dtype, args.duration, args.batch_size,
            n_clients=n,
        )
        scenarios.append(grpc_stream)
        print(f"# grpc {grpc_stream}", file=sys.stderr, flush=True)

    stream = _streaming_scenario(predictor, args.duration, args.stream_batch)
    print(f"# stream {stream}", file=sys.stderr, flush=True)

    best = max(scenarios, key=lambda s: s.get("scans_per_sec", 0.0))
    artifact = {
        "dtype": args.dtype,
        "mode": args.mode,
        "device": str(jax.devices()[0]),
        "grpc": scenarios,
        "streaming": stream,
        "baseline_scans_per_sec": 5.0,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)

    print(json.dumps({
        "metric": "serving_scans_per_sec",
        "value": best.get("scans_per_sec", 0.0),
        "unit": "scans/s",
        "vs_baseline": round(best.get("scans_per_sec", 0.0) / 5.0, 1),
        "best_grpc": best,
        "streaming_scans_per_sec": stream.get("scans_per_sec", 0.0),
        "artifact": args.out,
    }))


if __name__ == "__main__":
    main()
