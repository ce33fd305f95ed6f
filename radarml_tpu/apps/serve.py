"""CLI: continuous streaming classification service.

Production-shaped serving loop the reference doesn't have: a C++ (or
synthetic) scan source feeds an ingest thread; scans batch by
max-size-or-max-wait; each batch runs the jitted predictor; detections
stream to the log with end-to-end latency. Prints a JSON stats line on
exit.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

from radarml_tpu.apps.common_cli import (
    add_common_flags,
    add_driver_flags,
    add_scan_arena_flag,
    build_driver,
    load_label_encoder,
    load_model,
    parse_arena,
    setup_logging,
)
from radarml_tpu.core.arena import DEFAULT_ARENA
from radarml_tpu.models.pipeline import RadarPredictor, UNKNOWN
from radarml_tpu.serving import (
    StreamConfig,
    StreamingClassifier,
    driver_scan_source,
    native_scan_source,
)

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--svm_model", type=str,
                   default="train-results/svm_radar_classifier.pickle")
    p.add_argument("--label_encoder", type=str,
                   default="train-results/radar_labels.pickle")
    p.add_argument("--min_proba", type=float, default=0.7)
    p.add_argument("--cube_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16", "uint8", "int8"],
                   help="device dtype of the scan stream; bfloat16/uint8/"
                        "int8 are lossless for 8-bit radar data and cut "
                        "host-link and device-memory traffic 2x/4x/4x "
                        "(int8 scores via quantized s8 templates; "
                        "uint8/int8 truncate non-integer cubes)")
    p.add_argument("--mode", type=str, default="fast",
                   choices=["exact", "fast", "fused"],
                   help="scoring path (identical detections; fast is "
                        "strictly faster than exact; fused is fast+int8 "
                        "with the three table contractions in one pass "
                        "over each cube, a Pallas kernel compiled "
                        "through Triton for the GPU)")
    p.add_argument("--duration", type=float, default=10.0,
                   help="seconds to serve (0 = until interrupted)")
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--max_wait_ms", type=float, default=10.0)
    p.add_argument("--log_detections", action="store_true")
    p.add_argument("--sensors", type=int, default=1,
                   help="number of (synthetic) sensors to multiplex")
    p.add_argument("--export_serving", type=str, default="",
                   help="export the compiled predictor (symbolic batch, "
                        "weights folded in) to this path and exit; the "
                        "artifact serves via --serving_artifact with no "
                        "model pickles or pipeline code")
    p.add_argument("--serving_artifact", type=str, default="",
                   help="serve from an AOT artifact written by "
                        "--export_serving instead of building the "
                        "predictor from --svm_model")
    p.add_argument("--allow_v1_artifact", action="store_true",
                   help="accept legacy v1 PICKLE serving artifacts "
                        "(loading runs the unpickler — only for "
                        "trusted paths; re-export to v2 to avoid)")
    p.add_argument("--grpc_port", type=int, default=-1,
                   help="serve classifications over gRPC on this port "
                        "(0 = auto-pick) instead of running the local "
                        "sensor loop; clients ship raw scan cubes and "
                        "get calibrated detections (rpc/radar_serving"
                        ".proto)")
    p.add_argument("--grpc_host", type=str, default="127.0.0.1",
                   help="gRPC bind address; 0.0.0.0 accepts remote "
                        "edge clients")
    p.add_argument("--grpc_batch_window_ms", type=float, default=0.0,
                   help="dynamic batching: >0 enables leader-follower "
                        "coalescing of concurrent Classify calls "
                        "(bucketed padding, no hold window — the value "
                        "is only an on/off switch; 0 = off)")
    p.add_argument("--grpc_max_inflight_batches", type=int, default=8,
                   help="dynamic batching: concurrent leader slots "
                        "(device programs in flight); excess demand "
                        "queues and coalesces. Throughput over a "
                        "high-latency link tracks in-flight scans, so "
                        "keep slots >= the per-program concurrency the "
                        "unbatched path would enjoy")
    p.add_argument("--grpc_batch_size", type=int, default=8,
                   help="dynamic batching: max requests per device batch")
    p.add_argument("--grpc_publish", action="store_true",
                   help="with --grpc_port: run the local sensor loop "
                        "AND stream its detections to gRPC Subscribe "
                        "consumers (Classify stays available)")
    p.add_argument("--reload_poll", type=float, default=0.0,
                   help="hot-reload: poll the model artifact every N "
                        "seconds and swap the predictor in-place when "
                        "it changes (0 = off); pairs with "
                        "train --online_learn rewriting the artifact")
    add_scan_arena_flag(p)
    add_driver_flags(p)
    add_common_flags(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    setup_logging(None, args.logging_level)

    if args.export_serving and args.serving_artifact:
        raise SystemExit(
            "--export_serving needs a predictor built from "
            "--svm_model, not --serving_artifact"
        )
    le = load_label_encoder(args.label_encoder)
    # Sensors scan --scan_arena; the predictor zooms projections into
    # the training arena (reference predict.py:34-54). AOT artifacts
    # bake their own scan grid and ignore this flag.
    scan_arena = parse_arena(args.scan_arena)

    def build_predictor():
        if args.serving_artifact:
            from radarml_tpu.serving import load_serving_artifact

            p = load_serving_artifact(
                args.serving_artifact,
                allow_v1_pickle=args.allow_v1_artifact,
            )
            logger.info(
                "serving from AOT artifact %s (mode=%s, platforms=%s)",
                args.serving_artifact, p.mode, p.platforms,
            )
            if abs(p.min_proba - args.min_proba) > 1e-9:
                logger.warning(
                    "--min_proba %.2f ignored: the artifact bakes in %.2f "
                    "(thresholds are constants in the exported program; "
                    "re-export to change)",
                    args.min_proba, p.min_proba,
                )
            return p
        model, calib = load_model(args.svm_model)
        return RadarPredictor(
            train_arena=DEFAULT_ARENA, scan_arena=scan_arena,
            model=model, calibration=calib,
            min_proba=args.min_proba, mode=args.mode,
            cube_dtype=args.cube_dtype,
        )

    predictor = build_predictor()

    # A fused AOT artifact bakes a static batch; smaller batches pad up
    # inside ServingArtifact, but LARGER ones cannot run — clamp the
    # service's batch knobs so every served shape fits.
    baked = getattr(predictor, "batch", None)
    if baked:
        for knob in ("max_batch", "grpc_batch_size"):
            if getattr(args, knob) > baked:
                logger.warning(
                    "--%s %d exceeds the artifact's baked batch %d; "
                    "clamping", knob, getattr(args, knob), baked,
                )
                setattr(args, knob, baked)

    swap_targets = []  # objects whose .predictor / set_predictor to update

    def start_reloader():
        if args.reload_poll <= 0:
            return None
        from radarml_tpu.serving.reload import ModelReloader

        watch = args.serving_artifact or args.svm_model

        def build_and_warm():
            import jax
            import numpy as np

            p = build_predictor()
            # Compile every served shape off the serving path so the
            # swap is seamless: the streaming loop pads batches to
            # max_batch, and the gRPC Classify path runs (1, T). Use
            # the new predictor's own grid/target geometry (an AOT
            # artifact bakes both).
            grid = tuple(
                getattr(p, "grid_shape", None) or scan_arena.grid_shape
            )
            T = int(getattr(p, "max_targets", 4))
            loop_active = args.grpc_port < 0 or args.grpc_publish
            for b in sorted({args.max_batch, 1} if loop_active else {1}):
                warm = np.zeros((b,) + grid, np.float32)
                xyz_w = np.zeros((b, T, 3), np.float32)
                valid_w = np.zeros((b, T), bool)
                jax.block_until_ready(p(warm, xyz_w, valid_w))
            return p

        def swap(p):
            for tgt in swap_targets:
                if hasattr(tgt, "set_predictor"):
                    tgt.set_predictor(p)
                else:
                    tgt.predictor = p
            if rpc_server is not None:
                rpc_server.note_model_reload()

        reloader = ModelReloader(
            watch, build_and_warm, swap, poll_s=args.reload_poll
        )
        reloader.start()
        logger.info("hot-reload watching %s every %.1fs", watch,
                    args.reload_poll)
        return reloader
    if args.export_serving:
        from radarml_tpu.serving import export_predictor

        fused = predictor.mode == "fused"
        export_predictor(
            predictor, args.export_serving,
            # The fused kernel lowers for the backend it was built for
            # only (Triton on the GPU), so it exports for the current
            # backend; every other mode is plain XLA and exports for
            # both the GPU and the CPU.
            platforms=(None if fused else ("cuda", "cpu")),
            # the kernel's grid is the scan batch, so fused exports bake
            # a static batch: the service scores in --max_batch chunks.
            batch=(args.max_batch if fused else None),
        )
        return {"exported": args.export_serving}

    rpc_server = None
    if args.grpc_port >= 0:
        from radarml_tpu.rpc.radar_server import RadarServingServer

        grid = getattr(predictor, "grid_shape", None) or scan_arena.grid_shape
        rpc_server = RadarServingServer(
            predictor, classes=list(le.classes_), grid_shape=grid,
            # An AOT artifact bakes its target-slot axis; match it.
            max_targets=int(getattr(predictor, "max_targets", 4)),
            port=args.grpc_port,
            host=args.grpc_host,
            batch_window_ms=args.grpc_batch_window_ms,
            batch_size=args.grpc_batch_size,
            max_concurrent_batches=args.grpc_max_inflight_batches,
        )
        # Compile the (1, T) Classify program before accepting traffic
        # so the first client RPC doesn't absorb a 30-90 s compile and
        # blow its deadline.
        import jax
        import numpy as np

        T_rpc = int(getattr(predictor, "max_targets", 4))
        logger.info("warming gRPC classify program...")
        # (1,T) serves unary Classify; the batcher and ClassifyStream
        # pad to power-of-two bucket shapes, so compile every bucket
        # now rather than stalling the first partially-loaded batch.
        rpc_batches = {1} | set(rpc_server.batch_buckets)
        for b_rpc in sorted(rpc_batches):
            jax.block_until_ready(
                predictor(
                    np.zeros((b_rpc,) + tuple(grid), np.float32),
                    np.zeros((b_rpc, T_rpc, 3), np.float32),
                    np.zeros((b_rpc, T_rpc), bool),
                )
            )
        rpc_server.start()
        swap_targets.append(rpc_server)
        print(json.dumps({"grpc_port": rpc_server.port}), flush=True)
        if not args.grpc_publish:
            # Endpoint-only mode: no local sensor loop.
            reloader = start_reloader()
            try:
                if args.duration > 0:
                    time.sleep(args.duration)
                else:
                    while True:
                        time.sleep(1)
            except KeyboardInterrupt:
                pass
            finally:
                if reloader:
                    reloader.stop()
                rpc_server.stop()
            return {"grpc_port": rpc_server.port}

    def on_detection(d):
        if rpc_server is not None:
            name = "" if d.label_index == UNKNOWN else le.classes_[
                d.label_index
            ]
            rpc_server.publish(
                d.seq, d.target_index, name, d.proba, d.latency_ms
            )
        if args.log_detections:
            name = "Unknown" if d.label_index == UNKNOWN else le.classes_[
                d.label_index
            ]
            logger.info(
                "scan %d target %d: %s (%.3f) %.1fms",
                d.seq, d.target_index, name, d.proba, d.latency_ms,
            )

    # Warm/compile the device program before opening the stream so the
    # first real batch doesn't absorb compile time into its latency.
    import numpy as np

    logger.info("warming predictor (compile)...")
    warm_cubes = np.zeros(
        (args.max_batch,) + scan_arena.grid_shape, np.float32
    )
    warm_xyz = np.tile(
        np.array([0.0, 0.0, 100.0], np.float32), (args.max_batch, 4, 1)
    )
    warm_valid = np.ones((args.max_batch, 4), bool)
    import jax

    jax.block_until_ready(predictor(warm_cubes, warm_xyz, warm_valid))
    logger.info("predictor ready")

    # Shallow queue = low latency: beyond ~2 batches of backlog the
    # newest-wins drop policy should kick in rather than queueing
    # stale scans (a 5 Hz sensor's scan is worthless 2 s later).
    svc = StreamingClassifier(
        predictor,
        StreamConfig(
            max_batch=args.max_batch,
            max_wait_s=args.max_wait_ms / 1e3,
            queue_depth=2 * args.max_batch,
        ),
        on_detection=on_detection,
    )
    swap_targets.append(svc)
    if rpc_server is not None:
        rpc_server.set_loop_stats_fn(svc.stats)
    reloader = start_reloader()

    if args.driver == "native":
        from radarml_tpu.drivers import NativeScanSource

        src = NativeScanSource(
            arena=scan_arena, seed=args.driver_seed,
            scan_period_us=args.scan_period * 1e6,
        )
        src.start()
        source = native_scan_source(src, scan_arena)
        cleanup = src.close
    else:
        from radarml_tpu.drivers import RadarSession

        sessions = []
        sources = []
        for s in range(max(args.sensors, 1)):
            sensor_args = argparse.Namespace(**vars(args))
            sensor_args.driver_seed = args.driver_seed + s
            driver = build_driver(sensor_args, scan_arena)
            session = RadarSession(driver)
            session.__enter__()
            sessions.append(session)
            sources.append(driver_scan_source(driver))
        source = sources if len(sources) > 1 else sources[0]

        def cleanup():
            for session in sessions:
                session.__exit__(None, None, None)

    svc.start(source)
    try:
        if args.duration > 0:
            time.sleep(args.duration)
        else:
            while True:
                time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        if reloader:
            reloader.stop()
        svc.stop()
        cleanup()
        if rpc_server is not None:
            rpc_server.stop()
    stats = svc.stats()
    if reloader:
        stats["model_reloads"] = reloader.reloads
    print(json.dumps({k: round(v, 2) if isinstance(v, float) else v
                      for k, v in stats.items()}))
    return stats


if __name__ == "__main__":
    main()
