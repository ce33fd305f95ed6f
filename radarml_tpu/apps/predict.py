"""CLI: real-time radar target classification.

Mirror of the reference's predict.py entry point (predict.py:133-229):
bring up a radar session, load the pickled model + label encoder, and
loop Trigger → GetSensorTargets → GetRawImage → classify, logging each
prediction and falling back to "Unknown" below --min_proba.

The classify stage is the batched jitted RadarPredictor program
(models/pipeline.py): slicing, zoom, feature build and calibrated
scoring fuse into one device program, optionally micro-batching
--batch_scans scans per device call for throughput (the reference
classifies one target at a time in Python at ~8-10 ms each,
predict.log; one device program amortizes that to microseconds).
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np

from radarml_tpu.apps.common_cli import (
    add_common_flags,
    add_driver_flags,
    add_scan_arena_flag,
    build_driver,
    load_label_encoder,
    load_model,
    parse_arena,
    parse_proj_mask,
    setup_logging,
)
from radarml_tpu.core.arena import DEFAULT_ARENA
from radarml_tpu.drivers import RadarSession
from radarml_tpu.models.pipeline import RadarPredictor, UNKNOWN, pad_targets

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--min_proba", type=float, default=0.7,
                   help="minimum prediction probability")
    p.add_argument("--svm_model", type=str,
                   default="train-results/svm_radar_classifier.pickle")
    p.add_argument("--label_encoder", type=str,
                   default="train-results/radar_labels.pickle")
    p.add_argument("--proj_mask", nargs="+", default=[True, True, True],
                   help="projection mask (xz, yz, xy)")
    p.add_argument("--num_scans", type=int, default=0,
                   help="stop after N scans (0 = run forever)")
    p.add_argument("--batch_scans", type=int, default=1,
                   help="scans per device call")
    p.add_argument("--max_targets", type=int, default=4)
    p.add_argument("--log_file", type=str, default="predict.log")
    p.add_argument("--cube_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "uint8", "int8"],
                   help="device dtype of the scan stream; bfloat16/uint8/"
                        "int8 are lossless for 8-bit radar data and cut "
                        "host-link and device-memory traffic 2x/4x/4x "
                        "(use with --mode fast; int8 additionally scores "
                        "via quantized s8 templates; uint8/int8 truncate "
                        "non-integer cubes)")
    p.add_argument("--mode", type=str, default="exact",
                   choices=["exact", "fast", "fused"],
                   help="scoring path: exact reference math, folded "
                        "templates (fast: identical detections), or "
                        "fast+int8 with the three table contractions in "
                        "one pass over each cube (fused: a Pallas "
                        "kernel compiled through Triton for the GPU; "
                        "decisions identical to fast with --cube_dtype "
                        "int8)")
    p.add_argument("--derived_targets", action="store_true",
                   help="derive targets from the raw cube on-device "
                        "instead of trusting the sensor's reports (the "
                        "reference's dormant DerivedTarget path, "
                        "common.py:45-80)")
    p.add_argument("--profile", type=str, default="",
                   help="write a jax.profiler device trace to this dir")
    add_scan_arena_flag(p)
    add_driver_flags(p)
    add_common_flags(p)
    return p


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_file, args.logging_level)

    model, calib = load_model(args.svm_model)
    le = load_label_encoder(args.label_encoder)
    logger.info("Loaded model from %s; classes: %s",
                args.svm_model, list(le.classes_))

    # The radar scans --scan_arena; features zoom into the training
    # arena inside the predictor (reference predict.py:34-54).
    arena = parse_arena(args.scan_arena)
    if arena != DEFAULT_ARENA:
        logger.info(
            "Scan arena %s differs from training arena; zooming "
            "projections by train/scan per axis.", arena.grid_shape,
        )
    predictor = RadarPredictor(
        train_arena=DEFAULT_ARENA,
        scan_arena=arena,
        model=model,
        calibration=calib,
        proj_mask=parse_proj_mask(args.proj_mask),
        min_proba=args.min_proba,
        mode=args.mode,
        cube_dtype=args.cube_dtype,
    )

    from radarml_tpu.utils import RateMeter, StageTimer, device_trace

    timer = StageTimer()
    meter = RateMeter()
    driver = build_driver(args, arena)
    results = []
    scans = 0
    try:
        with device_trace(args.profile), RadarSession(driver) as radar:
            while args.num_scans == 0 or scans < args.num_scans:
                cubes, target_lists = [], []
                for _ in range(args.batch_scans):
                    with timer("trigger"):
                        radar.trigger()
                        targets = radar.get_sensor_targets()
                    scans += 1
                    if args.derived_targets:
                        with timer("read_image"):
                            cube = radar.get_raw_image()
                        with timer("derive_targets"):
                            from radarml_tpu.core.arena import derive_targets

                            tx, ty, tz, _amp = derive_targets(
                                cube, arena, num_targets=1
                            )
                        cubes.append(cube)
                        target_lists.append(
                            [(float(tx[0]), float(ty[0]), float(tz[0]))]
                        )
                        continue
                    if not targets:
                        logger.debug("No targets.")
                        continue
                    with timer("read_image"):
                        cubes.append(radar.get_raw_image())
                    target_lists.append([(t.x, t.y, t.z) for t in targets])
                if not cubes:
                    continue
                n_real = len(cubes)
                # Pin the device program's batch shape: scans with no
                # targets are dropped above, so a partial batch would
                # compile a DIFFERENT program per distinct size.
                # Padding with valid=False rows keeps every classify
                # call on one compiled shape.
                if n_real < args.batch_scans:
                    cubes.extend([cubes[-1]] * (args.batch_scans - n_real))
                    target_lists.extend(
                        [[]] * (args.batch_scans - n_real)
                    )
                xyz, valid = pad_targets(target_lists, args.max_targets)
                t0 = time.perf_counter()
                with timer("classify"):
                    pred, proba, _ = predictor(np.stack(cubes), xyz, valid)
                    pred = np.asarray(pred)
                    proba = np.asarray(proba)
                meter.tick(n_real)
                dt_ms = (time.perf_counter() - t0) * 1e3
                for b in range(pred.shape[0]):
                    for t in range(pred.shape[1]):
                        if not valid[b, t]:
                            continue
                        if pred[b, t] == UNKNOWN:
                            name = "Unknown"
                        else:
                            name = le.classes_[int(pred[b, t])]
                        logger.info(
                            "Detected %s with proba %.3f (%.2f ms/batch)",
                            name, float(proba[b, t]), dt_ms,
                        )
                        results.append((name, float(proba[b, t])))
    except KeyboardInterrupt:
        logger.info("Caught KeyboardInterrupt, shutting down radar.")
    logger.info("Scan rate (EMA): %.1f scans/s", meter.rate)
    timer.log_summary()
    return results


if __name__ == "__main__":
    main()
