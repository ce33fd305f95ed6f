"""Benchmark: radar scans/sec (preprocess + classify) on one GPU.

Measures the framework's end-to-end predict hot path — projection
slicing, cubic-spline zoom, feature concat/scale, calibrated linear
scoring, thresholding — as the one jitted device program in
radarml_tpu.models.pipeline, in every scoring mode and stream dtype.
It needs a GPU: without one it prints an error line and exits 1 (a CPU
time is not a device number).

Baseline: the reference runs the same logical pipeline at ~5 scans/s on
a Raspberry Pi 4 (README.md:48, predict.log "Radar frame rate: 5.0"),
with ~8-10 ms of per-target preprocess+classify on top (BASELINE.md).
`vs_baseline` is scans/sec over that 5 scans/s figure. Scan cubes are
device-resident when timed (the radar itself bounds ingest in the real
system; the metric isolates per-device compute throughput).

Every rate is a slope (utils/slopetime): fixed per-call dispatch and
fetch overhead cancels. Scan cubes are integer-valued (the radar's raw
image is 8-bit, reference predict.py:90-91), so the bf16-, uint8- and
int8-stream modes are lossless.

Prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_SCANS_PER_SEC = 5.0
BATCH = int(os.environ.get("RADARML_BENCH_BATCH", "4096"))
MAX_TARGETS = 4
METRIC = "radar scans/sec (preprocess+classify) per GPU"

from radarml_tpu.utils.slopetime import slope_time  # noqa: E402


def device_latency_ms(predictor, cube1, xyz1, valid1, n_lo=64, n_hi=1024):
    """On-device single-scan latency, excluding dispatch overhead.

    Runs N data-dependent single-scan predict steps inside ONE
    lax.scan dispatch (scan iterations execute strictly sequentially)
    for two values of N and takes the slope — per-dispatch overhead
    cancels. Each step streams its own cube from device memory, so the
    measured step is the full preprocess+classify
    program the reference times at ~8-10 ms/target on the Pi 4
    (BASELINE.md; predict.log 05:53:22,923→,931).
    """
    import jax
    import jax.numpy as jnp

    fn = predictor._fn

    def make_chain(n):
        @jax.jit
        def run(cubes_n, xyz, valid):
            def body(acc, c):
                pred, best_p, _ = fn(c[None], xyz, valid)
                return acc + jnp.sum(best_p), None

            acc, _ = jax.lax.scan(body, jnp.float32(0), cubes_n)
            return acc

        return run

    from radarml_tpu.models.pipeline import encode_int8_cubes

    rng = np.random.default_rng(3)
    cube_np = np.asarray(cube1, np.float32)[0]
    if predictor.cube_dtype == "int8":
        cube_np = cube_np + 128.0  # cube1 arrived encoded; decode
    times = {}
    for n in (n_lo, n_hi):
        raw = np.rint(
            cube_np[None] * rng.uniform(0.9, 1.1, size=(n, 1, 1, 1))
        ).astype(np.float32)
        if predictor.cube_dtype == "int8":
            cubes_n = encode_int8_cubes(np.clip(raw, 0, 255))
        else:
            cubes_n = jnp.asarray(raw, dtype=jnp.dtype(predictor.cube_dtype))
        chain = make_chain(n)
        _ = jax.device_get(chain(cubes_n, xyz1, valid1))  # compile
        times[n] = chain, cubes_n

    def timed(n):
        chain, cubes_n = times[n]
        t0 = time.perf_counter()
        _ = jax.device_get(chain(cubes_n, xyz1, valid1))
        return time.perf_counter() - t0

    # Paired slopes + median (same rationale as slopetime.py).
    slopes = sorted(
        (timed(n_hi) - timed(n_lo)) / (n_hi - n_lo) for _ in range(5)
    )
    med = slopes[len(slopes) // 2]
    if med <= 0:
        positive = [s for s in slopes if s > 0]
        med = positive[0] if positive else abs(med)
    return med * 1e3


def main():
    import jax
    import jax.numpy as jnp

    from radarml_tpu.apps.common_cli import enable_compile_cache
    from radarml_tpu.utils import card_name_and_power_limit

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "scans/s",
                          "error": f"no GPU (JAX found {dev.platform})"}))
        sys.exit(1)

    t_start = time.perf_counter()

    def mark(phase):
        # stderr phase markers: make a timeout diagnosable.
        print(f"# t+{time.perf_counter() - t_start:.0f}s {phase}",
              file=sys.stderr, flush=True)

    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.data.labels import LabelEncoder
    from radarml_tpu.data.synthetic import make_dataset, make_scan_batch
    from radarml_tpu.models.linear import (
        SGDConfig,
        calibrate_ovr,
        sgd_fit,
        sgd_model,
    )
    from radarml_tpu.models.pipeline import (
        RadarPredictor,
        encode_int8_cubes,
        pad_targets,
    )
    from radarml_tpu.ops.features import process_samples

    # --- train a small demo model (not timed) ---------------------------
    samples, labels = make_dataset(90, seed=11)
    le, y = LabelEncoder.fit_transform(labels)
    X = process_samples(samples, scale=True).astype(np.float32)
    cfg = SGDConfig(alpha=1e-5)
    state = sgd_fit(X[:70], y[:70], n_classes=len(le.classes_), cfg=cfg, epochs=15)
    model = sgd_model(state, cfg)
    calib = calibrate_ovr(model, X[70:], y[70:])

    kw = dict(
        train_arena=DEFAULT_ARENA,
        scan_arena=DEFAULT_ARENA,
        model=model,
        calibration=calib,
        min_proba=0.7,
    )
    # exact: reference math stage-by-stage. fast: model folded into
    # native-resolution templates + whole-cube contraction tables
    # (models/pipeline.py), on a float32/bf16/uint8/int8 stream. fused:
    # fast+int8 with the three tables from one kernel program per scan.
    predictors = {
        "exact": RadarPredictor(mode="exact", **kw),
        "fast": RadarPredictor(mode="fast", **kw),
        "fast_bf16": RadarPredictor(mode="fast", cube_dtype="bfloat16", **kw),
        "fast_u8": RadarPredictor(mode="fast", cube_dtype="uint8", **kw),
        "fast_i8": RadarPredictor(mode="fast", cube_dtype="int8", **kw),
        "fused": RadarPredictor(mode="fused", **kw),
    }

    # --- benchmark input: batch of scans, 4 target slots each ------------
    cubes_np, targets = make_scan_batch(BATCH, seed=7)
    cubes_np = np.rint(cubes_np)  # 8-bit radar range → bf16-exact
    xyz_np, valid_np = pad_targets(
        [[(t.x, t.y, t.z)] for t in targets], max_targets=MAX_TARGETS
    )
    xyz = jax.device_put(xyz_np)
    valid = jax.device_put(valid_np)

    def put_cubes(arr, predictor):
        if predictor.cube_dtype == "int8":
            return jax.device_put(encode_int8_cubes(arr))
        return jax.device_put(
            jnp.asarray(arr, dtype=jnp.dtype(predictor.cube_dtype))
        )

    # The two int8 modes are close, so they interleave rounds and take
    # medians; the others sit far apart and one round orders them. The
    # split also bounds device memory: each mode's cube buffer is
    # freed before the next (exact's float32 working set is GBs).
    contested = ("fast_i8", "fused")

    def make_timer(predictor, cubes):
        return lambda: BATCH / slope_time(
            lambda: predictor(cubes, xyz, valid),
            lambda out: jax.device_get(out[0][:1]),
        )

    runs = {}
    for name in [n for n in predictors if n not in contested]:
        predictor = predictors[name]
        cubes = put_cubes(cubes_np, predictor)
        jax.device_get(predictor(cubes, xyz, valid)[0][:1])  # compile
        runs[name] = [make_timer(predictor, cubes)()]
        del cubes
    mark("single-round modes done")

    timers = {}
    for name in contested:
        predictor = predictors[name]
        cubes = put_cubes(cubes_np, predictor)
        jax.device_get(predictor(cubes, xyz, valid)[0][:1])  # compile
        timers[name] = make_timer(predictor, cubes)
    runs.update({name: [] for name in timers})
    for _ in range(7):
        for name, t in timers.items():
            runs[name].append(t())
    rates = {name: float(np.median(v)) for name, v in runs.items()}
    mark("interleaved rounds done")

    best_mode = max(rates, key=rates.get)
    scans_per_sec = rates[best_mode]
    predictor = predictors[best_mode]

    # --- single-scan p50 latency (end-to-end, includes dispatch) --------
    cubes1 = put_cubes(cubes_np[:1], predictor)
    x1, v1 = xyz[:1], valid[:1]
    out = predictor(cubes1, x1, v1)
    _ = jax.device_get(out[0])
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        out = predictor(cubes1, x1, v1)
        _ = jax.device_get(out[0])
        lat.append(time.perf_counter() - t0)
    p50_ms = float(np.median(lat) * 1e3)
    dev_ms = device_latency_ms(predictor, cubes1, x1, v1)
    mark("latency done")

    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": round(scans_per_sec, 1),
                "unit": "scans/s",
                "vs_baseline": round(scans_per_sec / BASELINE_SCANS_PER_SEC, 1),
                "p50_single_scan_ms": round(p50_ms, 3),
                "p50_device_scan_ms": round(dev_ms, 4),
                "batch": BATCH,
                "mode": best_mode,
                **{f"scans_per_sec_{k}": round(v, 1) for k, v in rates.items()},
                "rounds": {
                    k: [round(x, 1) for x in v] for k, v in runs.items()
                },
                "max_targets": MAX_TARGETS,
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "card": card_name_and_power_limit(),  # name, power limit
            }
        )
    )


if __name__ == "__main__":
    if "--serving" in sys.argv:
        # End-to-end serving surfaces (gRPC + sensor loop) instead of
        # the device hot path; prints one JSON line (see
        # benchmarks/serving_bench.py).
        sys.argv.remove("--serving")
        from benchmarks.serving_bench import main as serving_main

        serving_main()
    else:
        main()
