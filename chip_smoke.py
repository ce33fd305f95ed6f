"""Prove that the main path runs on one NVIDIA GPU: train → predict → serve.

Run from the checkout root:  python chip_smoke.py

One process, no child that imports JAX. It calls the apps' own
`main(argv)` functions at the reference arena (22×31×176, 3 classes,
calibrated) and then holds each device path to a plain reference:

  0. device   — JAX must report a GPU; otherwise exit 2 with no result.
  1. train    — apps.train: linear SGD grid search on synthetic data.
  2. predict  — apps.predict once per mode (exact, fast f32, fast int8,
                fused), then the same predictors through the API at
                4096 scans × 4 targets: fused == fast+int8, fast ≈ exact,
                exact ≈ a float64 scipy reference on 64 scans.
  3. kernel   — the Triton kernel's int32 tables == an int64 numpy
                oracle at batch 4096; fused vs fast+int8 timed end to
                end; memory analysis of the fused step.
  4. serve    — apps.serve's sensor loop, then --export_serving and
                --serving_artifact, with the artifact's decisions equal
                to the live predictor's.

Any failed check raises, so the script exits non-zero. The last stdout
line is {"ok": true, "device": {...}}; every finding is printed before
it. Outputs go to train-results/chip_smoke/ (gitignored).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "train-results", "chip_smoke")
SERVE_MODE = "fused"  # the bulk path the kernel measurement kept


def log(msg: str):
    print(msg, flush=True)


def check(cond, what: str):
    if not cond:
        raise AssertionError(what)


def median_ms(fn, calls: int) -> tuple:
    """Warm up, then the median and all times of `calls` runs, each
    ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


# ---------------------------------------------------------------- phase 1
def phase_train(out: str, n_samples: int = 150) -> dict:
    from radarml_tpu.apps import train as train_app

    paths = {
        "model": os.path.join(out, "model.pickle"),
        "labels": os.path.join(out, "labels.pickle"),
    }
    result = train_app.main([
        "--synthetic", str(n_samples),
        "--datasets", os.path.join(out, "dataset.pickle"),
        "--grid_epochs", "3", "--folds", "2",
        "--svm_cm", "",
        "--svm_model", paths["model"],
        "--label_encoder", paths["labels"],
        "--log_file", os.path.join(out, "train.log"),
    ])
    acc = float(result["metrics"]["accuracy"])
    check(os.path.exists(paths["model"]), "train wrote no model")
    log(f"train: synthetic n={n_samples}, test accuracy {acc}")
    return paths


# ---------------------------------------------------------------- phase 2
def scan_batch(batch: int, targets: int, seed: int = 7):
    """Synthetic scans; slot 0 holds the scan's planted target, the
    other slots targets planted in other scans (all in the arena)."""
    from radarml_tpu.data.synthetic import make_scan_batch

    cubes, planted = make_scan_batch(batch, seed=seed)
    cubes = np.rint(cubes).astype(np.float32)  # 8-bit sensor values
    pos = np.array([(t.x, t.y, t.z) for t in planted], np.float32)
    xyz = np.stack(
        [pos[(np.arange(batch) + 37 * s) % batch] for s in range(targets)],
        axis=1,
    )
    # planted targets sit on grid nodes, i.e. on cell boundaries; move
    # them off (the reference comparison drops the few still near one)
    jitter = np.random.default_rng(seed).uniform(0.5, 1.5, xyz.shape)
    xyz = (xyz + jitter).astype(np.float32)
    return cubes, xyz, np.ones((batch, targets), bool)


def build_predictors(paths: dict, interpret: bool = False) -> dict:
    from radarml_tpu.apps.common_cli import load_model
    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.models.pipeline import RadarPredictor

    model, calib = load_model(paths["model"])
    kw = dict(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
              model=model, calibration=calib, min_proba=0.7)
    return {
        "exact": RadarPredictor(mode="exact", **kw),
        "fast": RadarPredictor(mode="fast", **kw),
        "fast_i8": RadarPredictor(mode="fast", cube_dtype="int8", **kw),
        "fused": RadarPredictor(mode="fused", interpret=interpret, **kw),
    }


BOUNDARY = 2e-3  # cell units: the program's 1e-3 nudge + float32 error


def reference_indices(xyz) -> tuple:
    """Float64 (i, j, k) cube cells of targets (..., 3) by the reference
    common.py spherical mapping, truncated and clamped into the arena,
    and whether a target lies within BOUNDARY of a cell boundary on any
    axis, where the cell is a matter of rounding, not of scoring."""
    from radarml_tpu.core.arena import DEFAULT_ARENA as a

    x, y, z = np.moveaxis(np.asarray(xyz, np.float64), -1, 0)
    r = np.sqrt(x * x + y * y + z * z)
    theta = np.rad2deg(np.arcsin(x / r))
    phi = np.rad2deg(np.arctan2(y, z))
    cont = np.stack([
        (theta - a.theta_min) * (a.size_x - 1) / (a.theta_max - a.theta_min),
        (phi - a.phi_min) * (a.size_y - 1) / (a.phi_max - a.phi_min),
        (r - a.r_min) * (a.size_z - 1) / (a.r_max - a.r_min),
    ], axis=-1)
    near = (np.abs(cont - np.rint(cont)) < BOUNDARY).any(-1)
    top = np.array([a.size_x, a.size_y, a.size_z]) - 1
    return np.clip(np.trunc(cont).astype(np.int64), 0, top), near


def reference_proba(model, calib, cube, ijk) -> np.ndarray:
    """Plain float64 host reference for one target: slice the three
    projections, scipy spline zoom into the training arena, concat and
    scale, linear decision, OvR sigmoid calibration."""
    from scipy import ndimage

    from radarml_tpu.core.arena import RADAR_MAX

    i, j, k = ijk
    c = np.asarray(cube, np.float64)
    planes = (c[:, j, :], c[i, :, :], c[:, :, k])  # xz, yz, xy
    feats = np.concatenate([
        ndimage.zoom(p, 1.0, order=3).reshape(-1) for p in planes
    ]) / RADAR_MAX
    dec = np.asarray(model.coef, np.float64) @ feats + np.asarray(
        model.intercept, np.float64)
    p = 1.0 / (1.0 + np.exp(np.asarray(calib.a, np.float64) * dec
                            + np.asarray(calib.b, np.float64)))
    return p / p.sum()


def decisions_agree(pred_a, pred_b, proba_ref, min_proba, tol) -> int:
    """Decisions must match except where the reference probability is
    within `tol` of the threshold or of the runner-up class (there a
    last-bit difference may flip a decision legitimately). Returns the
    number of such marginal slots."""
    top2 = np.sort(proba_ref, axis=-1)[..., -2:]
    marginal = ((np.abs(top2[..., 1] - min_proba) <= tol)
                | (top2[..., 1] - top2[..., 0] <= tol))
    bad = (np.asarray(pred_a) != np.asarray(pred_b)) & ~marginal
    check(not bad.any(), f"{int(bad.sum())} non-marginal decisions differ")
    return int(marginal.sum())


def phase_predict(paths: dict, out: str, batch: int, targets: int,
                  ref_scans: int, interpret: bool = False) -> tuple:
    import jax

    from radarml_tpu.apps import predict as predict_app

    for mode, dtype in (("exact", "float32"), ("fast", "float32"),
                        ("fast", "int8"), ("fused", "int8")):
        results = predict_app.main([
            "--num_scans", "8", "--batch_scans", "4",
            "--mode", mode, "--cube_dtype", dtype, "--min_proba", "0.0",
            "--svm_model", paths["model"],
            "--label_encoder", paths["labels"],
            "--log_file", os.path.join(out, f"predict_{mode}_{dtype}.log"),
        ])
        check(results, f"predict --mode {mode} classified nothing")
        log(f"predict app: --mode {mode} --cube_dtype {dtype}: "
            f"{len(results)} detections")

    preds = build_predictors(paths, interpret=interpret)
    cubes, xyz, valid = scan_batch(batch, targets)
    xyz_d, valid_d = jax.device_put(xyz), jax.device_put(valid)
    res = {}
    for name, p in preds.items():
        cubes_d = jax.device_put(p.encode_host(cubes))
        pred, best, proba = jax.block_until_ready(p(cubes_d, xyz_d, valid_d))
        res[name] = (np.asarray(pred), np.asarray(proba))
        check(res[name][1].shape == (batch, targets, 3), f"{name} shape")
        check(np.isfinite(res[name][1]).all(), f"{name} non-finite")
        del cubes_d
    min_p = preds["exact"].min_proba

    # fused vs fast+int8: the assertions of
    # tests/test_pallas_i8.py::test_fused_mode_matches_fast_int8
    np.testing.assert_array_equal(res["fused"][0], res["fast_i8"][0])
    np.testing.assert_allclose(res["fused"][1], res["fast_i8"][1], atol=1e-6)
    log(f"compare fused vs fast+int8 at {batch}x{targets}: decisions "
        "identical, |dproba| <= 1e-6 (float32 probabilities)")

    # fast float32 vs exact: the CPU tests' tolerance
    np.testing.assert_allclose(res["fast"][1], res["exact"][1], atol=2e-4)
    n_marg = decisions_agree(res["fast"][0], res["exact"][0],
                             res["exact"][1], min_p, 2e-4)
    log(f"compare fast f32 vs exact at {batch}x{targets}: |dproba| <= 2e-4 "
        "(float32, both paths at Precision.HIGHEST); decisions identical "
        f"outside {n_marg} slots within 2e-4 of threshold or runner-up")

    # exact vs the float64 host reference. Slots are dropped by the
    # reference alone (a target within BOUNDARY of a cell boundary); on
    # every other slot the device's cell must be the reference's.
    from radarml_tpu.core.arena import DEFAULT_ARENA

    model, calib = preds["exact"].model, preds["exact"].calibration
    ref_xyz = xyz[:ref_scans]
    ijk, near = reference_indices(ref_xyz)
    keep = ~near
    check(near.mean() <= 0.25, f"{int(near.sum())} of {near.size} "
          "reference targets near a cell boundary: scan_batch's jitter "
          "did not move them off the grid nodes")
    dev_ijk = np.stack(jax.device_get(DEFAULT_ARENA.clamped_matrix_indices(
        *np.moveaxis(ref_xyz, -1, 0))), axis=-1)
    bad = (dev_ijk != ijk).any(-1) & keep
    check(not bad.any(), f"{int(bad.sum())} device target cells differ from "
          "the float64 reference away from any cell boundary")
    want = np.array([[reference_proba(model, calib, cubes[b], ijk[b, t])
                      for t in range(targets)] for b in range(ref_scans)])
    got = res["exact"][1][:ref_scans]
    np.testing.assert_allclose(got[keep], want[keep], atol=5e-5)
    n_marg = decisions_agree(res["exact"][0][:ref_scans][keep],
                             np.where(want.max(-1) >= min_p,
                                      want.argmax(-1), -1)[keep],
                             want[keep], min_p, 5e-5)
    log(f"compare exact vs float64 scipy reference on {int(keep.sum())} of "
        f"{keep.size} slots ({int(near.sum())} dropped: within {BOUNDARY} "
        "cell of a boundary by the reference's float64 index); device "
        f"cells equal the reference's on all {int(keep.sum())}; "
        f"|dproba| <= 5e-5 (max {np.abs(got - want)[keep].max():.3g}); "
        f"decisions identical outside {n_marg} marginal slots")
    return preds, (cubes, xyz, valid)


# ---------------------------------------------------------------- phase 3
def table_oracle(quant, cubes_i8: np.ndarray, chunk: int = 256) -> list:
    """int64 numpy tables (m1 (B,C2,Y), m2 (B,C2,X), m3 (B,C2,Z))."""
    q = [np.asarray(e[0]).astype(np.int64) for e in quant]
    outs = [[], [], []]
    for s in range(0, cubes_i8.shape[0], chunk):
        v = cubes_i8[s:s + chunk].astype(np.int64)
        outs[0].append(np.einsum("cxz,bxyz->bcy", q[0], v, optimize=True))
        outs[1].append(np.einsum("cyz,bxyz->bcx", q[1], v, optimize=True))
        outs[2].append(np.einsum("cxy,bxyz->bcz", q[2], v, optimize=True))
    return [np.concatenate(o) for o in outs]


def phase_kernel(preds: dict, data: tuple, calls: int,
                 interpret: bool = False) -> None:
    import jax

    from radarml_tpu.ops.pallas_i8_score import (
        build_table_weights,
        tables_i8,
    )

    cubes, xyz, valid = data
    fast, fused = preds["fast_i8"], preds["fused"]
    cubes_i8 = fast.encode_host(cubes)
    dev_i8 = jax.device_put(cubes_i8)
    quant = fast._quantized_split_templates()
    w = build_table_weights(quant, fast.scan_arena.grid_shape)
    kernel = jax.jit(lambda c: tables_i8(c, w, interpret=interpret))
    got = [np.asarray(t) for t in jax.block_until_ready(kernel(dev_i8))]
    t0 = time.perf_counter()
    want = table_oracle(quant, cubes_i8)
    for g, o, name in zip(got, want, ("m1", "m2", "m3")):
        check(g.dtype == np.int32 and g.shape == o.shape, f"{name} shape")
        check(np.array_equal(g.astype(np.int64), o),
              f"kernel table {name} differs from the int64 oracle")
    log(f"kernel: Triton tables {[g.shape for g in got]} == int64 numpy "
        f"oracle exactly (integer arithmetic, no tolerance; oracle "
        f"{time.perf_counter() - t0:.1f}s on the host)")

    xyz_d, valid_d = jax.device_put(xyz), jax.device_put(valid)
    xla_tables = jax.jit(fast._raw_tables_fn(quant))
    timed = {
        "fused": lambda: fused(dev_i8, xyz_d, valid_d),
        "fast_i8": lambda: fast(dev_i8, xyz_d, valid_d),
        "tables_kernel": lambda: kernel(dev_i8),
        "tables_xla": lambda: xla_tables(dev_i8),
    }
    res = {k: median_ms(f, calls) for k, f in timed.items()}
    B, T = xyz.shape[:2]
    for k, (med, all_ms) in res.items():
        log(f"time {k} at {B}x{T}: median {med} ms over {calls} calls "
            f"(min {min(all_ms)}, max {max(all_ms)})")
    log(f"time fused/fast_i8 end to end: "
        f"{res['fused'][0] / res['fast_i8'][0]}")

    compiled = fused._fn.lower(dev_i8, xyz_d, valid_d).compile()
    log(f"memory_analysis(fused step): {compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'not reported')}")


# ---------------------------------------------------------------- phase 4
def phase_serve(paths: dict, out: str, data: tuple, seconds: float,
                max_batch: int, interpret: bool = False) -> None:
    from radarml_tpu.apps import serve as serve_app
    from radarml_tpu.apps.common_cli import load_model
    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.models.pipeline import RadarPredictor
    from radarml_tpu.serving import load_serving_artifact

    common = ["--mode", SERVE_MODE, "--cube_dtype", "int8",
              "--min_proba", "0.0", "--max_batch", str(max_batch),
              "--svm_model", paths["model"],
              "--label_encoder", paths["labels"]]
    stats = serve_app.main(["--duration", str(seconds), "--driver",
                            "synthetic", "--sensors", "4", *common])
    check(stats["processed"] > 0, "serve answered no scans")
    log(f"serve: --mode {SERVE_MODE}, {stats['processed']} scans answered "
        f"in {seconds}s (p50 {stats['latency_p50_ms']} ms)")

    art_path = os.path.join(out, "serving.rmlx")
    serve_app.main(["--export_serving", art_path, *common])
    stats = serve_app.main(["--serving_artifact", art_path, "--duration",
                            str(seconds), "--driver", "synthetic", *common])
    check(stats["processed"] > 0, "artifact serving answered no scans")

    art = load_serving_artifact(art_path)
    model, calib = load_model(paths["model"])
    live = RadarPredictor(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=model,
        calibration=calib, min_proba=0.0, mode=SERVE_MODE,
        interpret=interpret,
    )
    cubes, xyz, valid = (d[:max_batch] for d in data)
    a_pred, _, a_proba = art(cubes, xyz, valid)
    l_pred, _, l_proba = live(cubes, xyz, valid)
    np.testing.assert_array_equal(np.asarray(a_pred), np.asarray(l_pred))
    np.testing.assert_allclose(np.asarray(a_proba), np.asarray(l_proba),
                               atol=1e-6)
    log(f"serve: artifact {art.platforms} answered {stats['processed']} "
        f"scans; its decisions on {len(cubes)} scans equal the live "
        "predictor's")


def run(out: str = OUT, batch: int = 4096, targets: int = 4,
        ref_scans: int = 64, calls: int = 25, serve_seconds: float = 4.0,
        serve_batch: int = 64, interpret: bool = False) -> None:
    """Phases 1-4 (the CPU tests rehearse them at a tiny size)."""
    os.makedirs(out, exist_ok=True)
    paths = phase_train(out)
    preds, data = phase_predict(paths, out, batch, targets, ref_scans,
                                interpret)
    phase_kernel(preds, data, calls, interpret)
    phase_serve(paths, out, data, serve_seconds, serve_batch, interpret)


def main() -> int:
    import jax

    from radarml_tpu.apps.common_cli import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    from radarml_tpu.utils import card_name_and_power_limit

    log(card_name_and_power_limit())
    log(f"jax {jax.__version__}, compile cache {enable_compile_cache()}")
    run()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
