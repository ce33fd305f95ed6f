"""SGD quality sweep on the hardened quality-report dataset.

Round-4's quality report left SGD the weakest family (0.844 vs SVC/CNN
0.889) — inverting the reference, where SGD/logistic is the BEST
classical family (reference README.md:91-98: 0.886 vs SVC 0.842). The
CNN closed the same inversion with train-only concat augmentation; this
probe gives SGD the equivalent round, sweeping the recipes the
framework already ships:

  A. baseline       — grid_search_sgd on clean features (the r04 row)
  B. augment-epochs — continue the grid winner's optimizer state with
                      N partial-fit epochs of generatively-augmented
                      data (the reference's own recipe,
                      train.py:419-438; apps/train.py --epochs), N
                      selected on the VALIDATION split
  C. full-epochs    — baseline grid with tol early-stop disabled
                      (rules out underfitting from the 1e-3 tol)
  D. wide-alpha     — denser alpha sweep around the winner, both
                      averaging modes

Selection is honest: every knob is chosen on the validation split
(uncalibrated accuracy, same split quality_report.py calibrates on);
test accuracy is computed once per variant for the report. Exact same
dataset/split as quality_report.py (n=900, seed=7, hardness=0.5).

Usage: python benchmarks/sgd_quality_probe.py [--cpu] [--fast]
Writes one JSON line to stdout and the full record to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="tiny grids/epochs (CI smoke, not a measurement)")
    ap.add_argument("--n", type=int, default=900)
    ap.add_argument("--hardness", type=float, default=0.5)
    ap.add_argument("--sweep_hardness", action="store_true",
                    help="also run the SGD-vs-SVC hardness sweep "
                         "(4 extra datasets; locates the crossover)")
    ap.add_argument("--out", type=str,
                    default="chiprun_out/sgd_quality.json")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from radarml_tpu.apps.common_cli import enable_compile_cache

    enable_compile_cache()

    from radarml_tpu.core.arena import RADAR_MAX
    from radarml_tpu.data.labels import LabelEncoder
    from radarml_tpu.data.split import train_val_test_split
    from radarml_tpu.data.store import stack_samples
    from radarml_tpu.data.synthetic import make_dataset
    from radarml_tpu.models.linear import (
        calibrate_ovr,
        predict as linear_predict,
        predict_proba_calibrated,
        sgd_fit,
        sgd_model,
    )
    from radarml_tpu.ops.augment import augment_samples
    from radarml_tpu.ops.features import process_samples, process_views
    from radarml_tpu.train.gridsearch import grid_search_sgd

    samples, labels = make_dataset(args.n, seed=7, hardness=args.hardness)
    le, y = LabelEncoder.fit_transform(labels)
    (Xtr, ytr), (Xva, yva), (Xte, yte) = train_val_test_split(samples, y)
    Ftr = process_samples(Xtr, scale=True, device=True)
    Fva = process_samples(Xva, scale=True, device=True)
    Fte = process_samples(Xte, scale=True, device=True)
    n_classes = len(le.classes_)

    def val_acc(model):
        return float((np.asarray(linear_predict(model, Fva)) == yva).mean())

    def test_acc(model):
        calib = calibrate_ovr(model, Fva, yva)
        proba = np.asarray(predict_proba_calibrated(model, calib, Fte))
        return float((proba.argmax(1) == yte).mean())

    results = {}

    # --- A. baseline: the round-4 quality-report recipe ------------------
    t0 = time.perf_counter()
    folds = 3 if args.fast else 5
    fast_grid = (
        [{"alpha": [1e-4, 1e-5], "penalty": ["l2"], "average": [False]}]
        if args.fast else None
    )
    epochs = 20 if args.fast else None
    res = grid_search_sgd(Ftr, ytr, folds=folds, grid=fast_grid,
                          epochs=epochs)
    base_model, base_cfg = res.best_model
    base_state = res.best_state
    results["baseline"] = {
        "val": val_acc(base_model), "test": test_acc(base_model),
        "params": {k: (v if not isinstance(v, float) else float(v))
                   for k, v in res.best_params.items()},
        "wall_s": round(time.perf_counter() - t0, 1),
    }

    # --- B. augment-epochs: reference train.py:419-438 recipe ------------
    # Continue the winner's optimizer state (eta schedule, averaging
    # accumulators) with partial-fit epochs of generatively-augmented
    # train data; pick the epoch count by validation accuracy.
    t0 = time.perf_counter()
    xz, yz, xy = stack_samples(Xtr)
    xz, yz, xy = xz / RADAR_MAX, yz / RADAR_MAX, xy / RADAR_MAX
    key = jax.random.PRNGKey(1234)
    state = base_state
    model = base_model
    curve = [{"epoch": 0, "val": results["baseline"]["val"]}]
    best = {"epoch": 0, "val": results["baseline"]["val"],
            "model": base_model}
    n_epochs = 3 if args.fast else 12
    for e in range(1, n_epochs + 1):
        key, ek = jax.random.split(key)
        (axz, ayz, axy), ay = augment_samples(
            (xz, yz, xy), ytr, ek,
            rotation_range=5.0, zoom_range=0.2, noise_sd=0.1,
            balance=True, device=True,
        )
        F_aug = process_views(
            axz * RADAR_MAX, ayz * RADAR_MAX, axy * RADAR_MAX, scale=True,
        )
        state = sgd_fit(F_aug, ay, n_classes, base_cfg, state=state,
                        epochs=1)
        model = sgd_model(state, base_cfg)
        va = val_acc(model)
        curve.append({"epoch": e, "val": va})
        if va > best["val"]:
            best = {"epoch": e, "val": va, "model": model}
    results["augment_epochs"] = {
        "val": best["val"], "test": test_acc(best["model"]),
        "best_epoch": best["epoch"], "curve": curve,
        "wall_s": round(time.perf_counter() - t0, 1),
    }

    # --- C. full-epochs: tol early-stop disabled --------------------------
    if not args.fast:
        t0 = time.perf_counter()
        res_c = grid_search_sgd(Ftr, ytr, folds=folds, tol=None)
        m_c, _ = res_c.best_model
        results["no_tol"] = {
            "val": val_acc(m_c), "test": test_acc(m_c),
            "params": res_c.best_params,
            "wall_s": round(time.perf_counter() - t0, 1),
        }

    # --- D. wide-alpha grid around the winner ------------------------------
    if not args.fast:
        t0 = time.perf_counter()
        wide = [
            {"alpha": [3e-3, 1e-3, 3e-4, 1e-4, 3e-5, 1e-5, 3e-6, 1e-6],
             "penalty": ["l1", "l2"], "average": [False, True]},
        ]
        res_d = grid_search_sgd(Ftr, ytr, folds=folds, grid=wide)
        m_d, d_cfg = res_d.best_model
        d_state = res_d.best_state
        results["wide_alpha"] = {
            "val": val_acc(m_d), "test": test_acc(m_d),
            "params": res_d.best_params,
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        # D+B: augment-epochs on the wide-grid winner.
        key = jax.random.PRNGKey(1234)
        state, model = d_state, m_d
        bestd = {"epoch": 0, "val": results["wide_alpha"]["val"],
                 "model": m_d}
        for e in range(1, n_epochs + 1):
            key, ek = jax.random.split(key)
            (axz, ayz, axy), ay = augment_samples(
                (xz, yz, xy), ytr, ek,
                rotation_range=5.0, zoom_range=0.2, noise_sd=0.1,
                balance=True, device=True,
            )
            F_aug = process_views(
                axz * RADAR_MAX, ayz * RADAR_MAX, axy * RADAR_MAX,
                scale=True,
            )
            state = sgd_fit(F_aug, ay, n_classes, d_cfg, state=state,
                            epochs=1)
            model = sgd_model(state, d_cfg)
            va = val_acc(model)
            if va > bestd["val"]:
                bestd = {"epoch": e, "val": va, "model": model}
        results["wide_alpha_augment"] = {
            "val": bestd["val"], "test": test_acc(bestd["model"]),
            "best_epoch": bestd["epoch"],
            "wall_s": round(time.perf_counter() - t0, 1),
        }

    # --- hardness sweep: where does SGD-vs-SVC cross over? ----------------
    # The reference's SGD-beats-SVC result is on ITS captured data; the
    # quality report's inversion is on the hardened synthetic set. If
    # the inversion is a property of hardness (margin-flooding clutter
    # + label noise favoring the RBF kernel's local decision surface
    # over a linear one), the sweep shows the crossover directly.
    if args.sweep_hardness:
        from radarml_tpu.models import svc as jsvc

        sweep = []
        for h in (0.0, 0.25, 0.5, 0.75):
            s2, l2 = make_dataset(args.n, seed=7, hardness=h)
            _, y2 = LabelEncoder.fit_transform(l2)
            (X2tr, y2tr), (X2va, y2va), (X2te, y2te) = train_val_test_split(
                s2, y2
            )
            F2tr = process_samples(X2tr, scale=True, device=True)
            F2va = process_samples(X2va, scale=True, device=True)
            F2te = process_samples(X2te, scale=True, device=True)
            res_h = grid_search_sgd(
                F2tr, y2tr, folds=folds, grid=fast_grid, epochs=epochs,
            )
            m_h, _ = res_h.best_model
            calib_h = calibrate_ovr(m_h, F2va, y2va)
            sgd_acc = float(
                (np.asarray(
                    predict_proba_calibrated(m_h, calib_h, F2te)
                ).argmax(1) == y2te).mean()
            )
            svc_model = jsvc.svc_fit(
                F2tr, y2tr,
                jsvc.SVCConfig(C=10.0, kernel="rbf", gamma=0.01,
                               probability=False),
            )
            svc_acc = float(
                (np.asarray(jsvc.predict(svc_model, F2te)) == y2te).mean()
            )
            sweep.append({"hardness": h, "sgd_test": sgd_acc,
                          "svc_test": svc_acc})
            print(f"# hardness {h}: sgd {sgd_acc:.3f} svc {svc_acc:.3f}",
                  file=sys.stderr, flush=True)
        results["hardness_sweep"] = sweep

    record = {
        "dataset": {"n": args.n, "seed": 7, "hardness": args.hardness},
        "device": jax.devices()[0].platform,
        "results": results,
        "winner_by_val": max(
            (k for k in results if "val" in results[k]),
            key=lambda k: results[k]["val"],
        ),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
