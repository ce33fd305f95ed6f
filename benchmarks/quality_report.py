"""Train the classifier families on one dataset; report accuracy.

The reference's README documents each family's accuracy on its captured
radar data (README.md:91-202; BASELINE.md). Those pickles are external,
so this report runs the full pipelines on the synthetic dataset
(data/synthetic.py — same projections/shapes/value range, separable
class signatures) and records test accuracy + wall time per family.
Output: markdown to stdout and benchmarks/QUALITY.md.

Usage:
    python benchmarks/quality_report.py [--n 600] [--fast]
    python benchmarks/quality_report.py --families sgd,svc
    python benchmarks/quality_report.py --families cnn,sgan --append
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

# Runnable as `python benchmarks/quality_report.py` from the repo root.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=900)
    ap.add_argument("--fast", action="store_true",
                    help="reduced epochs/grids for smoke runs")
    ap.add_argument("--out", type=str,
                    default=os.path.join(os.path.dirname(__file__), "QUALITY.md"))
    ap.add_argument("--families", type=str, default="sgd,svc,cnn,sgan",
                    help="comma list of families to run")
    ap.add_argument("--append", action="store_true",
                    help="append rows to an existing report")
    ap.add_argument("--hardness", type=float, default=0.5,
                    help="synthetic-data difficulty (0 = separable; 1 = "
                         "overlapping signatures + clutter + label noise "
                         "so scores land in a discriminative band)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (accuracy is "
                         "device-independent)")
    args = ap.parse_args()
    families = set(args.families.split(","))

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from radarml_tpu.apps.common_cli import enable_compile_cache

    enable_compile_cache()

    from radarml_tpu.data.labels import LabelEncoder
    from radarml_tpu.data.split import train_val_test_split
    from radarml_tpu.data.synthetic import make_dataset
    from radarml_tpu.ops.features import process_samples

    rows = []
    samples, labels = make_dataset(args.n, seed=7, hardness=args.hardness)
    le, y = LabelEncoder.fit_transform(labels)
    (Xtr, ytr), (Xva, yva), (Xte, yte) = train_val_test_split(samples, y)

    if families & {"sgd", "svc"}:
        Ftr = process_samples(Xtr, scale=True, device=True)
        Fva = process_samples(Xva, scale=True, device=True)
        Fte = process_samples(Xte, scale=True, device=True)

    if "sgd" in families:
        from radarml_tpu.models.linear import (
            calibrate_ovr, predict_proba_calibrated,
        )
        from radarml_tpu.train.gridsearch import grid_search_sgd

        t0 = time.perf_counter()
        grid = (
            [{"alpha": [1e-4, 1e-5], "penalty": ["l2"], "average": [False]}]
            if args.fast else None
        )
        # tol=None: the sklearn-style tol early stop (loss improvement
        # < 1e-3 for 5 epochs, aggregated over the OvA classes)
        # underfits this hardened set AND misranks the grid — it was
        # the whole SGD-vs-SVC quality inversion. Disabling it lifts
        # SGD 0.844 → 0.911 test accuracy, selected on validation
        # (benchmarks/sgd_quality_probe.py, whose record
        # also records the recipes that DON'T help: the reference's
        # augment-epochs partial_fit degrades validation monotonically
        # here, and a wider alpha grid is flat).
        res = grid_search_sgd(
            Ftr, ytr, folds=3 if args.fast else 5, grid=grid,
            epochs=20 if args.fast else None,
            tol=None if not args.fast else 1e-3,
        )
        model, _cfg = res.best_model
        calib = calibrate_ovr(model, Fva, yva)
        acc = float(
            (np.asarray(predict_proba_calibrated(model, calib, Fte)).argmax(1)
             == yte).mean()
        )
        rows.append(("SGD/logistic (grid search + calibration)", acc,
                     time.perf_counter() - t0, "0.886 (README.md:91-98)"))

    if "svc" in families:
        from radarml_tpu.models import svc as jsvc

        t0 = time.perf_counter()
        svc_model = jsvc.svc_fit(
            Ftr, ytr,
            # probability=False: the accuracy row needs predict only,
            # and Platt's 5-fold CV sub-fits are compile-heavy here.
            jsvc.SVCConfig(C=10.0, kernel="rbf", gamma=0.01,
                           probability=False),
        )
        acc = float((np.asarray(jsvc.predict(svc_model, Fte)) == yte).mean())
        rows.append(("SVC rbf (SMO, C=10, γ=0.01)", acc,
                     time.perf_counter() - t0, "0.842 (train_svc.log)"))

    if "cnn" in families:
        from radarml_tpu.data.preprocess import preprocess_multiview
        from radarml_tpu.models.cnn import RESCALE, MultiViewCNN
        from radarml_tpu.ops.augment import augment_multiview
        from radarml_tpu.train.trainer import TrainConfig, train_cnn

        t0 = time.perf_counter()
        # Augmented, train_concat mode: without augmentation the CNN
        # overfits the small synthetic set and loses to the linear
        # families. The reference's own --augment recipe (replace
        # every sample pre-split, DC noise draw sigma=1.0 on [-1,1]
        # data, dnn.py:94-209) DESTROYS this dataset — it drives the
        # CNN to chance (0.36) because a clamped +-1 DC shift wipes
        # the class signatures — so the quality run uses the
        # framework's train-only concat mode (clean validation set,
        # 2 mildly-noised augmented copies appended to train).
        def augment_fn(views, rng):
            return augment_multiview(
                views, jax.random.PRNGKey(int(rng.integers(2**31))),
                noise_sd=0.1,
            )

        pre = preprocess_multiview(samples, labels, rescale=RESCALE,
                                   train_split=0.8,
                                   augment_fn=augment_fn,
                                   augment_mode="train_concat",
                                   augment_copies=2, device=True)
        model = MultiViewCNN(n_classes=pre["n_classes"])
        params = model.init(
            jax.random.PRNGKey(0),
            np.zeros((1,) + RESCALE + (3,), np.float32), train=False,
        )["params"]
        cfg = TrainConfig(
            epochs=10 if args.fast else 150,
            patience=10 if args.fast else 30,
        )
        best, hist = train_cnn(
            model, params, pre["X_train"], pre["y_train"],
            pre["X_val"], pre["y_val"], w_classes=pre["w_classes"],
            config=cfg,
        )
        rows.append(("Multi-view CNN (augmented, best val acc)",
                     float(max(hist["val_accuracy"])),
                     time.perf_counter() - t0, "0.843 (README.md:146-148)"))

    if "sgan" in families:
        from radarml_tpu.data.preprocess import preprocess_multiview
        from radarml_tpu.train.sgan_trainer import (
            SGANConfig, classifier_eval, sgan_init, train_sgan,
        )

        t0 = time.perf_counter()
        rescale = (32, 32) if args.fast else (128, 128)
        pre = preprocess_multiview(
            samples, labels, rescale=rescale, train_split=1.0,
            sup_mask=[True] * len(labels), balance=True, device=True,
        )
        scfg = SGANConfig(
            n_classes=pre["n_classes"],
            n_epochs=2 if args.fast else 15,
            n_sup_samples=150,
        )
        gen, disc, state = sgan_init(jax.random.PRNGKey(0), scfg, rescale)
        peak = [0.0]  # reference reports peak across checkpoints (README.md:190)
        state = train_sgan(
            gen, disc, state,
            (pre["X_train"], pre["y_train"], pre.get("sup_train")),
            (pre["X_val"], pre["y_val"]), scfg, w_classes=pre["w_classes"],
            on_summary=lambda i, acc, st: peak.__setitem__(
                0, max(peak[0], acc)
            ),
        )
        acc = max(
            peak[0], classifier_eval(disc, state, pre["X_val"], pre["y_val"])
        )
        rows.append(("SGAN classifier (150 supervised labels, peak)",
                     float(acc),
                     time.perf_counter() - t0, "0.745 peak (README.md:190)"))

    header = [
        "# Quality report",
        "",
        f"Synthetic dataset, n={args.n}, hardness={args.hardness} "
        "(signature overlap + clutter + 5% label noise at 1.0), 3 "
        f"classes, device={jax.devices()[0].platform}; reference numbers "
        "are on its own",
        "captured radar data (different data — context, not comparison).",
        "",
        "| family | test accuracy | wall s | reference (own data) |",
        "|---|---|---|---|",
    ]
    body = [f"| {name} | {acc:.3f} | {dt:.1f} | {ref} |"
            for name, acc, dt, ref in rows]
    if args.append and os.path.exists(args.out):
        with open(args.out) as fp:
            existing = fp.read().rstrip("\n")
        report = existing + "\n" + "\n".join(body) + "\n"
    else:
        report = "\n".join(header + body) + "\n"
    print("\n".join(header + body))
    with open(args.out, "w") as fp:
        fp.write(report)


if __name__ == "__main__":
    main()
