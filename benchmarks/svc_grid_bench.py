"""Time the FULL reference SVC grid search at reference data scale.

The reference's worst headline number: GridSearchCV over
{C×linear, C×γ×rbf} = 30 candidates × 5 stratified folds of
SVC(class_weight='balanced') on 1824 balanced samples × 10010 features
takes **77.5 minutes** on its Pi-class host
(/root/reference/train.py:472-491; train_svc.log 05:56:45→07:14:15).

This runs the same grid/folds/data-scale through the device-resident
batched CV (train/gridsearch.grid_search_svc): features transfer once,
the Gram is computed once, each kernel group's 75 (C × fold × pair)
dual QPs solve in one vmapped SMO dispatch, and scoring reuses the
resident Gram. Synthetic data at hardness 1.0 keeps the QPs
non-trivial (overlapping classes → many support vectors).

Usage:
    python benchmarks/svc_grid_bench.py [--n 1824] [--hardness 1.0]

Prints one JSON line with wall-clock seconds and the speedup vs the
77.5 min baseline, split into CV and probability-refit phases.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASELINE_MIN = 77.5  # train_svc.log wall time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1824)
    ap.add_argument("--hardness", type=float, default=1.0)
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--no_probability", action="store_true")
    args = ap.parse_args()

    import jax

    from radarml_tpu.apps.common_cli import enable_compile_cache

    enable_compile_cache()

    from radarml_tpu.data.labels import LabelEncoder
    from radarml_tpu.data.synthetic import make_dataset
    from radarml_tpu.ops.features import process_samples
    from radarml_tpu.train.gridsearch import grid_search_svc

    t0 = time.perf_counter()
    samples, labels = make_dataset(args.n, seed=42, hardness=args.hardness)
    le, y = LabelEncoder.fit_transform(labels)
    X = process_samples(samples, scale=True, device=True)
    t_data = time.perf_counter() - t0
    print(f"# data: {X.shape} built in {t_data:.1f}s", file=sys.stderr)

    t1 = time.perf_counter()
    res = grid_search_svc(
        X, y, folds=args.folds, probability=False, device_batched=True
    )
    t_cv = time.perf_counter() - t1

    t_refit = None
    if not args.no_probability:
        # Reference refits best params with probability=True
        # (train.py:478); time it separately — it is 15 host-driven
        # Platt sub-fits and dominates when the CV itself is fast.
        from radarml_tpu.models import svc as jsvc

        t2 = time.perf_counter()
        cfg = jsvc.SVCConfig(
            C=res.best_params["C"],
            kernel=res.best_params["kernel"],
            gamma=res.best_params.get("gamma", 0.01),
            class_weight="balanced",
            probability=True,
        )
        _ = jsvc.svc_fit(X, y, cfg)
        t_refit = time.perf_counter() - t2

    total = t_cv + (t_refit or 0.0)
    print(
        json.dumps(
            {
                "metric": "full reference SVC grid (30 cand x 5 folds)",
                "value": round(total, 1),
                "unit": "s",
                "vs_baseline_speedup": round(BASELINE_MIN * 60 / total, 1),
                "cv_s": round(t_cv, 1),
                "probability_refit_s": (
                    round(t_refit, 1) if t_refit is not None else None
                ),
                "n_samples": args.n,
                "n_features": int(X.shape[1]),
                "hardness": args.hardness,
                "best_params": res.best_params,
                "best_cv_score": round(res.best_score, 4),
                "device": str(jax.devices()[0]),
            }
        )
    )


if __name__ == "__main__":
    main()
