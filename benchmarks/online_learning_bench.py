"""Online-learning schedule bench: the real sklearn heuristic vs the cap.

The reference's --online_learn loop runs partial_fit max(1e6/n, 1000)
times (reference train.py:409-416). Round 2 capped the fused
equivalent at 300 epochs as a documented divergence; round 3 lifts the
cap (models/linear.sgd_fit defaults to the uncapped heuristic). This
bench quantifies both sides at reference scale (balanced n=1824,
F=10010): wall time of the fused 1000-epoch run and the accuracy delta
vs the capped run.

Run from the repo root on the GPU:  python benchmarks/online_learning_bench.py
Prints one JSON line.
"""

import json
import time

import numpy as np


def main():
    import jax

    from radarml_tpu.apps.common_cli import enable_compile_cache

    enable_compile_cache()

    from radarml_tpu.data.balance import balance_classes
    from radarml_tpu.data.labels import LabelEncoder
    from radarml_tpu.data.synthetic import make_dataset
    from radarml_tpu.models.linear import (
        SGDConfig,
        predict,
        sgd_fit,
        sgd_model,
    )
    from radarml_tpu.ops.features import process_samples

    # Reference-scale dataset (train_sgd.log: 909 train -> 1824 after
    # balancing, feature length 10010); hardness keeps accuracy off 1.0
    # so deltas are visible.
    samples, labels = make_dataset(1264, seed=7, hardness=0.85)
    le, y = LabelEncoder.fit_transform(labels)
    X = process_samples(samples, scale=True, device=True)
    n_te = 127
    X_te, y_te = X[:n_te], y[:n_te]
    y_tr, X_tr = balance_classes(np.asarray(y[n_te:]), X[n_te:])
    n = len(y_tr)
    n_classes = len(le.classes_)
    cfg = SGDConfig(alpha=1e-5)

    # Base model: a short fresh fit standing in for the previously
    # trained artifact the online path continues from.
    base = sgd_fit(X_tr, y_tr, n_classes, cfg, epochs=20, seed=1)

    results = {"n": int(n), "heuristic_epochs": int(max(np.ceil(1e6 / n), 1000))}
    for name, epochs in (("capped_300", 300), ("sklearn_heuristic", None)):
        t0 = time.perf_counter()
        st = sgd_fit(
            X_tr, y_tr, n_classes, cfg, epochs=epochs, state=base, seed=2
        )
        model = sgd_model(st, cfg)
        acc = float(np.mean(np.asarray(predict(model, X_te)) == y_te))
        results[name] = {
            "wall_s": round(time.perf_counter() - t0, 2),
            "test_acc": round(acc, 4),
        }

    results["acc_delta"] = round(
        results["sklearn_heuristic"]["test_acc"]
        - results["capped_300"]["test_acc"], 4,
    )
    print(json.dumps(results))


if __name__ == "__main__":
    main()
