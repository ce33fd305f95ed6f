"""CLI: train the classical SVM families (SGD / SVC).

Mirror of the reference's train.py entry point (train.py:547-737) with
the same flags and flow: load + concat dataset pickles, filter desired
classes, scale to [0, 1], encode labels, split 0.8/0.1/0.1 (seeded
1234), fit via grid-search (SGD default, --use_svc for the kernel
family), optional augmentation epochs with partial_fit (SGD) or
pre-augmentation (SVC), calibrate on the validation split, evaluate on
the held-out test set (accuracy + confusion-matrix PNG + report), and
pickle the model + label encoder.

Divergences (documented): models save as framework artifact dicts, not
sklearn object pickles (apps/common_cli.py can load either for
serving); `--synthetic N` generates a synthetic dataset when no pickle
exists, since the reference's captured datasets are external downloads;
`--grid_epochs` bounds SGD epochs per grid candidate for fast runs.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import time
import numpy as np

from radarml_tpu.apps.common_cli import (
    add_common_flags,
    parse_proj_mask,
    save_label_encoder,
    save_model,
    setup_logging,
)
from radarml_tpu.core.arena import RADAR_MAX
from radarml_tpu.data.labels import LabelEncoder, filter_samples
from radarml_tpu.data.balance import balance_classes
from radarml_tpu.data.split import train_val_test_split
from radarml_tpu.data.store import load_datasets, stack_samples
from radarml_tpu.ops.features import process_samples
from radarml_tpu.train.metrics import evaluate_model
from radarml_tpu.train.gridsearch import grid_search_sgd, grid_search_svc

logger = logging.getLogger(__name__)

RANDOM_SEED = 1234


def dump_augmented(dir_: str, epoch: int, views, y, batch_size: int = 32):
    """Write augmented batches as reference-format pickles.

    The reference's DataGenerator.flow(save_to_dir=..., save_prefix=...)
    writes {'x_batch': ..., 'y_batch': ...} pickles named
    batch_{batch}_{pos}.pickle, one per batch-size chunk
    (train.py:58-67, 209-212). Same schema here — x_batch is a list of
    (xz, yz, xy) projection tuples in [0, 1], y_batch the label array.
    (The reference pickles the pre-augment slice despite its
    docstring's stated intent; this dump saves the augmented data,
    which is the useful thing to inspect.)
    """
    os.makedirs(dir_, exist_ok=True)
    xz, yz, xy = (np.asarray(v) for v in views)
    y = np.asarray(y)
    for pos in range(0, len(y), batch_size):
        end = min(pos + batch_size, len(y))
        x_batch = [(xz[i], yz[i], xy[i]) for i in range(pos, end)]
        with open(
            os.path.join(dir_, f"batch_{epoch}_{pos}.pickle"), "wb"
        ) as fp:
            pickle.dump({"x_batch": x_batch, "y_batch": y[pos:end]}, fp)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=0,
                   help="number of augmentation epochs")
    p.add_argument("--save_augmented", type=str, default="",
                   help="directory to dump augmented batches as "
                        "reference-format batch_{epoch}_{pos}.pickle "
                        "files for inspection (train.py:58-67,209-212)")
    p.add_argument("--datasets", nargs="+", type=str,
                   default=["datasets/radar_samples.pickle"],
                   help="paths to training datasets")
    p.add_argument("--desired_labels", nargs="+", type=str,
                   default=["person", "dog", "cat"],
                   help="labels to use for training")
    p.add_argument("--proj_mask", nargs="+", default=[True, True, True],
                   help="projection mask (xz, yz, xy)")
    p.add_argument("--svm_cm", type=str,
                   default="train-results/svm_cm.png",
                   help="path of output confusion matrix png "
                        "(\"\" = no plot, and no matplotlib)")
    p.add_argument("--svm_model", type=str,
                   default="train-results/svm_radar_classifier.pickle",
                   help="path of output svm model")
    p.add_argument("--label_encoder", type=str,
                   default="train-results/radar_labels.pickle",
                   help="path of output label encoder")
    p.add_argument("--online_learn", action="store_true",
                   help="use dataset(s) for online learning "
                        "(ignored if --use_svc)")
    p.add_argument("--use_svc", action="store_true",
                   help="use the kernel SVC family instead of SGD")
    p.add_argument("--train_val_test_frac", nargs="+", type=float,
                   default=[0.8, 0.1, 0.1])
    p.add_argument("--log_file", type=str, default="train-results/train.log")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic samples if dataset missing")
    p.add_argument("--grid_epochs", type=int, default=None,
                   help="SGD epochs per grid candidate (default: sklearn "
                        "heuristic)")
    p.add_argument("--folds", type=int, default=5)
    add_common_flags(p)
    return p


def _load_or_synthesize(args):
    missing = [d for d in args.datasets if not os.path.exists(d)]
    if missing and args.synthetic:
        from radarml_tpu.data.synthetic import make_dataset
        from radarml_tpu.data.store import save_dataset

        logger.info("Synthesizing %d samples → %s", args.synthetic, missing[0])
        samples, labels = make_dataset(
            args.synthetic, classes=tuple(args.desired_labels), seed=RANDOM_SEED
        )
        save_dataset(missing[0], samples, labels, append=False)
    try:
        return load_datasets(args.datasets)
    except FileNotFoundError as e:
        logger.error("Dataset not found: %s", e)
        raise SystemExit(1)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_file, args.logging_level)

    data = _load_or_synthesize(args)
    samples, labels = filter_samples(
        data["samples"], data["labels"], args.desired_labels
    )
    logger.info("Scaling samples.")
    samples = [tuple(np.asarray(p) / RADAR_MAX for p in s) for s in samples]

    logger.info("Encoding labels.")
    le, encoded = LabelEncoder.fit_transform(labels)
    class_names = list(le.classes_)
    logger.info(
        "Found %d classes and %d samples:", len(class_names), len(labels)
    )
    for i, c in enumerate(class_names):
        logger.info(
            '...class: %d "%s" count: %d', i, c, int((encoded == i).sum())
        )

    (X_train, y_train), (X_val, y_val), (X_test, y_test) = train_val_test_split(
        samples, encoded, args.train_val_test_frac, seed=RANDOM_SEED
    )
    logger.info("...training samples: %d", len(X_train))
    logger.info("...validation samples: %d", len(X_val))
    logger.info("...test samples: %d", len(X_test))

    proj_mask = parse_proj_mask(args.proj_mask)
    logger.info("Projection mask: %s", (proj_mask,))

    t0 = time.perf_counter()
    if not args.use_svc:
        result = _fit_sgd(args, proj_mask, X_train, y_train, X_test, y_test)
    else:
        result = _fit_svc(args, proj_mask, X_train, y_train)
    logger.info("Fit completed in %.1fs", time.perf_counter() - t0)

    # device=True: feature matrices stay on the device end-to-end; only
    # small probabilities/predictions return to host.
    X_val_fv = (
        process_samples(X_val, proj_mask=proj_mask, device=True)
        if len(X_val) else None
    )
    X_test_fv = process_samples(X_test, proj_mask=proj_mask, device=True)

    if result["kind"] == "linear":
        from radarml_tpu.models.linear import (
            calibrate_ovr,
            predict_proba_calibrated,
        )

        model = result["model"]
        calib = None
        if X_val_fv is not None and len(np.unique(y_val)) > 1:
            logger.info("Calibrating classifier.")
            calib = calibrate_ovr(model, X_val_fv, y_val)
        if calib is not None:
            proba = np.asarray(predict_proba_calibrated(model, calib, X_test_fv))
        else:
            from radarml_tpu.models.linear import predict_proba_log_loss

            proba = np.asarray(predict_proba_log_loss(model, X_test_fv))
        y_pred = proba.argmax(1)
        import dataclasses as _dc

        sgd_cfg = result.get("cfg")
        sgd_state = result.get("state")
        save_model(
            args.svm_model, "linear",
            coef=np.asarray(model.coef), intercept=np.asarray(model.intercept),
            calib_a=None if calib is None else np.asarray(calib.a),
            calib_b=None if calib is None else np.asarray(calib.b),
            classes=class_names,
            # Hyperparameters + schedule position so --online_learn can
            # continue this exact estimator (reference keeps them inside
            # the sklearn pickle, train.py:409-416).
            sgd_cfg=None if sgd_cfg is None else _dc.asdict(sgd_cfg),
            sgd_t=None if sgd_state is None else float(sgd_state.t),
        )
    else:
        from radarml_tpu.models import svc as jsvc

        model = result["model"]
        y_pred = np.asarray(jsvc.predict(model, X_test_fv))
        save_model(
            args.svm_model, "svc",
            support_vectors=np.asarray(model.support_vectors),
            dual_coef=np.asarray(model.dual_coef),
            intercept=np.asarray(model.intercept),
            n_support=list(model.n_support),
            kernel=model.kernel, gamma=model.gamma,
            probA=None if model.probA is None else np.asarray(model.probA),
            probB=None if model.probB is None else np.asarray(model.probB),
            classes=class_names,
        )

    logger.info("Evaluating final classifier on test set.")
    if args.svm_cm:
        os.makedirs(os.path.dirname(args.svm_cm) or ".", exist_ok=True)
    metrics = evaluate_model(
        lambda _: y_pred, None, y_test, class_names,
        cm_path=args.svm_cm or None,
    )
    logger.info("Saving svm model to: %s.", args.svm_model)

    # Do not overwrite the label encoder after online learning
    # (reference train.py:733-737).
    if not args.online_learn or args.use_svc:
        logger.info("Saving label encoder to: %s.", args.label_encoder)
        save_label_encoder(args.label_encoder, le)
    return {"metrics": metrics, "classes": class_names, **result}


def _fit_sgd(args, proj_mask, X_train, y_train, X_test, y_test) -> dict:
    """Reference sgd_fit flow (train.py:324-440) on the JAX stack."""
    import jax

    from radarml_tpu.models.linear import (
        SGDConfig,
        predict as linear_predict,
        sgd_fit,
        sgd_model,
    )
    from radarml_tpu.ops.augment import augment_samples

    logger.info("Using SVM algo: SGD (jitted OvA log-loss).")
    logger.info("Generating feature vectors.")
    F_train = process_samples(X_train, proj_mask=proj_mask, device=True)
    F_test = process_samples(X_test, proj_mask=proj_mask, device=True)
    logger.info("Feature vector length: %d", F_train.shape[1])

    logger.info("Balancing classes.")
    y_bal, F_bal = balance_classes(np.asarray(y_train), F_train)
    n_classes = len(np.unique(y_bal))

    if not args.online_learn:
        logger.info("Running best fit with new data.")
        res = grid_search_sgd(
            F_bal, y_bal, folds=args.folds, epochs=args.grid_epochs,
            seed=RANDOM_SEED,
        )
        res.log_summary(args.folds)
        model, cfg = res.best_model
        state = res.best_state
    else:
        logger.info("Running partial fit with new data.")
        from radarml_tpu.apps.common_cli import (
            load_model as load_artifact,
            load_model_meta,
        )

        prev_model, _ = load_artifact(args.svm_model)
        from radarml_tpu.models.linear import sgd_init

        # Resume the artifact's hyperparameters and eta-schedule
        # position — the reference partial_fits the unpickled estimator
        # itself, retaining its alpha/penalty/average/t_
        # (train.py:409-416). Reference sklearn pickles and pre-v2
        # artifacts lack the metadata and fall back to defaults.
        meta = load_model_meta(args.svm_model)
        cfg = (
            SGDConfig(**meta["sgd_cfg"]) if meta.get("sgd_cfg") else SGDConfig()
        )
        state = sgd_init(n_classes, F_bal.shape[1], cfg)
        state = state._replace(
            coef=prev_model.coef, intercept=prev_model.intercept
        )
        if meta.get("sgd_t") is not None:
            import jax.numpy as jnp

            state = state._replace(t=jnp.float32(meta["sgd_t"]))
        state = sgd_fit(
            F_bal, y_bal, n_classes, cfg, state=state, seed=RANDOM_SEED,
            epochs=args.grid_epochs,
        )
        model = sgd_model(state, cfg)

    if args.epochs:
        logger.info(
            "Running partial fit with augmented data (epochs: %d).",
            args.epochs,
        )
        from radarml_tpu.models.linear import sgd_init, sgd_fit as _fit

        xz, yz, xy = stack_samples(X_train)
        key = jax.random.PRNGKey(RANDOM_SEED)
        if state is None:
            state = sgd_init(n_classes, F_bal.shape[1], cfg)
            state = state._replace(coef=model.coef, intercept=model.intercept)
        # Continue with the winner's hyperparameters and schedule state
        # — the reference partial_fits the best estimator itself
        # (train.py:419-438), not a fresh default one.
        from radarml_tpu.ops.features import process_views

        for e in range(args.epochs):
            key, ek = jax.random.split(key)
            # Device-resident epoch: augment → rescale → featurize →
            # balance-gather → fit, all without touching the host link.
            (axz, ayz, axy), ay = augment_samples(
                (xz, yz, xy), np.asarray(y_train), ek,
                rotation_range=5.0, zoom_range=0.2, noise_sd=0.1,
                balance=True, device=True,
            )
            if args.save_augmented:
                dump_augmented(args.save_augmented, e, (axz, ayz, axy), ay)
            F_aug = process_views(
                axz * RADAR_MAX, ayz * RADAR_MAX, axy * RADAR_MAX,
                proj_mask=proj_mask, scale=True,
            )
            yb, Fb = balance_classes(ay, F_aug)
            state = _fit(Fb, yb, n_classes, cfg, state=state, epochs=1)
            model = sgd_model(state, cfg)
            acc = float(
                (np.asarray(linear_predict(model, F_test)) == y_test).mean()
            )
            logger.debug("Augment epoch %d accuracy: %.4f", e, acc)

    return {"kind": "linear", "model": model, "cfg": cfg, "state": state}


def _fit_svc(args, proj_mask, X_train, y_train) -> dict:
    """Reference svc_fit flow (train.py:442-545): augment first, then
    features, balance and kernel grid search."""
    import jax

    from radarml_tpu.ops.augment import augment_samples

    logger.info("Using SVM algo: SVC (SMO dual solver).")
    X_train = list(X_train)
    y_train = np.asarray(y_train)
    if args.epochs:
        import jax.numpy as jnp

        from radarml_tpu.ops.features import process_views

        logger.info("Augmenting data set.")
        logger.info("Original number of training samples: %d", len(y_train))
        xz, yz, xy = stack_samples(X_train)
        key = jax.random.PRNGKey(RANDOM_SEED)
        # Device-resident: original + augmented view stacks accumulate
        # on device and featurize in one program, never crossing host.
        stacks = [tuple(jnp.asarray(v, jnp.float32) for v in (xz, yz, xy))]
        ys = [y_train]
        for e in range(args.epochs):
            key, ek = jax.random.split(key)
            aug_views, ay = augment_samples(
                (xz, yz, xy), y_train, ek,
                rotation_range=15.0, zoom_range=0.3, noise_sd=0.2,
                device=True,
            )
            if args.save_augmented:
                dump_augmented(args.save_augmented, e, aug_views, ay)
            stacks.append(aug_views)
            ys.append(ay)
        y_train = np.concatenate(ys)
        logger.info("Augmented number of training samples: %d", len(y_train))

        logger.info("Generating feature vectors from radar projections.")
        F = process_views(
            *[jnp.concatenate([s[i] for s in stacks]) for i in range(3)],
            proj_mask=proj_mask,
        )
    else:
        logger.info("Generating feature vectors from radar projections.")
        F = process_samples(X_train, proj_mask=proj_mask, device=True)
    logger.info("Feature vector length: %d", F.shape[1])
    logger.info("Balancing classes.")
    y_bal, F_bal = balance_classes(y_train, F)
    logger.info("Finding best classifier.")
    res = grid_search_svc(F_bal, y_bal, folds=args.folds, probability=True)
    res.log_summary(args.folds)
    return {"kind": "svc", "model": res.best_model, "params": res.best_params}


if __name__ == "__main__":
    main()
