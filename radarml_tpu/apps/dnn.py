"""CLI: train the multi-view CNN ("DNN") classifier.

Mirror of the reference's dnn.py entry point (dnn.py:393-476): load +
filter datasets, scale to [-1, 1], optional augmentation, bicubic
resize to 80×80, stack to (N, 80, 80, 3), split, and train with Adam
(2e-4, β1 0.5), class weights, early stopping and best-checkpoint
retention. Saves the best parameters + label classes to
<results_dir>/c_model.pickle and logs the Keras-style history.

Extras over the reference: `--synthetic N` generates data when no
pickles exist; `--mesh N` shards the batch over an N-device mesh
(data parallelism via pjit, the multi-device scale-out path).
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np

from radarml_tpu.apps.common_cli import (
    add_common_flags,
    require_flax,
    setup_logging,
)

require_flax("radarml-dnn")
from radarml_tpu.data.labels import filter_samples
from radarml_tpu.data.store import load_datasets
from radarml_tpu.models.cnn import RESCALE, MultiViewCNN
from radarml_tpu.data.preprocess import preprocess_multiview
from radarml_tpu.train.trainer import TrainConfig, train_cnn

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datasets", nargs="+", type=str, default=[])
    p.add_argument("--desired_labels", nargs="+", type=str,
                   default=["person", "dog", "cat", "pet"])
    p.add_argument("--train_split", type=float, default=0.8)
    p.add_argument("--results_dir", type=str, default="train-results/dnn")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0,
                   help="shard training over an N-device mesh")
    p.add_argument("--checkpoint_dir", type=str, default="",
                   help="write orbax checkpoints every "
                        "--checkpoint_every epochs during training "
                        "(the reference's ModelCheckpoint durability, "
                        "dnn.py:365-370); training still runs as fused "
                        "device chunks")
    p.add_argument("--checkpoint_every", type=int, default=10,
                   help="epochs per fused chunk between checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in "
                        "--checkpoint_dir; reproduces the "
                        "uninterrupted run exactly")
    add_common_flags(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    os.makedirs(args.results_dir, exist_ok=True)
    setup_logging(os.path.join(args.results_dir, "train.log"),
                  args.logging_level)

    if not args.datasets and args.synthetic:
        from radarml_tpu.data.synthetic import make_dataset

        samples, labels = make_dataset(args.synthetic, seed=1234)
    else:
        data = load_datasets(args.datasets)
        samples, labels = data["samples"], data["labels"]
    samples, labels = filter_samples(samples, labels, args.desired_labels)
    logger.info("Dataset: %d samples", len(labels))

    augment_fn = None
    if args.augment:
        import jax

        from radarml_tpu.ops.augment import augment_multiview

        def augment_fn(views, rng):
            return augment_multiview(
                views, jax.random.PRNGKey(int(rng.integers(2**31)))
            )

    pre = preprocess_multiview(
        samples, labels, rescale=RESCALE,
        train_split=args.train_split, augment_fn=augment_fn, device=True,
    )
    n_classes = pre["n_classes"]
    logger.info("Class weights: %s", pre["w_classes"])

    import jax

    model = MultiViewCNN(n_classes=n_classes)
    params = model.init(
        jax.random.PRNGKey(1234),
        np.zeros((1,) + RESCALE + (3,), np.float32),
        train=False,
    )["params"]

    mesh = None
    if args.mesh:
        from radarml_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh)

    # Architecture summary next to the checkpoint (the reference dumps
    # plot_model PNGs here, dnn.py:426-427).
    from radarml_tpu.utils.summary import plot_model_png, write_model_summary

    write_model_summary(
        os.path.join(args.results_dir, "c_model_summary.txt"),
        params, title=f"MultiViewCNN n_classes={n_classes} rescale={RESCALE}",
    )
    plot_model_png(
        os.path.join(args.results_dir, "dnn_model.png"),
        params, title=f"MultiViewCNN n_classes={n_classes} rescale={RESCALE}",
    )

    cfg = TrainConfig(batch_size=args.batch_size, epochs=args.epochs)
    best_params, history = train_cnn(
        model, params,
        pre["X_train"], pre["y_train"], pre["X_val"], pre["y_val"],
        w_classes=pre["w_classes"], config=cfg, mesh=mesh,
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
    )

    out_path = os.path.join(args.results_dir, "c_model.pickle")
    with open(out_path, "wb") as fp:
        pickle.dump(
            {
                "format": "radarml_tpu.v1",
                "kind": "cnn",
                "params": jax.tree.map(np.asarray, best_params),
                "classes": list(pre["label_encoder"].classes_),
                "rescale": RESCALE,
                "history": history,
            },
            fp,
        )
    logger.info("Saved classifier to %s", out_path)
    return {"history": history, "model_path": out_path, "params": best_params}


if __name__ == "__main__":
    main()
