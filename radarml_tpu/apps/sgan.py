"""CLI: train the semi-supervised GAN.

Mirror of the reference's sgan.py entry point (sgan.py:769-850): load
datasets (with --datasets_as_sup marking which carry supervised
labels), scale, optional augmentation, bicubic resize to 128×128,
mask-aware balancing, and the 4-phase GAN schedule with per-epoch
evaluation + generated-dataset/checkpoint dumps into --results_dir.

`--synthetic N` generates data when no pickles exist; `--rescale S`
trains a reduced-resolution pyramid (S = 8·2^n) for fast smoke runs.
"""

from __future__ import annotations

import argparse
import logging
import os

from radarml_tpu.apps.common_cli import (
    add_common_flags,
    require_flax,
    setup_logging,
)

require_flax("radarml-sgan")
from radarml_tpu.data.labels import filter_samples
from radarml_tpu.data.preprocess import preprocess_multiview
from radarml_tpu.data.store import load_datasets_with_sup_mask
from radarml_tpu.models.sgan import SGAN_RESCALE
from radarml_tpu.train.sgan_trainer import SGANConfig, sgan_init, train_sgan

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datasets", nargs="+", type=str, default=[])
    p.add_argument("--datasets_as_sup", nargs="+", type=str, default=[])
    p.add_argument("--desired_labels", nargs="+", type=str,
                   default=["person", "dog", "cat", "pet"])
    p.add_argument("--train_split", type=float, default=1.0)
    p.add_argument("--results_dir", type=str, default="train-results/sgan")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--sup_samples", type=int, default=150)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--rescale", type=int, default=SGAN_RESCALE[0],
                   help="square training resolution, 8·2^n")
    p.add_argument("--checkpoint_dir", type=str, default="",
                   help="orbax checkpoint directory (enables mid-run saves)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint")
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
        sup = [True] * len(labels)
    else:
        samples, labels, sup = load_datasets_with_sup_mask(
            args.datasets, args.datasets_as_sup
        )
    keep = filter_samples(list(zip(samples, sup)), labels, args.desired_labels)
    pairs, labels = keep
    samples = [p[0] for p in pairs]
    sup = [p[1] for p in pairs]
    logger.info("Dataset: %d samples (%d supervised)", len(labels), sum(sup))

    augment_fn = None
    if args.augment:
        import jax

        from radarml_tpu.ops.augment import augment_multiview

        def augment_fn(views, rng):
            return augment_multiview(
                views, jax.random.PRNGKey(int(rng.integers(2**31)))
            )

    rescale = (args.rescale, args.rescale)
    pre = preprocess_multiview(
        samples, labels, rescale=rescale,
        train_split=args.train_split, sup_mask=sup, balance=True,
        augment_fn=augment_fn, device=True,
    )
    n_classes = pre["n_classes"]

    import jax

    cfg = SGANConfig(
        n_classes=n_classes,
        n_epochs=args.epochs,
        n_batch=args.batch_size,
        n_sup_samples=args.sup_samples,
    )
    gen, disc, state = sgan_init(jax.random.PRNGKey(cfg.seed), cfg, rescale)

    # Architecture summaries next to the checkpoints (the reference
    # dumps plot_model PNGs here, sgan.py:750-765).
    from radarml_tpu.utils.summary import plot_model_png, write_model_summary

    write_model_summary(
        os.path.join(args.results_dir, "g_model_summary.txt"),
        state.g_params, title=f"SGAN generator rescale={rescale}",
    )
    write_model_summary(
        os.path.join(args.results_dir, "d_model_summary.txt"),
        state.d_params,
        title=f"SGAN discriminator (c+d heads) n_classes={n_classes}",
    )
    # Graphical dumps matching the reference's four plot_model PNGs
    # (sgan.py:750-765). c_model shares d_model's weights (shared-logit
    # heads, models/sgan.py), so its PNG renders the same tree; the gan
    # composite is generator+discriminator.
    plot_model_png(
        os.path.join(args.results_dir, "sgan_g_model.png"),
        state.g_params, title=f"SGAN generator rescale={rescale}",
    )
    plot_model_png(
        os.path.join(args.results_dir, "sgan_d_model.png"),
        state.d_params,
        title=f"SGAN discriminator (d head) n_classes={n_classes}",
    )
    plot_model_png(
        os.path.join(args.results_dir, "sgan_c_model.png"),
        state.d_params,
        title=f"SGAN classifier (c head, weights shared with d)",
    )
    plot_model_png(
        os.path.join(args.results_dir, "sgan_gan_model.png"),
        {"generator": state.g_params, "discriminator": state.d_params},
        title="SGAN composite (g → d, BN-only trainable in d)",
    )

    state = train_sgan(
        gen, disc, state,
        (pre["X_train"], pre["y_train"], pre.get("sup_train")),
        (pre["X_val"], pre["y_val"]),
        cfg,
        w_classes=pre["w_classes"],
        results_dir=args.results_dir,
        checkpoint_dir=args.checkpoint_dir or None,
        resume=args.resume,
    )

    # Serving artifact for the supervised head: loads via
    # common_cli.load_model into the RadarPredictor / serve CLI like
    # any other family (the reference's c_model_%04d.h5 analog,
    # sgan.py:497-500, made directly servable).
    import pickle

    import numpy as np

    classes = list(pre["label_encoder"].classes_)
    c_path = os.path.join(args.results_dir, "c_model.pickle")
    with open(c_path, "wb") as fp:
        pickle.dump(
            {
                "format": "radarml_tpu.v1",
                "kind": "sgan_classifier",
                "d_params": jax.tree.map(np.asarray, state.d_params),
                "d_stats": jax.tree.map(np.asarray, state.d_stats),
                "classes": classes,
                "rescale": rescale,
            },
            fp,
        )
    logger.info("Saved classifier to %s", c_path)
    return {"state": state, "classes": classes, "model_path": c_path}


if __name__ == "__main__":
    main()
