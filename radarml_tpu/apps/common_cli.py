"""Shared CLI plumbing: logging, flags, model artifacts, drivers.

The reference's per-script argparse + logging blocks (train.py:547-638,
predict.py:133-166, ground_truth_samples.py:474-508) are centralized
here: same log format string, FileHandler(mode='w') + stdout
StreamHandler, info/debug level flag.

Model artifacts: the framework saves a self-describing pickle dict
(`kind` + numpy arrays) instead of sklearn object pickles, and the
loader also accepts reference-style sklearn pickles
(CalibratedClassifierCV over SGD, or SVC) for drop-in serving of
models trained by the original code (reference predict.py:224-227).
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import sys
from typing import List, Optional, Sequence

from radarml_tpu.core.arena import Arena, DEFAULT_ARENA, ProjMask
from radarml_tpu.data.labels import LabelEncoder

LOG_FORMAT = "%(asctime)s %(name)-12s %(levelname)-8s %(message)s"

logger = logging.getLogger(__name__)


REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Persistent XLA compile cache shared by every CLI and benchmark.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and this
    sets nothing. Otherwise the cache lives at the fixed
    `<checkout>/.jax_cache` (gitignored), so repeat runs of any app in
    one checkout reuse each other's compiles. Returns the directory.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def setup_logging(log_file: Optional[str], level: str):
    enable_compile_cache()  # every app benefits; idempotent
    handlers: List[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file, mode="w"))
    logging.basicConfig(
        format=LOG_FORMAT,
        level=logging.DEBUG if level == "debug" else logging.INFO,
        handlers=handlers,
        force=True,
    )


def require_flax(app: str):
    """Fail with a clear message when a neural app runs without flax."""
    try:
        import flax  # noqa: F401
    except ImportError as e:
        raise ImportError(
            f"{app} trains a flax model, and flax is not installed "
            "(pip install 'radarml-tpu[neural]')"
        ) from e


def _apply_platform(value: str) -> str:
    """argparse type for --platform: applies the backend choice AT
    PARSE TIME, before the app touches any device — jax.config must be
    set before backend initialization."""
    if value:
        import jax

        jax.config.update("jax_platforms", value)
    return value


def add_common_flags(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--logging_level", type=str, default="info",
        help='logging level, "info" or "debug"',
    )
    parser.add_argument(
        "--platform", type=_apply_platform, default="",
        help="JAX backend to run on, e.g. 'cuda' or 'cpu' (an explicit "
             "choice: nothing falls back to the CPU on its own); "
             "default: JAX's own choice for the environment",
    )


def parse_proj_mask(values: Sequence) -> ProjMask:
    """Reference flag order is (xz, yz, xy) booleans."""
    def to_bool(v):
        if isinstance(v, bool):
            return v
        return str(v).lower() not in ("0", "false", "no", "")

    vals = [to_bool(v) for v in values]
    if len(vals) != 3:
        raise ValueError("--proj_mask needs exactly 3 values")
    return ProjMask(*vals)


def add_scan_arena_flag(parser: argparse.ArgumentParser):
    """--scan_arena: serve scans from a DIFFERENTLY-configured arena.

    The reference predictor is explicitly designed to classify scans
    from an arena that differs from the training arena — it zooms each
    projection by train_size/scan_size per axis (reference
    predict.py:34-54 calc_proj_zoom). The library implements this
    (ops/features.predict_zoom + RadarPredictor(scan_arena=...)); this
    flag makes it reachable from the CLI.
    """
    parser.add_argument(
        "--scan_arena", type=str, default="",
        help="scan arena if it differs from the training arena, as "
             "9 comma-separated values "
             "r_min,r_max,r_res,theta_min,theta_max,theta_res,"
             "phi_min,phi_max,phi_res (cm / deg; default: the "
             "training arena, i.e. %s)" % (
                 "10,360,2,-42,42,4,-30,30,2",
             ),
    )


def parse_arena(spec: str, default: Arena = DEFAULT_ARENA) -> Arena:
    """Parse a --scan_arena value; '' → the default (training) arena."""
    if not spec:
        return default
    vals = [float(v) for v in spec.replace(" ", "").split(",")]
    if len(vals) != 9:
        raise ValueError(
            "--scan_arena needs 9 comma-separated values "
            "(r_min,r_max,r_res,theta_min,theta_max,theta_res,"
            "phi_min,phi_max,phi_res); got %d" % len(vals)
        )
    return Arena(
        r_min=vals[0], r_max=vals[1], r_res=vals[2],
        theta_min=vals[3], theta_max=vals[4], theta_res=vals[5],
        phi_min=vals[6], phi_max=vals[7], phi_res=vals[8],
    )


def _parse_bool(value: str) -> bool:
    return str(value).lower() not in ("0", "false", "no", "")


def add_driver_flags(parser: argparse.ArgumentParser):
    from radarml_tpu.drivers.base import DEFAULT_THRESHOLD

    parser.add_argument(
        "--driver", type=str, default="synthetic",
        choices=["synthetic", "native", "walabot"],
        help="radar backend (walabot requires the vendor SDK)",
    )
    parser.add_argument(
        "--scan_period", type=float, default=0.0,
        help="simulated sensor scan period in seconds",
    )
    parser.add_argument("--driver_seed", type=int, default=1234)
    parser.add_argument(
        "--threshold", type=float, default=DEFAULT_THRESHOLD,
        help="radar sensitivity threshold applied at session configure "
             "(reference predict.py:203 SetThreshold(5))",
    )
    parser.add_argument(
        "--mti", type=_parse_bool, default=True,
        help="enable the MTI dynamic image filter; with --mti=false the "
             "session runs the explicit calibration loop before scanning "
             "(reference predict.py:207-213 SetDynamicImageFilter + "
             "common.calibrate)",
    )


def build_driver(args, arena: Arena = DEFAULT_ARENA):
    threshold = getattr(args, "threshold", None)
    mti = getattr(args, "mti", True)
    if threshold is None:
        from radarml_tpu.drivers.base import DEFAULT_THRESHOLD

        threshold = DEFAULT_THRESHOLD
    if args.driver == "synthetic":
        from radarml_tpu.drivers import SyntheticRadar

        return SyntheticRadar(
            arena=arena, seed=args.driver_seed,
            scan_period_s=args.scan_period, max_targets=2,
            threshold=threshold, mti=mti,
        )
    if args.driver == "native":
        from radarml_tpu.drivers import NativeRadar

        return NativeRadar(
            arena=arena, seed=args.driver_seed,
            scan_period_us=args.scan_period * 1e6,
            threshold=threshold, mti=mti,
        )
    from radarml_tpu.drivers import WalabotRadar, walabot_available

    if not walabot_available():
        raise SystemExit(
            "walabot driver requires the vendor WalabotAPI SDK wheel"
        )
    return WalabotRadar(arena=arena, threshold=threshold, mti=mti)


# --------------------------------------------------------------------------
# Model artifacts
# --------------------------------------------------------------------------

def save_model(path: str, kind: str, **arrays):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"format": "radarml_tpu.v1", "kind": kind}
    payload.update(arrays)
    with open(path, "wb") as fp:
        pickle.dump(payload, fp)


def save_label_encoder(path: str, le: LabelEncoder):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fp:
        pickle.dump({"format": "radarml_tpu.v1", "classes": list(le.classes_)}, fp)


def load_label_encoder(path: str) -> LabelEncoder:
    with open(path, "rb") as fp:
        obj = pickle.load(fp)
    if isinstance(obj, dict) and obj.get("format") == "radarml_tpu.v1":
        return LabelEncoder(classes_=list(obj["classes"]))
    # sklearn LabelEncoder pickle (reference artifact)
    return LabelEncoder(classes_=[str(c) for c in obj.classes_])


def load_model_meta(path: str) -> dict:
    """Raw artifact payload for this framework's v1 pickles.

    Returns {} for reference sklearn pickles (they carry hyperparams in
    the estimator object instead). Used by online learning to resume
    the SGD schedule (cfg + step counter t) the artifact trained with.
    """
    with open(path, "rb") as fp:
        obj = pickle.load(fp)
    if isinstance(obj, dict) and obj.get("format") == "radarml_tpu.v1":
        return obj
    return {}


def load_model(path: str):
    """Load a scoring model: returns (model, calibration_or_None).

    Accepts this framework's artifact dicts and reference sklearn
    pickles (CalibratedClassifierCV-over-linear or SVC).
    """
    import jax.numpy as jnp

    from radarml_tpu.models.linear import (
        LinearModel,
        SigmoidCalibration,
        from_sklearn_calibrated,
    )
    from radarml_tpu.models.svc import SVCModel, from_sklearn_svc

    with open(path, "rb") as fp:
        obj = pickle.load(fp)

    if isinstance(obj, dict) and obj.get("format") == "radarml_tpu.v1":
        kind = obj["kind"]
        if kind == "linear":
            model = LinearModel(
                coef=jnp.asarray(obj["coef"]),
                intercept=jnp.asarray(obj["intercept"]),
            )
            calib = None
            if obj.get("calib_a") is not None:
                calib = SigmoidCalibration(
                    a=jnp.asarray(obj["calib_a"]), b=jnp.asarray(obj["calib_b"])
                )
            return model, calib
        if kind == "cnn":
            import jax

            from radarml_tpu.models.cnn import MultiViewCNN
            from radarml_tpu.models.pipeline import NeuralClassifier

            classes = list(obj["classes"])
            module = MultiViewCNN(n_classes=len(classes))
            params = jax.tree.map(jnp.asarray, obj["params"])

            def apply(views):
                return module.apply({"params": params}, views, train=False)

            return (
                NeuralClassifier(
                    apply=apply,
                    rescale=tuple(obj["rescale"]),
                    n_classes=len(classes),
                ),
                None,
            )
        if kind == "sgan_classifier":
            import jax

            from radarml_tpu.models.pipeline import NeuralClassifier
            from radarml_tpu.models.sgan import Discriminator

            classes = list(obj["classes"])
            module = Discriminator(n_classes=len(classes))
            d_params = jax.tree.map(jnp.asarray, obj["d_params"])
            d_stats = jax.tree.map(jnp.asarray, obj["d_stats"])

            def apply(views):
                split = tuple(views[..., i : i + 1] for i in range(3))
                return module.apply(
                    {"params": d_params, "batch_stats": d_stats},
                    split, train=False,
                )

            return (
                NeuralClassifier(
                    apply=apply,
                    rescale=tuple(obj["rescale"]),
                    n_classes=len(classes),
                ),
                None,
            )
        if kind == "svc":
            model = SVCModel(
                support_vectors=jnp.asarray(obj["support_vectors"]),
                dual_coef=jnp.asarray(obj["dual_coef"]),
                intercept=jnp.asarray(obj["intercept"]),
                n_support=tuple(obj["n_support"]),
                kernel=obj["kernel"],
                gamma=float(obj["gamma"]),
                probA=jnp.asarray(obj["probA"]) if obj.get("probA") is not None else None,
                probB=jnp.asarray(obj["probB"]) if obj.get("probB") is not None else None,
            )
            return model, None
        raise ValueError(f"unknown model kind {kind!r}")

    # Reference sklearn pickles.
    cls = type(obj).__name__
    if cls == "CalibratedClassifierCV":
        return from_sklearn_calibrated(obj)
    if cls == "SVC":
        return from_sklearn_svc(obj), None
    raise ValueError(f"unrecognized model artifact {cls!r} in {path}")
