from radarml_tpu.models.linear import (
    LinearModel,
    SGDConfig,
    SGDState,
    SigmoidCalibration,
    calibrate_ovr,
    decision_function,
    fit_sigmoid_calibration,
    from_sklearn_calibrated,
    from_sklearn_linear,
    predict,
    predict_proba_calibrated,
    predict_proba_log_loss,
    sgd_fit,
    sgd_init,
    sgd_model,
)
from radarml_tpu.models.pipeline import UNKNOWN, RadarPredictor, pad_targets
from radarml_tpu.models.svc import (
    SVCConfig,
    SVCModel,
    from_sklearn_svc,
    svc_fit,
)
from radarml_tpu.models.svc import (
    decision_function_ovo as svc_decision_function,
    predict as svc_predict,
    predict_proba as svc_predict_proba,
)

# The neural families need flax; they import on first use so the
# linear/SVC main path runs with JAX, numpy, scipy and optax alone.
_LAZY = {
    "MultiViewCNN": "cnn",
    "ViewBranch": "cnn",
    "LATENT_DIM": "sgan",
    "Discriminator": "sgan",
    "Generator": "sgan",
    "c_head": "sgan",
    "custom_activation": "sgan",
    "d_head": "sgan",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f"radarml_tpu.models.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "SVCConfig",
    "SVCModel",
    "from_sklearn_svc",
    "svc_fit",
    "svc_decision_function",
    "svc_predict",
    "svc_predict_proba",
    "MultiViewCNN",
    "ViewBranch",
    "LATENT_DIM",
    "Discriminator",
    "Generator",
    "c_head",
    "custom_activation",
    "d_head",
    "LinearModel",
    "SGDConfig",
    "SGDState",
    "SigmoidCalibration",
    "calibrate_ovr",
    "decision_function",
    "fit_sigmoid_calibration",
    "from_sklearn_calibrated",
    "from_sklearn_linear",
    "predict",
    "predict_proba_calibrated",
    "predict_proba_log_loss",
    "sgd_fit",
    "sgd_init",
    "sgd_model",
    "UNKNOWN",
    "RadarPredictor",
    "pad_targets",
]
