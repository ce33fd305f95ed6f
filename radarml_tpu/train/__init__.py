from radarml_tpu.train.metrics import (
    accuracy_score,
    classification_report,
    confusion_matrix,
    evaluate_model,
    plot_confusion_matrix,
)
from radarml_tpu.train.trainer import TrainConfig, train_cnn, weighted_xent_loss
from radarml_tpu.train.checkpoint import CheckpointStore
from radarml_tpu.train.gridsearch import (
    GridSearchResult,
    SGD_PARAM_GRID,
    SVC_PARAM_GRID,
    grid_search_sgd,
    grid_search_svc,
    parameter_grid,
    stratified_kfold_indices,
)

# The SGAN trainer needs flax; it imports on first use so the linear/SVC
# main path runs with JAX, numpy, scipy and optax alone.
_SGAN = (
    "SGANConfig",
    "SGANState",
    "classifier_eval",
    "generate_fake_dataset",
    "make_sgan_step",
    "select_supervised_samples",
    "sgan_init",
    "train_sgan",
)


def __getattr__(name):
    if name in _SGAN:
        from radarml_tpu.train import sgan_trainer

        return getattr(sgan_trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "accuracy_score",
    "classification_report",
    "confusion_matrix",
    "evaluate_model",
    "plot_confusion_matrix",
    "TrainConfig",
    "train_cnn",
    "weighted_xent_loss",
    "CheckpointStore",
    "SGANConfig",
    "SGANState",
    "classifier_eval",
    "generate_fake_dataset",
    "make_sgan_step",
    "select_supervised_samples",
    "sgan_init",
    "train_sgan",
    "GridSearchResult",
    "SGD_PARAM_GRID",
    "SVC_PARAM_GRID",
    "grid_search_sgd",
    "grid_search_svc",
    "parameter_grid",
    "stratified_kfold_indices",
]
