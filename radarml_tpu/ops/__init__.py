from radarml_tpu.ops.resample import (
    bicubic_resize_matrix,
    bspline_zoom_matrix,
    resample2d,
    zoom_output_size,
)
from radarml_tpu.ops.features import FeatureSpec, make_feature_fn, process_samples, predict_zoom
from radarml_tpu.ops.augment import (
    add_noise,
    augment_multiview,
    augment_samples,
    bspline_sample2d,
    clipped_zoom_batch,
    clipped_zoom_operator,
    rotate,
    rotate_batch,
    sparse_noise,
    spline_coeffs2d,
    zoom_palette,
)

__all__ = [
    "add_noise",
    "augment_multiview",
    "augment_samples",
    "bspline_sample2d",
    "clipped_zoom_batch",
    "clipped_zoom_operator",
    "rotate",
    "rotate_batch",
    "sparse_noise",
    "spline_coeffs2d",
    "zoom_palette",
    "bicubic_resize_matrix",
    "bspline_zoom_matrix",
    "resample2d",
    "zoom_output_size",
    "FeatureSpec",
    "make_feature_fn",
    "process_samples",
    "predict_zoom",
]
