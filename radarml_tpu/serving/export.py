"""AOT serving artifacts: ship the compiled predictor, not the code.

The reference deploys by unpickling an sklearn estimator into the same
Python code that trained it (reference predict.py:224-227). For
production serving we additionally support exporting the ENTIRE
jitted predict program — slicing, zoom, feature build, calibrated
scoring, thresholding — as one portable `jax.export` artifact:

* the batch dimension is symbolic, so one artifact serves any batch
  size with no per-shape retrace;
* reloading needs no model weights, no pipeline construction, and no
  radarml_tpu model code — the weights are constants folded into the
  program (a serving host needs only jax + this loader);
* the StableHLO payload is versioned and platform-checked by jax.export
  itself, and round-trips bit-identically (tests/test_export.py);
* the metadata records the exporting jax/jaxlib versions. A `fused`
  artifact carries a Triton kernel, which jax.export does not promise
  to load elsewhere, so it loads only under the versions that made it.

`apps.serve --export_serving/--serving_artifact` wire this into the
streaming service.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
from typing import Callable, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

FORMAT_V1 = "radarml_tpu.serving_export.v1"  # legacy pickle container
FORMAT_V2 = "radarml_tpu.serving_export.v2"  # jax.export flatbuffer blob
FORMAT = "radarml_tpu.serving_export.v3"
# v3 container: MAGIC, one JSON metadata line (including the exported
# program's signature), then the portable StableHLO bytes. No unpickler
# runs on load, so a ModelReloader watching the path cannot be turned
# into code execution by whoever can write it, and nothing beyond JAX
# is needed: jax.export's own serializer needs the `flatbuffers`
# package, which a serving host need not have (v2 artifacts still load
# where it is installed).
MAGIC = b"RMLTPU-SERVING\n"
# The jax.export.Exported fields the v3 loader fills (`_exported`). A
# JAX whose Exported has other fields fails the load with a clear error
# (and tests/test_export.py fails), not a mis-built program.
_EXPORTED_FIELDS = (
    "fun_name", "in_tree", "in_avals", "out_tree", "out_avals",
    "_has_named_shardings", "_in_named_shardings", "_out_named_shardings",
    "in_shardings_hlo", "out_shardings_hlo", "nr_devices", "platforms",
    "ordered_effects", "unordered_effects", "disabled_safety_checks",
    "mlir_module_serialized", "calling_convention_version",
    "module_kept_var_idx", "uses_global_constants", "_get_vjp",
)


def _versions() -> dict:
    import jax
    import jaxlib

    return {"jax": jax.__version__, "jaxlib": jaxlib.__version__}


def _signature(exported) -> dict:
    """The fields of a single-device jax.export.Exported besides its
    StableHLO bytes, as JSON."""
    if exported.ordered_effects or exported.unordered_effects:
        raise ValueError("serving programs have no effects")
    if exported.nr_devices != 1:
        raise ValueError("serving artifacts are single-device programs")
    calls = [c.is_custom_call() for c in exported.disabled_safety_checks]
    if None in calls:
        raise ValueError("only custom-call safety checks may be disabled")
    return {
        "fun_name": exported.fun_name,
        "in_avals": [[[str(d) for d in a.shape], str(a.dtype)]
                     for a in exported.in_avals],
        "out_avals": [[[str(d) for d in a.shape], str(a.dtype)]
                      for a in exported.out_avals],
        "platforms": list(exported.platforms),
        "disabled_custom_calls": calls,
        "calling_convention_version": exported.calling_convention_version,
        "module_kept_var_idx": list(exported.module_kept_var_idx),
        "uses_global_constants": exported.uses_global_constants,
    }


def _exported(sig: dict, module: bytes):
    """Rebuild the jax.export.Exported that `_signature` described."""
    import jax
    import numpy as np
    from jax import export as jexport

    fields = tuple(f.name for f in dataclasses.fields(jexport.Exported))
    if fields != _EXPORTED_FIELDS:
        raise RuntimeError(
            f"jax {jax.__version__}'s jax.export.Exported has fields "
            f"{fields}; this v3 artifact loader fills {_EXPORTED_FIELDS}"
        )
    ccv = sig["calling_convention_version"]
    if not (jexport.minimum_supported_calling_convention_version <= ccv
            <= jexport.maximum_supported_calling_convention_version):
        raise ValueError(
            f"artifact calling convention {ccv} is outside the range "
            f"jax {jax.__version__} supports: re-export it"
        )
    scope = jexport.SymbolicScope()

    def avals(specs):
        return tuple(
            jax.core.ShapedArray(
                jexport.symbolic_shape(",".join(dims), scope=scope),
                np.dtype(dtype),
            )
            for dims, dtype in specs
        )

    in_avals, out_avals = avals(sig["in_avals"]), avals(sig["out_avals"])
    n_in, n_out = len(in_avals), len(out_avals)
    return jexport.Exported(
        fun_name=sig["fun_name"],
        in_tree=jax.tree_util.tree_structure(((0,) * n_in, {})),
        in_avals=in_avals,
        out_tree=jax.tree_util.tree_structure((0,) * n_out),
        out_avals=out_avals,
        _has_named_shardings=True,
        _in_named_shardings=(None,) * n_in,
        _out_named_shardings=(None,) * n_out,
        in_shardings_hlo=(None,) * n_in,
        out_shardings_hlo=(None,) * n_out,
        nr_devices=1,
        platforms=tuple(sig["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=tuple(
            jexport.DisabledSafetyCheck.custom_call(t)
            for t in sig["disabled_custom_calls"]
        ),
        mlir_module_serialized=module,
        calling_convention_version=sig["calling_convention_version"],
        module_kept_var_idx=tuple(sig["module_kept_var_idx"]),
        uses_global_constants=sig["uses_global_constants"],
        _get_vjp=None,
    )


def export_predictor(
    predictor,
    path: str,
    max_targets: int = 4,
    platforms: Optional[Sequence[str]] = None,
    batch: Optional[int] = None,
) -> dict:
    """Export a RadarPredictor's jitted program to `path`.

    Args:
        predictor: a models.pipeline.RadarPredictor (any mode/dtype).
        path: output file.
        max_targets: static target-slot axis baked into the program
            (the batch axis stays symbolic).
        platforms: lowering platforms, e.g. ("cuda", "cpu"). Defaults
            to the current backend only.
        batch: static scan-batch size — REQUIRED for mode="fused" (the
            kernel's grid is the scan batch, which shape polymorphism
            cannot express). Other modes keep the symbolic batch axis
            and ignore this.

    Returns the artifact metadata dict.
    """
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    grid = predictor.scan_arena.grid_shape
    cube_dtype = jnp.dtype(predictor.cube_dtype)
    if predictor.mode == "fused":
        if batch is None:
            raise ValueError(
                "mode='fused' exports need a static batch= (the "
                "kernel's grid is the scan batch)"
            )
        b = batch
    else:
        (b,) = jexport.symbolic_shape("b")
    fn = predictor._fn
    args = (
        jax.ShapeDtypeStruct((b,) + tuple(grid), cube_dtype),
        jax.ShapeDtypeStruct((b, max_targets, 3), jnp.float32),
        jax.ShapeDtypeStruct((b, max_targets), jnp.bool_),
    )
    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = tuple(platforms)
    if predictor.mode == "fused":
        # The fused kernel is a Triton custom call, which jax.export
        # does not promise to load in another jaxlib: such an artifact
        # serves on the backend and JAX version that exported it.
        kwargs["disabled_checks"] = [
            jexport.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ]
    exported = jexport.export(fn, **kwargs)(*args)
    meta = {
        "format": FORMAT,
        "mode": predictor.mode,
        "cube_dtype": str(predictor.cube_dtype),
        "min_proba": float(predictor.min_proba),
        "max_targets": int(max_targets),
        "grid_shape": tuple(int(g) for g in grid),
        "platforms": list(exported.platforms),
        "versions": _versions(),
        **({"batch": int(batch)} if predictor.mode == "fused" else {}),
        "exported": _signature(exported),
    }
    # Atomic replace: a ModelReloader watching `path` (train
    # --online_learn or a re-export rewrites it live) must never read
    # a half-written artifact.
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fp:
        fp.write(MAGIC)
        fp.write(json.dumps(meta).encode("utf-8"))
        fp.write(b"\n")
        fp.write(exported.mlir_module_serialized)
    os.replace(tmp, path)
    logger.info(
        "exported serving program to %s (%s, batch %s, T=%d)",
        path, meta["platforms"], meta.get("batch", "symbolic"), max_targets,
    )
    return meta


@dataclasses.dataclass(frozen=True)
class ServingArtifact:
    """Loaded AOT predictor: call like a RadarPredictor."""

    call: Callable
    mode: str
    cube_dtype: str
    min_proba: float
    max_targets: int
    grid_shape: Tuple[int, ...]
    platforms: Tuple[str, ...]
    # static scan batch for fused-mode artifacts; None = symbolic
    batch: Optional[int] = None

    def encode_host(self, cubes):
        """Narrow a canonical 0..255 host cube to the artifact's baked
        stream dtype (see models/pipeline.encode_host_cubes)."""
        from radarml_tpu.models.pipeline import encode_host_cubes

        return encode_host_cubes(cubes, self.cube_dtype)

    def __call__(self, cubes, xyz, valid):
        import jax.numpy as jnp

        b = cubes.shape[0]
        if self.batch is not None and b > self.batch:
            raise ValueError(
                f"this fused artifact was exported for a static batch "
                f"of {self.batch} scans, got {b} — score in chunks of "
                f"{self.batch} (the serve CLI's --max_batch does this)"
            )
        from radarml_tpu.models.pipeline import _dev_cast

        if self.cube_dtype == "int8":
            # The baked program expects the value-128 wire encoding;
            # a straight cast of canonical 0..255 would overflow int8.
            import jax

            if not (
                isinstance(cubes, jax.Array) and cubes.dtype == jnp.int8
            ):
                from radarml_tpu.models.pipeline import encode_int8_cubes

                cubes = encode_int8_cubes(cubes)
        else:
            cubes = _dev_cast(cubes, jnp.dtype(self.cube_dtype))
        xyz = _dev_cast(xyz, jnp.float32)
        valid = _dev_cast(valid, jnp.bool_)
        if self.batch is not None and b < self.batch:
            # Smaller batches (the unary gRPC path runs (1, T)) pad up
            # to the baked shape; pad slots carry valid=False targets
            # and the outputs slice back, so results are unaffected.
            pad = self.batch - b
            cubes = jnp.pad(cubes, ((0, pad),) + ((0, 0),) * (cubes.ndim - 1))
            xyz = jnp.pad(xyz, ((0, pad), (0, 0), (0, 0)))
            valid = jnp.pad(valid, ((0, pad), (0, 0)))
            out = self.call(cubes, xyz, valid)
            return tuple(o[:b] for o in out)
        return self.call(cubes, xyz, valid)


def load_serving_artifact(
    path: str, allow_v1_pickle: bool = False
) -> ServingArtifact:
    """Load an exported predictor; no model code or weights needed.

    v3 artifacts (the current format) are a JSON metadata line plus the
    portable StableHLO bytes — loading never runs an unpickler, so
    a `ModelReloader` watching the path is safe against artifact-file
    writers injecting code. Legacy v1 artifacts are pickles; loading
    one runs the unpickler (arbitrary code execution for whoever wrote
    the file), so it requires an explicit `allow_v1_pickle=True` from
    a caller who trusts the path — the reference's own trust model (an
    sklearn pickle, predict.py:224-227). Re-export to v3 to drop the
    requirement.
    """
    from jax import export as jexport

    with open(path, "rb") as fp:
        raw = fp.read()
    if raw.startswith(MAGIC):
        head, _, blob = raw[len(MAGIC):].partition(b"\n")
        payload = json.loads(head.decode("utf-8"))
        if payload.get("format") not in (FORMAT, FORMAT_V2):
            raise ValueError(f"not a serving export artifact: {path}")
        payload["blob"] = blob
    else:
        if not allow_v1_pickle:
            raise ValueError(
                f"{path} is not a v2/v3 serving artifact; if it is a "
                "legacy v1 pickle from a TRUSTED source, pass "
                "allow_v1_pickle=True (v1 loading executes the "
                "unpickler) or re-export it"
            )
        payload = pickle.loads(raw)
        if payload.get("format") != FORMAT_V1:
            raise ValueError(f"not a serving export artifact: {path}")
    if payload["format"] == FORMAT:
        here = _versions()
        if (payload["exported"]["disabled_custom_calls"]
                and payload.get("versions") != here):
            raise ValueError(
                f"{path} holds a kernel custom call exported under "
                f"{payload.get('versions', 'unrecorded versions')}; it "
                f"loads only under the same jax/jaxlib ({here}): re-export"
            )
        exported = _exported(payload["exported"], payload["blob"])
    else:
        exported = jexport.deserialize(payload["blob"])
    return ServingArtifact(
        call=exported.call,
        mode=payload["mode"],
        cube_dtype=payload["cube_dtype"],
        min_proba=payload["min_proba"],
        max_targets=payload["max_targets"],
        grid_shape=tuple(payload["grid_shape"]),
        platforms=tuple(payload["platforms"]),
        batch=payload.get("batch"),
    )
