"""The real-time predict pipeline as a single jitted device program.

Re-design of the reference's predict loop (predict.py:72-131): per
scan, slice the three 2-D projections at each target's cube indices,
zoom them into the training arena, build the feature vector, score the
calibrated linear model, and threshold. The reference runs this
per-target in Python at ~8-10 ms/target on a Pi; here the whole batch
of scans × targets executes as one XLA program — slices are dynamic
gathers, zooms are matmuls, scoring is one matmul — so per-device
throughput is bounded by streaming the scan cubes from device memory.

Dynamic target counts become a static `max_targets` axis with a
validity mask (SURVEY.md §7 hard part 5): invalid rows still flow
through the math on clamped indices and are masked at the end, which is
the XLA-friendly alternative to data-dependent control flow.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from radarml_tpu.core.arena import Arena, ProjMask, RADAR_MAX
from radarml_tpu.ops.features import predict_zoom
from radarml_tpu.ops.resample import spline_zoom_pair
from radarml_tpu.models.linear import (
    LinearModel,
    SigmoidCalibration,
    calibrated_from_decision,
    predict_proba_calibrated,
    predict_proba_log_loss,
    proba_from_decision,
)

UNKNOWN = -1  # prediction index when below min_proba (the "Unknown" label)


def _dev_cast(x, dtype):
    """`jnp.asarray(x, dtype)` that is a true no-op when `x` is already
    a device array of that dtype (an explicit-dtype `jnp.asarray` can
    enqueue a conversion even when nothing changes)."""
    if isinstance(x, jax.Array) and x.dtype == dtype:
        return x
    return jnp.asarray(x, dtype)


def encode_int8_cubes(cubes):
    """Encode raw 0..255 scan cubes as the int8 wire format (value-128).

    Lossless for integer-valued radar data; uint8 input converts with a
    zero-copy xor-msb reinterpret on host. Already-int8 input passes
    through (a native driver can emit the shifted form directly).
    """
    if isinstance(cubes, np.ndarray):
        if cubes.dtype == np.int8:
            return jnp.asarray(cubes)
        if cubes.dtype == np.uint8:
            return jnp.asarray((cubes ^ np.uint8(0x80)).view(np.int8))
        return jnp.asarray(
            (np.asarray(cubes, np.int16) - 128).astype(np.int8)
        )
    if not isinstance(cubes, jax.Array):
        cubes = jnp.asarray(cubes)
    if cubes.dtype == jnp.int8:
        return cubes  # no asarray dispatch: see _dev_cast
    return (cubes.astype(jnp.int16) - 128).astype(jnp.int8)


def encode_host_cubes(cubes: np.ndarray, cube_dtype: str) -> np.ndarray:
    """Narrow a canonical 0..255 host cube to a stream dtype on host.

    Shared by RadarPredictor.encode_host and ServingArtifact.encode_host
    so serving layers move 1 B/voxel (2 for bf16) from ingest onward.
    int8 output carries the value-128 wire encoding (encode_int8_cubes);
    non-integer input truncates exactly like the device-side cast.
    """
    cubes = np.asarray(cubes)
    if cube_dtype == "uint8":
        return cubes if cubes.dtype == np.uint8 else cubes.astype(np.uint8)
    if cube_dtype == "int8":
        if cubes.dtype == np.int8:
            return cubes
        u8 = cubes if cubes.dtype == np.uint8 else cubes.astype(np.uint8)
        return (u8 ^ np.uint8(0x80)).view(np.int8)
    if cube_dtype == "bfloat16":
        import ml_dtypes

        return cubes.astype(ml_dtypes.bfloat16)
    return cubes if cubes.dtype == np.float32 else cubes.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class NeuralClassifier:
    """Serving wrapper for the neural families (CNN / SGAN classifier).

    The reference can only serve its sklearn SVM pickle
    (predict.py:224-227); here every trained family plugs into the same
    RadarPredictor: targets slice out of the cube, each projection
    bicubic-resizes to `rescale` and scales to [-1, 1] exactly as
    training preprocessing did (dnn.py:202-245 semantics,
    data/preprocess.py), and `apply` maps the (N, h, w, 3) view stack
    to (N, n_classes) logits in inference mode.
    """

    apply: Callable
    rescale: Tuple[int, int]
    n_classes: int


@dataclasses.dataclass(frozen=True)
class RadarPredictor:
    """Batched scan→detections predictor.

    Args mirror the reference CLI (predict.py:133-157): a training
    arena (fixes feature geometry), a scan arena (may differ → zoom),
    projection mask, calibrated linear model, and the min_proba
    threshold below which a target is 'Unknown'.
    """

    train_arena: Arena
    scan_arena: Arena
    model: LinearModel
    calibration: Optional[SigmoidCalibration] = None
    proj_mask: ProjMask = ProjMask(True, True, True)
    min_proba: float = 0.7
    # "exact" | "fast" | "fused" (the last two: linear models only).
    # "fused" is fast+int8 with the three table contractions in one
    # kernel program per scan (ops/pallas_i8_score, Pallas through
    # Triton on the GPU): same quantized templates, same XLA tail,
    # identical decisions.
    mode: str = "exact"
    mesh: object = None  # optional jax Mesh: shard scans over 'data'
    # Run the fused kernel in the Pallas interpreter (CPU tests only;
    # the program itself never sets this).
    interpret: bool = False
    # Device dtype of the scan-cube stream. Radar cubes are 8-bit
    # sensor data (reference predict.py:90-91 GetRawImage yields
    # 0..255), and every such value is exactly representable in
    # bfloat16, uint8 AND (shifted by -128) int8 — so all three narrow
    # dtypes are lossless on real scans.
    # "bfloat16" halves device-memory and host-link traffic vs f32;
    # "uint8" quarters them with the f32 cast fused into the
    # contraction; "int8" carries value-128 on the wire and scores with
    # error-compensated int8 templates as s8xs8->s32 dots (the -128
    # shift folds into the intercept, so it is as lossless as uint8).
    # uint8/int8 truncate: only use them for integer-valued 0..255
    # cubes. Keep "float32" for arbitrary continuous inputs.
    cube_dtype: str = "float32"  # "float32"|"bfloat16"|"uint8"|"int8"

    def __post_init__(self):
        if self.mode not in ("exact", "fast", "fused"):
            raise ValueError(f"unknown mode {self.mode!r}")
        is_linear = type(self.model).__name__ == "LinearModel"
        if self.mode == "fused":
            if not is_linear:
                raise ValueError("fused mode folds linear models only")
            # The kernel's stream IS int8 (value-128); every requested
            # stream dtype resolves to it (all four are lossless for
            # 8-bit radar cubes, so a bfloat16/uint8 request loses
            # nothing).
            object.__setattr__(self, "cube_dtype", "int8")
        if type(self.model).__name__ == "NeuralClassifier":
            object.__setattr__(self, "_fn", self._build_neural())
        elif self.mode in ("fast", "fused") and is_linear:
            object.__setattr__(self, "_fn", self._build_folded())
        else:
            object.__setattr__(self, "_fn", self._build())

    def _folded_templates(self):
        """Fold zoom matrices + /255 scale + linear weights into
        per-class templates at the scan's NATIVE plane resolution.

        The per-target pipeline slice→zoom→flatten→concat→scale→score
        is linear in the raw planes, so for each plane p with zoom
        operators R_p, C_p and weight block W_c^p (reshaped to the
        zoomed plane), decision contributions collapse to
        ⟨R_pᵀ W_c^p C_p, X_p⟩ / RADAR_MAX. One (C, F_native) template
        matrix replaces all resampling matmuls — the per-target cost
        becomes a single matvec on the raw slices.
        """
        scan = self.scan_arena
        zoom = predict_zoom(self.train_arena, scan)
        coef = np.asarray(self.model.coef, np.float64)
        C = coef.shape[0]
        parts = []
        off = 0
        for shape, z, keep in zip(
            (scan.xz_shape, scan.yz_shape, scan.xy_shape), zoom, self.proj_mask
        ):
            if not keep:
                continue
            r, c, (o_h, o_w) = spline_zoom_pair(tuple(shape), tuple(z))
            W = coef[:, off : off + o_h * o_w].reshape(C, o_h, o_w)
            A = np.einsum("oh,cop,pw->chw", r, W, c) / RADAR_MAX
            parts.append(A.reshape(C, -1))
            off += o_h * o_w
        templates = np.concatenate(parts, axis=1).astype(np.float32)
        return templates  # (C, F_native)

    def _split_templates(self):
        """Folded templates reshaped to per-plane (C, ·, ·) tensors
        (None where the plane is masked out)."""
        scan = self.scan_arena
        templates = self._folded_templates()
        C = templates.shape[0]
        shapes = [scan.xz_shape, scan.yz_shape, scan.xy_shape]
        out = []
        off = 0
        for shape, keep in zip(shapes, self.proj_mask):
            if not keep:
                out.append(None)
                continue
            size = shape[0] * shape[1]
            out.append(
                jnp.asarray(templates[:, off : off + size].reshape((C,) + shape))
            )
            off += size
        return out

    def _quantized_split_templates(self):
        """Per-plane error-compensated int8 templates + scales.

        For each plane template t (C, H, W): a coarse per-class int8
        quantization q1 = rint(t/s1) with s1 = max|t_c|/127, and a
        second int8 pass q2 over the residual r = t - s1*q1 with
        s2 = max|r_c|/127 — so ⟨t, x⟩ ≈ s1⟨q1, x⟩ + s2⟨q2, x⟩ with
        per-element error ≤ s2/2 ≈ max|t|/32k (empirically ~1e-5
        relative on decisions). q1 and q2 CONCATENATE on the class
        axis: one (2C, H, W) operand means one s8xs8->s32 dot and one
        cube read per plane.

        Also returns const_c = 128*Σt: int8 cubes carry value-128, and
        ⟨t, u⟩ = ⟨t, u-128⟩ + 128Σt folds the shift into a per-class
        constant.
        """
        outs = []
        for t in self._split_templates():
            if t is None:
                outs.append(None)
                continue
            t = np.asarray(t, np.float64)
            a1 = np.abs(t).max(axis=(1, 2))
            s1 = np.where(a1 > 0, a1 / 127.0, 1.0)
            q1 = np.rint(t / s1[:, None, None])
            const = jnp.asarray(128.0 * t.sum(axis=(1, 2)), jnp.float32)
            r = t - q1 * s1[:, None, None]
            a2 = np.abs(r).max(axis=(1, 2))
            s2 = np.where(a2 > 0, a2 / 127.0, 1.0)
            q2 = np.rint(r / s2[:, None, None])
            outs.append(
                (
                    jnp.asarray(np.concatenate([q1, q2]).astype(np.int8)),
                    jnp.asarray(s1, jnp.float32),
                    jnp.asarray(s2, jnp.float32),
                    const,
                )
            )
        return outs

    def _build_folded(self) -> Callable:
        """Template-contraction scoring: per-target cost is 3 lookups.

        The decision's xz contribution for a target at plane index j is
        ⟨A_xz_c, cube[:, j, :]⟩ — so contracting the WHOLE cube with
        the template once, M1[c, y] = Σ_xz A_xz[c, x, z]·cube[x, y, z],
        turns every target's contribution into the table read M1[c, j]
        (similarly M2[c, i] for yz and M3[c, k] for xy). Three einsums
        per scan replace all per-target slicing/matvecs; the number of
        targets becomes free.

        With cube_dtype="int8" the einsums run as s8xs8->s32 dots
        against quantized templates (see _quantized_split_templates);
        mode="fused" computes the same int32 tables with the two-pass
        kernel (ops/pallas_i8_score) and shares everything after them.
        """
        scan = self.scan_arena
        int8 = self.cube_dtype == "int8"
        quant = self._quantized_split_templates() if int8 else None
        t_xz, t_yz, t_xy = self._split_templates()
        intercept = self.model.intercept
        calib = self.calibration
        min_proba = self.min_proba
        p = jax.lax.Precision.HIGHEST  # bandwidth-bound; precision is free
        raw_tables = self._raw_tables_fn(quant) if int8 else None

        idx_fn = jax.vmap(
            jax.vmap(
                lambda xyz: jnp.stack(
                    scan.clamped_matrix_indices(xyz[0], xyz[1], xyz[2])
                )
            )
        )

        def dequant(raw, plane_i):
            """(B, 2C, ·) int32 raw table → (B, C, ·) f32 table."""
            _, s1, s2, const = quant[plane_i]
            raw = raw.astype(jnp.float32)
            C = s1.shape[0]
            return (
                raw[:, :C] * s1[None, :, None]
                + raw[:, C:] * s2[None, :, None]
                + const[None, :, None]
            )

        def tables(cubes):
            """Per-plane (B, C, ·) lookup tables (None if masked)."""
            if not int8:
                # bf16/u8-ingested cubes widen here; XLA fuses the cast
                # into the reduction loops, so the stream is read once
                # per table at the narrow width.
                cubes = cubes.astype(jnp.float32)
                return [
                    None if t is None
                    else jnp.einsum(spec, t, cubes, precision=p)
                    for t, spec in zip(
                        (t_xz, t_yz, t_xy),
                        ("cxz,bxyz->bcy", "cyz,bxyz->bcx", "cxy,bxyz->bcz"),
                    )
                ]
            return [
                None if raw is None else dequant(raw, i)
                for i, raw in enumerate(raw_tables(cubes))
            ]

        @jax.jit
        def predict_batch(cubes, target_xyz, target_valid):
            B, T = target_xyz.shape[:2]
            M1, M2, M3 = tables(cubes)
            ijk = idx_fn(target_xyz)  # (B, T, 3) int32
            dec = jnp.broadcast_to(
                intercept[None, None, :], (B, T, intercept.shape[0])
            )
            # Table reads as one-hot contractions (exact at HIGHEST:
            # one nonzero term per sum).
            if M1 is not None:
                o = jax.nn.one_hot(
                    ijk[..., 1], M1.shape[2], dtype=jnp.float32
                )
                dec = dec + jnp.einsum("bcy,bty->btc", M1, o, precision=p)
            if M2 is not None:
                o = jax.nn.one_hot(
                    ijk[..., 0], M2.shape[2], dtype=jnp.float32
                )
                dec = dec + jnp.einsum("bcx,btx->btc", M2, o, precision=p)
            if M3 is not None:
                o = jax.nn.one_hot(
                    ijk[..., 2], M3.shape[2], dtype=jnp.float32
                )
                dec = dec + jnp.einsum("bcz,btz->btc", M3, o, precision=p)
            dec = dec.reshape(B * T, -1)
            if calib is not None:
                proba = calibrated_from_decision(dec, calib)
            else:
                proba = proba_from_decision(dec)
            proba = proba.reshape(B, T, -1)
            best = jnp.argmax(proba, axis=-1).astype(jnp.int32)
            best_p = jnp.max(proba, axis=-1)
            pred = jnp.where(best_p >= min_proba, best, UNKNOWN)
            pred = jnp.where(target_valid, pred, UNKNOWN)
            return pred, best_p, proba

        return predict_batch

    def _raw_tables_fn(self, quant) -> Callable:
        """cubes (B, X, Y, Z) int8 → per-plane (B, 2C, ·) int32 tables.

        mode="fast": three XLA einsums, each streaming the cube (the xy
        table contracts the flattened (X·Y) axis: an int8 dot over the
        unflattened pair lowers to a cuBLAS call the H100 refuses).
        mode="fused": the two-pass Pallas kernel, shard_map'ped over
        the mesh's 'data' axis when there is one. Masked planes give
        None.
        """
        X, Y, Z = self.scan_arena.grid_shape
        if self.mode != "fused":
            q = [None if e is None else e[0] for e in quant]
            i32 = jnp.int32

            def einsums(cubes):
                B = cubes.shape[0]
                return [
                    None if q[0] is None else jnp.einsum(
                        "cxz,bxyz->bcy", q[0], cubes,
                        preferred_element_type=i32),
                    None if q[1] is None else jnp.einsum(
                        "cyz,bxyz->bcx", q[1], cubes,
                        preferred_element_type=i32),
                    None if q[2] is None else jnp.einsum(
                        "ck,bkz->bcz", q[2].reshape(q[2].shape[0], -1),
                        cubes.reshape(B, X * Y, Z),
                        preferred_element_type=i32),
                ]

            return einsums

        from radarml_tpu.ops.pallas_i8_score import (
            build_table_weights,
            tables_i8,
        )

        weights = build_table_weights(quant, (X, Y, Z))
        interpret = self.interpret
        present = [e is not None for e in quant]

        def kernel(cubes):
            return tables_i8(cubes, weights, interpret=interpret)

        if self.mesh is not None:
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            kernel = shard_map(
                kernel, mesh=self.mesh, in_specs=P("data"),
                out_specs=P("data"),
                # pallas_call outputs carry no varying-mesh-axis info
                check_vma=False,
            )

        def fused(cubes):
            return [m if keep else None
                    for m, keep in zip(kernel(cubes), present)]

        return fused

    def _build(self) -> Callable:
        train, scan = self.train_arena, self.scan_arena
        zoom = predict_zoom(train, scan)
        mats = []
        for shape, z, keep in zip(
            (scan.xz_shape, scan.yz_shape, scan.xy_shape), zoom, self.proj_mask
        ):
            if not keep:
                mats.append(None)
                continue
            r, c, _ = spline_zoom_pair(tuple(shape), tuple(z))
            mats.append(
                (
                    jnp.asarray(r, dtype=jnp.float32),
                    jnp.asarray(c, dtype=jnp.float32),
                )
            )

        model, calib = self.model, self.calibration
        min_proba = self.min_proba
        is_svc = type(model).__name__ == "SVCModel"
        if is_svc:
            from radarml_tpu.models import svc as _svc
        p = jax.lax.Precision.HIGHEST
        # int8 wire format carries value-128; decode restores 0..255.
        shift = 128.0 if self.cube_dtype == "int8" else 0.0

        def per_target(cube, xyz):
            cube = cube.astype(jnp.float32) + shift
            i, j, k = scan.clamped_matrix_indices(xyz[0], xyz[1], xyz[2])
            yz = jax.lax.dynamic_index_in_dim(cube, i, axis=0, keepdims=False)
            xz = jax.lax.dynamic_index_in_dim(cube, j, axis=1, keepdims=False)
            xy = jax.lax.dynamic_index_in_dim(cube, k, axis=2, keepdims=False)
            parts = []
            for plane, mat in zip((xz, yz, xy), mats):
                if mat is None:
                    continue
                out = jnp.einsum("oh,hw->ow", mat[0], plane, precision=p)
                out = jnp.einsum("ow,pw->op", out, mat[1], precision=p)
                parts.append(out.reshape(-1))
            return jnp.concatenate(parts) / RADAR_MAX

        # vmap over targets within a scan, then over scans.
        feat_fn = jax.vmap(jax.vmap(per_target, in_axes=(None, 0)), in_axes=(0, 0))

        @jax.jit
        def predict_batch(cubes, target_xyz, target_valid):
            B, T = target_xyz.shape[:2]
            feats = feat_fn(cubes, target_xyz).reshape(B * T, -1)
            if is_svc:
                proba = _svc.predict_proba(model, feats)
            elif calib is not None:
                proba = predict_proba_calibrated(model, calib, feats)
            else:
                proba = predict_proba_log_loss(model, feats)
            proba = proba.reshape(B, T, -1)
            best = jnp.argmax(proba, axis=-1).astype(jnp.int32)
            best_p = jnp.max(proba, axis=-1)
            pred = jnp.where(best_p >= min_proba, best, UNKNOWN)
            pred = jnp.where(target_valid, pred, UNKNOWN)
            return pred, best_p, proba

        return predict_batch

    def _build_neural(self) -> Callable:
        """Serving path for NeuralClassifier models (CNN / SGAN c-head).

        Per target: slice the three projections, reproduce the training
        preprocessing exactly — scale [0, RADAR_MAX] → [-1, 1]
        (dnn.py:202-204), PIL-parity bicubic resize to the model's
        rescale (dnn.py:240-245 / data/preprocess.resize_views) — then
        run the network in inference mode and softmax the logits.
        """
        from radarml_tpu.ops.resample import bicubic_pair

        scan = self.scan_arena
        model: NeuralClassifier = self.model
        min_proba = self.min_proba
        half = RADAR_MAX / 2.0
        p = jax.lax.Precision.HIGHEST
        # int8 wire format carries value-128; decode restores 0..255.
        shift = 128.0 if self.cube_dtype == "int8" else 0.0
        mats = []
        for shape in (scan.xz_shape, scan.yz_shape, scan.xy_shape):
            r, c = bicubic_pair(tuple(shape), tuple(model.rescale))
            mats.append(
                (jnp.asarray(r, jnp.float32), jnp.asarray(c, jnp.float32))
            )

        def per_target(cube, xyz):
            cube = cube.astype(jnp.float32) + shift
            i, j, k = scan.clamped_matrix_indices(xyz[0], xyz[1], xyz[2])
            yz = jax.lax.dynamic_index_in_dim(cube, i, axis=0, keepdims=False)
            xz = jax.lax.dynamic_index_in_dim(cube, j, axis=1, keepdims=False)
            xy = jax.lax.dynamic_index_in_dim(cube, k, axis=2, keepdims=False)
            views = []
            for plane, (r, c) in zip((xz, yz, xy), mats):
                sym = (plane - half) / half
                out = jnp.einsum("oh,hw->ow", r, sym, precision=p)
                out = jnp.einsum("ow,pw->op", out, c, precision=p)
                views.append(out)
            return jnp.stack(views, axis=-1)  # (h, w, 3) in XZ,YZ,XY order

        feat_fn = jax.vmap(
            jax.vmap(per_target, in_axes=(None, 0)), in_axes=(0, 0)
        )

        @jax.jit
        def predict_batch(cubes, target_xyz, target_valid):
            B, T = target_xyz.shape[:2]
            views = feat_fn(cubes, target_xyz)
            views = views.reshape((B * T,) + tuple(model.rescale) + (3,))
            logits = model.apply(views)
            proba = jax.nn.softmax(logits, axis=-1).reshape(B, T, -1)
            best = jnp.argmax(proba, axis=-1).astype(jnp.int32)
            best_p = jnp.max(proba, axis=-1)
            pred = jnp.where(best_p >= min_proba, best, UNKNOWN)
            pred = jnp.where(target_valid, pred, UNKNOWN)
            return pred, best_p, proba

        return predict_batch

    def encode_host(self, cubes: np.ndarray) -> np.ndarray:
        """Narrow a canonical 0..255 host cube to the stream dtype.

        Serving loops call this at INGEST so every later stage —
        host-side stacking/batching, the process-internal memcpy, and
        the host→device transfer — moves 1 B/voxel (2 for bf16)
        instead of 4. __call__ accepts the result directly: uint8/int8
        arrays pass through its device encode untouched. Lossless for
        integer-valued radar data (reference predict.py:90-91);
        non-integer values truncate exactly like the device-side cast.
        """
        return encode_host_cubes(cubes, self.cube_dtype)

    def __call__(
        self,
        cubes: jax.Array,
        target_xyz: jax.Array,
        target_valid: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Classify targets in a batch of scans.

        Args:
            cubes: (B, size_x, size_y, size_z) raw scan cubes.
            target_xyz: (B, T, 3) target positions in cm (padded).
            target_valid: (B, T) bool mask of real targets.

        Returns:
            (pred, best_proba, proba): (B, T) int32 class index or
            UNKNOWN; (B, T) best probability; (B, T, C) full matrix.
        """
        if self.cube_dtype == "int8":
            if not (
                isinstance(cubes, jax.Array) and cubes.dtype == jnp.int8
            ):
                cubes = encode_int8_cubes(cubes)
        else:
            cubes = _dev_cast(cubes, jnp.dtype(self.cube_dtype))
        target_xyz = _dev_cast(target_xyz, jnp.float32)
        if target_valid is None:
            target_valid = jnp.ones(target_xyz.shape[:2], dtype=bool)
        if self.mesh is not None:
            from radarml_tpu.parallel.mesh import shard_batch

            cubes, target_xyz, target_valid = shard_batch(
                self.mesh, cubes, target_xyz, target_valid
            )
        return self._fn(cubes, target_xyz, target_valid)


def pad_targets(
    target_lists, max_targets: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-scan variable-length target lists into padded arrays.

    Host-side glue between a driver's target reports and the static
    shapes the jitted predictor requires.
    """
    B = len(target_lists)
    xyz = np.zeros((B, max_targets, 3), dtype=np.float32)
    valid = np.zeros((B, max_targets), dtype=bool)
    for b, targets in enumerate(target_lists):
        for t, tgt in enumerate(targets[:max_targets]):
            xyz[b, t] = (tgt[0], tgt[1], tgt[2])
            valid[b, t] = True
    return xyz, valid
