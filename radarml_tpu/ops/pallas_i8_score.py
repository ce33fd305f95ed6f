"""Two-pass int8 Pallas kernel (Triton route) for the folded scoring tables.

The folded predict path (models/pipeline.py `_build_folded`) scores a
target by three table lookups after contracting the whole cube against
each per-plane class template:

    M1[c, y] = Σ_xz Q_xz[c, x, z] · cube[x, y, z]
    M2[c, x] = Σ_yz Q_yz[c, y, z] · cube[x, y, z]
    M3[c, z] = Σ_xy Q_xy[c, x, y] · cube[x, y, z]

and a target at cell (i, j, k) reads M1[c, j] + M2[c, i] + M3[c, k]. It
replaces the per-target loop of the reference
(/root/reference/predict.py:72-131). The plain XLA form
(`mode="fast"`, `cube_dtype="int8"`) is three s8×s8→s32 einsums with
different free axes. This kernel computes all three tables in one
program per scan, reading the scan twice: pass 2 re-reads it right after
pass 1. Whether that re-read hits L2 or goes back to device memory is
not measured (PERF.md, open questions).

Design (one program per scan, natural (B, X, Y, Z) layout, no repack):

  * Pass 1 walks z in chunks of `_Z_CHUNK` (outer) and x (inner),
    loading one (Yp, Zc) int8 tile cube[b, x, :, z0:z0+Zc] per step,
    masked at Y and Z (Yp and Zc are powers of two, as Triton wants):
    M1 += Q_xz[x, :, zc] @ tileᵀ and M3[:, zc] += Q_xy[x] @ tile.
  * Pass 2 is M2 = Q_yz @ cube[b]ᵀ over the scan's flat (X, Y·Z) rows,
    in `_K_CHUNK` slices. No tile of pass 1 serves M2 as a dot (it is
    that tile's full contraction), so the scan is read a second time.
  * Every dot is int8 × int8 → int32 with C2 padded to 16 rows (the
    smallest operand Triton's dot takes), so the arithmetic is exact.

The tile widths and CompilerParams were tuned on an H100 (PERF.md);
processing several scans per program to share weight tiles did not
help there.

Templates are the error-compensated int8 pairs of
models/pipeline._quantized_split_templates (hi + lo rows, C2 = 2C);
dequantisation, lookup and calibration stay in XLA and are shared with
`mode="fast"`, so decisions are identical to fast+int8 by construction.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["TableWeights", "build_table_weights", "tables_i8"]

_MIN_DOT = 16  # Triton's dot wants every operand dim >= 16
# Tuned on an H100 at the reference arena, batch 4096 (PERF.md).
_Z_CHUNK = 128  # pass 1 tile width along z (a power of two)
_K_CHUNK = 512  # pass 2 tile width along the flat Y·Z axis
_NUM_WARPS = 2
_NUM_STAGES = 2


def _pow2(n: int, floor: int = 1) -> int:
    return max(floor, pl.next_power_of_2(int(n)))


class TableWeights(NamedTuple):
    """Device operands of the kernel, zero-padded to power-of-two tiles."""

    w1: jax.Array  # (X, C2p, Zp) int8 — Q_xz[c, x, z] by x
    w2: jax.Array  # (C2p, Kp) int8 — Q_yz[c, y·Z + z], K = Y·Z padded
    w3: jax.Array  # (X, C2p, Yp) int8 — Q_xy[c, x, y] by x
    dims: Tuple[int, int, int, int]  # (X, Y, Z, C2)


def build_table_weights(
    quant: Sequence[Optional[tuple]],
    dims: Tuple[int, int, int],
) -> TableWeights:
    """Lay out the per-plane int8 templates for the kernel.

    quant: the three per-plane entries (xz, yz, xy) of
    models/pipeline.RadarPredictor._quantized_split_templates —
    (q (C2, ·, ·) int8, s1, s2, const), or None for a masked plane,
    whose weights stay zero so its table is zero.
    dims: (X, Y, Z) of the scan arena grid.
    """
    X, Y, Z = dims
    present = [np.asarray(q[0]) for q in quant if q is not None]
    if not present:
        raise ValueError("at least one plane must be present")
    C2 = present[0].shape[0]
    C2p = _pow2(C2, _MIN_DOT)
    Yp = _pow2(Y, _MIN_DOT)
    Zp = -(-Z // _Z_CHUNK) * _Z_CHUNK
    Kp = -(-(Y * Z) // _K_CHUNK) * _K_CHUNK
    w1 = np.zeros((X, C2p, Zp), np.int8)
    w2 = np.zeros((C2p, Kp), np.int8)
    w3 = np.zeros((X, C2p, Yp), np.int8)
    if quant[0] is not None:  # xz: (C2, X, Z)
        w1[:, :C2, :Z] = np.transpose(np.asarray(quant[0][0]), (1, 0, 2))
    if quant[1] is not None:  # yz: (C2, Y, Z), flattened like the cube
        w2[:C2, : Y * Z] = np.asarray(quant[1][0]).reshape(C2, Y * Z)
    if quant[2] is not None:  # xy: (C2, X, Y)
        w3[:, :C2, :Y] = np.transpose(np.asarray(quant[2][0]), (1, 0, 2))
    return TableWeights(
        w1=jnp.asarray(w1), w2=jnp.asarray(w2), w3=jnp.asarray(w3),
        dims=(X, Y, Z, C2),
    )


def _tables_kernel(
    cube_ref, flat_ref, w1_ref, w2_ref, w3_ref, m1_ref, m2_ref, m3_ref,
    *, X, Y, Z, Yp, Xp, Zc, nz, Kc, nk, C2r,
):
    b = pl.program_id(0)
    C2p = w1_ref.shape[1]

    def rows(acc):  # the C2r live rows of a (C2p, ·) dot result
        return acc if C2r == C2p else jnp.split(acc, C2p // C2r)[0]

    # Pass 1 — M1 and M3 from (Yp, Zc) tiles cube[b, x, :, zc].
    y_ok = jnp.arange(Yp) < Y

    def z_step(zi, m1):
        z0 = zi * Zc
        mask = y_ok[:, None] & ((z0 + jnp.arange(Zc)) < Z)[None, :]

        def x_step(x, carry):
            m1, m3 = carry
            tile = plgpu.load(
                cube_ref.at[b, x, pl.ds(0, Yp), pl.ds(z0, Zc)],
                mask=mask, other=0,
            )
            m1 = m1 + pl.dot(w1_ref[x, :, pl.ds(z0, Zc)], tile, trans_b=True)
            m3 = m3 + pl.dot(w3_ref[x], tile)
            return m1, m3

        m3 = jnp.zeros((C2p, Zc), jnp.int32)
        m1, m3 = jax.lax.fori_loop(0, X, x_step, (m1, m3))
        m3_ref[b, :, pl.ds(z0, Zc)] = rows(m3)
        return m1

    m1 = jax.lax.fori_loop(0, nz, z_step, jnp.zeros((C2p, Yp), jnp.int32))
    m1_ref[b] = rows(m1)

    # Pass 2 — M2 as one GEMM over the scan's flat (X, Y·Z) rows,
    # reading the scan a second time.
    x_ok = (jnp.arange(Xp) < X)[:, None]

    def k_step(ki, m2):
        k0 = ki * Kc
        mask = x_ok & ((k0 + jnp.arange(Kc)) < Y * Z)[None, :]
        tile = plgpu.load(
            flat_ref.at[b, pl.ds(0, Xp), pl.ds(k0, Kc)], mask=mask, other=0
        )
        return m2 + pl.dot(w2_ref[:, pl.ds(k0, Kc)], tile, trans_b=True)

    m2 = jax.lax.fori_loop(0, nk, k_step, jnp.zeros((C2p, Xp), jnp.int32))
    m2_ref[b] = rows(m2)


def tables_i8(
    cubes: jax.Array,
    weights: TableWeights,
    *,
    interpret: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(B, X, Y, Z) int8 cubes (value-128) → int32 tables.

    Returns (m1 (B, C2, Y), m2 (B, C2, X), m3 (B, C2, Z)) — the same
    orientation as the einsums "cxz,bxyz->bcy", "cyz,bxyz->bcx" and
    "cxy,bxyz->bcz" of the fast int8 path, and equal to them exactly.
    `interpret=True` runs the kernel in the Pallas interpreter (CPU
    tests); otherwise it compiles through Triton for the GPU.
    """
    X, Y, Z, C2 = weights.dims
    if cubes.dtype != jnp.int8 or cubes.shape[1:] != (X, Y, Z):
        raise ValueError(
            f"expected (B, {X}, {Y}, {Z}) int8 cubes, got "
            f"{cubes.shape} {cubes.dtype}"
        )
    B = cubes.shape[0]
    C2p, Zp = weights.w1.shape[1:]
    C2r = _pow2(C2)
    Yp = weights.w3.shape[2]
    Xp = _pow2(X, _MIN_DOT)
    Zc, Kc = _Z_CHUNK, _K_CHUNK
    kernel = functools.partial(
        _tables_kernel, X=X, Y=Y, Z=Z, Yp=Yp, Xp=Xp, Zc=Zc, nz=Zp // Zc,
        Kc=Kc, nk=weights.w2.shape[1] // Kc, C2r=C2r,
    )
    m1, m2, m3 = pl.pallas_call(
        kernel,
        grid=(B,),
        out_shape=(
            jax.ShapeDtypeStruct((B, C2r, Yp), jnp.int32),
            jax.ShapeDtypeStruct((B, C2r, Xp), jnp.int32),
            jax.ShapeDtypeStruct((B, C2r, Zp), jnp.int32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        interpret=interpret,
        name="radar_i8_tables",
    )(cubes, cubes.reshape(B, X, Y * Z), weights.w1, weights.w2, weights.w3)
    return m1[:, :C2, :Y], m2[:, :C2, :X], m3[:, :C2, :Z]
