"""Radar scan-arena geometry and coordinate transforms.

JAX re-design of the reference arena math (reference:
common.py:25-37 constants, common.py:93-121 transforms,
predict.py:74-76 grid-size derivation, common.py:45-80 derived
targets). Everything here is shape-static, vectorized, and traceable
under `jax.jit`; scalar Python paths exist only for host-side setup.

The arena is a spherical (r, theta, phi) grid scanned from the radar
origin. Radial distance R is along the +Z axis (cm); theta is measured
from the Z axis (deg); phi is the angle from X to the projection on the
XY plane (deg). The raw return-signal cube is indexed (i, j, k) =
(theta, phi, r), so the default 10-360/2 x ±42/4 x ±30/2 arena yields a
(22, 31, 176) cube — confirmed against the reference's committed run
logs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Min and max of radar return signal strengths (reference common.py:30-31).
RADAR_MIN = 0.0
RADAR_MAX = 255.0


class ProjMask(NamedTuple):
    """Which 2-D projections participate in the feature vector."""

    xz: bool = True
    yz: bool = True
    xy: bool = True


class ProjZoom(NamedTuple):
    """Per-projection (row, col) zoom factors."""

    xz: Tuple[float, float] = (1.0, 1.0)
    yz: Tuple[float, float] = (1.0, 1.0)
    xy: Tuple[float, float] = (1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Arena:
    """Spherical scan arena (units: cm for r, degrees for angles).

    (max - min) / res must be an integer for every axis, mirroring the
    radar hardware constraint noted in the reference (common.py:23).
    """

    r_min: float = 10.0
    r_max: float = 360.0
    r_res: float = 2.0
    theta_min: float = -42.0
    theta_max: float = 42.0
    theta_res: float = 4.0
    phi_min: float = -30.0
    phi_max: float = 30.0
    phi_res: float = 2.0

    def __post_init__(self):
        for lo, hi, res, name in (
            (self.r_min, self.r_max, self.r_res, "r"),
            (self.theta_min, self.theta_max, self.theta_res, "theta"),
            (self.phi_min, self.phi_max, self.phi_res, "phi"),
        ):
            span = hi - lo
            if span <= 0:
                raise ValueError(f"{name}: max must exceed min")
            if abs(span / res - round(span / res)) > 1e-9:
                raise ValueError(f"{name}: (max - min) / res must be integral")

    # -- grid sizes (reference predict.py:74-76) ---------------------------
    @property
    def size_x(self) -> int:
        """Theta axis length (cube axis 0)."""
        return int((self.theta_max - self.theta_min) / self.theta_res) + 1

    @property
    def size_y(self) -> int:
        """Phi axis length (cube axis 1)."""
        return int((self.phi_max - self.phi_min) / self.phi_res) + 1

    @property
    def size_z(self) -> int:
        """Range axis length (cube axis 2)."""
        return int((self.r_max - self.r_min) / self.r_res) + 1

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (self.size_x, self.size_y, self.size_z)

    # -- projection plane shapes -------------------------------------------
    @property
    def yz_shape(self) -> Tuple[int, int]:
        """Slice cube[i, :, :] → (phi, r)."""
        return (self.size_y, self.size_z)

    @property
    def xz_shape(self) -> Tuple[int, int]:
        """Slice cube[:, j, :] → (theta, r)."""
        return (self.size_x, self.size_z)

    @property
    def xy_shape(self) -> Tuple[int, int]:
        """Slice cube[:, :, k] → (theta, phi)."""
        return (self.size_x, self.size_y)

    @property
    def feature_length(self) -> int:
        """Flattened xz+yz+xy feature length (10010 for the default arena)."""
        return (
            self.size_x * self.size_z
            + self.size_y * self.size_z
            + self.size_x * self.size_y
        )

    # -- axis coordinate vectors (host-side, static) ------------------------
    def theta_axis(self) -> np.ndarray:
        return np.linspace(self.theta_min, self.theta_max, self.size_x)

    def phi_axis(self) -> np.ndarray:
        return np.linspace(self.phi_min, self.phi_max, self.size_y)

    def r_axis(self) -> np.ndarray:
        return np.linspace(self.r_min, self.r_max, self.size_z)

    # -- coordinate transforms (traceable) ----------------------------------
    def matrix_indices(self, x, y, z):
        """(x, y, z) cm → integer cube indices (i, j, k).

        Same mapping as the reference (common.py:106-121): spherical
        conversion followed by linear index scaling with truncation
        toward zero. Fully vectorized; works on scalars or arrays.
        """
        r, theta, phi = cartesian_to_spherical(x, y, z)
        i = (theta - self.theta_min) * (self.size_x - 1) / (
            self.theta_max - self.theta_min
        )
        j = (phi - self.phi_min) * (self.size_y - 1) / (self.phi_max - self.phi_min)
        k = (r - self.r_min) * (self.size_z - 1) / (self.r_max - self.r_min)
        # Nudge before truncation: targets that sit exactly on a grid
        # node (the common case for derived targets) land a few float32
        # ulps below the integer, which truncation would send to the
        # neighboring cell. 1e-3 index-units dwarfs f32 rounding error
        # (~1e-5 at index scale) while being far below any physically
        # meaningful sub-cell offset.
        eps = 1e-3
        trunc = lambda v: jnp.trunc(v + eps).astype(jnp.int32)
        return trunc(i), trunc(j), trunc(k)

    def clamped_matrix_indices(self, x, y, z):
        """Like :meth:`matrix_indices` but clamped into the cube.

        The jit-friendly variant used by the batched predict path, where
        a padded targets array may carry out-of-arena sentinels that must
        still produce in-range gather indices.
        """
        i, j, k = self.matrix_indices(x, y, z)
        return (
            jnp.clip(i, 0, self.size_x - 1),
            jnp.clip(j, 0, self.size_y - 1),
            jnp.clip(k, 0, self.size_z - 1),
        )

    def grid_to_cartesian(self, i, j, k):
        """Cube indices → (x, y, z) cm at the grid node centers.

        Inverse of the index mapping used when deriving targets from raw
        cubes (reference common.py:62-70).
        """
        theta = self.theta_min + i * (self.theta_max - self.theta_min) / (
            self.size_x - 1
        )
        phi = self.phi_min + j * (self.phi_max - self.phi_min) / (self.size_y - 1)
        r = self.r_min + k * (self.r_max - self.r_min) / (self.size_z - 1)
        return spherical_to_cartesian(r, theta, phi)

    def grid_to_cartesian_np(self, i, j, k):
        """Host-side numpy twin of :meth:`grid_to_cartesian`.

        Hot host loops (driver target reports at sensor rate) must not
        pay a device dispatch for scalar trig.
        """
        theta = self.theta_min + i * (self.theta_max - self.theta_min) / (
            self.size_x - 1
        )
        phi = self.phi_min + j * (self.phi_max - self.phi_min) / (self.size_y - 1)
        r = self.r_min + k * (self.r_max - self.r_min) / (self.size_z - 1)
        t, p = np.deg2rad(theta), np.deg2rad(phi)
        x = r * np.sin(t)
        y = r * np.cos(t) * np.sin(p)
        z = r * np.cos(t) * np.cos(p)
        return x, y, z


DEFAULT_ARENA = Arena()


def cartesian_to_spherical(x, y, z):
    """Cartesian cm → (r cm, theta deg, phi deg).

    Matches the reference convention (common.py:93-97): phi =
    atan2(y, z), theta = asin(x / r).
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    y = jnp.asarray(y, dtype=jnp.float32)
    z = jnp.asarray(z, dtype=jnp.float32)
    r = jnp.sqrt(x * x + y * y + z * z)
    phi = jnp.arctan2(y, z)
    theta = jnp.arcsin(jnp.where(r > 0, x / jnp.where(r > 0, r, 1.0), 0.0))
    return r, jnp.rad2deg(theta), jnp.rad2deg(phi)


def spherical_to_cartesian(r, theta, phi):
    """(r cm, theta deg, phi deg) → cartesian cm (common.py:99-104)."""
    r = jnp.asarray(r, dtype=jnp.float32)
    theta = jnp.deg2rad(jnp.asarray(theta, dtype=jnp.float32))
    phi = jnp.deg2rad(jnp.asarray(phi, dtype=jnp.float32))
    x = r * jnp.sin(theta)
    y = r * jnp.cos(theta) * jnp.sin(phi)
    z = r * jnp.cos(theta) * jnp.cos(phi)
    return x, y, z


def derive_targets(
    cube: jax.Array, arena: Arena, num_targets: int = 1
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Derive the strongest targets from a raw scan cube, on device.

    Software replacement for the radar SDK's target extraction, in the
    spirit of the reference's DerivedTarget path (common.py:45-80): sum
    the cube down to per-axis profiles, take the top-`num_targets`
    indices per axis, and map grid nodes back to cartesian coordinates.

    Args:
        cube: (size_x, size_y, size_z) float array.
        arena: scan arena describing the cube geometry.
        num_targets: number of targets to emit (static).

    Returns:
        (x, y, z, amplitude) arrays of shape (num_targets,), weakest to
        strongest, matching the reference's argsort ordering.
    """
    theta_profile = cube.sum(axis=(1, 2))
    phi_profile = cube.sum(axis=(0, 2))
    r_profile = cube.sum(axis=(0, 1))

    def top(profile):
        vals, idx = jax.lax.top_k(profile, num_targets)
        # top_k is descending; the reference emits ascending-by-strength.
        return idx[::-1], vals[::-1]

    i, amp = top(theta_profile)
    j, _ = top(phi_profile)
    k, _ = top(r_profile)
    x, y, z = arena.grid_to_cartesian(
        i.astype(jnp.float32), j.astype(jnp.float32), k.astype(jnp.float32)
    )
    return x, y, z, amp


def slice_projections(
    cube: jax.Array, i, j, k
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Slice the three 2-D projections of a target out of a scan cube.

    Matches the reference slicing (predict.py:103-107): yz = cube[i],
    xz = cube[:, j], xy = cube[..., k]. Uses dynamic indexing so a
    traced (i, j, k) from :meth:`Arena.clamped_matrix_indices` works
    under jit with static output shapes.

    Returns:
        (xz, yz, xy) with shapes (size_x, size_z), (size_y, size_z),
        (size_x, size_y).
    """
    yz = jax.lax.dynamic_index_in_dim(cube, i, axis=0, keepdims=False)
    xz = jax.lax.dynamic_index_in_dim(cube, j, axis=1, keepdims=False)
    xy = jax.lax.dynamic_index_in_dim(cube, k, axis=2, keepdims=False)
    return xz, yz, xy
