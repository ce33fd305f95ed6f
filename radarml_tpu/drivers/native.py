"""ctypes bindings for the native C++ scan source + driver adapter.

Builds csrc/radar_source.cc on first use (g++ -O3 -shared; the image
ships no pybind11, so the boundary is a C ABI + ctypes as the
environment prescribes), caches the .so next to the source, and adapts
the ring-buffer stream to the RadarDriver session protocol.

The native source produces scans on its own thread at sensor cadence
(newest-wins when the consumer lags, as real hardware does), which
makes it the ingest half of the throughput benchmark: the GPU consumes
batches while C++ fills the next ones.
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from radarml_tpu.core.arena import Arena, DEFAULT_ARENA
from radarml_tpu.drivers.base import RadarDriver, RadarTarget

logger = logging.getLogger(__name__)

__all__ = ["NativeScanSource", "NativeRadar", "native_available", "build_library"]

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
_SO_PATH = os.path.join(_CSRC, "libradar_source.so")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def build_library(force: bool = False) -> str:
    """Compile the shared library if missing/stale; returns its path."""
    src = os.path.join(_CSRC, "radar_source.cc")
    with _LOCK:
        if (
            not force
            and os.path.exists(_SO_PATH)
            and os.path.getmtime(_SO_PATH) >= os.path.getmtime(src)
        ):
            return _SO_PATH
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC",
            "-std=c++17", "-pthread", src, "-o", _SO_PATH,
        ]
        logger.info("building native scan source: %s", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=True)
    return _SO_PATH


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build_library()
    lib = ctypes.CDLL(path)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.rs_create.restype = ctypes.c_void_p
    lib.rs_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_double, ctypes.c_int,
    ]
    lib.rs_load_pool.argtypes = [
        ctypes.c_void_p, f32p, f32p, i32p, ctypes.c_int
    ]
    lib.rs_start.argtypes = [ctypes.c_void_p]
    lib.rs_stop.argtypes = [ctypes.c_void_p]
    lib.rs_next.restype = ctypes.c_int
    lib.rs_next.argtypes = [
        ctypes.c_void_p, f32p, f32p, ctypes.c_int, i32p, u64p, ctypes.c_int
    ]
    lib.rs_produced.restype = ctypes.c_uint64
    lib.rs_produced.argtypes = [ctypes.c_void_p]
    lib.rs_dropped.restype = ctypes.c_uint64
    lib.rs_dropped.argtypes = [ctypes.c_void_p]
    lib.rs_destroy.argtypes = [ctypes.c_void_p]
    lib.rs_max_targets.restype = ctypes.c_int
    _LIB = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception as e:  # toolchain missing etc.
        logger.warning("native scan source unavailable: %s", e)
        return False


class NativeScanSource:
    """Thin RAII wrapper over the C++ ring-buffer producer."""

    def __init__(
        self,
        arena: Arena = DEFAULT_ARENA,
        capacity: int = 8,
        seed: int = 1234,
        scan_period_us: float = 0.0,
        mode: str = "synthetic",
    ):
        self._lib = _load()
        self.arena = arena
        self.max_targets = int(self._lib.rs_max_targets())
        self._h = self._lib.rs_create(
            arena.size_x, arena.size_y, arena.size_z,
            capacity, seed, scan_period_us,
            0 if mode == "synthetic" else 1,
        )
        self._cube = np.empty(arena.grid_shape, np.float32)
        self._targets = np.empty((self.max_targets, 4), np.float32)
        self._started = False
        # Serializes next()/close(): destroying the C++ object while a
        # consumer thread is blocked inside rs_next is undefined
        # behavior (condvar torn down under a waiter).
        self._use_lock = threading.Lock()

    def load_pool(
        self, cubes: np.ndarray, targets_ijka: Sequence[np.ndarray]
    ) -> None:
        """Provide replay cubes (N, X, Y, Z) + per-scan (t, 4) target
        rows of (i, j, k, amplitude)."""
        n = cubes.shape[0]
        cubes = np.ascontiguousarray(cubes, np.float32)
        tbuf = np.zeros((n, self.max_targets, 4), np.float32)
        counts = np.zeros(n, np.int32)
        for s, rows in enumerate(targets_ijka):
            rows = np.asarray(rows, np.float32).reshape(-1, 4)
            c = min(len(rows), self.max_targets)
            tbuf[s, :c] = rows[:c]
            counts[s] = c
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int)
        self._lib.rs_load_pool(
            self._h,
            cubes.ctypes.data_as(f32p),
            tbuf.ctypes.data_as(f32p),
            counts.ctypes.data_as(i32p),
            n,
        )

    def start(self):
        self._lib.rs_start(self._h)
        self._started = True

    def stop(self):
        if self._started:
            self._lib.rs_stop(self._h)
            self._started = False

    def next(
        self, timeout_s: float = 1.0
    ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
        """Pop one scan: (cube copy, (n,4) target rows, seq) or None."""
        f32p = ctypes.POINTER(ctypes.c_float)
        n = ctypes.c_int(0)
        seq = ctypes.c_uint64(0)
        with self._use_lock:
            if self._h is None:
                return None
            rc = self._lib.rs_next(
                self._h,
                self._cube.ctypes.data_as(f32p),
                self._targets.ctypes.data_as(f32p),
                self.max_targets,
                ctypes.byref(n),
                ctypes.byref(seq),
                int(timeout_s * 1e6),
            )
            if rc != 1:
                return None
            return (
                self._cube.copy(),
                self._targets[: n.value].copy(),
                int(seq.value),
            )

    @property
    def produced(self) -> int:
        return int(self._lib.rs_produced(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.rs_dropped(self._h))

    def close(self):
        if self._h:
            self.stop()
            with self._use_lock:
                if self._h:
                    self._lib.rs_destroy(self._h)
                    self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


@dataclasses.dataclass
class NativeRadar(RadarDriver):
    """RadarDriver over the native source: Trigger pops the next scan."""

    seed: int = 1234
    capacity: int = 8
    scan_period_us: float = 0.0
    mode: str = "synthetic"
    timeout_s: float = 2.0

    def __post_init__(self):
        self._src: Optional[NativeScanSource] = None
        self._cube: Optional[np.ndarray] = None
        self._targets: List[RadarTarget] = []

    def _do_connect(self):
        _load()  # fail here, at connect time, if the toolchain is broken

    def _do_configure(self):
        if self._src is not None:
            self._src.close()
        self._src = NativeScanSource(
            arena=self.arena,
            capacity=self.capacity,
            seed=self.seed,
            scan_period_us=self.scan_period_us,
            mode=self.mode,
        )

    def _do_start(self):
        self._src.start()

    def _do_trigger(self):
        out = self._src.next(self.timeout_s)
        if out is None:
            raise TimeoutError("native scan source produced no scan")
        cube, rows, _ = out
        self._cube = cube
        self._targets = []
        for i, j, k, amp in rows:
            x, y, z = self.arena.grid_to_cartesian_np(float(i), float(j), float(k))
            self._targets.append(
                RadarTarget(float(x), float(y), float(z), float(amp))
            )

    def _do_get_raw_image(self) -> np.ndarray:
        if self._cube is None:
            raise RuntimeError("trigger() first")
        return self._cube

    def _do_get_sensor_targets(self) -> List[RadarTarget]:
        return list(self._targets)

    def _do_stop(self):
        if self._src:
            self._src.stop()

    def _do_disconnect(self):
        if self._src:
            self._src.close()
            self._src = None
