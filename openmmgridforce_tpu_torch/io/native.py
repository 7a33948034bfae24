"""ctypes binding to the native tile-streaming runtime.

The C++ library (``native/tilestream.cpp`` at the repository root) provides
the reference TileManager's role: random tile access over OMGTILE files, an
LRU cache with hit/miss/eviction counters, and clamped region assembly, the
host side of out-of-core grid evaluation.

The port builds its own copy with g++ into ``openmmgridforce_tpu_torch/
_build/`` at first use, and again when the source is newer than the
library; it never writes under ``native/``. The build goes to a temporary
name and is renamed into place, so processes that build at once (test
workers) each see a whole library. A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .omgtile import tile_range

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "tilestream.cpp"
LIBRARY = _PKG / "_build" / "libomgtilestream.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_LIB = None


def build() -> Path:
    """Compile the library if it is missing or older than its source."""
    if not SOURCE.exists():
        raise RuntimeError(f"native tile streamer source {SOURCE} not found")
    if (LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return LIBRARY
    LIBRARY.parent.mkdir(exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    out = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if out.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{out.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def load_library():
    """Load (building if needed) the native library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    lib.omg_open.restype = ctypes.c_void_p
    lib.omg_open.argtypes = [ctypes.c_char_p]
    lib.omg_close.argtypes = [ctypes.c_void_p]
    lib.omg_meta.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint32)]
    lib.omg_set_budget.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.omg_cache_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 4
    lib.omg_read_tile.restype = ctypes.c_int
    lib.omg_read_tile.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.omg_read_region.restype = ctypes.c_int
    lib.omg_read_region.argtypes = [
        ctypes.c_void_p] + [ctypes.c_int64] * 6 + [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    _LIB = lib
    return lib


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


@dataclass
class CacheStats:
    hits: int
    misses: int
    evictions: int
    used_bytes: int


class NativeTileStream:
    """Python face of the native streamer (TiledGridReader's API plus the
    LRU cache and region assembly)."""

    def __init__(self, path, budget_bytes: int = 2 << 30):
        self._lib = load_library()
        self._h = self._lib.omg_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open OMGTILE file {path}")
        self._lib.omg_set_budget(self._h, budget_bytes)

        counts = (ctypes.c_uint32 * 3)()
        spacing = (ctypes.c_double * 3)()
        origin = (ctypes.c_double * 3)()
        tile_size = ctypes.c_uint32()
        has_derivs = ctypes.c_int()
        inv_power = ctypes.c_double()
        mode = ctypes.c_uint32()
        self._lib.omg_meta(self._h, counts, spacing, origin,
                           ctypes.byref(tile_size),
                           ctypes.byref(has_derivs),
                           ctypes.byref(inv_power), ctypes.byref(mode))
        self.counts = tuple(counts)
        self.spacing = tuple(spacing)
        self.origin = tuple(origin)
        self.tile_size = tile_size.value
        self.has_derivatives = bool(has_derivs.value)
        self.inv_power = inv_power.value
        self.inv_power_mode = mode.value

    def read_tile(self, tx, ty, tz):
        x0, y0, z0, x1, y1, z1 = tile_range(self.counts, self.tile_size,
                                            tx, ty, tz)
        sx, sy, sz = x1 - x0, y1 - y0, z1 - z0
        vals = np.empty((sx, sy, sz), np.float32)
        derivs = (np.empty((27, sx, sy, sz), np.float32)
                  if self.has_derivatives else None)
        rc = self._lib.omg_read_tile(
            self._h, tx, ty, tz, _fptr(vals),
            _fptr(derivs) if derivs is not None else None)
        if rc != 0:
            raise IOError(f"tile read failed ({tx},{ty},{tz})")
        return vals, derivs

    def read_region(self, start, shape, with_derivatives=False):
        """Assemble a clamped [nx, ny, nz] region of grid points.

        Returns (values [nx,ny,nz], derivs [27,nx,ny,nz] or None)."""
        x0, y0, z0 = (int(v) for v in start)
        nx, ny, nz = (int(v) for v in shape)
        vals = np.empty((nx, ny, nz), np.float32)
        derivs = None
        dptr = None
        if with_derivatives and self.has_derivatives:
            derivs = np.empty((27, nx, ny, nz), np.float32)
            dptr = _fptr(derivs)
        rc = self._lib.omg_read_region(self._h, x0, y0, z0, nx, ny, nz,
                                       _fptr(vals), dptr)
        if rc != 0:
            raise IOError("region read failed")
        return vals, derivs

    def cache_stats(self) -> CacheStats:
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.omg_cache_stats(self._h, *[ctypes.byref(v) for v in vals])
        return CacheStats(*(v.value for v in vals))

    def close(self):
        if self._h:
            self._lib.omg_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
