"""OMGTILE v1 tiled grid format, byte-compatible with the reference and with
the JAX package's writer and reader (a file either writes, the other reads
bit for bit).

Layout (reference openmmapi/include/TiledGridData.h:6-46 and
openmmapi/src/TiledGridData.cpp:102-260):

  [64-byte header] [grid metadata] [tile 0] ... [tile N-1] [tile index]

  header:   magic "OMGTILE\\0" (8), u32 version (1), u32 headerSize (64),
            u32 flags (bit0 = HAS_DERIVATIVES), u32 tileSize, 40 reserved
  metadata: u32 counts[3], f64 spacing[3], f64 origin[3], f64 invPower,
            u32 invPowerMode, u32 numTiles, i64 tileIndexOffset (@140)
  tile:     u16 dims[3] (actual size; boundary tiles are smaller), f32
            values [sx*sy*sz] (z-fastest), f32 derivs [27 * points] if flag
  index:    per tile (linear order tx*nty*ntz + ty*ntz + tz):
            i32 tx, ty, tz, i64 fileOffset, i64 dataSize
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np
import torch

MAGIC = b"OMGTILE\x00"
VERSION = 1
HEADER_SIZE = 64
FLAG_HAS_DERIVATIVES = 0x01
TILE_INDEX_OFFSET_POS = 140


def num_tiles(counts, tile_size):
    return tuple(-(-int(c) // tile_size) for c in counts)


def tile_range(counts, tile_size, tx, ty, tz):
    """(x0, y0, z0, x1, y1, z1) grid-point range of a tile (exclusive end)."""
    x0, y0, z0 = tx * tile_size, ty * tile_size, tz * tile_size
    return (x0, y0, z0,
            min(x0 + tile_size, counts[0]),
            min(y0 + tile_size, counts[1]),
            min(z0 + tile_size, counts[2]))


class TiledGridWriter:
    """Streaming writer: tiles can be written in any order."""

    def __init__(self, path, counts, spacing, origin, tile_size=32,
                 has_derivatives=False, inv_power=0.0, inv_power_mode=0):
        self.counts = tuple(int(c) for c in counts)
        self.spacing = tuple(float(s) for s in spacing)
        self.origin = tuple(float(o) for o in origin)
        self.tile_size = int(tile_size)
        self.has_derivatives = has_derivatives
        self.inv_power = float(inv_power)
        self.inv_power_mode = int(inv_power_mode)
        self.ntx, self.nty, self.ntz = num_tiles(self.counts, self.tile_size)
        n = self.ntx * self.nty * self.ntz
        self._index = [(0, 0, 0, 0, 0)] * n
        self._fh = open(path, "wb")
        self._write_header(0)

    def _write_header(self, tile_index_offset):
        h = bytearray(HEADER_SIZE)
        flags = FLAG_HAS_DERIVATIVES if self.has_derivatives else 0
        struct.pack_into("<8sIIII", h, 0, MAGIC, VERSION, HEADER_SIZE, flags,
                         self.tile_size)
        self._fh.write(h)
        meta = struct.pack("<III", *self.counts)
        meta += struct.pack("<ddd", *self.spacing)
        meta += struct.pack("<ddd", *self.origin)
        meta += struct.pack("<dII", self.inv_power, self.inv_power_mode,
                            self.ntx * self.nty * self.ntz)
        meta += struct.pack("<q", tile_index_offset)
        self._fh.write(meta)

    def write_tile(self, tx, ty, tz, values, derivatives=None):
        """values: [sx, sy, sz] or flat (z fastest); derivatives:
        [27 * points] or [27, sx, sy, sz]."""
        x0, y0, z0, x1, y1, z1 = tile_range(self.counts, self.tile_size,
                                            tx, ty, tz)
        sx, sy, sz = x1 - x0, y1 - y0, z1 - z0
        pts = sx * sy * sz
        values = np.asarray(values, dtype=np.float32).reshape(pts)
        offset = self._fh.tell()
        self._fh.write(struct.pack("<HHH", sx, sy, sz))
        self._fh.write(values.tobytes())
        if self.has_derivatives:
            if derivatives is None:
                raise ValueError("file declares derivatives but none given")
            d = np.asarray(derivatives, dtype=np.float32).reshape(27 * pts)
            self._fh.write(d.tobytes())
        size = self._fh.tell() - offset
        li = (tx * self.nty + ty) * self.ntz + tz
        self._index[li] = (tx, ty, tz, offset, size)

    def close(self):
        index_offset = self._fh.tell()
        for (tx, ty, tz, off, size) in self._index:
            self._fh.write(struct.pack("<iiiqq", tx, ty, tz, off, size))
        self._fh.seek(TILE_INDEX_OFFSET_POS)
        self._fh.write(struct.pack("<q", index_offset))
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class TiledGridReader:
    path: str
    counts: tuple = field(init=False)
    spacing: tuple = field(init=False)
    origin: tuple = field(init=False)
    tile_size: int = field(init=False)
    has_derivatives: bool = field(init=False)
    inv_power: float = field(init=False)
    inv_power_mode: int = field(init=False)

    def __post_init__(self):
        self._fh = open(self.path, "rb")
        h = self._fh.read(HEADER_SIZE)
        magic, version, header_size, flags, tile_size = struct.unpack_from(
            "<8sIIII", h, 0)
        if magic != MAGIC:
            raise ValueError(f"{self.path}: not an OMGTILE file")
        if version != VERSION:
            raise ValueError(f"{self.path}: unsupported version {version}")
        self.tile_size = tile_size
        self.has_derivatives = bool(flags & FLAG_HAS_DERIVATIVES)
        meta = self._fh.read(12 + 24 + 24 + 8 + 4 + 4 + 8)
        cx, cy, cz = struct.unpack_from("<III", meta, 0)
        self.counts = (cx, cy, cz)
        self.spacing = struct.unpack_from("<ddd", meta, 12)
        self.origin = struct.unpack_from("<ddd", meta, 36)
        (self.inv_power,) = struct.unpack_from("<d", meta, 60)
        mode, n_tiles = struct.unpack_from("<II", meta, 68)
        self.inv_power_mode = mode
        (index_offset,) = struct.unpack_from("<q", meta, 76)
        self.ntx, self.nty, self.ntz = num_tiles(self.counts, self.tile_size)
        if n_tiles != self.ntx * self.nty * self.ntz:
            raise ValueError(f"{self.path}: tile count mismatch")
        self._fh.seek(index_offset)
        self._index = {}
        for _ in range(n_tiles):
            tx, ty, tz, off, size = struct.unpack(
                "<iiiqq", self._fh.read(28))
            self._index[(tx, ty, tz)] = (off, size)

    def read_tile(self, tx, ty, tz):
        """Returns (values [sx,sy,sz] f32, derivs [27,sx,sy,sz] f32 or
        None)."""
        off, _size = self._index[(tx, ty, tz)]
        self._fh.seek(off)
        sx, sy, sz = struct.unpack("<HHH", self._fh.read(6))
        pts = sx * sy * sz
        vals = np.frombuffer(self._fh.read(4 * pts),
                             np.float32).reshape(sx, sy, sz)
        derivs = None
        if self.has_derivatives:
            derivs = np.frombuffer(self._fh.read(4 * 27 * pts),
                                   np.float32).reshape(27, sx, sy, sz)
        return vals, derivs

    def read_full(self):
        """Assemble the full grid (for grids that fit in host memory).
        Returns (values [nx,ny,nz], derivs [27,nx,ny,nz] or None)."""
        nx, ny, nz = self.counts
        vals = np.zeros((nx, ny, nz), np.float32)
        derivs = (np.zeros((27, nx, ny, nz), np.float32)
                  if self.has_derivatives else None)
        for tx in range(self.ntx):
            for ty in range(self.nty):
                for tz in range(self.ntz):
                    x0, y0, z0, x1, y1, z1 = tile_range(
                        self.counts, self.tile_size, tx, ty, tz)
                    v, d = self.read_tile(tx, ty, tz)
                    vals[x0:x1, y0:y1, z0:z1] = v
                    if derivs is not None:
                        derivs[:, x0:x1, y0:y1, z0:z1] = d
        return vals, derivs

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_grid_tiled(path, grid, tile_size: int = 32):
    """Save an in-memory :class:`Grid` (tensors on any device) as an
    OMGTILE file, the analogue of the reference's TiledGridData save path
    (openmmapi/src/TiledGridData.cpp:102-161), so a generated-or-loaded
    grid can later be streamed out-of-core without regeneration."""
    vals = grid.vals.detach().to("cpu", dtype=torch.float32).numpy()
    derivs = None
    if grid.derivs is not None:
        derivs = np.moveaxis(
            grid.derivs.detach().to("cpu", dtype=torch.float32).numpy(),
            -1, 0)
    counts = vals.shape
    with TiledGridWriter(
            path, counts,
            tuple(float(s) for s in grid.spacing.tolist()),
            tuple(float(o) for o in grid.origin.tolist()),
            tile_size=tile_size, has_derivatives=derivs is not None,
            inv_power=float(grid.inv_power),
            inv_power_mode=int(grid.inv_power_mode)) as w:
        for tx in range(w.ntx):
            for ty in range(w.nty):
                for tz in range(w.ntz):
                    x0, y0, z0, x1, y1, z1 = tile_range(
                        counts, tile_size, tx, ty, tz)
                    d = (None if derivs is None
                         else derivs[:, x0:x1, y0:y1, z0:z1])
                    w.write_tile(tx, ty, tz, vals[x0:x1, y0:y1, z0:z1], d)

