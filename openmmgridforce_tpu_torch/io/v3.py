"""V3 binary grid file format ("OMGRID"), byte-compatible with the reference.

Layout (reference openmmapi/src/GridForce.cpp:694-799, load at :495-692):

  offset  size  field
  0       8     magic "OMGRID\\0\\0"
  8       4     u32 version (3)
  12      4     u32 header_size (128)
  16      12    i32 nx, ny, nz
  28      4     u32 deriv_count (0 or 27)
  32      24    f64 dx, dy, dz
  56      8     u64 data_offset (128)
  64      24    f64 origin x, y, z
  88      4     u32 grid_type_code (0 none, 1 charge, 2 ljr, 3 lja)
  92      4     u32 flags (0)
  96      8     f64 inv_power
  104     4     u32 inv_power_mode
  108     20    reserved (zeros)
  128     ...   f64 data: [27, nx, ny, nz] when deriv_count > 0, else
                [nx*ny*nz] values. Older files may append a legacy block
                (i32 numScalingFactors + f64s + f64 origin[3]) and an
                optional "DERIVS" trailer (6-byte tag + u16 big-endian
                count + f64 data) — the loader tolerates both.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

MAGIC = b"OMGRID\x00\x00"
VERSION = 3
HEADER_SIZE = 128

GRID_TYPE_TO_CODE = {"": 0, "charge": 1, "ljr": 2, "lja": 3}
CODE_TO_GRID_TYPE = {v: k for k, v in GRID_TYPE_TO_CODE.items()}


@dataclass
class GridFileData:
    counts: tuple
    spacing: tuple
    origin: tuple
    vals: np.ndarray                 # [nx, ny, nz] float64
    derivs: Optional[np.ndarray]     # [27, nx, ny, nz] float64 or None
    grid_type: str = ""
    inv_power: float = 0.0
    inv_power_mode: int = 0


def save_v3(path, counts, spacing, origin, vals, derivs=None, grid_type="",
            inv_power=0.0, inv_power_mode=0):
    """Write a V3 grid file. ``vals``: [nx,ny,nz] or flat; ``derivs``:
    [27,nx,ny,nz] (written instead of values when present, matching the
    reference)."""
    nx, ny, nz = (int(c) for c in counts)
    n = nx * ny * nz
    vals = np.asarray(vals, dtype=np.float64).reshape(n)
    header = bytearray(HEADER_SIZE)
    struct.pack_into("<8sII", header, 0, MAGIC, VERSION, HEADER_SIZE)
    struct.pack_into("<iiiI", header, 16, nx, ny, nz,
                     27 if derivs is not None else 0)
    struct.pack_into("<dddQ", header, 32, float(spacing[0]),
                     float(spacing[1]), float(spacing[2]), HEADER_SIZE)
    struct.pack_into("<dddII", header, 64, float(origin[0]),
                     float(origin[1]), float(origin[2]),
                     GRID_TYPE_TO_CODE.get(grid_type, 0), 0)
    struct.pack_into("<dI", header, 96, float(inv_power),
                     int(inv_power_mode))
    with open(path, "wb") as fh:
        fh.write(header)
        if derivs is not None:
            d = np.asarray(derivs, dtype=np.float64).reshape(27 * n)
            fh.write(d.tobytes())
        else:
            fh.write(vals.tobytes())


def save_v3_griddata(path, counts, spacing, origin, vals, derivs=None,
                     inv_power=0.0, inv_power_mode=0):
    """Write the GridData container's V3 variant (reference
    openmmapi/src/GridData.cpp:180-265): header with deriv_count=0 and
    grid_type=0, VALUES (never the [27,...] block), a legacy
    compatibility block (i32 numScalingFactors=0 + origin f64 x3), and —
    when derivatives are present — a ``DERIVS`` trailer
    (8 bytes {'D','E','R','I','V','S',0,27} + 27*n f64)."""
    nx, ny, nz = (int(c) for c in counts)
    n = nx * ny * nz
    vals = np.asarray(vals, dtype=np.float64).reshape(n)
    header = bytearray(HEADER_SIZE)
    struct.pack_into("<8sII", header, 0, MAGIC, VERSION, HEADER_SIZE)
    struct.pack_into("<iiiI", header, 16, nx, ny, nz, 0)
    struct.pack_into("<dddQ", header, 32, float(spacing[0]),
                     float(spacing[1]), float(spacing[2]), HEADER_SIZE)
    struct.pack_into("<dddII", header, 64, float(origin[0]),
                     float(origin[1]), float(origin[2]), 0, 0)
    struct.pack_into("<dI", header, 96, float(inv_power),
                     int(inv_power_mode))
    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(vals.tobytes())
        fh.write(struct.pack("<i", 0))                    # scaling count
        fh.write(struct.pack("<ddd", float(origin[0]), float(origin[1]),
                             float(origin[2])))
        if derivs is not None:
            d = np.asarray(derivs, dtype=np.float64).reshape(27 * n)
            fh.write(b"DERIVS\x00\x1b")                   # tag + 0 + 27
            fh.write(d.tobytes())


def load_v3(path) -> GridFileData:
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:8] != MAGIC:
        raise ValueError(f"{path}: not an OMGRID file (bad magic)")
    version, _header_size = struct.unpack_from("<II", raw, 8)
    if version != 3:
        raise ValueError(
            f"{path}: only V3 grid files are supported, found version "
            f"{version}")
    nx, ny, nz, deriv_count = struct.unpack_from("<iiiI", raw, 16)
    dx, dy, dz, data_offset = struct.unpack_from("<dddQ", raw, 32)
    ox, oy, oz, type_code, _flags = struct.unpack_from("<dddII", raw, 64)
    inv_power, mode = struct.unpack_from("<dI", raw, 96)
    if mode > 2:
        raise ValueError(f"{path}: invalid inv_power_mode {mode}")
    if mode != 0 and inv_power == 0.0:
        raise ValueError(f"{path}: inv_power_mode set but inv_power is 0")

    n = nx * ny * nz
    off = int(data_offset)
    derivs = None
    if deriv_count > 0:
        total = deriv_count * n
        derivs = np.frombuffer(raw, np.float64, total, off).reshape(
            deriv_count, nx, ny, nz).copy()
        vals = derivs[0].copy()
    else:
        vals = np.frombuffer(raw, np.float64, n, off).reshape(
            nx, ny, nz).copy()
        pos = off + 8 * n
        # optional legacy block: numScalingFactors + doubles + origin
        if pos + 4 <= len(raw):
            (nsf,) = struct.unpack_from("<i", raw, pos)
            pos += 4
            if 0 <= nsf < 10_000_000 and pos + 8 * nsf + 24 <= len(raw):
                pos += 8 * nsf + 24
        # optional DERIVS trailer: 6-byte tag + u16 big-endian count
        if pos + 8 <= len(raw) and raw[pos:pos + 6] == b"DERIVS":
            nd = (raw[pos + 6] << 8) | raw[pos + 7]
            pos += 8
            derivs = np.frombuffer(raw, np.float64, nd * n, pos).reshape(
                nd, nx, ny, nz).copy()

    return GridFileData(
        counts=(nx, ny, nz),
        spacing=(dx, dy, dz),
        origin=(ox, oy, oz),
        vals=vals,
        derivs=derivs,
        grid_type=CODE_TO_GRID_TYPE.get(type_code, ""),
        inv_power=inv_power,
        inv_power_mode=mode,
    )
