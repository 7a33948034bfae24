"""NetCDF and OpenDX grid I/O (mirrors reference python/grid_io.py; the
port's copy of the JAX package's numpy module).

NetCDF uses the AlGDock variable layout — ``counts``/``spacing``/``origin``/
``vals``, each with a leading ``time`` dimension — via scipy's NetCDF3
implementation (the reference wrote NETCDF4 through the netCDF4 package;
NetCDF3 classic is readable by every NetCDF tool and by netCDF4 itself).

.dx files convert nm -> Angstrom on write by default (visualization tools
expect Angstroms, reference grid_io.py:107-164).
"""

from __future__ import annotations

import gzip

import numpy as np
from scipy.io import netcdf_file


def read_netcdf(filename):
    """Read a grid NetCDF file -> dict(counts, spacing, origin, vals)."""
    with netcdf_file(filename, "r", mmap=False) as nc:
        data = {}
        counts = nc.variables["counts"][:]
        counts = counts[0] if counts.ndim > 1 else counts
        data["counts"] = tuple(int(c) for c in counts)
        spacing = nc.variables["spacing"][:]
        spacing = spacing[0] if spacing.ndim > 1 else spacing
        data["spacing"] = tuple(float(s) for s in spacing)
        if "origin" in nc.variables:
            origin = nc.variables["origin"][:]
            origin = origin[0] if origin.ndim > 1 else origin
            data["origin"] = tuple(float(o) for o in origin)
        else:
            data["origin"] = (0.0, 0.0, 0.0)
        vals = nc.variables["vals"][:]
        vals = vals[0] if vals.ndim > 1 else vals
        data["vals"] = np.array(vals, dtype=np.float64)
    return data


def write_netcdf(filename, counts, spacing, vals,
                 origin=(0.0, 0.0, 0.0)):
    """Write a grid NetCDF file with the AlGDock layout."""
    vals = np.asarray(vals, dtype=np.float64).reshape(-1)
    with netcdf_file(filename, "w") as nc:
        nc.createDimension("time", 1)
        nc.createDimension("data", len(vals))
        nc.createDimension("xyz", 3)
        counts_var = nc.createVariable("counts", "i", ("time", "xyz"))
        spacing_var = nc.createVariable("spacing", "d", ("time", "xyz"))
        origin_var = nc.createVariable("origin", "d", ("time", "xyz"))
        vals_var = nc.createVariable("vals", "d", ("time", "data"))
        counts_var[0, :] = counts
        spacing_var[0, :] = spacing
        origin_var[0, :] = origin
        vals_var[0, :] = vals


def read_dx(filename, to_nm=False):
    """Read an OpenDX grid -> dict(counts, spacing, origin, vals).

    ``to_nm=True`` converts origin/spacing Angstrom -> nm (the inverse of
    write_dx's default nm -> Angstrom; grid VALUES are untouched, matching
    reference python/grid_io.py which never converts values)."""
    opener = gzip.open if filename.endswith(".gz") else open
    with opener(filename, "rt") as fh:
        line = fh.readline()
        while line and "object" not in line:
            line = fh.readline()
        if not line:
            raise ValueError(f"{filename}: invalid .dx file")
        counts = [int(x) for x in line.split()[-3:]]
        header = {}
        for name in ["origin", "d0", "d1", "d2"]:
            header[name] = [float(x) for x in fh.readline().split()[-3:]]
        fh.readline()  # gridconnections
        npts = int(fh.readline().split()[-3])
        vals = np.empty(npts)
        idx = 0
        while idx < npts:
            line = fh.readline()
            if not line or "object" in line:
                break
            items = [float(x) for x in line.split()]
            vals[idx:idx + len(items)] = items
            idx += len(items)
    scale = 0.1 if to_nm else 1.0
    return {
        "origin": np.array(header["origin"]) * scale,
        "spacing": np.array([header["d0"][0], header["d1"][1],
                             header["d2"][2]]) * scale,
        "counts": np.array(counts),
        "vals": vals,
    }


def write_dx(filename, counts, spacing, vals, origin=(0.0, 0.0, 0.0),
             convert_to_angstrom=True):
    """Write an OpenDX grid for VMD/PyMOL/Chimera."""
    vals = np.asarray(vals).reshape(-1)
    n_points = counts[0] * counts[1] * counts[2]
    scale = 10.0 if convert_to_angstrom else 1.0
    origin_out = tuple(o * scale for o in origin)
    spacing_out = tuple(s * scale for s in spacing)

    opener = gzip.open if filename.endswith(".gz") else open
    with opener(filename, "wt") as fh:
        fh.write(
            "object 1 class gridpositions counts {0} {1} {2}\n".format(
                *counts))
        fh.write("origin {0} {1} {2}\n".format(*origin_out))
        fh.write(f"delta {spacing_out[0]} 0.0 0.0\n")
        fh.write(f"delta 0.0 {spacing_out[1]} 0.0\n")
        fh.write(f"delta 0.0 0.0 {spacing_out[2]}\n")
        fh.write(
            "object 2 class gridconnections counts {0} {1} {2}\n".format(
                *counts))
        fh.write(f"object 3 class array type double rank 0 items "
                 f"{n_points} data follows\n")
        for start in range(0, len(vals), 3):
            fh.write(" ".join("%6e" % v
                              for v in vals[start:start + 3]) + "\n")
        fh.write('object 4 class field\n')
        fh.write('component "positions" value 1\n')
        fh.write('component "connections" value 2\n')
        fh.write('component "data" value 3\n')


def nc_to_v3(nc_file, grid_file):
    """AlGDock NetCDF (Angstrom, kcal/mol) -> V3 binary (nm, kJ/mol)
    (reference python/nc_converter.py:12-27)."""
    from ..units import ANGSTROM_TO_NM, KCAL_TO_KJ
    from .v3 import save_v3

    data = read_netcdf(nc_file)
    spacing = tuple(s * ANGSTROM_TO_NM for s in data["spacing"])
    vals = data["vals"] * KCAL_TO_KJ
    save_v3(grid_file, data["counts"], spacing, (0.0, 0.0, 0.0),
            np.asarray(vals).reshape(data["counts"]))



def save_grid_as_dx(grid_force, filename):
    """Save a GridForce (API object) or a Grid as .dx
    (reference python/grid_io.py:167-183)."""
    if hasattr(grid_force, "getGridParameters"):
        counts, spacing, vals, _ = grid_force.getGridParameters()
        origin = grid_force.getGridOrigin()
    else:
        counts = grid_force.counts
        spacing, origin, vals = (
            np.asarray(t.detach().cpu()) for t in
            (grid_force.spacing, grid_force.origin, grid_force.vals))
        vals = vals.reshape(-1)
    write_dx(filename, counts, spacing, vals, origin)
