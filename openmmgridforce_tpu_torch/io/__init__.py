"""Grid file I/O: V3 (``OMGRID``), OMGTILE, NetCDF and OpenDX, the native
tile streamer, and out-of-core evaluation over it (``io.streaming``)."""

from .gridio import (nc_to_v3, read_dx, read_netcdf,  # noqa: F401
                     write_dx, write_netcdf)
from .omgtile import (TiledGridReader, TiledGridWriter,  # noqa: F401
                      write_grid_tiled)
from .v3 import (GridFileData, load_v3, save_v3,  # noqa: F401
                 save_v3_griddata)


def grid_from_file(path, device=None, **grid_kwargs):
    """Load a V3 or OMGTILE grid file into the port's Grid on ``device``
    (the CUDA card unless ``device="cpu"``). ``grid_kwargs`` are the
    Grid's configuration (``interp_method``, ``grid_cap``, ``oob_k``,
    ``dtype``); the dtype is the file's (float64 for V3, float32 for
    OMGTILE) unless given."""
    from ..device import resolve_device
    from ..grid import grid_from_numpy

    device = resolve_device(device)
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic == b"OMGRID\x00\x00":
        data = load_v3(path)
        return grid_from_numpy(
            data.vals, data.spacing, data.origin, derivs=data.derivs,
            inv_power=data.inv_power, inv_power_mode=data.inv_power_mode,
            grid_type=data.grid_type, device=device, **grid_kwargs)
    if magic == b"OMGTILE\x00":
        with TiledGridReader(path) as r:
            vals, derivs = r.read_full()
            return grid_from_numpy(
                vals, r.spacing, r.origin, derivs=derivs,
                inv_power=r.inv_power, inv_power_mode=r.inv_power_mode,
                device=device, **grid_kwargs)
    raise ValueError(f"{path}: unrecognized grid file format")
