"""ERA5 training-data ingestion (the reference's regridded-ERA5 readers):
the port's own copy of speedyml/io/era.py (host numpy and scipy; nothing of
it runs on the device).

File/variable schema follows the reference (speedy_res_interface.f90:277-436,
read_era; mod_io.f90:1905-2282 parallel hyperslab readers):

  era_5_y{YYYY}_regridded_mpi_fixed_var_gcc.nc
      Temperature / U-wind / V-wind / Specific_Humidity (lon, lat, lev, time)
      logp (lon, lat, time)
  toa_incident_solar_radiation_{YYYY}_regridded_classic4.nc : tisr
  (optional) SST / p6hr / sohtc300 companions
  restart_6hour_y{YYYY}.nc : precomputed one-window SPEEDY forecasts
      (read_model_states, speedy_res_interface.f90:637-723)

This implementation reads NetCDF-3 (classic) files via scipy. The reference
ecosystem's NetCDF-4/HDF5 files must be converted once with `nccopy -k
classic` (no netCDF4/HDF5 stack in this image); the variable layout is
unchanged. Where the reference scatters per-region hyperslabs over MPI-IO
(one read per rank per region), here whole fields are read into host arrays
and the per-region slicing happens in the packed-supervector gather on the
device (domain.decomposition).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from scipy.io import netcdf_file

from ..core.calendar import hours_since_epoch

VAR4D = ("Temperature", "U-wind", "V-wind", "Specific_Humidity")


def _native(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(a.dtype.newbyteorder("="))


def _open(path: str) -> netcdf_file:
    # mmap=False: every field is copied to a float32 array below anyway, so
    # mapping buys nothing — and scipy's mmap mode warns on close (and is a
    # use-after-close hazard) whenever lazily-sliced views are still alive
    try:
        return netcdf_file(path, "r", mmap=False)
    except Exception as e:  # HDF5-based NetCDF-4 gives a format error here
        raise OSError(
            f"{path}: not a NetCDF-3 classic file ({e}). NetCDF-4/HDF5 "
            "inputs must be converted once: nccopy -k classic in.nc out.nc"
        ) from e


_DIM_ROLE = {
    "time": ("timestep", "time", "t", "record"),
    "lev": ("sigma_level", "lev", "level", "sigma", "plev", "z"),
    "lat": ("lat", "latitude", "y"),
    "lon": ("lon", "longitude", "x"),
}


def _dim_role(name: str) -> Optional[str]:
    n = name.lower()
    for role, aliases in _DIM_ROLE.items():
        if n in aliases:
            return role
    return None


def _to_tzyx(a: np.ndarray, dims=()) -> np.ndarray:
    """Orient a 3-D/4-D field to (time[, lev], lat, lon).

    The reference declares fields (lon, lat, lev, time) in Fortran
    (mod_io.f90:1905-2036), i.e. (time, lev, lat, lon) in C dimension order —
    but files produced by other regridders may store any permutation.
    Dimension names are authoritative when recognizable; otherwise a shape
    heuristic applies (on this grid lon = 2*lat, lev <= 16) and an
    ambiguous file raises rather than being read transposed silently."""
    a = np.asarray(a)
    if a.ndim not in (3, 4):
        return a
    want = ("time", "lev", "lat", "lon") if a.ndim == 4 else \
        ("time", "lat", "lon")

    roles = [_dim_role(d) for d in dims] if len(dims) == a.ndim else []
    if roles and sorted(str(r) for r in roles) == sorted(want):
        return np.transpose(a, [roles.index(r) for r in want])

    # Shape heuristic — requires all axis sizes distinct to be unambiguous.
    shape = a.shape
    if len(set(shape)) == a.ndim:
        axes = set(range(a.ndim))
        # lon is the unique axis that is exactly twice another (96 = 2*48)
        pairs = [(i, j) for i in axes for j in axes
                 if i != j and shape[i] == 2 * shape[j]]
        if len(pairs) == 1:
            lon, lat = pairs[0]
            rest = sorted(axes - {lon, lat}, key=lambda i: shape[i])
            if a.ndim == 3:
                return np.transpose(a, [rest[0], lat, lon])
            lev, time = rest          # lev < time (8 levels vs >=365 records)
            if shape[lev] <= 16 and shape[time] > shape[lev]:
                return np.transpose(a, [time, lev, lat, lon])
    raise ValueError(
        f"cannot determine orientation of field with shape {shape} "
        f"and dims {tuple(dims)}; name the dimensions (time/lev/lat/lon)")


def read_era_year(path: str, q_to_gkg: bool = True) -> dict:
    """Read one regridded ERA5 year file.

    Returns dict(atmo (T, 4, kx, il, ix) in (T, u, v, q[g/kg]) order,
    logp (T, il, ix), plus any of sst/p6hr/sohtc300 present).
    The q -> g/kg x1000 and clamp mirror speedy_res_interface.f90:772-790.
    """
    f = _open(path)
    try:
        fields = []
        for name in VAR4D:
            key = name if name in f.variables else name.replace("_", "-")
            var = f.variables[key]
            a = _native(var[:]).astype(np.float32)
            fields.append(_to_tzyx(a, var.dimensions))
        atmo = np.stack(fields, axis=1)     # (T, 4, kx, il, ix)
        if q_to_gkg:
            q = atmo[:, 3] * 1000.0
            atmo[:, 3] = np.clip(q, 0.0, 25.0)
        vlp = f.variables["logp"]
        out = {"atmo": atmo,
               "logp": _to_tzyx(_native(vlp[:]).astype(np.float32),
                                vlp.dimensions)}
        for extra in ("SST", "p6hr", "sohtc300"):
            if extra in f.variables:
                v = f.variables[extra]
                out[extra.lower()] = _to_tzyx(
                    _native(v[:]).astype(np.float32), v.dimensions)
        return out
    finally:
        f.close()


def read_tisr_year(path: str) -> np.ndarray:
    """(T, il, ix) top-incident solar radiation
    (speedy_res_interface.f90:368-370)."""
    f = _open(path)
    try:
        v = f.variables["tisr"]
        return np.maximum(
            _to_tzyx(_native(v[:]).astype(np.float32), v.dimensions), 0.0)
    finally:
        f.close()


def read_model_states(path: str) -> dict:
    """Precomputed SPEEDY one-window forecasts
    ("restart_6hour_yYYYY.nc", read_model_states,
    speedy_res_interface.f90:637-723). Same variable schema as ERA files."""
    return read_era_year(path, q_to_gkg=False)


def era_file_name(dirpath: str, year: int,
                  suffix: str = "_regridded_mpi_fixed_var_gcc") -> str:
    return os.path.join(dirpath, f"era_5_y{year}{suffix}.nc")


def tisr_file_name(dirpath: str, year: int) -> str:
    return os.path.join(
        dirpath, f"toa_incident_solar_radiation_{year}_regridded_classic4.nc")


def read_era_range(dirpath: str, y0: int, y1: int,
                   tisr_dir: Optional[str] = None,
                   suffix: str = "_regridded_mpi_fixed_var_gcc") -> dict:
    """Concatenate years [y0, y1] (the reference's year loop,
    speedy_res_interface.f90:299-436)."""
    parts = [read_era_year(era_file_name(dirpath, y)) for y in
             range(y0, y1 + 1)]
    out = {"atmo": np.concatenate([p["atmo"] for p in parts]),
           "logp": np.concatenate([p["logp"] for p in parts])}
    for extra in ("sst", "p6hr", "sohtc300"):
        if all(extra in p for p in parts):
            out[extra] = np.concatenate([p[extra] for p in parts])
    if tisr_dir is not None:
        out["tisr"] = np.concatenate(
            [read_tisr_year(tisr_file_name(tisr_dir, y))
             for y in range(y0, y1 + 1)])
    return out


def read_sst_year(path: str) -> np.ndarray:
    """(T, il, ix) observed SST from an ERA-schema file, without loading the
    3-D fields (the per-variable analog of the reference's
    read_3d_file_parallel on the SST companion, mod_io.f90:2731-2812)."""
    f = _open(path)
    try:
        v = f.variables["SST"]
        return _to_tzyx(_native(v[:]).astype(np.float32), v.dimensions)
    finally:
        f.close()


class ObservedBoundary:
    """File-backed SST/TISR-by-date at PREDICTION time.

    The reference's get_sst_by_date / get_tisr_by_date (mpires.f90:1676-1710)
    re-read the observed companion files every hybrid step so the reservoir
    feedback uses observed boundary conditions rather than climatology /
    analytic values. Here the reference-schema files for years [y0, y1] are
    loaded once (SST from the era files' SST variable; TISR from the
    toa_incident_solar_radiation files) and served by date at the file
    cadence.

    Usage: ob = ObservedBoundary(dir, 1990, 1999, tisr_dir=dir);
    HybridRunner.run(..., sst_fn=ob.sst_fn, tisr_fn=ob.tisr_fn).
    """

    def __init__(self, dirpath: str, y0: int, y1: Optional[int] = None,
                 tisr_dir: Optional[str] = None,
                 suffix: str = "_regridded_mpi_fixed_var_gcc",
                 cadence_hours: int = 6):
        y1 = y1 if y1 is not None else y0
        self.cadence = cadence_hours
        self.hours0 = hours_since_epoch(y0, 1, 1, 0)
        self.sst = None
        self.tisr = None
        sst_parts = []
        for y in range(y0, y1 + 1):
            p = era_file_name(dirpath, y, suffix)
            if not os.path.exists(p):
                # fail at construction (matching the TISR path) — a silent
                # self.sst = None would only surface as a bare assertion at
                # the first prediction step, far from the misconfiguration
                raise FileNotFoundError(
                    f"SST year file missing: {p} (years {y0}-{y1})")
            sst_parts.append(read_sst_year(p))
        self.sst = np.concatenate(sst_parts)
        if tisr_dir is not None:
            self.tisr = np.concatenate(
                [read_tisr_year(tisr_file_name(tisr_dir, y))
                 for y in range(y0, y1 + 1)])

    def _index(self, series: np.ndarray, date) -> int:
        h = hours_since_epoch(date.iyear, date.imonth, date.iday,
                              date.ihour) - self.hours0
        i = int(h) // self.cadence
        if not 0 <= i < len(series):
            raise IndexError(
                f"date {date.iyear}-{date.imonth:02d}-{date.iday:02d}"
                f"T{date.ihour:02d} outside the loaded boundary window "
                f"({len(series)} records from epoch+{self.hours0}h)")
        return i

    def sst_fn(self, date) -> np.ndarray:
        assert self.sst is not None, "no SST files loaded"
        return self.sst[self._index(self.sst, date)]

    def tisr_fn(self, date) -> np.ndarray:
        assert self.tisr is not None, "no TISR files loaded"
        return self.tisr[self._index(self.tisr, date)]


def write_tisr_year(path: str, tisr: np.ndarray) -> None:
    """Write an hourly/6-hourly TISR file in the reference's schema
    (toa_incident_solar_radiation_*.nc, speedy_res_interface.f90:368-370)."""
    T, il, ix = tisr.shape
    f = netcdf_file(path, "w", version=2)
    try:
        f.createDimension("Timestep", None)
        f.createDimension("Lat", il)
        f.createDimension("Lon", ix)
        v = f.createVariable("tisr", "f4", ("Timestep", "Lat", "Lon"))
        v[:] = tisr
    finally:
        f.close()


def write_era_year(path: str, atmo: np.ndarray, logp: np.ndarray,
                   sst: Optional[np.ndarray] = None,
                   p6hr: Optional[np.ndarray] = None,
                   tisr: Optional[np.ndarray] = None) -> None:
    """Write an ERA-schema NetCDF-3 file (useful for caching self-generated
    truth in the reference's interchange format; write path mirrors
    mod_io.f90:311-436 variable naming)."""
    T, nv, kx, il, ix = atmo.shape
    f = netcdf_file(path, "w", version=2)
    try:
        f.createDimension("Timestep", None)
        f.createDimension("Sigma_Level", kx)
        f.createDimension("Lat", il)
        f.createDimension("Lon", ix)
        names = ("Temperature", "U-wind", "V-wind", "Specific_Humidity")
        for i, name in enumerate(names):
            v = f.createVariable(name, "f4", ("Timestep", "Sigma_Level",
                                              "Lat", "Lon"))
            v[:] = atmo[:, i]
        v = f.createVariable("logp", "f4", ("Timestep", "Lat", "Lon"))
        v[:] = logp
        for name, arr in (("SST", sst), ("p6hr", p6hr), ("tisr", tisr)):
            if arr is not None:
                v = f.createVariable(name, "f4", ("Timestep", "Lat", "Lon"))
                v[:] = arr
    finally:
        f.close()
