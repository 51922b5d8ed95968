"""Forecast/truth output writers (NetCDF-3). The port's own copy of
speedyml/io/output.py: host-side numpy and scipy; the two packages write and
read the same files.

Replaces the reference's incremental hybrid-prediction NetCDF writer on
rank 0 (mpires.f90:456-563 -> mod_io.f90:32-849 write_netcdf_4d + multi-2d)
with a host-side writer fed host arrays at the output edge (the runners
bring their tensors to the host before they call it).
Incremental: the time dimension is NetCDF's unlimited record dimension, so a
crashed run keeps everything written so far (same property as the
reference's per-step writes)."""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.io import netcdf_file

VAR3D = ("Temperature", "U-wind", "V-wind", "Specific-Humidity")
UNITS3D = ("K", "m/s", "m/s", "g/kg")


class ForecastWriter:
    """Incremental writer for hybrid/ML forecast trajectories.

    Variables follow the reference's naming (mod_io.f90:59-75): Temperature,
    U-wind, V-wind, Specific-Humidity (time, lev, lat, lon) + logp, and
    optional 2-D fields (p6hr precip, SST).
    """

    def __init__(self, path: str, kx: int, il: int, ix: int,
                 sigma: Optional[np.ndarray] = None,
                 lat: Optional[np.ndarray] = None,
                 lon: Optional[np.ndarray] = None,
                 with_precip: bool = True, with_sst: bool = False,
                 title: str = "speedyml hybrid forecast"):
        self.path = path
        f = netcdf_file(path, "w", version=2)
        self._f = f
        f.title = title.encode()
        f.createDimension("Timestep", None)       # record dim
        f.createDimension("Sigma_Level", kx)
        f.createDimension("Lat", il)
        f.createDimension("Lon", ix)
        for name, vals in (("Sigma_Level", sigma), ("Lat", lat),
                           ("Lon", lon)):
            v = f.createVariable(name, "f4", (name,))
            n = dict(Sigma_Level=kx, Lat=il, Lon=ix)[name]
            v[:] = np.arange(n) if vals is None else np.asarray(vals)
        self._v3 = {}
        for name, unit in zip(VAR3D, UNITS3D):
            v = f.createVariable(name, "f4",
                                 ("Timestep", "Sigma_Level", "Lat", "Lon"))
            v.units = unit.encode()
            self._v3[name] = v
        self._logp = f.createVariable("logp", "f4", ("Timestep", "Lat",
                                                     "Lon"))
        self._precip = None
        self._sst = None
        if with_precip:
            self._precip = f.createVariable("p6hr", "f4",
                                            ("Timestep", "Lat", "Lon"))
            self._precip.units = b"mm"
        if with_sst:
            self._sst = f.createVariable("SST", "f4",
                                         ("Timestep", "Lat", "Lon"))
            self._sst.units = b"K"
        self._t = 0
        self.with_precip = with_precip
        self.with_sst = with_sst
        # scipy writes the header + coordinate data once; appends then go
        # through the O(1) record-slab appender (io.ncstream) — scipy's own
        # record path is O(T^2) in memcpy AND file I/O (full rewrite per
        # flush), which a 10-year run cannot pay. Neutralize the scipy
        # object so its close()/__del__ can't rewrite the file later.
        f.flush()
        f.fp.close()
        self._f = None
        from .ncstream import RecordAppender
        self._rec = RecordAppender(path)

    def append(self, atmo: np.ndarray, logp: np.ndarray,
               precip_mm: Optional[np.ndarray] = None,
               sst: Optional[np.ndarray] = None):
        """atmo: (4, kx, il, ix) in (T, u, v, q) order; 2-D fields (il, ix)."""
        t = self._t
        for i, name in enumerate(VAR3D):
            self._rec.write(name, t, atmo[i])
        self._rec.write("logp", t, logp)
        if self.with_precip and precip_mm is not None:
            self._rec.write("p6hr", t, precip_mm)
        if self.with_sst and sst is not None:
            self._rec.write("SST", t, sst)
        self._t += 1
        self._rec.flush()        # numrecs patch: crashed runs keep records

    def close(self):
        if self._rec is not None:
            self._rec.close()
            self._rec = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_forecast(path: str) -> dict:
    """Load a forecast file back as native-endian numpy arrays."""
    f = netcdf_file(path, "r", mmap=False)
    try:
        out = {}
        for name, v in f.variables.items():
            a = np.asarray(v[:])
            out[name] = a.astype(a.dtype.newbyteorder("="))
        return out
    finally:
        f.close()
