"""GrADS binary + .ctl descriptor output (reference: ppo_setctl.f90,
ppo_iogrid.f90 modes 1/2/4, ppo_setgrd.f90): the port's own copy of
speedyml/io/grads.py (host numpy), which writes byte-identical files.

The reference's legacy visualization format: sequential float32 records, one
(lat, lon) slab per (variable, level, time), plus a .ctl descriptor GrADS
reads. Written little-endian stream (no Fortran record markers), declared in
the .ctl options, which modern GrADS accepts.
"""

from __future__ import annotations

import os

import numpy as np

_MON = ["jan", "feb", "mar", "apr", "may", "jun",
        "jul", "aug", "sep", "oct", "nov", "dec"]


class GradsWriter:
    """Incremental GrADS output: call append() once per time step."""

    def __init__(self, basepath: str, lat: np.ndarray, sigma: np.ndarray,
                 ix: int, var3d=("TEMP", "U", "V", "Q"), var2d=("LNPS",),
                 dt_hours: int = 6, year0: int = 1982, month0: int = 1):
        self.base = basepath
        self.lat = np.asarray(lat, np.float64)
        self.sigma = np.asarray(sigma, np.float64)
        self.ix = ix
        self.var3d = tuple(var3d)
        self.var2d = tuple(var2d)
        self.dt_hours = dt_hours
        self.year0, self.month0 = year0, month0
        self._fh = open(basepath + ".grd", "wb")
        self._nt = 0

    def append(self, fields3d, fields2d=()):
        """fields3d: sequence matching var3d, each (kx, il, ix);
        fields2d: sequence matching var2d, each (il, ix)."""
        assert len(fields3d) == len(self.var3d)
        assert len(fields2d) == len(self.var2d)
        for f in fields3d:
            a = np.asarray(f, "<f4")
            assert a.shape[1:] == (len(self.lat), self.ix)
            a.tofile(self._fh)
        for f in fields2d:
            np.asarray(f, "<f4").tofile(self._fh)
        self._fh.flush()
        self._nt += 1

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
            self._write_ctl()

    def _write_ctl(self):
        kx = len(self.sigma)
        nlat = len(self.lat)
        name = os.path.basename(self.base)
        lines = [
            f"dset ^{name}.grd",
            "undef -9.99e33",
            "options little_endian",
            f"title speedyml output",
            f"xdef {self.ix} linear 0.0 {360.0 / self.ix:.6f}",
            "ydef %d levels %s" % (nlat, " ".join(
                f"{v:.3f}" for v in self.lat)),
            "zdef %d levels %s" % (kx, " ".join(
                f"{v:.3f}" for v in self.sigma)),
            f"tdef {self._nt} linear 0z1{_MON[self.month0 - 1]}{self.year0} "
            f"{self.dt_hours}hr",
            f"vars {len(self.var3d) + len(self.var2d)}",
        ]
        for v in self.var3d:
            lines.append(f"{v.lower()} {kx} 99 {v}")
        for v in self.var2d:
            lines.append(f"{v.lower()} 0 99 {v}")
        lines.append("endvars")
        with open(self.base + ".ctl", "w") as fh:
            fh.write("\n".join(lines) + "\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_grads(basepath: str, kx: int, il: int, ix: int, n3d: int = 4,
               n2d: int = 1):
    """Read back a GradsWriter file: (arr3d (T, n3d, kx, il, ix),
    arr2d (T, n2d, il, ix))."""
    raw = np.fromfile(basepath + ".grd", dtype="<f4")
    per_t = n3d * kx * il * ix + n2d * il * ix
    T = raw.size // per_t
    assert T * per_t == raw.size
    out3, out2 = [], []
    raw = raw.reshape(T, per_t)
    out3 = raw[:, :n3d * kx * il * ix].reshape(T, n3d, kx, il, ix)
    out2 = raw[:, n3d * kx * il * ix:].reshape(T, n2d, il, ix)
    return out3, out2
