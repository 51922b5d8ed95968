"""Readers for the SPEEDY climatological boundary-condition files (the port's
own copy of speedyml/io/boundary.py).

The reference reads these as direct-access little-endian real*4 records of one
latitude row each, stored north->south and flipped to south->north on read
(reference: src/ini_inbcon.f90:463-495). Field/unit assignments follow
ini_inbcon.f90:38-201.
"""

from __future__ import annotations

import os

import numpy as np

def read_boundary_records(path: str, ix: int = 96, il: int = 48) -> np.ndarray:
    """Read all (nfields, il, ix) records from a fort.2x file.

    Rows are flipped so row 0 = southernmost latitude (the model's internal
    convention), mirroring load_boundary_file's `inp(:,nlat+1-i)`.
    Values <= -999 (missing) are zeroed. Decoded in numpy: the native
    reader (io/native_loader.read_records_native) gives the same array,
    but would make every model construction depend on a C++ compiler for
    six files of about 0.2 MB.
    """
    raw = np.fromfile(path, dtype="<f4")
    nrec = raw.size // (ix * il)
    if nrec * ix * il != raw.size:
        raise ValueError(f"file {path} not a whole number of fields")
    data = raw.reshape(nrec, il, ix)[:, ::-1, :].astype(np.float64)
    data[data <= -999] = 0.0
    return data


class BoundaryData:
    """Static + monthly-climatology boundary fields (ini_inbcon.f90).

    Unit map (records within each file; ini_inbcon.f90:38-201):
      fort.20: [orography(m), land-sea mask, annual albedo, vegetation (low),
                vegetation (high)]
      fort.21: 12 monthly SST climatology
      fort.22: 12 monthly sea-ice concentration climatology
      fort.23: 12 monthly land-surface temperature climatology
      fort.24: 12 monthly snow depth climatology
      fort.26: 12 months x [soil wetness layer 1, layer 2 (root), layer 3]
    """

    def __init__(self, bindir: str, ix: int = 96, il: int = 48):
        f20 = read_boundary_records(os.path.join(bindir, "fort.20"), ix, il)
        self.orog = f20[0]           # surface height [m]
        self.fmask = f20[1]          # fractional land-sea mask
        self.alb0 = f20[2]           # annual-mean albedo
        self.veg_low = f20[3]
        self.veg_high = f20[4] if f20.shape[0] > 4 else np.zeros_like(f20[0])

        def monthly(unit, nvar=1):
            p = os.path.join(bindir, f"fort.{unit}")
            if not os.path.exists(p):
                return None
            d = read_boundary_records(p, ix, il)
            return d.reshape(12, nvar, il, ix) if nvar > 1 else d

        self.sst12 = monthly(21)     # (12, il, ix) sea sfc temperature [K]
        self.sice12 = monthly(22)    # sea-ice concentration [0..1]
        if self.sice12 is not None:
            self.sice12 = np.maximum(self.sice12, 0.0)
        self.stl12 = monthly(23)     # land sfc temperature [K]
        self.snowd12 = monthly(24)   # snow depth [mm w.e.]
        f26 = monthly(26, nvar=3)
        if f26 is not None:
            self.swl1_12 = f26[:, 0]
            self.swl2_12 = f26[:, 1]
        else:
            self.swl1_12 = self.swl2_12 = None
