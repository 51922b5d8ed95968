"""Seeded stand-in boundary files in the format `io.boundary` reads.

The SPEEDY climatology (`fort.20..26`) is observational data that does not
ship with this repository. `write_synthetic_boundary` writes files of the
same layout from a seed, so that the full-physics model can be built, run and
tested anywhere, and so that two implementations can be fed the very same
files. It is stand-in DATA, as seeded random reservoirs are stand-in weights:
an idealised planet with a few continents and mountains, not a model feature
and not a climatology to validate skill against.

Layout (src/ini_inbcon.f90:38-201, 463-495): little-endian real*4, one
(il, ix) field per record, rows stored north to south.
  fort.20  5 records: orography [m], land fraction, albedo, low and high
           vegetation fractions
  fort.21  12 monthly sea-surface temperature [K]
  fort.22  12 monthly sea-ice fraction
  fort.23  12 monthly land-surface temperature [K]
  fort.24  12 monthly snow depth [mm water]
  fort.26  36 records: 12 months x 3 soil-wetness layers
"""

from __future__ import annotations

import os

import numpy as np

# missing-data flags over the surface type a field does not describe. The
# reader zeroes values <= -999, which suits the fields whose masked-out value
# is 0 anyway (ice, snow, soil wetness; `forchk` sets it). The temperatures
# carry a flag the reader keeps (it is > -999), and `fillsf` replaces those
# cells by zonal means of the valid ones before `forchk` masks them.
MISSING = -999.0
MISSING_FILL = -99.0

# continents: (lat, lon, lat radius, lon radius) in degrees
_CONTINENTS = [(52.0, 85.0, 24.0, 62.0),     # a broad northern continent
               (45.0, 258.0, 22.0, 34.0),
               (-12.0, 300.0, 24.0, 17.0),
               (4.0, 22.0, 26.0, 22.0),
               (-25.0, 135.0, 11.0, 19.0)]
# mountains: (lat, lon, lat radius, lon radius, height [m])
_MOUNTAINS = [(42.0, 88.0, 14.0, 26.0, 3300.0),
              (41.0, 251.0, 12.0, 9.0, 1900.0),
              (-16.0, 296.0, 15.0, 8.0, 2400.0),
              (2.0, 34.0, 11.0, 9.0, 1300.0)]


def _blob(lat, lon, lat0, lon0, rlat, rlon):
    dlon = (lon - lon0 + 180.0) % 360.0 - 180.0
    return np.exp(-((lat - lat0) / rlat) ** 2 - (dlon / rlon) ** 2)


def _smooth_noise(rng, lat, lon, n_terms=6):
    """A seeded sum of a few low-wavenumber harmonics, of order one."""
    out = np.zeros(np.broadcast_shapes(lat.shape, lon.shape))
    for _ in range(n_terms):
        m = int(rng.integers(1, 5))
        n = int(rng.integers(1, 4))
        out += rng.normal() \
            * np.cos(np.radians(m * lon) + rng.uniform(0, 6.28)) \
            * np.cos(np.radians(n * lat) + rng.uniform(0, 6.28))
    return out / np.sqrt(n_terms)


def synthetic_fields(seed: int = 0, ix: int = 96, il: int = 48) -> dict:
    """The fields as float64 arrays with row 0 = southernmost latitude (the
    model's convention), missing-value flags included. Keys are the file
    names; values are (nrec, il, ix)."""
    rng = np.random.default_rng(seed)
    lat = (-90.0 + (np.arange(il) + 0.5) * 180.0 / il)[:, None]     # (il, 1)
    lon = (np.arange(ix) * 360.0 / ix)[None, :]                      # (1, ix)
    phi = np.radians(lat)
    slat = np.sin(phi)

    # --- land fraction: seeded continents plus a southern polar cap -------
    cont = np.zeros((il, ix))
    for lat0, lon0, rlat, rlon in _CONTINENTS:
        cont = np.maximum(cont, _blob(lat, lon, lat0 + rng.uniform(-6, 6),
                                      lon0 + rng.uniform(-8, 8), rlat, rlon))
    cont = np.maximum(cont, np.clip((-66.0 - lat) / 9.0, 0.0, 1.0))
    cont = cont + 0.06 * _smooth_noise(rng, lat, lon)
    fmask = np.clip((cont - 0.32) / 0.36, 0.0, 1.0)
    sea = fmask < 0.05            # the reader's masks cut at 0.1 and 0.9
    land = fmask > 0.95

    # --- orography: a few broad mountains, an ice dome on the polar cap ---
    orog = np.zeros((il, ix))
    for lat0, lon0, rlat, rlon, h in _MOUNTAINS:
        orog += h * _blob(lat, lon, lat0, lon0, rlat, rlon)
    orog += 250.0 * np.clip(cont, 0.0, 1.0)
    orog += 2300.0 * np.clip((-68.0 - lat) / 22.0, 0.0, 1.0)
    orog = np.minimum(orog, 3800.0) * fmask

    # --- albedo, vegetation ----------------------------------------------
    alb_land = 0.12 + 0.30 * slat ** 2 + 0.02 * _smooth_noise(rng, lat, lon)
    alb = 0.07 + fmask * (np.clip(alb_land, 0.1, 0.45) - 0.07)
    green = np.clip(np.cos(phi) ** 2 * (0.75 + 0.25 * _smooth_noise(
        rng, lat, lon)), 0.0, 1.0) * fmask
    dry = np.exp(-((np.abs(lat) - 25.0) / 10.0) ** 2)       # subtropical belts
    veg_high = np.clip(green * (1.0 - 0.8 * dry), 0.0, 1.0)
    veg_low = np.clip(green - veg_high + 0.1 * fmask, 0.0, 1.0)

    # --- monthly cycles ---------------------------------------------------
    month = np.arange(12)[:, None, None] + 1.0
    season = np.cos(2.0 * np.pi * (month - 7.5) / 12.0)   # +1 in boreal summer
    waves = _smooth_noise(rng, lat, lon)

    sst_raw = (300.5 - 31.0 * slat ** 2 + 4.5 * slat * season
               + 1.2 * waves * np.cos(phi))
    sst = np.maximum(sst_raw, 271.0)
    sice = np.clip((273.6 - sst_raw) / 4.0, 0.0, 1.0)

    stl = (289.0 - 44.0 * slat ** 2 + 13.0 * slat * season
           + 1.5 * _smooth_noise(rng, lat, lon) - 0.0065 * orog)
    winter = np.maximum(-np.sign(lat) * season, 0.0)
    snowd = fmask * (450.0 * winter * np.clip((np.abs(lat) - 42.0) / 25.0,
                                              0.0, 1.0)
                     + 2000.0 * np.clip((-66.0 - lat) / 8.0, 0.0, 1.0))

    # volumetric soil wetness between the wilting point and field capacity
    # (physics/constants.py swwil, swcap): wet tropics and high latitudes,
    # dry subtropics, a little wetter in the local winter
    wet = np.clip(0.75 - 0.6 * dry + 0.12 * _smooth_noise(rng, lat, lon)
                  + 0.1 * winter, 0.0, 1.0)
    swl1 = 0.17 + 0.13 * wet
    swl2 = 0.17 + 0.13 * np.clip(wet + 0.1, 0.0, 1.0)
    swl3 = np.broadcast_to(0.17 + 0.13 * wet.mean(axis=0), wet.shape)

    # --- missing-value flags over the surface type a field does not
    # describe, as the observed files carry them ---------------------------
    sst = np.where(land, MISSING_FILL, sst)
    sice = np.where(land, MISSING, sice)
    stl = np.where(sea, MISSING_FILL, stl)
    snowd = np.where(sea, MISSING, snowd)
    swl1, swl2, swl3 = (np.where(sea, MISSING, s) for s in (swl1, swl2, swl3))
    # and a few flagged cells on the coasts, where the model does read the
    # field: what `fillsf` puts there is used
    coast = (fmask > 0.2) & (fmask < 0.8)
    pick = coast & (rng.uniform(size=(il, ix)) < 0.15)
    sst = np.where(pick, MISSING_FILL, sst)
    pick = coast & (rng.uniform(size=(il, ix)) < 0.15)
    stl = np.where(pick, MISSING_FILL, stl)

    soil = np.stack([swl1, swl2, swl3], axis=1).reshape(36, il, ix)
    return {"fort.20": np.stack([orog, fmask, alb, veg_low, veg_high]),
            "fort.21": sst, "fort.22": sice, "fort.23": stl,
            "fort.24": snowd, "fort.26": soil}


def write_synthetic_boundary(dirpath: str, seed: int = 0, ix: int = 96,
                             il: int = 48) -> str:
    """Write fort.20, 21, 22, 23, 24 and 26 under `dirpath` (created if
    absent) from `seed`; the same seed gives the same bytes. Returns
    `dirpath`, which is what `Speedy(config, bindir=...)` takes."""
    os.makedirs(dirpath, exist_ok=True)
    for name, rec in synthetic_fields(seed, ix, il).items():
        # rows go out north to south
        np.ascontiguousarray(rec[:, ::-1, :]).astype("<f4").tofile(
            os.path.join(dirpath, name))
    return dirpath
