"""Coarse climate-sanity scoring: the regression band for long runs. The
port's own copy of speedyml/utils/climate.py (host numpy).

The reference model's real use is multi-year climate simulation
(src/mod_reservoir.f90:34: 20-year runs; Arcomano et al. JAMES 2022/2023
validate jets, tropical precipitation, and drift). These checks encode the
level at which a T30L8 SPEEDY-class model must be sane — wide enough to
pass any healthy simulation, tight enough that a broken scheme (radiation
sign error, moisture blow-up, jet collapse, runaway drift) fails:

  * midlatitude westerly jet in BOTH hemispheres (position + strength),
  * tropical precipitation maximum (deep tropics wetter than midlatitudes),
  * global-mean lowest-level and mass-mean temperature inside bands,
  * TOA net radiation (absorbed solar - OLR) bounded,
  * global-mean temperature drift bounded.

Scored on time means from either the truth-trajectory cache or a live run
(scripts_torch/climate_check.py); the scoring math is held to the
original's in tests/test_torch_analysis.py.
"""

from __future__ import annotations

import numpy as np

# upper-troposphere sigma levels on the L8 grid (full-level sigma ~0.2-0.5:
# indices 1..3 of 8; the jet core lives here at T30)
JET_LEVELS = slice(1, 4)

BANDS = {
    "jet_speed_nh": (8.0, 60.0),     # m/s, zonal-mean u max
    "jet_speed_sh": (8.0, 60.0),
    "jet_lat_nh": (18.0, 65.0),      # deg, |latitude| of the max
    "jet_lat_sh": (18.0, 65.0),
    "precip_tropics_ratio": (1.1, 50.0),   # tropics / midlatitudes
    "precip_global_mm_day": (0.5, 8.0),
    "t_low_global": (272.0, 298.0),  # K, lowest-level area mean
    "t_mass_global": (235.0, 275.0), # K, all-level area mean
    "toa_net_w_m2": (-25.0, 25.0),   # absorbed solar - OLR
    "drift_k_per_year": (-3.0, 3.0), # lowest-level global-mean T trend
}


def _area_w(lat_deg):
    w = np.cos(np.radians(np.asarray(lat_deg)))
    return w / w.mean()


def climate_scores(lat_deg, u_mean=None, t_mean=None, precip_mm_day=None,
                   tsr=None, olr=None, t_low_series=None, hours=None):
    """Compute the score dict from time-mean fields.

    u_mean/t_mean: (kx, il, ix) time means; precip_mm_day: (il, ix) mean
    [mm/day]; tsr/olr: scalar global-time means [W/m^2]; t_low_series (T,)
    global-mean lowest-level T per sample with `hours` (T,) timestamps for
    the drift trend. Any None input skips its scores.
    """
    lat = np.asarray(lat_deg)
    w = _area_w(lat)
    s = {}
    if u_mean is not None:
        uz = np.asarray(u_mean)[JET_LEVELS].mean(axis=(0, 2))   # (il,)
        for hemi, mask in (("nh", lat > 15.0), ("sh", lat < -15.0)):
            um = np.where(mask, uz, -np.inf)
            i = int(np.argmax(um))
            s[f"jet_speed_{hemi}"] = float(uz[i])
            s[f"jet_lat_{hemi}"] = float(abs(lat[i]))
    if t_mean is not None:
        t = np.asarray(t_mean)
        s["t_low_global"] = float((t[-1] * w[:, None]).mean())
        s["t_mass_global"] = float((t * w[None, :, None]).mean())
    if precip_mm_day is not None:
        p = np.asarray(precip_mm_day)
        pz = (p * w[:, None]).mean(axis=1)                      # (il,)
        trop = pz[np.abs(lat) < 15.0].mean()
        midl = pz[(np.abs(lat) > 20.0) & (np.abs(lat) < 50.0)].mean()
        s["precip_tropics_ratio"] = float(trop / max(midl, 1e-9))
        s["precip_global_mm_day"] = float((p * w[:, None]).mean())
    if tsr is not None and olr is not None:
        s["toa_net_w_m2"] = float(tsr - olr)
    if t_low_series is not None and hours is not None:
        t_s = np.asarray(t_low_series, np.float64)
        h = np.asarray(hours, np.float64)
        slope = np.polyfit(h - h[0], t_s, 1)[0]                 # K/hour
        s["drift_k_per_year"] = float(slope * 8760.0)
    return s


def climate_check(scores: dict):
    """Returns (ok, failures): each score outside its band is a failure."""
    failures = []
    for name, val in scores.items():
        lo, hi = BANDS[name]
        if not (lo <= val <= hi) or not np.isfinite(val):
            failures.append(f"{name}={val:.3f} outside [{lo}, {hi}]")
    return (not failures), failures
