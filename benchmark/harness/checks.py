"""The numbers a check compares, and the verdict against the limits.

Gaps are taken in the readout's standardized units: each field's
difference from the reference divided by the configuration's scale of its
variable (the standardizer's spread), so that temperature, winds, humidity,
surface pressure and precipitation count alike.
"""

from __future__ import annotations

import sys

import torch

DYN = ("t", "u", "v")
# precipitation is judged by a high quantile of its gaps: a few columns
# whose moist triggers flip in float32 must not decide it, a field that is
# wrong in more than one column in a hundred does
PRECIP_QUANTILE = 0.99


def scaled_gaps(cfg: dict, atmo, logp, pr, ref_atmo, ref_logp, ref_pr):
    """{variable: (difference / scale) as a flat float64 tensor}."""
    sc = cfg["scales"]
    f = torch.float64
    d = {}
    for i, k in enumerate(("t", "u", "v", "q")):
        d[k] = ((atmo[i].to(ref_atmo.device, f) - ref_atmo[i]) / sc[k]
                ).reshape(-1)
    d["logp"] = ((logp.to(ref_logp.device, f) - ref_logp) / sc["logp"]
                 ).reshape(-1)
    d["precip"] = ((pr.to(ref_pr.device, f) - ref_pr) / sc["precip"]
                   ).reshape(-1)
    return d


def rms(parts) -> float:
    cat = torch.cat(list(parts))
    return float(cat.pow(2).mean().sqrt())


def widest(parts) -> float:
    return float(torch.cat(list(parts)).abs().max())


def median_abs(parts) -> float:
    return float(torch.cat(list(parts)).abs().median())


def quantile_abs(parts, q: float) -> float:
    return float(torch.quantile(torch.cat(list(parts)).abs(), q))


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number lies at or under its limit (a number that is
    not finite fails). Prints each beside its limit on standard error, as
    the run's last lines there."""
    ok = True
    for name in sorted(limits):
        v = numbers.get(name)
        good = v is not None and v == v and v <= limits[name]
        ok = ok and good
        print(f"check {name} {v!r} limit {limits[name]!r} "
              f"{'ok' if good else 'FAILED'}", file=sys.stderr)
    return ok
