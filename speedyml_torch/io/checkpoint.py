"""Prediction checkpoint/resume (the port's counterpart of
speedyml/io/checkpoint.py; the two packages write and read the same files).

The reference can't checkpoint a running prediction (reservoir state x is
only saved at sync time, mod_reservoir.f90:1025). Here the full prediction
state (reservoir states, global transformed fields, calendar) is one `.npz`
written atomically, so a multi-year hybrid run resumes exactly. Tensors come
to the host inside the save functions; the load functions return numpy, and
the caller puts what it needs on its device.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..core.calendar import ModelDate
from ..device import resolve_device, to_host
from ..dynamics.state import SpectralState


def _atomic_savez(path: str, payload: dict) -> None:
    """np.savez into a temporary file beside `path`, then rename."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _date_array(date: ModelDate) -> np.ndarray:
    return np.asarray([date.iyear, date.imonth, date.iday, date.ihour])


def save_prediction(path: str, x, atmo, logp, precip_t, date: ModelDate,
                    step: int = 0, extra: dict | None = None) -> None:
    """Atomic write (tmp + rename) of the prediction state."""
    payload = dict(x=to_host(x), atmo=to_host(atmo), logp=to_host(logp),
                   date=_date_array(date), step=np.asarray(step))
    if precip_t is not None:
        payload["precip_t"] = to_host(precip_t)
    for k, v in (extra or {}).items():
        payload["extra_" + k] = to_host(v)
    _atomic_savez(path, payload)


def load_prediction(path: str) -> dict:
    """Returns dict(x, atmo, logp, precip_t|None, date, step, extra), the
    arrays as host numpy."""
    with np.load(path) as z:
        out = dict(x=z["x"], atmo=z["atmo"], logp=z["logp"],
                   precip_t=z["precip_t"] if "precip_t" in z else None,
                   step=int(z["step"]))
        y, m, d, h = (int(v) for v in z["date"])
        out["date"] = ModelDate(iyear=y, imonth=m, iday=d, ihour=h)
        out["extra"] = {k[6:]: z[k] for k in z.files
                        if k.startswith("extra_")}
    return out


_SPEC_FIELDS = ("vor", "div", "t", "ps", "tr")


def save_speedy_restart(path: str, state: SpectralState, coupler,
                        date: ModelDate) -> None:
    """SPEEDY restart: spectral state + coupler slab fields + calendar
    (the reference's restart()/iogrid(69), ppo_restart.f90:1,
    ppo_iogrid.f90:400-435)."""
    payload = dict(date=_date_array(date))
    for k in _SPEC_FIELDS:
        payload["spec_" + k] = to_host(getattr(state, k))
    for k, v in vars(coupler).items():
        if isinstance(v, np.ndarray):
            payload["cpl_" + k] = v
    _atomic_savez(path, payload)


def load_speedy_restart(path: str,
                        device: torch.device | str | None = None):
    """Returns (SpectralState on `device`: the card unless the caller names
    another, coupler-field dict of host numpy, ModelDate)."""
    device = resolve_device(device)
    with np.load(path) as z:
        state = SpectralState(*(torch.as_tensor(z["spec_" + k], device=device)
                                for k in _SPEC_FIELDS))
        cpl = {k[4:]: z[k] for k in z.files if k.startswith("cpl_")}
        y, m, d, h = (int(v) for v in z["date"])
    return state, cpl, ModelDate(iyear=y, imonth=m, iday=d, ihour=h)
