"""The model's typed configuration (a frozen copy of the port's
`ModelConfig`, without the options the reference's window never turns on:
SPPT, random diabatic forcing, time means).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Atmosphere resolution + time stepping (mod_atparam.f90, mod_tsteps.f90)."""

    # spectral resolution (T30 L8 default)
    ntrun: int = 30
    ix: int = 96
    il: int = 48
    kx: int = 8
    ntr: int = 1          # number of tracers (tr 0 = specific humidity, g/kg)

    # time stepping (mod_tsteps.f90:19,84-99)
    nsteps: int = 96      # steps per day
    rob: float = 0.05     # Robert filter
    wil: float = 0.53     # Williams filter
    alph: float = 0.5     # semi-implicit centering

    # physics cadence
    nstrad: int = 3       # shortwave radiation period (steps)

    # seasonal cycle flag (1 = yes)
    iseasc: int = 1

    # start date
    iyear0: int = 1981
    imont0: int = 1

    # numerics
    dtype: str = "float32"   # "float32" on the card, "float64" for CPU validation
    # grid-space tendency compute dtype: "bfloat16" halves the HBM traffic of
    # the dominant elementwise tendency work (spectral state/transforms stay
    # in `dtype`); opt-in fast path for large-ensemble throughput runs
    grid_compute: str = "float32"

    @property
    def mx(self) -> int:
        return self.ntrun + 1

    @property
    def nx(self) -> int:
        return self.ntrun + 2

    @property
    def iy(self) -> int:
        return self.il // 2

    @property
    def delt(self) -> float:
        return 86400.0 / self.nsteps

    @property
    def delt2(self) -> float:
        return 2.0 * self.delt
