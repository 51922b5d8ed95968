"""SPPT: stochastically perturbed parametrization tendencies (PyTorch port of
speedyml/physics/sppt.py; reference: src/mod_sppt.f90, after Palmer et al.
2009).

The spectral AR(1) noise is an explicit state (no module globals). Its
random numbers come from a `torch.Generator` on the model's device, seeded
by a pure function of (seed, day, step), as the JAX package's are a pure
function of its key folded with the day and the step. The two streams
differ, so parity with the JAX package is held with the noise given
(`Sppt.noise` is the one method that draws it).

Usage:
    sppt = Sppt(dy)                           # precompute sigma / phi / mu
    state = sppt.init()                       # first AR(1) sample
    state, pattern = sppt.step(state, day, j) # (kx, il, ix) in [-1, 1]
    tends = sppt.perturb(tends, pattern)      # tend * (1 + pattern * mu)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import PHYS

#: the generators' seed: fixed, as the JAX package's PRNGKey(0)
SEED = 0


class SpptState(NamedTuple):
    spec: torch.Tensor    # (kx, mx, 2, nx) AR(1) spectral state


class Sppt:
    # decorrelation time [h], length scale [m], grid-space stddev
    TIME_DECORR = 6.0
    LEN_DECORR = 5.0e5
    STDDEV = 0.33

    def __init__(self, dy, mu=None):
        self.dy = dy
        cfg = dy.config
        self.mu = np.ones(cfg.kx) if mu is None else np.asarray(mu)
        self.mu_col = torch.as_tensor(
            np.asarray(self.mu, np.float64), dtype=dy.dtype,
            device=dy.device)[:, None, None]
        # time autocorrelation per step (mod_sppt.f90:29)
        self.phi = float(np.exp(-(24.0 / cfg.nsteps) / self.TIME_DECORR))
        # wavenumber-wise sigma (mod_sppt.f90:73-79)
        rearth = PHYS.rearth
        n = np.arange(1, cfg.ntrun + 1)
        f0 = np.sum((2 * n + 1) * np.exp(
            -0.5 * (self.LEN_DECORR / rearth) ** 2 * n * (n + 1)))
        f0 = np.sqrt(self.STDDEV ** 2 * (1 - self.phi ** 2) / (2 * f0))
        el2 = np.asarray(dy.tables.el2)[:, None, :]   # (mx, 1, nx)
        self.sigma = torch.as_tensor(
            f0 * np.exp(-0.25 * self.LEN_DECORR ** 2 * el2),
            dtype=dy.dtype, device=dy.device)
        self._shape = (cfg.kx, cfg.mx, 2, cfg.nx)

    def noise(self, day: int, step: int) -> torch.Tensor:
        """The standard-normal spectral noise eta of (day, step), clipped to
        +-10 (mod_sppt.f90:63-66): drawn on the model's device from a
        generator whose seed is a pure function of (SEED, day, step). The
        initial sample is (0, 0); step j of day d >= 1 is (d, j + 1)."""
        dev = self.dy.device
        key = np.random.SeedSequence([SEED, int(day), int(step)])
        g = torch.Generator(device=dev).manual_seed(
            int(key.generate_state(1, np.uint64)[0]) >> 1)
        eta = torch.randn(self._shape, generator=g, dtype=self.dy.dtype,
                          device=dev)
        return torch.clamp(eta, -10.0, 10.0)

    def init(self) -> SpptState:
        eta = self.noise(0, 0)
        spec = (1 - self.phi ** 2) ** (-0.5) * self.sigma * eta
        return SpptState(spec=spec)

    def step(self, state: SpptState, day: int, j: int):
        """One AR(1) step (step j of day `day`); returns (new_state, grid
        pattern (kx, il, ix) clipped to [-1, 1])."""
        eta = self.noise(day, j + 1)
        spec = self.phi * state.spec + self.sigma * eta
        grid = self.dy.T.spec_to_grid(spec)
        return SpptState(spec=spec), torch.clamp(grid, -1.0, 1.0)

    def perturb(self, tends, pattern):
        """The multiplicative tendency perturbation (phy_phypar.f90 SPPT
        hook; mod_sppt.f90 mu tapering): each tendency times
        1 + pattern * mu."""
        s = 1.0 + pattern * self.mu_col
        return tuple(t * s for t in tends)
