"""Batched spherical-harmonic transforms in real arithmetic (PyTorch port of
speedyml/transforms/spectral.py).

Layouts match the JAX package one to one:
  spectral: real (..., mx, 2, nx)   zonal wavenumber m, (re, im), n offset
  fourier:  real (..., il, mx, 2)
  grid:     real (..., il, ix)      row 0 = southernmost latitude

The Legendre transform is an einsum over the latitude grid and the longitude
transform a dense DFT matmul, as in the reference; whether torch.fft is
faster on the GPU is left to a profiled later change.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .tables import SpectralTables, build_tables


def to_real(c: np.ndarray) -> np.ndarray:
    """complex (..., mx, nx) -> real (..., mx, 2, nx)."""
    return np.stack([np.real(c), np.imag(c)], axis=-2)


def to_complex(r) -> np.ndarray:
    """real (..., mx, 2, nx) -> complex numpy (..., mx, nx)."""
    r = np.asarray(r)
    return r[..., 0, :] + 1j * r[..., 1, :]


def _shift_down(x):
    """out[..., n] = x[..., n-1] (zero at n=0)."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def _shift_up(x):
    """out[..., n] = x[..., n+1] (zero at n=nx-1)."""
    return torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)


def _mul_i(x):
    """Multiply by the imaginary unit: (re, im) -> (-im, re)."""
    return torch.stack([-x[..., 1, :], x[..., 0, :]], dim=-2)


class SpectralTransform:
    """Operator constants as tensors on `device` (the card unless the caller
    names another) in `dtype`; the methods are plain functions of their
    tensor arguments."""

    def __init__(self, tables: SpectralTables | None = None,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        t = tables if tables is not None else build_tables()
        self.tables = t
        self.dtype = dtype
        self.device = resolve_device(device)
        self.ix, self.il, self.iy = t.ix, t.il, t.iy
        self.mx, self.nx, self.ntrun = t.mx, t.nx, t.ntrun

        def as_t(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                   device=self.device)

        def b(x):      # (mx, nx) -> (mx, 1, nx), broadcast over (re, im)
            return as_t(np.asarray(x)[:, None, :])

        self.leg_inv = as_t(t.leg_inv)      # (mx, nx, il)
        self.leg_fwd = as_t(t.leg_fwd)      # (mx, nx, il)
        self.el2 = b(t.el2)
        self.elm2 = b(t.elm2)
        self.el4 = b(t.el4)
        self.trfilt = b(t.trfilt)
        self.gradx = as_t(t.gradx)          # (mx,)
        self.gradym = b(t.gradym)
        self.gradyp = b(t.gradyp)
        self.uvdx = b(t.uvdx)
        self.uvdym = b(t.uvdym)
        self.uvdyp = b(t.uvdyp)
        self.vddym = b(t.vddym)
        self.vddyp = b(t.vddyp)
        self.cosgr = as_t(t.cosgr)
        self.cosgr2 = as_t(t.cosgr2)
        self.coriol = as_t(t.coriol)

        # dense DFT operators, built in f64 on the host
        m = np.arange(self.mx)
        i = np.arange(self.ix)
        ang = 2.0 * np.pi * np.outer(i, m) / self.ix          # (ix, mx)
        scale = np.where(m == 0, 1.0, 2.0)
        # inverse: grid[i] = sum_m scale*(re_m cos - im_m sin)
        dft_inv = np.empty((self.mx, 2, self.ix))
        dft_inv[:, 0, :] = scale[:, None] * np.cos(ang).T
        dft_inv[:, 1, :] = -scale[:, None] * np.sin(ang).T
        # forward: re_m = (1/ix) sum_i g cos ; im_m = -(1/ix) sum_i g sin
        dft_fwd = np.empty((self.ix, self.mx, 2))
        dft_fwd[:, :, 0] = np.cos(ang) / self.ix
        dft_fwd[:, :, 1] = -np.sin(ang) / self.ix
        # the host helpers use the operators as rounded to `dtype`, as the
        # JAX package's do
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self._dft_inv_np = np.asarray(dft_inv.reshape(self.mx * 2, self.ix),
                                      np_dtype)
        self._dft_fwd_np = np.asarray(dft_fwd.reshape(self.ix, self.mx * 2),
                                      np_dtype)
        self.dft_inv = as_t(self._dft_inv_np)
        self.dft_fwd = as_t(self._dft_fwd_np)

    # ------------------------------------------------------------------
    # core transforms
    # ------------------------------------------------------------------
    def spec_to_fourier(self, spec):
        """(..., mx, 2, nx) -> (..., il, mx, 2) (gridy equivalent)."""
        return torch.einsum("...mcn,mnj->...jmc", spec, self.leg_inv)

    def fourier_to_grid(self, fourier, kcos: int = 1):
        """(..., il, mx, 2) -> (..., il, ix) via dense DFT matmul."""
        flat = fourier.reshape(fourier.shape[:-2] + (self.mx * 2,))
        grid = flat @ self.dft_inv
        if kcos == 2:
            grid = grid * self.cosgr[:, None]
        return grid

    def grid_to_fourier(self, grid):
        """(..., il, ix) -> (..., il, mx, 2)."""
        flat = grid @ self.dft_fwd
        return flat.reshape(flat.shape[:-1] + (self.mx, 2))

    def fourier_to_spec(self, fourier):
        """(..., il, mx, 2) -> (..., mx, 2, nx) (specy equivalent)."""
        return torch.einsum("...jmc,mnj->...mcn", fourier, self.leg_fwd)

    def spec_to_grid(self, spec, kcos: int = 1):
        """Spectral -> grid (reference `grid`, spe_spectral.f90:389-401)."""
        return self.fourier_to_grid(self.spec_to_fourier(spec), kcos)

    def grid_to_spec(self, grid):
        """Grid -> spectral (reference `spec`, spe_spectral.f90:403-414)."""
        return self.fourier_to_spec(self.grid_to_fourier(grid))

    # ------------------------------------------------------------------
    # spectral-space operators
    # ------------------------------------------------------------------
    def lap(self, spec):
        return -spec * self.el2

    def invlap(self, spec):
        return -spec * self.elm2

    def trunct(self, spec):
        return spec * self.trfilt

    def grad(self, psi):
        """Spectral gradient (spe_spectral.f90:271-305)."""
        psdx = _mul_i(psi) * self.gradx[:, None, None]
        psdy = (-self.gradym * _shift_down(psi)
                + self.gradyp * _shift_up(psi))
        return psdx, psdy

    def uvspec(self, vorm, divm):
        """(vor, div) -> (U*cos, V*cos) spectral (spe_spectral.f90:351-387)."""
        zp = _mul_i(vorm) * self.uvdx
        zc = _mul_i(divm) * self.uvdx
        ucosm = (self.uvdym * _shift_down(vorm)
                 - self.uvdyp * _shift_up(vorm) + zc)
        vcosm = (-self.uvdym * _shift_down(divm)
                 + self.uvdyp * _shift_up(divm) + zp)
        return ucosm, vcosm

    def vds(self, ucosm, vcosm):
        """(U*cos, V*cos) spectral -> (vor, div) (spe_spectral.f90:307-349)."""
        zp = _mul_i(ucosm) * self.gradx[:, None, None]
        zc = _mul_i(vcosm) * self.gradx[:, None, None]
        vorm = (self.vddym * _shift_down(ucosm)
                - self.vddyp * _shift_up(ucosm) + zc)
        divm = (-self.vddym * _shift_down(vcosm)
                + self.vddyp * _shift_up(vcosm) + zp)
        return vorm, divm

    def vdspec(self, ug, vg, kcos: int = 2):
        """Grid (u, v) -> spectral (vor, div) (spe_spectral.f90:416-452)."""
        scale = self.cosgr if kcos == 2 else self.cosgr2
        um = self.grid_to_spec(ug * scale[:, None])
        vm = self.grid_to_spec(vg * scale[:, None])
        return self.vds(um, vm)

    def uv_grid(self, vorm, divm):
        """Spectral (vor, div) -> grid (u, v) (dyn_grtend.f90:70-72)."""
        ucosm, vcosm = self.uvspec(vorm, divm)
        return (self.spec_to_grid(ucosm, kcos=2),
                self.spec_to_grid(vcosm, kcos=2))

    # ------------------------------------------------------------------
    # host (numpy, float64) variants for set-up code
    # ------------------------------------------------------------------
    def host_grid_to_spec(self, grid: np.ndarray) -> np.ndarray:
        """numpy grid -> real-layout spectral (..., mx, 2, nx), float64."""
        flat = np.einsum("...ji,if->...jf", np.asarray(grid, np.float64),
                         np.asarray(self._dft_fwd_np, np.float64))
        fourier = flat.reshape(flat.shape[:-1] + (self.mx, 2))
        return np.einsum("...jmc,mnj->...mcn", fourier,
                         np.asarray(self.tables.leg_fwd))

    def host_spec_to_grid(self, spec: np.ndarray, kcos: int = 1) -> np.ndarray:
        fourier = np.einsum("...mcn,mnj->...jmc", np.asarray(spec, np.float64),
                            np.asarray(self.tables.leg_inv))
        flat = fourier.reshape(fourier.shape[:-2] + (self.mx * 2,))
        grid = np.einsum("...jf,fi->...ji", flat,
                         np.asarray(self._dft_inv_np, np.float64))
        if kcos == 2:
            grid = grid * np.asarray(self.tables.cosgr)[:, None]
        return grid

    def host_trunct(self, spec: np.ndarray) -> np.ndarray:
        return np.asarray(spec) * np.asarray(self.tables.trfilt)[:, None, :]
