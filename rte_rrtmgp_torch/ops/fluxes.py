"""Spectral flux reductions (reference: ``src/Fluxes.cpp`` +
``src_kernels_cuda/fluxes_kernels.cu`` and the vendored Fortran
``src_kernels/mo_fluxes_byband_kernels.F90``)."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def _index(idx: tuple, device: torch.device) -> torch.Tensor:
    """A static index tuple as a long tensor on ``device`` (cached so the
    chunk loop does not copy it to the card on every call)."""
    return torch.tensor(idx, dtype=torch.long, device=device)


def sum_broadband(gpt_flux):
    """Sum over g-points: (ncol, nlev, ngpt) -> (ncol, nlev)."""
    return gpt_flux.sum(dim=-1)


def net_broadband(flux_dn, flux_up):
    """Net flux, down minus up."""
    return flux_dn - flux_up


def sum_byband(gpt_flux, gpt2band, nbnd: int):
    """Per-band sums: (ncol, nlev, ngpt) -> (ncol, nlev, nbnd).

    ``gpt2band`` maps each (possibly chunk-local) g-point to its *global*
    band; the g-points of one band are contiguous, so each band is one
    slice sum (reference ``mo_fluxes_byband_kernels.F90:22-42``)."""
    out = gpt_flux.new_zeros(gpt_flux.shape[:-1] + (nbnd,))
    g0 = 0
    while g0 < len(gpt2band):
        g1 = g0
        while g1 < len(gpt2band) and gpt2band[g1] == gpt2band[g0]:
            g1 += 1
        out[..., gpt2band[g0]] += gpt_flux[..., g0:g1].sum(dim=-1)
        g0 = g1
    return out


def expand_bands_to_gpt(arr_bnd, gpt2band):
    """Expand (..., nbnd) to (..., ngpt) via the g-point -> band map
    (reference ``expand_and_transpose``, src/Rte_lw.cpp:204-217)."""
    return arr_bnd.index_select(-1, _index(tuple(gpt2band), arr_bnd.device))


def heating_rate(flux_up, flux_dn, plev, grav=9.80665, cp=1004.64):
    """Radiative heating rate K/s from net flux divergence (aux output;
    conventional definition, not in the reference driver)."""
    net = flux_dn - flux_up
    dnet = net[:, 1:] - net[:, :-1]
    dp = plev[:, 1:] - plev[:, :-1]
    return grav / cp * dnet / dp
