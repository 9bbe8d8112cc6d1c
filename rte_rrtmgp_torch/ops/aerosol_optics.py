"""Aerosol optics: 11 CAMS species, relative-humidity-classed tables.

Reference: ``src/Aerosol_optics.cpp:38-222``.  The rh-class search
(``rh_class``, `:26-36`) is a ``searchsorted``; each hydrophilic table is
read by plain indexing with the per-cell class.
"""

from __future__ import annotations

import torch

from .. import config
from ..models.aerosol_lut import AEROSOL_SPECIES, AerosolLUT
from ..models.types import OpticalProps2str


def aerosol_optics_2str(lut: AerosolLUT, aermr, rh, plev) -> OpticalProps2str:
    """aermr: (ncol, nlay, 11) mass mixing ratios in AEROSOL_SPECIES order;
    rh: (ncol, nlay) relative humidity; plev: (ncol, nlay+1).

    Returns banded two-stream optical properties (ncol, nlay, nbnd).
    """
    eps = config.eps(rh.dtype)
    # dpg = |plev[l] - plev[l+1]| / g  (src/Aerosol_optics.cpp:54; abs()
    # makes the layer mass orientation-independent).
    dpg = torch.abs(plev[:, :-1] - plev[:, 1:]) / 9.81

    # rh class: smallest ihum with rh_upper[ihum] >= rh.
    ihum = torch.searchsorted(lut.rh_upper, rh.contiguous(), side="left")
    ihum = torch.clamp(ihum, 0, lut.nhum - 1)

    tau = 0.0
    taussa = 0.0
    taussag = 0.0
    for k, spec in enumerate(AEROSOL_SPECIES):
        mmr = aermr[:, :, k]
        if spec.philic:
            # (nbnd, nhum) -> per-cell class row (ncol, nlay, nbnd)
            mext = lut.mext_philic[:, :, spec.table_idx].T[ihum]
            ssa = lut.ssa_philic[:, :, spec.table_idx].T[ihum]
            g = lut.g_philic[:, :, spec.table_idx].T[ihum]
        else:
            mext = lut.mext_phobic[None, None, :, spec.table_idx]
            ssa = lut.ssa_phobic[None, None, :, spec.table_idx]
            g = lut.g_phobic[None, None, :, spec.table_idx]

        od = (mmr * dpg)[:, :, None] * mext
        tau = tau + od
        taussa = taussa + od * ssa
        taussag = taussag + od * ssa * g

    return OpticalProps2str(
        tau=tau,
        ssa=taussa / torch.clamp(tau, min=eps),
        g=taussag / torch.clamp(taussa, min=eps),
    )
