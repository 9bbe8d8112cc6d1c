"""Cloud optics: effective-radius LUT interpolation under a cloud mask.

Reference: ``compute_all_from_table`` + the 2str/1scl combination
(``src/Cloud_optics.cpp:72-232``).  The per-cell LUT lookup is a plain
row index into the (nsize, nbnd) tables; the lo/hi corners stay separate
so ``lo + fint*(hi - lo)`` keeps the reference's association.
"""

from __future__ import annotations

import torch

from .. import config
from ..models.cloud_lut import CloudLUT
from ..models.types import OpticalProps1scl, OpticalProps2str


def _from_table(cwp, re, nsteps, step_size, offset, *tabs):
    """(ncol, nlay) water path + effective size -> per-band products
    (tau, tau*ssa[, tau*ssa*g]) each (ncol, nlay, nbnd), given
    (tau_t, ssa_t[, asy_t]) LUTs of shape (nsize, nbnd)."""
    dtype = cwp.dtype
    mask = (cwp > 0.0)[:, :, None]
    pos = (re - offset) / step_size
    idx = torch.clamp(pos.to(torch.int32) + 1, max=nsteps - 1)   # 1-based
    fint = (pos - (idx - 1).to(dtype))[:, :, None]
    # Indices are floor-clamped at row 0: for re below the table range both
    # corners collapse to the first row (a flat clamp); below-range re is
    # outside the reference's contract (src/Cloud_optics.cpp:85-94).
    hi_i = torch.clamp(idx, min=0).long()
    lo_i = torch.clamp(idx - 1, min=0).long()
    lerped = [t[lo_i] + fint * (t[hi_i] - t[lo_i]) for t in tabs]

    zero = torch.zeros((), dtype=dtype, device=cwp.device)
    tau = torch.where(mask, cwp[:, :, None] * lerped[0], zero)
    taussa = torch.where(mask, tau * lerped[1], zero)
    if len(tabs) == 2:
        return tau, taussa
    taussag = torch.where(mask, taussa * lerped[2], zero)
    return tau, taussa, taussag


def cloud_optics_2str(lut: CloudLUT, lwp, iwp, rel, dei) -> OpticalProps2str:
    """Two-stream cloud optics per band (src/Cloud_optics.cpp:111-172)."""
    eps = config.eps(lwp.dtype)
    ltau, ltaussa, ltaussag = _from_table(
        lwp, rel, lut.liq_nsteps, lut.liq_step_size, lut.radliq_lwr,
        lut.lut_extliq, lut.lut_ssaliq, lut.lut_asyliq)
    itau, itaussa, itaussag = _from_table(
        iwp, dei, lut.ice_nsteps, lut.ice_step_size, lut.diamice_lwr,
        lut.lut_extice, lut.lut_ssaice, lut.lut_asyice)

    tau = ltau + itau
    taussa = ltaussa + itaussa
    taussag = ltaussag + itaussag
    return OpticalProps2str(
        tau=tau,
        ssa=taussa / torch.clamp(tau, min=eps),
        g=taussag / torch.clamp(taussa, min=eps),
    )


def cloud_optics_1scl(lut: CloudLUT, lwp, iwp, rel, dei) -> OpticalProps1scl:
    """Absorption-only cloud optics: tau_abs = tau - tau*ssa
    (src/Cloud_optics.cpp:176-232)."""
    ltau, ltaussa = _from_table(
        lwp, rel, lut.liq_nsteps, lut.liq_step_size, lut.radliq_lwr,
        lut.lut_extliq, lut.lut_ssaliq)
    itau, itaussa = _from_table(
        iwp, dei, lut.ice_nsteps, lut.ice_step_size, lut.diamice_lwr,
        lut.lut_extice, lut.lut_ssaice)
    return OpticalProps1scl(tau=(ltau - ltaussa) + (itau - itaussa))
