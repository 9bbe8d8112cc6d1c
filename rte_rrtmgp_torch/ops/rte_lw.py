"""Longwave no-scattering RTE solver (Gauss quadrature) in PyTorch.

Port of the reference's LW pipeline (``src_kernels_cuda/rte_solver_kernels.cu
:97-193`` + ``lw_transport_noscat_kernel`` `:35-94`): per-cell optical prep
and linear-in-tau sources, a downward sweep from the top, surface
reflection and emission, and an upward sweep carrying the surface-source
Jacobian.

:func:`lw_solver_noscat` returns per-g-point fluxes as plain tensor code.
:func:`lw_solver_noscat_broadband` returns g-point-summed fluxes: on the
card each Gauss angle is one launch of the hand-written sweep kernel
(``csrc/lw_sweep.cu``), which never materializes (ncol, nlev, ngpt).
:func:`lw_solver_noscat_broadband_lm` does the same on layer-major
(nlay*ncol, G) planes (cell (c, l) at row l*ncol + c).

Canonical orientation: **top of atmosphere at layer index 0**.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from .kernels import solvers as _kern

# Gauss-Jacobi-5 quadrature (Table 1, Hogan 2023; src/Rte_lw.cpp:138-152).
GAUSS_DS = np.array([
    [1.0 / 0.6096748751, 0.0, 0.0, 0.0],
    [1.0 / 0.2509907356, 1.0 / 0.7908473988, 0.0, 0.0],
    [1.0 / 0.1024922169, 1.0 / 0.4417960320, 1.0 / 0.8633751621, 0.0],
    [1.0 / 0.0454586727, 1.0 / 0.2322334416, 1.0 / 0.5740198775, 1.0 / 0.903077597],
])
GAUSS_WTS = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.2300253764, 0.7699746236, 0.0, 0.0],
    [0.0437820218, 0.3875796738, 0.5686383044, 0.0],
    [0.0092068785, 0.1285704278, 0.4323381850, 0.4298845087],
])


def solve_one_angle(tau, lay_src, lev_src, sfc_emis, sfc_src, sfc_src_jac,
                    inc_flux, D: float, w: float):
    """One quadrature angle; returns per-g-point (up, dn, jac) radiances
    scaled to fluxes, each (ncol, nlay+1, ngpt)."""
    dtype = tau.dtype
    nlay = tau.shape[1]
    # D and w are rounded to the working type first, as the reference's
    # typed constants are.
    D = torch.tensor(D, dtype=dtype).item()
    w = torch.tensor(w, dtype=dtype).item()
    tau_loc = tau * D
    trans = torch.exp(-tau_loc)

    tau_thres = config.tau_thres(dtype)
    safe = torch.where(tau_loc == 0.0, 1.0, tau_loc)
    fact = torch.where(
        tau_loc > tau_thres,
        (1.0 - trans) / safe - trans,
        tau_loc * (0.5 + tau_loc * (-1.0 / 3.0 + tau_loc * (1.0 / 8.0))),
    )
    # top at index 0: downward source sees the level below the layer.
    src_dn = (1.0 - trans) * lev_src[:, 1:] + 2.0 * fact * (lay_src - lev_src[:, 1:])
    src_up = (1.0 - trans) * lev_src[:, :-1] + 2.0 * fact * (lay_src - lev_src[:, :-1])

    # Downward sweep: radn_dn[l+1] = trans[l]*radn_dn[l] + src_dn[l].
    rad = inc_flux / (2.0 * torch.tensor(math.pi, dtype=dtype).item() * w)
    dn = [rad]
    for l in range(nlay):
        rad = trans[:, l] * rad + src_dn[:, l]
        dn.append(rad)

    # Surface reflection + upward sweep (with Jacobian carried along).
    up_l = dn[-1] * (1.0 - sfc_emis) + sfc_emis * sfc_src
    jac_l = sfc_emis * sfc_src_jac
    up, jac = [up_l], [jac_l]
    for l in range(nlay - 1, -1, -1):
        up_l = trans[:, l] * up_l + src_up[:, l]
        jac_l = trans[:, l] * jac_l
        up.append(up_l)
        jac.append(jac_l)

    scale = (torch.tensor(math.pi, dtype=dtype) * w).item()
    return (scale * torch.stack(up[::-1], dim=1),
            scale * torch.stack(dn, dim=1),
            scale * torch.stack(jac[::-1], dim=1))


def lw_solver_noscat(tau, lay_src, lev_src, sfc_emis, sfc_src, sfc_src_jac,
                     inc_flux, n_gauss_angles: int = 1):
    """Gauss-quadrature LW solver.  All (ncol, nlay[, +1], ngpt), top at 0.

    sfc_emis / sfc_src / inc_flux: (ncol, ngpt).
    Returns flux_up, flux_dn, flux_up_jac: (ncol, nlay+1, ngpt).
    """
    fu = fd = fj = 0.0
    for imu in range(n_gauss_angles):
        u, d, j = solve_one_angle(
            tau, lay_src, lev_src, sfc_emis, sfc_src, sfc_src_jac, inc_flux,
            float(GAUSS_DS[n_gauss_angles - 1, imu]),
            float(GAUSS_WTS[n_gauss_angles - 1, imu]))
        fu, fd, fj = fu + u, fd + d, fj + j
    return fu, fd, fj


def lw_sweep_plain(tau, lay_src, lev_src, sfc_emis, sfc_src, sfc_src_jac,
                   inc_flux, D: float, w: float):
    """Plain twin of the LW sweep kernel: one angle, summed over g."""
    u, d, j = solve_one_angle(tau, lay_src, lev_src, sfc_emis, sfc_src,
                              sfc_src_jac, inc_flux, D, w)
    return u.sum(-1), d.sum(-1), j.sum(-1)


def lw_solver_noscat_broadband(tau, lay_src, lev_src, sfc_emis, sfc_src,
                               sfc_src_jac, inc_flux,
                               n_gauss_angles: int = 1):
    """As :func:`lw_solver_noscat` but returning g-point-summed broadband
    fluxes (ncol, nlay+1): one sweep per Gauss angle, each a kernel launch
    on the card."""
    fu = fd = fj = 0.0
    for imu in range(n_gauss_angles):
        u, d, j = _kern.lw_sweep(
            tau, lay_src, lev_src, sfc_emis, sfc_src, sfc_src_jac, inc_flux,
            D=float(GAUSS_DS[n_gauss_angles - 1, imu]),
            w=float(GAUSS_WTS[n_gauss_angles - 1, imu]))
        fu, fd, fj = fu + u, fd + d, fj + j
    return fu, fd, fj


def _col_major(a, nrow: int, ncol: int):
    """Layer-major (nrow*ncol, G) -> a (ncol, nrow, G) view."""
    return a.reshape(nrow, ncol, -1).transpose(0, 1)


def lw_sweep_lm_plain(tau_lm, lay_lm, lev_pieces, sfc_emis, sfc_src,
                      sfc_src_jac, inc_flux, ncol: int, D: float, w: float):
    """Plain twin of the layer-major LW sweep kernel: :func:`lw_sweep_plain`
    on the planes viewed column-major (the level pieces concatenated)."""
    nlay = tau_lm.shape[0] // ncol
    lev = torch.cat(tuple(lev_pieces), dim=0)
    return lw_sweep_plain(_col_major(tau_lm, nlay, ncol),
                          _col_major(lay_lm, nlay, ncol),
                          _col_major(lev, nlay + 1, ncol), sfc_emis, sfc_src,
                          sfc_src_jac, inc_flux, D, w)


def lw_solver_noscat_broadband_lm(tau_lm, lay_lm, lev_pieces, sfc_emis,
                                  sfc_src, sfc_src_jac, inc_flux, *,
                                  ncol: int, n_gauss_angles: int = 1):
    """Broadband LW solve on layer-major planes: tau_lm/lay_lm
    (nlay*ncol, G), ``lev_pieces`` = (lev0 (ncol, G), inner
    ((nlay-1)*ncol, G), lev_last (ncol, G)) as :func:`planck_source_lm`
    returns them, the rest (ncol, G).  One kernel launch per Gauss angle
    on the card.  Returns up, dn, jac each (ncol, nlay+1)."""
    fu = fd = fj = 0.0
    for imu in range(n_gauss_angles):
        u, d, j = _kern.lw_sweep_lm(
            tau_lm, lay_lm, lev_pieces, sfc_emis, sfc_src, sfc_src_jac,
            inc_flux, ncol=ncol,
            D=float(GAUSS_DS[n_gauss_angles - 1, imu]),
            w=float(GAUSS_WTS[n_gauss_angles - 1, imu]))
        fu, fd, fj = fu + u, fd + d, fj + j
    return fu, fd, fj
