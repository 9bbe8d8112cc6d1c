"""The flagship forward step: all-sky LW + SW broadband fluxes, and on
request the clear-sky ones from the same gas optics.

Counterpart of the JAX package's ``__graft_entry__`` (``_build``,
``_atmos_arrays``, ``make_step``): clouds on, aerosols off, delta-scaled SW
clouds, one Gauss angle, bottom-up inputs (the solvers flip them), and the
spectral-chunk loop.  The step takes the same 16 arrays in the same order
and returns the same dict of ``lw_*`` and ``sw_*`` fluxes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .cases.profiles import make_atmosphere
from .data import synthetic
from .models.cloud_lut import CloudLUT
from .models.kdist import KDist
from .models.radiation import _solve_lw_impl, _solve_sw_impl
from .ops.gas_optics import get_col_dry

GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
ARG_NAMES = ("p_lay", "p_lev", "t_lay", "t_lev", "t_sfc", "vmr", "col_dry",
             "emis_sfc", "sfc_alb_dir", "sfc_alb_dif", "tsi_scaling", "mu0",
             "lwp", "iwp", "rel", "dei")


def build_tables(gpt_per_band: int, dtype=torch.float32, device=None):
    """(kd_lw, kd_sw, clut_lw, clut_sw) from the synthetic coefficient
    dicts, on ``device`` (default ``cuda``)."""
    device = config.resolve_device(device)
    kd_lw = KDist.from_raw(synthetic.make_kdist_raw(True, gpt_per_band=gpt_per_band),
                           GASES, dtype=dtype, device=device)
    kd_sw = KDist.from_raw(synthetic.make_kdist_raw(False, gpt_per_band=gpt_per_band),
                           GASES, dtype=dtype, device=device)
    clut_lw = CloudLUT.from_raw(synthetic.make_cloud_raw(True), dtype=dtype,
                                device=device)
    clut_sw = CloudLUT.from_raw(synthetic.make_cloud_raw(False), dtype=dtype,
                                device=device)
    return kd_lw, kd_sw, clut_lw, clut_sw


def atmos_arrays(ncol: int, nlay: int, dtype=np.float32, seed: int = 0) -> dict:
    """The step's 16 input arrays (NumPy, bottom-up) from the analytic RCE
    atmosphere of ``make_atmosphere``."""
    atm = make_atmosphere(ncol, nlay, seed=seed)
    vmr = atm["gas_concs"].materialize(GASES, ncol, nlay)
    col_dry = get_col_dry(torch.from_numpy(vmr[:, :, 0]),
                          torch.from_numpy(atm["p_lev"])).numpy()
    cast = lambda a: np.asarray(a, dtype)
    nbnd_lw, nbnd_sw = 16, 14
    return dict(
        p_lay=cast(atm["p_lay"]), p_lev=cast(atm["p_lev"]),
        t_lay=cast(atm["t_lay"]), t_lev=cast(atm["t_lev"]),
        t_sfc=cast(atm["t_sfc"]), vmr=cast(vmr), col_dry=cast(col_dry),
        emis_sfc=np.full((ncol, nbnd_lw), 0.98, dtype),
        sfc_alb_dir=np.full((ncol, nbnd_sw), 0.06, dtype),
        sfc_alb_dif=np.full((ncol, nbnd_sw), 0.06, dtype),
        tsi_scaling=np.ones((ncol,), dtype),
        mu0=cast(atm["mu0"]),
        lwp=cast(atm["lwp"]), iwp=cast(atm["iwp"]),
        rel=cast(atm["rel"]), dei=cast(atm["dei"]),
    )


def make_step(kd_lw, kd_sw, clut_lw, clut_sw, gpt_chunk=None, cellw=True,
              layer_major=False, clear_sky=False):
    """The flagship forward step on the tables' device.  The returned
    ``step(p_lay, ..., dei)`` takes tensors (or arrays) in ``ARG_NAMES``
    order and returns {lw_flux_up, lw_flux_dn, lw_flux_net, sw_flux_up,
    sw_flux_dn, sw_flux_dn_dir, sw_flux_net}, each (ncol, nlev).

    ``clear_sky=True`` also returns the clear-sky fluxes a GCM writes as
    its clear-sky diagnostics, {lw_clrsky_flux_up, lw_clrsky_flux_dn,
    lw_clrsky_flux_net, sw_clrsky_flux_up, sw_clrsky_flux_dn,
    sw_clrsky_flux_dn_dir, sw_clrsky_flux_net}, from the same gas optics:
    each spectral chunk is solved once on its gas-only optics, before the
    clouds are added, and once on the all-sky optics, whose fluxes stay
    bit-equal to those of ``clear_sky=False``.

    ``cellw`` / ``layer_major`` choose the layout, i.e. which kernels run
    (``models/radiation.py``)."""
    device, dtype = kd_lw.device, kd_lw.dtype

    def step(p_lay, p_lev, t_lay, t_lev, t_sfc, vmr, col_dry, emis_sfc,
             sfc_alb_dir, sfc_alb_dif, tsi_scaling, mu0, lwp, iwp, rel, dei):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        (p_lay, p_lev, t_lay, t_lev, t_sfc, vmr, col_dry, emis_sfc,
         sfc_alb_dir, sfc_alb_dif, tsi_scaling, mu0, lwp, iwp, rel, dei) = map(
            t, (p_lay, p_lev, t_lay, t_lev, t_sfc, vmr, col_dry, emis_sfc,
                sfc_alb_dir, sfc_alb_dif, tsi_scaling, mu0, lwp, iwp, rel, dei))
        lw = _solve_lw_impl(
            kd_lw, clut_lw, p_lay, p_lev, t_lay, t_lev, t_sfc, vmr, col_dry,
            emis_sfc, lwp, iwp, rel, dei,
            top_at_1=False, gpt_chunk=gpt_chunk, output_bnd_fluxes=False,
            n_gauss_angles=1, with_clouds=True, cellw=cellw,
            layer_major=layer_major, clear_sky=clear_sky)
        zeros = torch.zeros_like(lwp)
        sw = _solve_sw_impl(
            kd_sw, clut_sw, None, p_lay, p_lev, t_lay, vmr, col_dry,
            sfc_alb_dir, sfc_alb_dif, tsi_scaling, mu0, lwp, iwp, rel, dei,
            zeros, torch.zeros(lwp.shape + (11,), dtype=dtype, device=device),
            top_at_1=False, gpt_chunk=gpt_chunk, output_bnd_fluxes=False,
            with_clouds=True, with_aerosols=False,
            delta_cloud=True, delta_aerosol=False, cellw=cellw,
            layer_major=layer_major, clear_sky=clear_sky)
        return {**lw, **sw}

    return step
