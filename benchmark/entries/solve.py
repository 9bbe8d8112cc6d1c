"""The public solver classes, as the CLI and the RFMIP case call them:
``RadiationSolverLW(kd_lw, clut_lw).solve(...)`` then
``RadiationSolverSW(kd_sw, clut_sw).solve(...)`` with their defaults
(``check_inputs=True``, ``gpt_chunk=None``, no delta scaling), on NumPy
float32 arrays on the host and a ``GasConcs`` of NumPy vmr (what the CLI
hands them after reading NetCDF); the broadband fluxes come back to NumPy
within the call."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs import atmosphere
from benchmark.trace import span

RUNS = {"clouds": True, "aerosols": False, "n_gauss_angles": 1}


class Entry:
    def __init__(self, cell, device):
        from rte_rrtmgp_torch.models.cloud_lut import CloudLUT
        from rte_rrtmgp_torch.models.gas_concs import GasConcs
        from rte_rrtmgp_torch.models.kdist import KDist
        from rte_rrtmgp_torch.models.radiation import (RadiationSolverLW,
                                                       RadiationSolverSW)

        self.device = torch.device(device)
        dt = cell.dtype
        r = cell.raws
        self.lw = RadiationSolverLW(
            KDist.from_raw(r["kd_lw"], cell.gases, dtype=dt,
                           device=self.device),
            CloudLUT.from_raw(r["cloud_lw"], dtype=dt, device=self.device))
        self.sw = RadiationSolverSW(
            KDist.from_raw(r["kd_sw"], cell.gases, dtype=dt,
                           device=self.device),
            CloudLUT.from_raw(r["cloud_sw"], dtype=dt, device=self.device))
        atm = cell.atm
        ncol = atm["p_lay"].shape[0]
        self.vmr, self.gases = atm["vmr"], cell.gases
        self.gas = GasConcs()
        for g in cell.gases:
            self.gas.set_vmr(g, atm["vmr"][g])
        npdt = torch.empty((), dtype=dt).numpy().dtype
        c = lambda a: np.asarray(a, npdt)
        self.x = {k: c(atm[k]) for k in ("p_lay", "p_lev", "t_lay", "t_lev",
                                         "t_sfc", "lwp", "iwp", "rel", "dei",
                                         "mu0")}
        self.x["emis_sfc"] = np.full((ncol, atmosphere.NBND_LW), 0.98, npdt)
        self.x["sfc_alb"] = np.full((ncol, atmosphere.NBND_SW), 0.06, npdt)
        self.delta_cloud = False

    def call(self):
        x = self.x
        clouds = dict(lwp=x["lwp"], iwp=x["iwp"], rel=x["rel"], dei=x["dei"])
        with span("lw_solve"):
            lw = self.lw.solve(self.gas, x["p_lay"], x["p_lev"], x["t_lay"],
                               x["t_lev"], x["t_sfc"], x["emis_sfc"], **clouds)
        with span("sw_solve"):
            sw = self.sw.solve(self.gas, x["p_lay"], x["p_lev"], x["t_lay"],
                               x["mu0"], x["sfc_alb"], x["sfc_alb"], **clouds)
        out = {k: v.cpu().numpy() for k, v in {**lw, **sw}.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def reference_inputs(self) -> dict:
        x = self.x
        ncol, nlay = x["p_lay"].shape
        ref = {k: x[k] for k in ("p_lay", "p_lev", "t_lay", "t_lev", "t_sfc",
                                 "lwp", "iwp", "rel", "dei", "mu0",
                                 "emis_sfc")}
        ref.update(vmr=atmosphere.vmr_field(self.vmr, ncol, nlay, self.gases),
                   gases=self.gases, col_dry=None, sfc_alb_dir=x["sfc_alb"],
                   sfc_alb_dif=x["sfc_alb"],
                   tsi_scaling=np.ones((ncol,), x["mu0"].dtype))
        return ref

    def close(self):
        self.lw = self.sw = None
