"""RFMIP-style multi-experiment runner.

The reference's RFMIP case drives 18 experiments x 100 sites x 60 layers
from the official RFMIP input file and packs rld/rlu/rsd/rsu output files
(``rfmip/rfmip_init.py``, ``rfmip/rfmip_run.py``).  The official data is not
redistributable with this repo, so this runner generates the same *shape* of
workload from the analytic atmosphere generator — one perturbed experiment
per seed — runs the clear-sky LW+SW solve per experiment in float32, and
packs the four RFMIP flux variables with the official (expt, lev, site)
layout so the downstream checker tooling is exercised end to end.

Usage: python -m rte_rrtmgp_torch.cases.rfmip --workdir work/ [--experiments 18]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import config
from ..models import GasConcs, KDist, RadiationSolverLW, RadiationSolverSW
from ..utils import status
from ..utils.ncio import NcWriter
from .profiles import make_atmosphere


def run(workdir: str, n_experiments: int = 18, n_sites: int = 100,
        n_layers: int = 60, gpt_per_band: int = 16, seed: int = 0,
        device=None) -> str:
    """Run the sweep on ``device`` (default ``cuda``) and return the path of
    ``rfmip_fluxes.nc``."""
    from ..data import synthetic

    device = config.resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    coefs_lw = os.path.join(workdir, "coefficients_lw.nc")
    coefs_sw = os.path.join(workdir, "coefficients_sw.nc")
    if not os.path.exists(coefs_lw):
        synthetic.write_kdist_nc(coefs_lw, synthetic.make_kdist_raw(
            True, gpt_per_band=gpt_per_band))
    if not os.path.exists(coefs_sw):
        synthetic.write_kdist_nc(coefs_sw, synthetic.make_kdist_raw(
            False, gpt_per_band=gpt_per_band))

    atm0 = make_atmosphere(n_sites, n_layers, seed=seed, perturb=True)
    gases = atm0["gas_concs"].names()
    f32 = torch.float32
    kd_lw = KDist.from_netcdf(coefs_lw, gases, dtype=f32, device=device)
    kd_sw = KDist.from_netcdf(coefs_sw, gases, dtype=f32, device=device)
    lw = RadiationSolverLW(kd_lw)
    sw = RadiationSolverSW(kd_sw)

    nlev = n_layers + 1
    rld = np.zeros((n_experiments, nlev, n_sites), np.float32)
    rlu = np.zeros_like(rld)
    rsd = np.zeros_like(rld)
    rsu = np.zeros_like(rld)

    host = lambda t: t.cpu().numpy()
    for expt in range(n_experiments):
        t0 = time.perf_counter()
        atm = make_atmosphere(n_sites, n_layers, seed=seed + 1000 + expt,
                              perturb=True)
        gc: GasConcs = atm["gas_concs"]
        ncol = n_sites
        emis = np.full((ncol, kd_lw.nbnd), atm["emis_sfc"], np.float32)
        out_lw = lw.solve(
            gas_concs=gc, p_lay=atm["p_lay"], p_lev=atm["p_lev"],
            t_lay=atm["t_lay"], t_lev=atm["t_lev"], t_sfc=atm["t_sfc"],
            emis_sfc=emis, dtype=f32)
        alb = np.full((ncol, kd_sw.nbnd), atm["sfc_alb_dir"], np.float32)
        out_sw = sw.solve(
            gas_concs=gc, p_lay=atm["p_lay"], p_lev=atm["p_lev"],
            t_lay=atm["t_lay"], mu0=atm["mu0"], sfc_alb_dir=alb,
            sfc_alb_dif=alb, dtype=f32)
        rld[expt] = host(out_lw["lw_flux_dn"]).T
        rlu[expt] = host(out_lw["lw_flux_up"]).T
        rsd[expt] = host(out_sw["sw_flux_dn"]).T
        rsu[expt] = host(out_sw["sw_flux_up"]).T
        status.print_message(
            f"experiment {expt + 1}/{n_experiments}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    out_path = os.path.join(workdir, "rfmip_fluxes.nc")
    with NcWriter(out_path) as nc:
        nc.def_dim("expt", n_experiments)
        nc.def_dim("level", nlev)
        nc.def_dim("site", n_sites)
        for name, arr, long_name in (
                ("rld", rld, "downwelling longwave flux"),
                ("rlu", rlu, "upwelling longwave flux"),
                ("rsd", rsd, "downwelling shortwave flux"),
                ("rsu", rsu, "upwelling shortwave flux")):
            nc.write(name, arr, ("expt", "level", "site"),
                     attrs={"long_name": long_name, "units": "W m-2"})
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="RFMIP-style experiment sweep")
    p.add_argument("--workdir", default=".")
    p.add_argument("--experiments", type=int, default=18)
    p.add_argument("--sites", type=int, default=100)
    p.add_argument("--layers", type=int, default=60)
    p.add_argument("--gpt-per-band", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    path = run(args.workdir, args.experiments, args.sites, args.layers,
               args.gpt_per_band, args.seed, device=args.device)
    status.print_message(f"fluxes: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
