"""Case input-file generation in the reference's ``rte_rrtmgp_input.nc``
format (variables/dims per ``src_test/test_rte_rrtmgp.cpp:208-293``)."""

from __future__ import annotations

import numpy as np

from ..utils.ncio import NcWriter
from .profiles import make_atmosphere


def write_input_nc(path: str, atm: dict, n_col_x: int, n_col_y: int = 1,
                   nbnd_lw: int = 16, nbnd_sw: int = 14,
                   with_clouds: bool = True, with_aerosols: bool = False,
                   rt_grid: dict = None):
    """Write an atmosphere dict (from ``make_atmosphere``) as a reference-
    format input file.  Column index = y*nx + x; field layout (lay, y, x)."""
    ncol, nlay = atm["p_lay"].shape
    assert ncol == n_col_x * n_col_y, (ncol, n_col_x, n_col_y)
    nlev = nlay + 1

    def to_zyx(a, nz):
        return np.asarray(a).T.reshape(nz, n_col_y, n_col_x)

    with NcWriter(path) as nc:
        nc.def_dim("x", n_col_x)
        nc.def_dim("y", n_col_y)
        nc.def_dim("lay", nlay)
        nc.def_dim("lev", nlev)
        nc.def_dim("band_lw", nbnd_lw)
        nc.def_dim("band_sw", nbnd_sw)

        nc.write("z_lay", atm["z_lay"], ("lay",))
        nc.write("z_lev", atm["z_lev"], ("lev",))
        nc.write("p_lay", to_zyx(atm["p_lay"], nlay), ("lay", "y", "x"))
        nc.write("t_lay", to_zyx(atm["t_lay"], nlay), ("lay", "y", "x"))
        nc.write("p_lev", to_zyx(atm["p_lev"], nlev), ("lev", "y", "x"))
        nc.write("t_lev", to_zyx(atm["t_lev"], nlev), ("lev", "y", "x"))

        gc = atm["gas_concs"]
        for gas in gc.names():
            v = gc.get_vmr(gas)
            if v.ndim == 0:
                nc.write_scalar(f"vmr_{gas}", float(v))
            elif v.ndim == 1:
                nc.write(f"vmr_{gas}", v, ("lay",))
            else:
                nc.write(f"vmr_{gas}", to_zyx(v, nlay), ("lay", "y", "x"))

        nc.write("emis_sfc",
                 np.full((n_col_y, n_col_x, nbnd_lw), atm["emis_sfc"]),
                 ("y", "x", "band_lw"))
        nc.write("t_sfc", atm["t_sfc"].reshape(n_col_y, n_col_x), ("y", "x"))

        # 3D ray-traced cases have ONE sun: the tracer takes a single
        # direction (reference uses mu0({1}), Radiation_solver_rt.cu), so a
        # per-column mu0 would make the 1D two-stream inconsistent with it.
        mu0 = (np.full(ncol, np.cos(rt_grid.get("sza", 0.5)))
               if rt_grid is not None else atm["mu0"])
        nc.write("mu0", mu0.reshape(n_col_y, n_col_x), ("y", "x"))
        nc.write("sfc_alb_dir",
                 np.full((n_col_y, n_col_x, nbnd_sw), atm["sfc_alb_dir"]),
                 ("y", "x", "band_sw"))
        nc.write("sfc_alb_dif",
                 np.full((n_col_y, n_col_x, nbnd_sw), atm["sfc_alb_dif"]),
                 ("y", "x", "band_sw"))

        if with_clouds:
            for k in ("lwp", "iwp", "rel", "dei"):
                nc.write(k, to_zyx(atm[k], nlay), ("lay", "y", "x"))
        if with_aerosols:
            nc.write("rh", to_zyx(atm["rh"], nlay), ("lay", "y", "x"))
            for i in range(11):
                nc.write(f"aermr{i+1:02d}", to_zyx(atm["aermr"][:, :, i], nlay),
                         ("lay", "y", "x"))

        if rt_grid is not None:
            # 3D ray-tracing grid (test_rte_rrtmgp_rt.cu:327-346): uniform
            # x/y spacing, z from the case grid, null-grid dims, sun angles.
            nz = rt_grid["nz"]
            dx = rt_grid.get("dx", 1000.0)
            dy = rt_grid.get("dy", 1000.0)
            nc.write("x", (np.arange(n_col_x) + 0.5) * dx, ("x",))
            nc.write("y", (np.arange(n_col_y) + 0.5) * dy, ("y",))
            nc.write("z", np.asarray(atm["z_lay"][:nz]), ("z",))
            for name, val in (("ngrid_x", rt_grid.get("ngrid_x", 2)),
                              ("ngrid_y", rt_grid.get("ngrid_y", 2)),
                              ("ngrid_z", rt_grid.get("ngrid_z", 4)),
                              ("sza", rt_grid.get("sza", 0.5)),
                              ("azi", rt_grid.get("azi", 0.0))):
                nc.write_scalar(name, val)


def make_case_files(workdir: str, case: str = "allsky", seed: int = 0,
                    gpt_per_band: int = 16):
    """Generate input + coefficient files for a named case in ``workdir``.

    Cases (sizes per SURVEY.md par.6):
      * allsky:  24 x 1 columns, 72 layers, idealized clouds
      * rcemip:  64 x 64 columns, 256 layers (throughput case, reference
        rcemip/test_rcemip_input.py:5-8 scale)
      * rfmip:   100 x 18 columns, 60 layers (clear-sky accuracy case)
    """
    import os

    from ..data import synthetic

    specs = {
        "allsky": dict(nx=24, ny=1, nlay=72, perturb=False, clouds=True, aerosols=False),
        "rcemip": dict(nx=64, ny=64, nlay=256, perturb=True, clouds=True, aerosols=False),
        "rfmip": dict(nx=100, ny=18, nlay=60, perturb=True, clouds=False, aerosols=False),
        "aerosky": dict(nx=24, ny=1, nlay=72, perturb=False, clouds=True, aerosols=True),
    }
    spec = specs[case]
    os.makedirs(workdir, exist_ok=True)
    atm = make_atmosphere(spec["nx"] * spec["ny"], spec["nlay"], seed=seed,
                          perturb=spec["perturb"])
    paths = {}
    paths["input"] = os.path.join(workdir, "rte_rrtmgp_input.nc")
    write_input_nc(paths["input"], atm, spec["nx"], spec["ny"],
                   with_clouds=spec["clouds"], with_aerosols=spec["aerosols"])

    paths["coefs_lw"] = os.path.join(workdir, "coefficients_lw.nc")
    paths["coefs_sw"] = os.path.join(workdir, "coefficients_sw.nc")
    synthetic.write_kdist_nc(paths["coefs_lw"],
                             synthetic.make_kdist_raw(True, gpt_per_band=gpt_per_band))
    synthetic.write_kdist_nc(paths["coefs_sw"],
                             synthetic.make_kdist_raw(False, gpt_per_band=gpt_per_band))
    paths["cloud_lw"] = os.path.join(workdir, "cloud_coefficients_lw.nc")
    paths["cloud_sw"] = os.path.join(workdir, "cloud_coefficients_sw.nc")
    synthetic.write_cloud_nc(paths["cloud_lw"], synthetic.make_cloud_raw(True))
    synthetic.write_cloud_nc(paths["cloud_sw"], synthetic.make_cloud_raw(False))
    paths["aerosol"] = os.path.join(workdir, "aerosol_optics.nc")
    synthetic.write_aerosol_nc(paths["aerosol"], synthetic.make_aerosol_raw())
    return paths


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Generate case input files")
    p.add_argument("case", choices=["allsky", "rcemip", "rfmip", "aerosky"])
    p.add_argument("--workdir", default=".")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gpt-per-band", type=int, default=16)
    args = p.parse_args(argv)
    paths = make_case_files(args.workdir, args.case, args.seed, args.gpt_per_band)
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
