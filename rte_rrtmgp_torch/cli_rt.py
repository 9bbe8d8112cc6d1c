"""3D forward ray-tracing CLI — the port's ``test_rte_rrtmgp_rt``.

Reads ``rte_rrtmgp_input.nc`` with the z grid and null-grid dims
(``src_test/test_rte_rrtmgp_rt.cu:327-346``), runs the shortwave solver
with per-g-point Monte-Carlo ray tracing (and optionally the 1D two-stream
pass and the 1D longwave solve), writes the ray-traced fluxes.

Flags, files and output variables are those of the JAX package's
``cli_rt`` (the reference's `:227-247`), in float32, plus ``--device``:
``cuda`` (default) or ``cpu``; without a card the CLI raises unless given
``--device cpu``.  ``--gpt-per-dispatch N`` traces the g-points in windows
of N that chain the accumulators (equal to one window up to accumulation
order); ``auto`` and ``off`` trace them in one window.  ``--seed`` seeds
the tracer: g-point ``igpt`` draws from the stream of ``seed + igpt``.
``--profiling`` traces one extra solve with torch.profiler and writes a
chrome trace ``<output>_rt_trace.json``.

Usage:  python -m rte_rrtmgp_torch.cli_rt [--raytracing N] [--two-stream] ...
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import config
from .cli import GAS_NAMES_ALL, _read_field, _read_vmr
from .models import AerosolLUT, CloudLUT, GasConcs, KDist, RadiationSolverLW
from .models.radiation import _host
from .models.radiation_rt import RadiationSolverRT
from .utils import status
from .utils.ncio import NcReader, NcWriter


def _dispatch(s: str):
    return None if s in ("auto", "off") else int(s)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rte_rrtmgp_rt")
    p.add_argument("--raytracing", type=int, default=32,
                   help="photons per pixel")
    p.add_argument("--two-stream", action="store_true")
    p.add_argument("--output-bnd-fluxes", action="store_true",
                   help="also write per-band fluxes (Fluxes_byband_rt)")
    p.add_argument("--independent-column", action="store_true")
    p.add_argument("--cloud-optics", action="store_true")
    p.add_argument("--liq-cloud-optics", action="store_true")
    p.add_argument("--ice-cloud-optics", action="store_true")
    p.add_argument("--aerosol-optics", action="store_true")
    p.add_argument("--delta-cloud", action="store_true")
    p.add_argument("--delta-aerosol", action="store_true")
    p.add_argument("--tica", action="store_true",
                   help="tilt columns along the sun ray and solve 1D "
                        "(forces independent-column)")
    p.add_argument("--longwave", action="store_true",
                   help="also run the 1D longwave solver (no LW ray "
                        "tracing, matching the reference)")
    p.add_argument("--cloud-mie", action="store_true",
                   help="sample cloud scattering from Mie phase LUTs")
    p.add_argument("--mie-file", default="mie_lut_broadband.nc")
    p.add_argument("--gpt-per-dispatch", default="auto", type=_dispatch,
                   help="g-points a window of the Monte-Carlo loop: an "
                        "integer, or 'auto' / 'off' (one window)")
    p.add_argument("--spectral-mode", choices=("scan", "lanes"),
                   default="scan",
                   help="per-window spectral execution: g-points one after "
                        "another, or all in one batched photon loop")
    p.add_argument("--single-gpt", type=int, default=None, metavar="G",
                   help="trace only g-point G (1-based)")
    p.add_argument("--profiling", action="store_true",
                   help="trace one extra solve with torch.profiler (a "
                        "chrome trace beside the output file)")
    p.add_argument("--coefs-lw", default="coefficients_lw.nc")
    p.add_argument("--cloud-lw", default="cloud_coefficients_lw.nc")
    p.add_argument("--gpt-chunk", type=int, default=None)
    p.add_argument("--input", default="rte_rrtmgp_input.nc")
    p.add_argument("--output", default="rte_rrtmgp_output.nc")
    p.add_argument("--coefs-sw", default="coefficients_sw.nc")
    p.add_argument("--cloud-sw", default="cloud_coefficients_sw.nc")
    p.add_argument("--aerosol", default="aerosol_optics.nc")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = config.resolve_device(args.device)
    f32 = torch.float32

    status.print_message("Reading atmospheric input data from NetCDF.")
    inp = NcReader(args.input)
    nx, ny = inp.dim("x"), inp.dim("y")
    ncol = nx * ny
    nlay, nlev = inp.dim("lay"), inp.dim("lev")
    nz = inp.dim("z")

    grid_x, grid_y, grid_z = inp.read("x"), inp.read("y"), inp.read("z")
    dxy = lambda g: float(g[1] - g[0]) if len(g) > 1 else float(2 * g[0])
    grid_d = (dxy(grid_z), dxy(grid_y), dxy(grid_x))
    kn_grid = (int(inp.read_scalar("ngrid_z")), int(inp.read_scalar("ngrid_y")),
               int(inp.read_scalar("ngrid_x")))

    p_lay = _read_field(inp, "p_lay", nlay, ncol)
    t_lay = _read_field(inp, "t_lay", nlay, ncol)
    p_lev = _read_field(inp, "p_lev", nlev, ncol)
    t_lev = _read_field(inp, "t_lev", nlev, ncol)

    gas_concs = GasConcs()
    for gas in GAS_NAMES_ALL:
        _read_vmr(inp, gas, gas_concs, nlay, ncol)

    mu0 = np.asarray(inp.read("mu0")).reshape(ncol) if inp.has("mu0") \
        else np.full(ncol, float(np.cos(inp.read_scalar("sza"))))
    azi_v = (float(np.asarray(inp.read("azi")).reshape(-1)[0])
             if inp.has("azi") else 0.0)
    azi = np.full(ncol, azi_v)

    clouds = {}
    clut = None
    if args.cloud_optics or args.liq_cloud_optics or args.ice_cloud_optics:
        if args.cloud_mie and (args.cloud_optics or args.ice_cloud_optics):
            raise SystemExit("--cloud-mie requires liquid-only cloud optics "
                             "(reference: 'Thou shall not use mie tables as "
                             "long as ice optics are enabled')")
        clut = CloudLUT.from_netcdf(args.cloud_sw, dtype=f32, device=device)
        for k in ("lwp", "iwp", "rel", "dei"):
            clouds[k] = _read_field(inp, k, nlay, ncol)
        if args.liq_cloud_optics and not args.cloud_optics:
            clouds["iwp"] = np.zeros_like(clouds["iwp"])
        if args.ice_cloud_optics and not args.cloud_optics:
            clouds["lwp"] = np.zeros_like(clouds["lwp"])
    alut = None
    aerosols = {}
    if args.aerosol_optics:
        alut = AerosolLUT.from_netcdf(args.aerosol, dtype=f32, device=device)
        aerosols["rh"] = _read_field(inp, "rh", nlay, ncol)
        aermr = np.zeros((ncol, nlay, 11), np.float32)
        for i in range(11):
            aermr[:, :, i] = _read_field(inp, f"aermr{i+1:02d}", nlay, ncol)
        aerosols["aermr"] = aermr

    kd = KDist.from_netcdf(args.coefs_sw, gas_concs.names(), dtype=f32,
                           device=device)
    alb_dir = np.asarray(inp.read("sfc_alb_dir")).reshape(ncol, kd.nbnd)
    alb_dif = np.asarray(inp.read("sfc_alb_dif")).reshape(ncol, kd.nbnd)
    emis_sfc = (np.asarray(inp.read("emis_sfc")).reshape(ncol, -1)
                if inp.has("emis_sfc") else None)
    t_sfc = (np.asarray(inp.read("t_sfc")).reshape(ncol)
             if inp.has("t_sfc") else None)
    inp.close()

    mie_cdf = mie_ang = None
    if args.cloud_mie:
        # mie_lut_broadband.nc: phase_cdf (nbnd, n_mie) descending, and
        # phase_cdf_angle (nbnd, n_re, n_mie) (Radiation_solver_rt.cu:652-666).
        with NcReader(args.mie_file) as mie_nc:
            mie_cdf = np.asarray(mie_nc.read("phase_cdf"), np.float32)
            mie_ang = np.asarray(mie_nc.read("phase_cdf_angle"), np.float32)

    independent_column = args.independent_column or args.tica
    if args.tica:
        status.print_message("Applying TICA tilt along the sun ray.")
        from .tools.tica_tilt import tica_tilt

        xh = np.arange(nx + 1) * grid_d[2]
        yh = np.arange(ny + 1) * grid_d[1]
        zh = np.arange(nz + 1) * grid_d[0]
        z = 0.5 * (zh[1:] + zh[:-1])
        fields = dict(clouds)
        if "rh" in aerosols:
            fields["rh"] = aerosols["rh"]
        for g in gas_concs.names():
            vv = gas_concs.get_vmr(g)
            if vv.ndim == 2:
                fields[f"vmr_{g}"] = vv
        sza = float(np.arccos(np.clip(mu0[0], -1, 1)))
        tilt = tica_tilt(sza, azi_v, nx, ny, xh, yh, zh, z, fields,
                         p_lay, t_lay, p_lev, t_lev)
        p_lay, t_lay = tilt["p_lay"], tilt["t_lay"]
        p_lev, t_lev = tilt["p_lev"], tilt["t_lev"]
        for k in list(clouds):
            clouds[k] = tilt["fields"][k]
        if "rh" in aerosols:
            aerosols["rh"] = tilt["fields"]["rh"]
        for g in gas_concs.names():
            if f"vmr_{g}" in tilt["fields"]:
                gas_concs.set_vmr(g, tilt["fields"][f"vmr_{g}"])
        nz = tilt["n_tilt"]
        nlay = p_lay.shape[1]
        nlev = nlay + 1
        # vertical direct beam after tilting
        mu0 = np.ones(ncol)

    solver = RadiationSolverRT(kd, clut, alut, mie_cdf=mie_cdf,
                               mie_ang=mie_ang)

    def solve():
        return solver.solve(
            gas_concs=gas_concs, p_lay=p_lay, p_lev=p_lev, t_lay=t_lay,
            mu0=mu0, azi=azi, sfc_alb_dir=alb_dir, sfc_alb_dif=alb_dif,
            grid_cells=(nz, ny, nx), grid_d=grid_d, kn_grid=kn_grid,
            photons_per_pixel=args.raytracing,
            independent_column=independent_column,
            twostream=args.two_stream, raytracing=True,
            delta_cloud=args.delta_cloud, delta_aerosol=args.delta_aerosol,
            gpt_chunk=args.gpt_chunk, single_gpt=args.single_gpt,
            gpt_per_dispatch=args.gpt_per_dispatch,
            spectral_mode=args.spectral_mode,
            output_bnd_fluxes=args.output_bnd_fluxes, seed=args.seed,
            dtype=f32, **clouds, **aerosols)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    status.print_message(f"Tracing {args.raytracing} photons per pixel.")
    t0 = time.perf_counter()
    out = solve()
    sync()
    status.print_message(
        f"Duration solver: {(time.perf_counter()-t0)*1e3:.2f} (ms)")
    if args.profiling:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            solve()
            sync()
        path = f"{os.path.splitext(args.output)[0]}_rt_trace.json"
        prof.export_chrome_trace(path)
        status.print_message(f"Profiler trace in {path}")

    lw_out = None
    if args.longwave:
        # 1D longwave on the same columns ("no longwave radiation implemented
        # in the ray tracer, yet" — test_rte_rrtmgp_rt.cu:279).
        status.print_message("Solving the longwave radiation (1D).")
        kd_lw = KDist.from_netcdf(args.coefs_lw, gas_concs.names(),
                                  dtype=f32, device=device)
        clut_lw = (CloudLUT.from_netcdf(args.cloud_lw, dtype=f32,
                                        device=device) if clouds else None)
        if emis_sfc is None:
            emis_sfc = np.full((ncol, kd_lw.nbnd), 0.98, np.float32)
        if t_sfc is None:
            t_sfc = t_lev[:, 0].copy()
        lw_out = RadiationSolverLW(kd_lw, clut_lw).solve(
            gas_concs=gas_concs, p_lay=p_lay, p_lev=p_lev, t_lay=t_lay,
            t_lev=t_lev, t_sfc=t_sfc, emis_sfc=emis_sfc,
            gpt_chunk=args.gpt_chunk, dtype=f32, **clouds)
        sync()

    status.print_message("Writing output.")
    with NcWriter(args.output) as w:
        w.def_dim("x", nx)
        w.def_dim("y", ny)
        # nz+1 when the atmosphere extends above the domain: the last layer
        # is the integrated above-domain (TOD) cell, matching the
        # reference's grid_cells.z = n_z_in+1 (test_rte_rrtmgp_rt.cu:334).
        w.def_dim("z", out.rt_flux_abs_dir.shape[0])
        w.def_dim("lev", nlev)
        for name in ("rt_flux_tod_dn", "rt_flux_tod_up", "rt_flux_sfc_dir",
                     "rt_flux_sfc_dif", "rt_flux_sfc_up"):
            w.write(name, _host(getattr(out, name)), ("y", "x"))
        w.write("rt_flux_abs_dir", _host(out.rt_flux_abs_dir), ("z", "y", "x"))
        w.write("rt_flux_abs_dif", _host(out.rt_flux_abs_dif), ("z", "y", "x"))
        if args.two_stream:
            for name in ("sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir"):
                arr = _host(getattr(out, name))  # (ncol, nlev)
                w.write(name, arr.T.reshape(nlev, ny, nx), ("lev", "y", "x"))
        if args.output_bnd_fluxes:
            w.def_dim("band_sw", kd.nbnd if args.single_gpt is None else 1)
            for name in ("rt_bnd_flux_tod_dn", "rt_bnd_flux_tod_up",
                         "rt_bnd_flux_sfc_dir", "rt_bnd_flux_sfc_dif",
                         "rt_bnd_flux_sfc_up"):
                w.write(name, _host(getattr(out, name)), ("band_sw", "y", "x"))
            if args.two_stream:
                for name in ("sw_bnd_flux_up", "sw_bnd_flux_dn",
                             "sw_bnd_flux_dn_dir"):
                    arr = _host(getattr(out, name))  # (ncol, nlev, nbnd)
                    w.write(name,
                            arr.transpose(2, 1, 0).reshape(-1, nlev, ny, nx),
                            ("band_sw", "lev", "y", "x"))
        if lw_out is not None:
            for name in ("lw_flux_up", "lw_flux_dn", "lw_flux_net"):
                arr = _host(lw_out[name])
                w.write(name, arr.T.reshape(nlev, ny, nx), ("lev", "y", "x"))
    status.print_message("Finished.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
