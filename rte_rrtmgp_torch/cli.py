"""Command-line driver — the port's ``test_rte_rrtmgp``.

Reads ``rte_rrtmgp_input.nc`` (same conventions as
``src_test/test_rte_rrtmgp.cpp:208-293``: x/y/lay/lev grids, ``vmr_<gas>``
variables that may be scalar / profile / full-field, optional ``col_dry``,
cloud fields lwp/iwp/rel/dei, aerosol rh + aermr01..11, LW and SW boundary
conditions), runs the requested solvers, and writes
``rte_rrtmgp_output.nc`` (classic NetCDF) with the reference's variable
names and dimension orders (`:296-631`).

Flags are those of the JAX package's CLI (the reference's `:105-168` plus
--gpt-chunk and --precision), and ``--device``: ``cuda`` (default) or
``cpu``.  Without a card the CLI raises unless given ``--device cpu``.  The
card's kernels are float32 only: ``--precision float64`` on the card runs
their plain twins there, as the JAX package runs XLA for float64.

Usage:  python -m rte_rrtmgp_torch.cli [--no-shortwave] [--cloud-optics] ...
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import config
from .models import (AerosolLUT, CloudLUT, GasConcs, KDist,
                     RadiationSolverLW, RadiationSolverSW)
from .models.radiation import _host
from .utils import status
from .utils.ncio import NcReader, NcWriter

GAS_NAMES_ALL = [
    "h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2",
    "ccl4", "cfc11", "cfc12", "cfc22", "hfc143a", "hfc125", "hfc23",
    "hfc32", "hfc134a", "cf4", "no2",
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rte_rrtmgp_torch",
        description="RTE+RRTMGP radiation solver (PyTorch/CUDA)")

    def flag(name, default, help):
        dest = name.replace("-", "_")
        p.add_argument(f"--{name}", dest=dest, action="store_true",
                       help=help + f" (default: {default})")
        p.add_argument(f"--no-{name}", dest=dest, action="store_false")
        p.set_defaults(**{dest: default})

    flag("shortwave", True, "enable shortwave solver")
    flag("longwave", True, "enable longwave solver")
    flag("fluxes", True, "compute fluxes")
    flag("cloud-optics", False, "enable cloud optics")
    flag("aerosol-optics", False, "enable aerosol optics")
    flag("output-optical", False, "write tau/ssa/g and sources per g-point")
    flag("output-bnd-fluxes", False, "write per-band fluxes")
    flag("delta-cloud", False, "delta-scale cloud optics")
    flag("delta-aerosol", False, "delta-scale aerosol optics")
    flag("profiling", False, "trace one extra solve with torch.profiler "
         "(a chrome trace beside the output file)")
    p.add_argument("--timings", type=int, default=0, metavar="N",
                   help="repeat each solve N extra times and report stats")
    p.add_argument("--gpt-chunk", type=int, default=None,
                   help="spectral chunk size (memory/perf knob)")
    p.add_argument("--precision", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--input", default="rte_rrtmgp_input.nc")
    p.add_argument("--output", default="rte_rrtmgp_output.nc")
    p.add_argument("--coefs-lw", default="coefficients_lw.nc")
    p.add_argument("--coefs-sw", default="coefficients_sw.nc")
    p.add_argument("--cloud-lw", default="cloud_coefficients_lw.nc")
    p.add_argument("--cloud-sw", default="cloud_coefficients_sw.nc")
    p.add_argument("--aerosol", default="aerosol_optics.nc")
    return p


def _read_field(nc: NcReader, name: str, nlay: int, ncol: int):
    """Read a (lay, y, x) field into (ncol, nlay) (column = y*nx + x)."""
    arr = nc.read(name)
    return arr.reshape(nlay, ncol).T.copy()


def _read_vmr(nc: NcReader, gas: str, gas_concs: GasConcs, nlay, ncol):
    name = f"vmr_{gas}"
    if not nc.has(name):
        return
    arr = np.asarray(nc.read(name))
    if arr.ndim == 0:
        gas_concs.set_vmr(gas, float(arr))
    elif arr.ndim == 1:
        gas_concs.set_vmr(gas, arr)
    else:
        gas_concs.set_vmr(gas, arr.reshape(nlay, ncol).T.copy())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = config.resolve_device(args.device)
    dtype = torch.float32 if args.precision == "float32" else torch.float64

    status.print_message("Reading atmospheric input data from NetCDF.")
    inp = NcReader(args.input)
    nx, ny = inp.dim("x"), inp.dim("y")
    ncol = nx * ny
    nlay, nlev = inp.dim("lay"), inp.dim("lev")

    p_lay = _read_field(inp, "p_lay", nlay, ncol)
    t_lay = _read_field(inp, "t_lay", nlay, ncol)
    p_lev = _read_field(inp, "p_lev", nlev, ncol)
    t_lev = _read_field(inp, "t_lev", nlev, ncol)
    col_dry = (_read_field(inp, "col_dry", nlay, ncol)
               if inp.has("col_dry") else None)

    gas_concs = GasConcs()
    for gas in GAS_NAMES_ALL:
        _read_vmr(inp, gas, gas_concs, nlay, ncol)

    clouds = {}
    if args.cloud_optics:
        for k in ("lwp", "iwp", "rel", "dei"):
            clouds[k] = _read_field(inp, k, nlay, ncol)

    aerosols = {}
    if args.aerosol_optics:
        aerosols["rh"] = _read_field(inp, "rh", nlay, ncol)
        aermr = np.zeros((ncol, nlay, 11))
        for i in range(11):
            arr = np.asarray(inp.read(f"aermr{i+1:02d}"))
            if arr.ndim <= 1:
                aermr[:, :, i] = float(arr.reshape(-1)[0])
            else:
                aermr[:, :, i] = arr.reshape(nlay, ncol).T
        aerosols["aermr"] = aermr

    status.print_message("Preparing NetCDF output file.")
    out_nc = NcWriter(args.output)
    out_nc.def_dim("x", nx)
    out_nc.def_dim("y", ny)
    out_nc.def_dim("lay", nlay)
    out_nc.def_dim("lev", nlev)
    out_nc.def_dim("pair", 2)
    out_nc.write("p_lay", p_lay.T.reshape(nlay, ny, nx), ("lay", "y", "x"))
    out_nc.write("p_lev", p_lev.T.reshape(nlev, ny, nx), ("lev", "y", "x"))

    def w2(name, arr, zdim="lev"):  # (ncol, nz) -> (z, y, x)
        nz = arr.shape[1]
        out_nc.write(name, _host(arr).T.reshape(nz, ny, nx), (zdim, "y", "x"))

    def w3(name, arr, zdim, sdim):  # (ncol, nz, ns) -> (s, z, y, x)
        _, nz, ns = arr.shape
        out_nc.write(name, _host(arr).transpose(2, 1, 0).reshape(ns, nz, ny, nx),
                     (sdim, zdim, "y", "x"))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run_with_timing(label, f):
        t0 = time.perf_counter()
        out = f()
        sync()
        status.print_message(
            f"Duration {label} solver: {(time.perf_counter()-t0)*1e3:.2f} (ms)")
        if args.timings:
            ts = []
            for _ in range(args.timings):
                t0 = time.perf_counter()
                f()
                sync()
                ts.append(time.perf_counter() - t0)
            status.print_message(
                f"{label} timings over {args.timings} runs: "
                f"min {min(ts)*1e3:.2f} ms, mean {np.mean(ts)*1e3:.2f} ms")
        if args.profiling:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=acts) as prof:
                f()
                sync()
            path = f"{os.path.splitext(args.output)[0]}_{label}_trace.json"
            prof.export_chrome_trace(path)
            status.print_message(f"Profiler trace in {path}")
        return out

    if args.longwave:
        status.print_message("Initializing the longwave solver.")
        kd_lw = KDist.from_netcdf(args.coefs_lw, gas_concs.names(),
                                  dtype=dtype, device=device)
        clut = (CloudLUT.from_netcdf(args.cloud_lw, dtype=dtype, device=device)
                if args.cloud_optics else None)
        solver = RadiationSolverLW(kd_lw, clut)

        emis_sfc = np.asarray(inp.read("emis_sfc")).reshape(ncol, kd_lw.nbnd)
        t_sfc = np.asarray(inp.read("t_sfc")).reshape(ncol)

        status.print_message("Solving the longwave radiation.")
        out = run_with_timing("longwave", lambda: solver.solve(
            gas_concs=gas_concs, p_lay=p_lay, p_lev=p_lev, t_lay=t_lay,
            t_lev=t_lev, t_sfc=t_sfc, emis_sfc=emis_sfc, col_dry=col_dry,
            gpt_chunk=args.gpt_chunk,
            output_bnd_fluxes=args.output_bnd_fluxes,
            output_optical=args.output_optical, with_fluxes=args.fluxes,
            dtype=dtype, **clouds))

        status.print_message("Storing the longwave output.")
        out_nc.def_dim("gpt_lw", kd_lw.ngpt)
        out_nc.def_dim("band_lw", kd_lw.nbnd)
        out_nc.write("lw_band_lims_wvn", np.asarray(kd_lw.band_lims_wvn),
                     ("band_lw", "pair"))
        if args.output_optical:
            out_nc.write("lw_band_lims_gpt",
                         np.asarray(kd_lw.band_lims_gpt) + [[1, 0]],
                         ("band_lw", "pair"))
            w3("lw_tau", out["lw_tau"], "lay", "gpt_lw")
            w3("lay_source", out["lay_source"], "lay", "gpt_lw")
            w3("lev_source", out["lev_source"], "lev", "gpt_lw")
            out_nc.write("sfc_source",
                         _host(out["sfc_source"]).T.reshape(kd_lw.ngpt, ny, nx),
                         ("gpt_lw", "y", "x"))
        if args.fluxes:
            for k in ("lw_flux_up", "lw_flux_dn", "lw_flux_net"):
                w2(k, out[k])
            if args.output_bnd_fluxes:
                for k in ("lw_bnd_flux_up", "lw_bnd_flux_dn", "lw_bnd_flux_net"):
                    w3(k, out[k], "lev", "band_lw")

    if args.shortwave:
        status.print_message("Initializing the shortwave solver.")
        kd_sw = KDist.from_netcdf(args.coefs_sw, gas_concs.names(),
                                  dtype=dtype, device=device)
        clut = (CloudLUT.from_netcdf(args.cloud_sw, dtype=dtype, device=device)
                if args.cloud_optics else None)
        alut = (AerosolLUT.from_netcdf(args.aerosol, dtype=dtype, device=device)
                if args.aerosol_optics else None)
        solver = RadiationSolverSW(kd_sw, clut, alut)

        mu0 = np.asarray(inp.read("mu0")).reshape(ncol)
        alb_dir = np.asarray(inp.read("sfc_alb_dir")).reshape(ncol, kd_sw.nbnd)
        alb_dif = np.asarray(inp.read("sfc_alb_dif")).reshape(ncol, kd_sw.nbnd)
        if inp.has("tsi"):
            tsi = np.asarray(inp.read("tsi")).reshape(ncol)
            tsi_scaling = tsi / kd_sw.total_solar_irradiance()
        elif inp.has("tsi_scaling"):
            tsi_scaling = np.full(ncol, float(np.asarray(inp.read("tsi_scaling"))))
        else:
            tsi_scaling = np.ones(ncol)

        status.print_message("Solving the shortwave radiation.")
        out = run_with_timing("shortwave", lambda: solver.solve(
            gas_concs=gas_concs, p_lay=p_lay, p_lev=p_lev, t_lay=t_lay,
            mu0=mu0, sfc_alb_dir=alb_dir, sfc_alb_dif=alb_dif,
            tsi_scaling=tsi_scaling, col_dry=col_dry,
            gpt_chunk=args.gpt_chunk,
            output_bnd_fluxes=args.output_bnd_fluxes,
            output_optical=args.output_optical, with_fluxes=args.fluxes,
            delta_cloud=args.delta_cloud, delta_aerosol=args.delta_aerosol,
            dtype=dtype, **clouds, **aerosols))

        status.print_message("Storing the shortwave output.")
        out_nc.def_dim("gpt_sw", kd_sw.ngpt)
        out_nc.def_dim("band_sw", kd_sw.nbnd)
        out_nc.write("sw_band_lims_wvn", np.asarray(kd_sw.band_lims_wvn),
                     ("band_sw", "pair"))
        if args.output_optical:
            out_nc.write("sw_band_lims_gpt",
                         np.asarray(kd_sw.band_lims_gpt) + [[1, 0]],
                         ("band_sw", "pair"))
            w3("sw_tau", out["sw_tau"], "lay", "gpt_sw")
            w3("ssa", out["ssa"], "lay", "gpt_sw")
            w3("g", out["g"], "lay", "gpt_sw")
            out_nc.write("toa_source",
                         _host(out["toa_source"]).T.reshape(kd_sw.ngpt, ny, nx),
                         ("gpt_sw", "y", "x"))
        if args.fluxes:
            for k in ("sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir", "sw_flux_net"):
                w2(k, out[k])
            if args.output_bnd_fluxes:
                for k in ("sw_bnd_flux_up", "sw_bnd_flux_dn",
                          "sw_bnd_flux_dn_dir", "sw_bnd_flux_net"):
                    w3(k, out[k], "lev", "band_sw")

    inp.close()
    out_nc.close()
    status.print_message("Finished.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
