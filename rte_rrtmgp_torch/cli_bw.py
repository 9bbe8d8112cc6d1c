"""Backward (camera) ray-tracing CLI — the port's ``test_rte_rrtmgp_bw``.

Reads ``rte_rrtmgp_input.nc`` with the z grid, null-grid dims, ``z_lev``
and a "camera-settings" group (``src_test/test_rte_rrtmgp_bw.cu:300-335``;
an HDF5 group, or in a classic file the variables ``camera-settings.<name>``
that ``tools/set_virtual_camera.py`` writes), renders XYZ images or
broadband radiances, writes ``rte_rrtmgp_output.nc`` with "XYZ" /
"radiance" variables (and the ``--cloud-cam`` images).

Flags, files and output variables are those of the JAX package's
``cli_bw``, in float32, plus ``--device``: ``cuda`` (default) or ``cpu``;
without a card the CLI raises unless given ``--device cpu``.
``--steps-per-dispatch N`` renders the spectral steps in windows of N
(each window folds its first step into the key, as in JAX); ``auto`` and
``off`` render them in one window.  ``--seed`` seeds the render.
``--profiling`` traces one extra render with torch.profiler and writes a
chrome trace ``<output>_bw_trace.json``.

Usage: python -m rte_rrtmgp_torch.cli_bw [--image|--broadband]
           [--bw-raytracing N] [--cloud-optics] [--cloud-cam] ...
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import config
from .cli import GAS_NAMES_ALL, _read_field, _read_vmr
from .models import AerosolLUT, CloudLUT, GasConcs, KDist
from .models.radiation import _host
from .models.radiation_bw import RadiationSolverBW
from .tools.set_virtual_camera import read_camera
from .utils import status
from .utils.ncio import NcReader, NcWriter


def _dispatch(s: str):
    return None if s in ("auto", "off") else int(s)


def cloud_cam_images(camera, grid_d, grid_cells, kd, clut, clouds, device):
    """The ``--cloud-cam`` images (liquid+ice water path, cloud optical
    depth, distance to the first cloud, zenith) of ``camera``: the
    visible-band (441-615 nm) cloud optics of the (ncol, nlay) cloud
    fields ``clouds`` marched along the pixel-centre rays in float32 on
    ``device`` (Radiation_solver_bw.cu:1082-1103)."""
    from .models.raytracer_bw import accumulate_clouds
    from .ops import cloud_optics as cloud_ops

    nz, ny, nx = grid_cells
    band = int(np.argmin([abs(0.5 * (lo + hi) - 1.0e7 / 520.0)
                          for lo, hi in kd.band_lims_wvn]))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    cld = cloud_ops.cloud_optics_2str(clut, t(clouds["lwp"]), t(clouds["iwp"]),
                                      t(clouds["rel"]), t(clouds["dei"]))
    to3d = lambda a: a[:, :nz].T.reshape(nz, ny, nx)
    return accumulate_clouds(camera, grid_d, grid_cells,
                             to3d(t(clouds["lwp"])), to3d(t(clouds["iwp"])),
                             to3d(cld.tau[:, :, band]))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rte_rrtmgp_bw")
    p.add_argument("--image", action="store_true", default=True)
    p.add_argument("--broadband", dest="image", action="store_false")
    p.add_argument("--bw-raytracing", type=int, default=16,
                   help="photons per pixel")
    p.add_argument("--cloud-optics", action="store_true")
    p.add_argument("--liq-cloud-optics", action="store_true",
                   help="liquid-only cloud optics")
    p.add_argument("--ice-cloud-optics", action="store_true",
                   help="ice-only cloud optics")
    p.add_argument("--aerosol-optics", action="store_true")
    p.add_argument("--cloud-mie", action="store_true",
                   help="Mie cloud phase functions (sampling + sun NEE) "
                        "from --mie-file instead of Henyey-Greenstein")
    p.add_argument("--mie-file", default="mie_lut_broadband.nc")
    p.add_argument("--delta-cloud", action="store_true")
    p.add_argument("--delta-aerosol", action="store_true")
    p.add_argument("--cloud-cam", action="store_true",
                   help="accumulate per-pixel cloud water/optical-depth "
                        "images along the camera rays")
    p.add_argument("--profiling", action="store_true",
                   help="trace one extra render with torch.profiler (a "
                        "chrome trace beside the output file)")
    p.add_argument("--n-sub", type=int, default=3)
    p.add_argument("--nee-mode", choices=("walk", "field"), default="walk",
                   help="sun-transmission estimator: unbiased stochastic "
                        "walk (reference-exact) or the deterministic "
                        "tilted-field fast preview")
    p.add_argument("--steps-per-dispatch", default="auto", type=_dispatch,
                   help="spectral steps a window: an integer, or 'auto' / "
                        "'off' (one window)")
    p.add_argument("--spectral-mode", choices=("scan", "lanes"),
                   default="scan",
                   help="per-window spectral execution: steps one after "
                        "another, or all in one batched photon loop")
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
    z_lev = inp.read("z_lev")
    camera = read_camera(inp)

    p_lay = _read_field(inp, "p_lay", nlay, ncol)
    t_lay = _read_field(inp, "t_lay", nlay, ncol)
    p_lev = _read_field(inp, "p_lev", nlev, ncol)

    gas_concs = GasConcs()
    for gas in GAS_NAMES_ALL:
        _read_vmr(inp, gas, gas_concs, nlay, ncol)

    mu0 = np.asarray(inp.read("mu0")).reshape(ncol) if inp.has("mu0") \
        else np.full(ncol, float(np.cos(inp.read_scalar("sza"))))
    azi = np.full(ncol, float(np.asarray(inp.read("azi")).reshape(-1)[0]))
    land_use = (np.asarray(inp.read("land_use_map")).reshape(ncol)
                if inp.has("land_use_map") else np.ones(ncol))

    kd = KDist.from_netcdf(args.coefs_sw, gas_concs.names(), dtype=f32,
                           device=device)
    sfc_alb = np.asarray(inp.read("sfc_alb_dir")).reshape(ncol, kd.nbnd)

    with_any_cloud = (args.cloud_optics or args.liq_cloud_optics
                      or args.ice_cloud_optics or args.cloud_cam)
    clouds = {}
    clut = None
    if with_any_cloud:
        clut = CloudLUT.from_netcdf(args.cloud_sw, dtype=f32, device=device)
        for k in ("lwp", "iwp", "rel", "dei"):
            clouds[k] = _read_field(inp, k, nlay, ncol)
        # Phase-restricted optics: zeroing the other water path disables its
        # contribution exactly (tau is proportional to the path).
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
    inp.close()

    solve_clouds = dict(clouds)
    if not (args.cloud_optics or args.liq_cloud_optics
            or args.ice_cloud_optics):
        solve_clouds = {}
    mie_kw = {}
    if args.cloud_mie:
        if args.cloud_optics or args.ice_cloud_optics:
            raise SystemExit("--cloud-mie requires liquid-only cloud optics "
                             "(reference: 'Thou shall not use mie tables as "
                             "long as ice optics are not considered')")
        # mie_lut_broadband.nc: phase_cdf/phase_cdf_angle for sampling plus
        # phase/phase_angle values for the sun next-event estimation
        # (load_mie_tables, Radiation_solver_bw.cu:740-764).
        with NcReader(args.mie_file) as mie_nc:
            mie_kw = dict(
                mie_cdf=np.asarray(mie_nc.read("phase_cdf"), np.float32),
                mie_ang=np.asarray(mie_nc.read("phase_cdf_angle"),
                                   np.float32))
            if mie_nc.has("phase"):
                mie_kw.update(
                    mie_phase=np.asarray(mie_nc.read("phase"), np.float32),
                    mie_phase_ang=np.asarray(mie_nc.read("phase_angle"),
                                             np.float32))
    solver = RadiationSolverBW(kd, clut, alut, **mie_kw)
    mode = "image" if args.image else "broadband"

    def render():
        return solver.solve(
            gas_concs=gas_concs, p_lay=p_lay, p_lev=p_lev, t_lay=t_lay,
            mu0=mu0, azi=azi, sfc_alb=sfc_alb, land_use_map=land_use,
            camera=camera, grid_cells=(nz, ny, nx), grid_d=grid_d,
            kn_grid=kn_grid, z_lev=z_lev,
            photons_per_pixel=args.bw_raytracing, mode=mode,
            n_sub=args.n_sub, delta_cloud=args.delta_cloud,
            delta_aerosol=args.delta_aerosol, gpt_chunk=args.gpt_chunk,
            seed=args.seed, nee_mode=args.nee_mode,
            steps_per_dispatch=args.steps_per_dispatch,
            spectral_mode=args.spectral_mode, dtype=f32, **solve_clouds,
            **aerosols)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    status.print_message(
        f"Rendering ({mode}, {args.bw_raytracing} photons/pixel).")
    t0 = time.perf_counter()
    out = render()
    sync()
    status.print_message(
        f"Duration renderer: {(time.perf_counter()-t0)*1e3:.2f} (ms)")

    cloud_cam_out = None
    if args.cloud_cam:
        cloud_cam_out = cloud_cam_images(camera, grid_d, (nz, ny, nx), kd,
                                         clut, clouds, device)

    if args.profiling:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            render()
            sync()
        path = f"{os.path.splitext(args.output)[0]}_bw_trace.json"
        prof.export_chrome_trace(path)
        status.print_message(f"Profiler trace in {path}")

    with NcWriter(args.output) as w:
        w.def_dim("x", camera.nx)
        w.def_dim("y", camera.ny)
        w.def_dim("n", 3)
        if mode == "image":
            w.write("XYZ", _host(out["XYZ"]), ("n", "y", "x"),
                    attrs={"long_name": "XYZ tristimulus values"})
        w.write("radiance", _host(out["radiance"]), ("y", "x"),
                attrs={"long_name": "shortwave radiance"})
        if cloud_cam_out is not None:
            liwp, tauc, dist, zen = (_host(a) for a in cloud_cam_out)
            w.write("liq_ice_wp_cam", liwp, ("y", "x"),
                    attrs={"long_name": "accumulated liquid+ice water path"})
            w.write("tau_cld_cam", tauc, ("y", "x"),
                    attrs={"long_name":
                           "accumulated cloud optical depth (vis band)"})
            w.write("dist_cld_cam", dist, ("y", "x"),
                    attrs={"long_name": "distance to first cloudy cell"})
            w.write("zen_cam", zen, ("y", "x"),
                    attrs={"long_name": "camera ray zenith angle"})
    status.print_message("Finished.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
