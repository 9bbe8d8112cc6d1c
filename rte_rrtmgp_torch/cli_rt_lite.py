"""Standalone forward ray tracer on prescribed optical fields.

The port's ``test_rt_lite`` (``src_test/test_rt_lite.cu``; the JAX
package's ``cli_rt_lite``): reads ``rt_lite_input.nc`` (tot/cld/aer tau,
ssa, asy per (z, y, x); albedo; sza/azi; tod_direct; ngrid_x/y/z
null-collision grid dims) — no gas optics — traces photons in float32,
writes the ray-traced fluxes.  ``--bw-raytracing N`` also renders camera
radiances with the backward tracer (N photons a pixel; the input needs a
"camera-settings" group) into ``radiance`` (cam_y, cam_x).  ``--device``:
``cuda`` (default) or ``cpu``.

Usage: python -m rte_rrtmgp_torch.cli_rt_lite [--raytracing N] [--bw-raytracing N]
           [--independent-column]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import config
from .models import raytracer as rt
from .models import raytracer_bw as rbw
from .models.radiation import _host
from .ops import rte_sw
from .utils import status
from .utils.ncio import NcReader, NcWriter


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rt_lite")
    p.add_argument("--raytracing", type=int, default=32,
                   help="forward photons per pixel (0 disables)")
    p.add_argument("--bw-raytracing", type=int, default=0, metavar="N",
                   help="render camera radiances with N photons per pixel "
                        "(needs a camera-settings group in the input)")
    p.add_argument("--two-stream", action="store_true",
                   help="also run the 1D two-stream solver on the "
                        "prescribed optics")
    p.add_argument("--independent-column", action="store_true")
    p.add_argument("--input", default="rt_lite_input.nc")
    p.add_argument("--output", default="rt_lite_output.nc")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = config.resolve_device(args.device)
    f32 = torch.float32

    status.print_message("Reading optical input data from NetCDF.")
    nc = NcReader(args.input)
    nx, ny = nc.dim("x"), nc.dim("y")
    nz = nc.dim("z")
    grid_x = nc.read("x")
    grid_y = nc.read("y")
    grid_z = nc.read("z")
    dx = float(grid_x[1] - grid_x[0]) if nx > 1 else float(2 * grid_x[0])
    dy = float(grid_y[1] - grid_y[0]) if ny > 1 else float(2 * grid_y[0])
    dz = float(grid_z[1] - grid_z[0]) if nz > 1 else float(2 * grid_z[0])
    kn_grid = (int(nc.read_scalar("ngrid_z")), int(nc.read_scalar("ngrid_y")),
               int(nc.read_scalar("ngrid_x")))

    def field(name):  # (lay/z, y, x), keep only the domain's nz cells
        return torch.as_tensor(nc.read(name)[:nz], dtype=f32, device=device)

    tot_tau, tot_ssa, tot_asy = map(field, ("tot_tau", "tot_ssa", "tot_asy"))
    cld_tau, cld_ssa, cld_asy = map(field, ("cld_tau", "cld_ssa", "cld_asy"))
    aer_tau, aer_ssa, aer_asy = map(field, ("aer_tau", "aer_ssa", "aer_asy"))

    albedo = torch.as_tensor(nc.read("albedo"), dtype=f32, device=device)
    sza = nc.read_scalar("sza")
    azi = nc.read_scalar("azi")
    tod_dir = nc.read_scalar("tod_direct")
    tod_dif = nc.read_scalar("tod_diffuse") if nc.has("tod_diffuse") else 0.0
    camera = None
    if args.bw_raytracing > 0:
        from .tools.set_virtual_camera import read_camera

        camera = read_camera(nc)
    nc.close()

    k = rt.bundle_optical_props(tot_tau, tot_ssa, cld_tau, cld_ssa, cld_asy,
                                aer_tau, aer_ssa, aer_asy, dz)
    sun = rt.sun_direction_from_angles(sza, azi)

    out = None
    if args.raytracing > 0:
        status.print_message(f"Tracing {args.raytracing} photons per pixel.")
        out = rt.trace_rays(
            args.seed, *k, None, albedo, kn_grid, (dz, dy, dx),
            tod_dir * float(np.cos(sza)), tod_dif, sun,
            photons_per_pixel=args.raytracing,
            independent_column=args.independent_column)

    radiance = None
    if camera is not None:
        status.print_message(
            f"Rendering camera radiances ({args.bw_raytracing} photons/pixel).")
        # Prescribed optics: no background column above the domain.
        z_top = nz * dz
        zero = lambda *s: torch.zeros(s, dtype=f32, device=device)
        count, _ = rbw.trace_rays_bw(
            rbw._key(args.seed + 1), camera, *k, zero(1), zero(1), zero(1, 3),
            torch.tensor([z_top, z_top * (1 + 1e-6)], dtype=f32,
                         device=device),
            albedo, torch.ones((ny, nx), dtype=f32, device=device), kn_grid,
            (dz, dy, dx), -sun,    # toward the sun (z > 0)
            float(np.cos(sza)), photons_per_pixel=args.bw_raytracing)
        radiance = rbw.count_to_radiance(count, tod_dir, 1.0,
                                         args.bw_raytracing)

    ts = None
    if args.two_stream:
        status.print_message("Running the 1D two-stream solver.")
        # (nz, ny, nx) -> (ncol, nz, 1): one spectral interval; flip so the
        # top of atmosphere is at layer 0.
        to_col = lambda a: torch.flip(a.reshape(nz, -1).T, dims=(1,))[:, :, None]
        ncol = ny * nx
        mu0v = torch.full((ncol,), float(np.cos(sza)), dtype=f32,
                          device=device)
        albv = albedo.reshape(ncol, 1)
        up, dn, fdir = rte_sw.sw_solver_2stream(
            to_col(tot_tau), to_col(tot_ssa), to_col(tot_asy), mu0v,
            albv, albv,
            torch.full((ncol, 1), tod_dir, dtype=f32, device=device),
            torch.full((ncol, 1), tod_dif, dtype=f32, device=device))
        ts = tuple(torch.flip(a[:, :, 0], dims=(1,)) for a in (up, dn, fdir))

    status.print_message("Writing output.")
    with NcWriter(args.output) as w:
        w.def_dim("x", nx)
        w.def_dim("y", ny)
        w.def_dim("z", nz)
        if out is not None:
            for name, val in (("flux_tod_dn", out.flux_toa_down),
                              ("flux_tod_up", out.flux_tod_up),
                              ("flux_sfc_dir", out.flux_sfc_dir),
                              ("flux_sfc_dif", out.flux_sfc_dif),
                              ("flux_sfc_up", out.flux_sfc_up)):
                w.write(name, _host(val), ("y", "x"))
            w.write("flux_abs_dir", _host(out.flux_abs_dir), ("z", "y", "x"))
            w.write("flux_abs_dif", _host(out.flux_abs_dif), ("z", "y", "x"))
        if radiance is not None:
            w.def_dim("cam_x", camera.nx)
            w.def_dim("cam_y", camera.ny)
            w.write("radiance", _host(radiance), ("cam_y", "cam_x"),
                    attrs={"long_name": "rendered radiance"})
        if ts is not None:
            w.def_dim("lev", nz + 1)
            for name, val in zip(("sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir"),
                                 ts):
                w.write(name, _host(val).T.reshape(nz + 1, ny, nx),
                        ("lev", "y", "x"))
    status.print_message("Finished.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
