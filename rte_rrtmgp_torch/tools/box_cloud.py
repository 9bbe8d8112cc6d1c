"""Synthetic box-cloud input generator for the standalone ray tracer.

The port's copy of the JAX package's ``tools/box_cloud.py`` (the
reference's ``python/box_cloud.py``; same defaults: rectangular cloud
blocks in a periodic domain), writing the ``rt_lite_input.nc`` variable set
consumed by ``rte_rrtmgp_torch.cli_rt_lite`` / the reference's
``test_rt_lite`` as classic NetCDF (``utils/ncio.NcWriter``).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.ncio import NcWriter


def make_box_cloud(nx=64, ny=64, nz=32, dx=25.0, dy=25.0, dz=25.0,
                   tau_clear=0.1, tau_cloud=10.0, ssa_clear=0.5,
                   ssa_cloud=0.9, asy_param=0.86,
                   cld_bot_frac=0.5, cld_top_frac=0.75,
                   cloud_size_x=None, cloud_size_y=None,
                   n_cloud_x=2, n_cloud_y=2,
                   zenith_deg=45.0, azimuth_deg=235.0, albedo=0.2,
                   tod_direct=95.0, tod_diffuse=5.0,
                   ngrid=(8, 8, 8)) -> dict:
    cloud_size_x = cloud_size_x or nx // 8
    cloud_size_y = cloud_size_y or ny // 4
    cld_bot = int(nz * cld_bot_frac)
    cld_top = int(nz * cld_top_frac)

    cld_mask = np.zeros((nz, ny, nx))
    void_x = (nx - cloud_size_x * n_cloud_x) // max(n_cloud_x, 1)
    void_y = (ny - cloud_size_y * n_cloud_y) // max(n_cloud_y, 1)
    for j in range(n_cloud_y):
        for i in range(n_cloud_x):
            i0 = i * (cloud_size_x + void_x)
            j0 = j * (cloud_size_y + void_y)
            cld_mask[cld_bot:cld_top, j0:j0 + cloud_size_y,
                     i0:i0 + cloud_size_x] = 1.0

    tau_cld = cld_mask * (tau_cloud / max(cld_top - cld_bot, 1))
    tau_gas = np.full((nz, ny, nx), tau_clear / nz)
    tau_tot = tau_gas + tau_cld
    # total ssa from the mix of clear gas and cloud scattering
    ssa_tot = (tau_cld * ssa_cloud + tau_gas * ssa_clear) / tau_tot
    asy_cld = cld_mask * asy_param

    zeros = np.zeros_like(tau_tot)
    return dict(
        x=np.arange(nx) * dx, y=np.arange(ny) * dy, z=np.arange(nz) * dz,
        tot_tau=tau_tot, tot_ssa=ssa_tot, tot_asy=asy_cld,
        cld_tau=tau_cld, cld_ssa=np.full_like(tau_tot, ssa_cloud) * cld_mask,
        cld_asy=asy_cld,
        aer_tau=zeros, aer_ssa=zeros, aer_asy=zeros,
        albedo=np.full((ny, nx), albedo),
        sza=np.deg2rad(zenith_deg), azi=np.deg2rad(azimuth_deg),
        tod_direct=tod_direct, tod_diffuse=tod_diffuse,
        ngrid_x=ngrid[2], ngrid_y=ngrid[1], ngrid_z=ngrid[0],
    )


def write_rt_lite_input(path: str, data: dict) -> None:
    with NcWriter(path) as w:
        nz, ny, nx = data["tot_tau"].shape
        w.def_dim("x", nx)
        w.def_dim("y", ny)
        w.def_dim("z", nz)
        w.def_dim("lay", nz)
        for k in ("x", "y", "z"):
            w.write(k, data[k], (k,))
        for k in ("tot_tau", "tot_ssa", "tot_asy", "cld_tau", "cld_ssa",
                  "cld_asy", "aer_tau", "aer_ssa", "aer_asy"):
            w.write(k, data[k], ("z", "y", "x"))
        w.write("albedo", data["albedo"], ("y", "x"))
        for k in ("sza", "azi", "tod_direct", "tod_diffuse",
                  "ngrid_x", "ngrid_y", "ngrid_z"):
            w.write_scalar(k, data[k])


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate a box-cloud rt input")
    p.add_argument("--output", default="rt_lite_input.nc")
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--ny", type=int, default=64)
    p.add_argument("--nz", type=int, default=32)
    args = p.parse_args(argv)
    write_rt_lite_input(args.output, make_box_cloud(args.nx, args.ny, args.nz))
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
