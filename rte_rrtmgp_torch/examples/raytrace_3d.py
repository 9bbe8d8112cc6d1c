"""3-D Monte-Carlo ray-tracing walkthrough, the port of
``examples/raytrace_3d.py`` (the Python-API analog of the reference's
``test_rte_rrtmgp_rt_gpu`` driver, ``src_test/test_rte_rrtmgp_rt.cu``).

Builds a small cloudy 3-D domain, runs the per-g-point spectral pipeline
(gas optics -> cloud optics -> two-stream TOD boundary -> forward
null-collision tracer -> broadband accumulation) through
``RadiationSolverRT`` and checks the Monte-Carlo surface flux against the
1-D two-stream solve on the same optics, the check the reference makes in
its driver (``Radiation_solver_rt.cu:903-956``).  Then it traces
PRESCRIBED optics with the tracer alone (the ``test_rt_lite`` analog) with
the photon-queue respawn.  The tracer runs in float32, the solver's
default.

    python -m rte_rrtmgp_torch.examples.raytrace_3d [--device cpu]
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..cases.profiles import make_atmosphere
from ..data import synthetic
from ..models import CloudLUT, KDist
from ..models import raytracer as rt
from ..models.radiation_rt import RadiationSolverRT
from . import device_from_args

GASES = ("h2o", "co2", "o3", "n2o", "ch4", "o2", "n2")


def full_spectral_solve(device, photons_per_pixel: int = 64):
    """The reference rt driver's flow: 3-D cloudy domain, full spectrum."""
    ny, nx, nz, nlay = 8, 8, 12, 24
    ncol = ny * nx
    kd = KDist.from_raw(synthetic.make_kdist_raw(False, gpt_per_band=2),
                        GASES, dtype=torch.float32, device=device)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "cloud.nc")
        synthetic.write_cloud_nc(p, synthetic.make_cloud_raw(False))
        clut = CloudLUT.from_netcdf(p, dtype=torch.float32, device=device)
    atm = make_atmosphere(ncol, nlay, seed=7)

    out = RadiationSolverRT(kd, clut).solve(
        gas_concs=atm["gas_concs"], p_lay=atm["p_lay"], p_lev=atm["p_lev"],
        t_lay=atm["t_lay"], mu0=np.full(ncol, 0.8), azi=np.zeros(ncol),
        sfc_alb_dir=np.full((ncol, kd.nbnd), 0.06),
        sfc_alb_dif=np.full((ncol, kd.nbnd), 0.06),
        grid_cells=(nz, ny, nx), grid_d=(500.0, 1000.0, 1000.0),
        kn_grid=(4, 2, 2), photons_per_pixel=photons_per_pixel,
        lwp=atm["lwp"], iwp=atm["iwp"], rel=atm["rel"], dei=atm["dei"],
        delta_cloud=True, twostream=True, seed=0)

    host = lambda x: x.cpu().numpy()
    mc_sfc = host(out.rt_flux_sfc_dir + out.rt_flux_sfc_dif).mean()
    ts_sfc = host(out.sw_flux_dn)[:, 0].mean()  # surface = level 0 here
    print(f"MC surface flux      {mc_sfc:8.2f} W m-2")
    print(f"two-stream surface   {ts_sfc:8.2f} W m-2  "
          f"(rel diff {abs(mc_sfc - ts_sfc) / ts_sfc:.1%})")
    assert abs(mc_sfc - ts_sfc) / ts_sfc < 0.15, "MC vs two-stream"
    print(f"TOD down             {host(out.rt_flux_tod_dn).mean():8.2f}")
    print(f"TOD up               {host(out.rt_flux_tod_up).mean():8.2f}")
    abs3d = host(out.rt_flux_abs_dir + out.rt_flux_abs_dif)
    print(f"3-D absorption field shape {abs3d.shape}, "
          f"column-integrated {abs3d.sum(axis=0).mean() * 500.0:8.2f} W m-2")
    return out


def prescribed_optics_trace(device, photons_per_pixel: int = 64):
    """test_rt_lite analog: trace prescribed optical fields directly."""
    nz, ny, nx = 16, 16, 16
    rng = np.random.default_rng(0)
    k_gas = np.full((nz, ny, nx), 2e-4, np.float32)
    cloud = np.zeros((nz, ny, nx), np.float32)
    cloud[5:8] = 8e-3 * (rng.random((3, ny, nx)) < 0.3)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    full = lambda v, shape: torch.full(shape, v, dtype=torch.float32,
                                       device=device)
    out = rt.trace_rays(
        1,
        t(k_gas + cloud),                        # k_ext
        t(k_gas * 0.5),                          # gas scattering
        t(cloud * 0.999),                        # cloud scattering
        full(0.0, (nz, ny, nx)),                 # aerosol scattering
        full(0.85, (nz, ny, nx)),                # cloud asymmetry
        full(0.0, (nz, ny, nx)),                 # aerosol asymmetry
        None,                                    # r_eff (no Mie tables)
        full(0.2, (ny, nx)),                     # surface albedo
        (4, 4, 4), (250.0, 500.0, 500.0),
        800.0, 50.0,                             # TOD direct/diffuse W m-2
        t(rt.sun_direction_from_angles(0.64, 0.3)),
        photons_per_pixel=photons_per_pixel,
        respawn_mode="auto")                     # tuned winner, else fifo
    mean = lambda x: float(x.double().mean())
    tod_in = mean(out.flux_toa_down)
    sfc = mean(out.flux_sfc_dir + out.flux_sfc_dif)
    up = mean(out.flux_tod_up)
    absorbed = mean((out.flux_abs_dir + out.flux_abs_dif).sum(dim=0)) * 250.0
    sfc_up = mean(out.flux_sfc_up)
    print(f"prescribed-optics trace: in {tod_in:.1f} = up {up:.1f} "
          f"+ sfc_net {sfc - sfc_up:.1f} + absorbed {absorbed:.1f} "
          f"(closure {(up + sfc - sfc_up + absorbed) / tod_in:.1%})")
    assert abs((up + sfc - sfc_up + absorbed) / tod_in - 1.0) < 0.05
    return out


def main(device, photons_per_pixel: int = 64) -> dict:
    """Both parts on ``device`` at ``photons_per_pixel`` (the JAX
    walkthrough's 64 unless the caller asks for fewer); returns their
    outputs."""
    device = torch.device(device)
    print("=== full spectral 3-D solve (RadiationSolverRT) ===")
    solve = full_spectral_solve(device, photons_per_pixel)
    print("\n=== prescribed-optics trace (rt_lite analog) ===")
    trace = prescribed_optics_trace(device, photons_per_pixel)
    print("\nOK")
    return dict(solve=solve, trace=trace)


if __name__ == "__main__":
    main(device_from_args("The port's 3-D Monte-Carlo walkthrough."))
