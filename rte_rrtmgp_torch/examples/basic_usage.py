"""Python-API walkthrough, the port of ``examples/basic_usage.py`` (the
analog of the reference's Cython-binding example ``python/test.py``): build
gas concentrations, load coefficient tables through the production loaders,
solve LW + SW fluxes, and differentiate the outgoing longwave with respect
to a CO2 scaling through the whole solver with ``torch.autograd``.

The solves pass ``dtype=torch.float32``.  The JAX walkthrough runs with x64
off, so its NumPy atmosphere enters as float32; on a card these solves
launch the float32 kernels (gas optics, LW sweep, SW two-stream).  Those
kernels have no backward, as the JAX package's Pallas kernels have none, so
on a card the gradient is taken in float64, through the plain twins (the
float32 tables promote); on the CPU it is taken in float32, as the JAX
walkthrough does there.

    python -m rte_rrtmgp_torch.examples.basic_usage [--device cpu]
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..cases.profiles import make_atmosphere
from ..data import synthetic
from ..models import (CloudLUT, KDist, RadiationSolverLW,
                      RadiationSolverSW)
from ..models.radiation import _solve_lw_impl
from ..ops import gas_optics as gas_ops
from . import device_from_args

GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
NCOL, NLAY = 8, 48


def olr_function(kd_lw, atm, gas, dtype):
    """``olr(co2_scale)``: the mean outgoing longwave (W m-2) of the clear
    sky with the CO2 vmr scaled by the 0-dim tensor ``co2_scale``, through
    ``_solve_lw_impl`` in ``dtype`` on the tables' device."""
    dev = kd_lw.device
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    vmr = t(gas.materialize(GASES, NCOL, NLAY))
    col_dry = gas_ops.get_col_dry(vmr[:, :, 0], t(atm["p_lev"]))
    ico2 = GASES.index("co2")
    zeros = torch.zeros((NCOL, NLAY), dtype=dtype, device=dev)
    fixed = [t(atm[k]) for k in ("p_lay", "p_lev", "t_lay", "t_lev",
                                 "t_sfc")]
    emis = torch.full((NCOL, kd_lw.nbnd), 0.98, dtype=dtype, device=dev)

    def olr(co2_scale):
        v = vmr.clone()
        v[:, :, ico2] = vmr[:, :, ico2] * co2_scale
        out = _solve_lw_impl(
            kd_lw, None, *fixed, v, col_dry, emis, zeros, zeros, zeros,
            zeros, top_at_1=False, gpt_chunk=None, output_bnd_fluxes=False,
            n_gauss_angles=1, with_clouds=False)
        return out["lw_flux_up"][:, -1].mean()

    return olr


def olr_gradient(olr, dtype, device) -> float:
    """d(olr)/d(co2_scale) at a scale of 1, by ``torch.autograd``."""
    scale = torch.tensor(1.0, dtype=dtype, device=device, requires_grad=True)
    olr(scale).backward()
    return float(scale.grad)


def main(device) -> dict:
    """The walkthrough on ``device``; returns its fluxes, the gradient and
    the inputs the gradient was taken on."""
    device = torch.device(device)
    # --- 1. coefficient tables (KDist.from_netcdf works identically on the
    # real RRTMGP coefficient files) ---
    f32 = torch.float32
    kd_lw = KDist.from_raw(synthetic.make_kdist_raw(True, gpt_per_band=4),
                           GASES, dtype=f32, device=device)
    kd_sw = KDist.from_raw(synthetic.make_kdist_raw(False, gpt_per_band=4),
                           GASES, dtype=f32, device=device)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "cloud.nc")
        synthetic.write_cloud_nc(p, synthetic.make_cloud_raw(False))
        clut_sw = CloudLUT.from_netcdf(p, dtype=f32, device=device)

    # --- 2. atmosphere + gas concentrations: set_vmr takes a scalar, an
    # (nlay,) profile or an (ncol, nlay) field ---
    atm = make_atmosphere(NCOL, NLAY, seed=0)
    gas = atm["gas_concs"]
    gas.set_vmr("co2", 420e-6)
    gas.set_vmr("n2o", gas.expand("n2o", NCOL, NLAY)[0])
    gas.set_vmr("o3", gas.expand("o3", NCOL, NLAY))

    # --- 3. longwave ---
    lw = RadiationSolverLW(kd_lw).solve(
        gas_concs=gas, p_lay=atm["p_lay"], p_lev=atm["p_lev"],
        t_lay=atm["t_lay"], t_lev=atm["t_lev"], t_sfc=atm["t_sfc"],
        emis_sfc=np.full((NCOL, kd_lw.nbnd), 0.98), dtype=f32)
    host = lambda x: x.detach().cpu().numpy()
    print(f"LW sfc dn {host(lw['lw_flux_dn'])[:, 0].mean():8.2f} "
          f"TOA up {host(lw['lw_flux_up'])[:, -1].mean():8.2f} W/m2")

    # --- 4. shortwave, cloudy ---
    alb = np.full((NCOL, kd_sw.nbnd), 0.06)
    sw = RadiationSolverSW(kd_sw, clut_sw).solve(
        gas_concs=gas, p_lay=atm["p_lay"], p_lev=atm["p_lev"],
        t_lay=atm["t_lay"], mu0=atm["mu0"], sfc_alb_dir=alb,
        sfc_alb_dif=alb, lwp=atm["lwp"], iwp=atm["iwp"],
        rel=atm["rel"], dei=atm["dei"], delta_cloud=True, dtype=f32)
    print(f"SW sfc dn {host(sw['sw_flux_dn'])[:, 0].mean():8.2f} "
          f"(dir {host(sw['sw_flux_dn_dir'])[:, 0].mean():.2f}) W/m2")

    # --- 5. gradient of OLR with respect to a CO2 scaling ---
    grad_dtype = torch.float64 if device.type == "cuda" else f32
    dolr = olr_gradient(olr_function(kd_lw, atm, gas, grad_dtype),
                        grad_dtype, device)
    print(f"d(OLR)/d(CO2 scale) = {dolr:+.3f} W/m2  "
          f"(negative: more CO2 -> less outgoing LW)")
    assert dolr < 0.0

    print("EXAMPLE OK")
    return dict(lw=lw, sw=sw, dolr=dolr, kd_lw=kd_lw, kd_sw=kd_sw, atm=atm,
                gas=gas)


if __name__ == "__main__":
    main(device_from_args("The port's Python-API walkthrough."))
