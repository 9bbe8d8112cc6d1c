"""One end-to-end forward ray-traced solve at the reference's headline
scale: gas optics, cloud optics, then every SW g-point traced.

The port's counterpart of the JAX package's ``tools/bench_rt_solve.py``.
The reference's headline rt workload traces all SW g-points per solve on
its 64x64x256 RCEMIP domain (``src_test/Radiation_solver_rt.cu:760``;
domain ``rcemip/test_rcemip_input_rt.py``).  This runs the port's driver
(``RadiationSolverRT.solve``) on a synthetic RCEMIP-like case (64x64
columns, 256 layers, the lowest ``nz`` traced in 3D, clouds, delta-scaled)
and records the wall clock of one complete solve, synchronized with the
card: ``warmup`` solves (seeds 0, 1, ...), then one timed solve.

Usage: python -m rte_rrtmgp_torch.tools.bench_rt_solve [--nx 64]
           [--nlay 256] [--nz 64] [--ppp 16] [--gpt-per-band 16]
           [--spectral scan|lanes] [--gpt-per-dispatch auto|off|N]
           [--warmup 1] [--device cuda]

``--spectral`` and ``--gpt-per-dispatch`` are the JAX tool's
``BENCH_RT_SPECTRAL`` / ``BENCH_RT_GPD`` variables; ``auto`` and ``off``
are both one window on the card (no dispatch watchdog).  One JSON line:
s/solve, photons/s, the mean surface direct flux, the mean flux at the top
of the domain beside its exact value, and the energy closure.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import config
from ..cases.profiles import make_atmosphere
from ..data import synthetic
from ..models import CloudLUT, KDist
from ..models.radiation_rt import RadiationSolverRT
from ..step import GASES

MU0 = 0.8
DX = 100.0      # the cell size, m, on every axis


def closure(out, dz: float) -> float:
    """Relative energy closure of the MC fluxes (domain means): TOD up +
    net surface + the column's absorption, against the incident flux."""
    m = lambda a: float(a.double().mean())
    toa = m(out.rt_flux_tod_dn)
    absorbed = float((out.rt_flux_abs_dir.double() + out.rt_flux_abs_dif
                      .double()).mean(dim=(1, 2)).sum()) * dz
    return (m(out.rt_flux_tod_up) + m(out.rt_flux_sfc_dir)
            + m(out.rt_flux_sfc_dif) - m(out.rt_flux_sfc_up) + absorbed
            - toa) / toa


def measure(nx=64, nlay=256, nz=64, ppp=16, gpt_per_band=16,
            spectral="scan", gpt_per_dispatch=None, warmup=1,
            device="cuda") -> dict:
    """Time one solve after ``warmup`` solves.  Returns the JSON fields and
    ``"out"``, the timed solve's ``RTFluxes``."""
    dev = config.resolve_device(device)
    ny, ncol = nx, nx * nx
    kd = KDist.from_raw(synthetic.make_kdist_raw(False, gpt_per_band=gpt_per_band),
                        GASES, dtype=torch.float32, device=dev)
    clut = CloudLUT.from_raw(synthetic.make_cloud_raw(False),
                             dtype=torch.float32, device=dev)
    atm = make_atmosphere(ncol, nlay, seed=3, perturb=True)
    solver = RadiationSolverRT(kd, clut)
    kn = (max(2, nz // 16), max(2, nx // 16), max(2, nx // 16))

    def solve(seed):
        return solver.solve(
            gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
            p_lev=atm["p_lev"], t_lay=atm["t_lay"],
            mu0=np.full(ncol, MU0), azi=np.zeros(ncol),
            sfc_alb_dir=np.full((ncol, kd.nbnd), 0.06),
            sfc_alb_dif=np.full((ncol, kd.nbnd), 0.06),
            grid_cells=(nz, ny, nx), grid_d=(DX, DX, DX), kn_grid=kn,
            photons_per_pixel=ppp,
            lwp=atm["lwp"], iwp=atm["iwp"], rel=atm["rel"], dei=atm["dei"],
            delta_cloud=True, gpt_per_dispatch=gpt_per_dispatch,
            spectral_mode=spectral, seed=seed)

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    for seed in range(warmup):
        solve(seed)
    sync()
    t0 = time.perf_counter()
    out = solve(warmup)
    sync()
    dt = time.perf_counter() - t0
    n_photons = ncol * ppp * kd.ngpt
    return {
        "metric": f"end-to-end rt solve ({nx}x{ny}x{nz} domain, {nlay} lay, "
                  f"{kd.ngpt} gpt, {ppp} ppp, {spectral}, "
                  f"gpd={gpt_per_dispatch})",
        "value": dt, "unit": "s/solve",
        "photons_per_s": n_photons / dt,
        "sfc_dir_mean_wm2": float(out.rt_flux_sfc_dir.double().mean()),
        "tod_dn_mean_wm2": float(out.rt_flux_tod_dn.double().mean()),
        "tod_dn_exact_wm2": MU0 * float(kd.solar_source.double().sum()),
        "closure": closure(out, DX), "warmup": warmup, "ngpt": kd.ngpt,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "out": out,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--nlay", type=int, default=256)
    p.add_argument("--nz", type=int, default=64)
    p.add_argument("--ppp", type=int, default=16)
    p.add_argument("--gpt-per-band", type=int, default=16)
    p.add_argument("--spectral", choices=("scan", "lanes"), default="scan")
    p.add_argument("--gpt-per-dispatch", default="auto",
                   help="auto or off (one window), or g-points a window")
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    gpd = (None if a.gpt_per_dispatch in ("auto", "off")
           else int(a.gpt_per_dispatch))
    res = measure(a.nx, a.nlay, a.nz, a.ppp, a.gpt_per_band, a.spectral, gpd,
                  a.warmup, a.device)
    res.pop("out")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
