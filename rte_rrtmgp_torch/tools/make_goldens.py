"""One-time generator of the port's frozen tracer goldens.

Counterpart of the JAX package's ``tests/make_goldens.py`` for the two
Monte-Carlo fixtures: the same cases (``tests/golden_case.py``
``solve_rt_case`` / ``solve_bw_case``: a cloudy 4x4x12-cell forward solve
under 24 layers, and an 8x8 px TOA camera render of 4x4x6 cells under 12
layers), copied here and solved by the port's tracers on the CPU with the
port's own random stream (``seed=``; JAX's threefry keys have no
counterpart, so these are not JAX's goldens).  Written as classic NetCDF
through ``utils/ncio.NcWriter``:

    python -m rte_rrtmgp_torch.tools.make_goldens --device cpu [--force]
        [--out-dir D]

(default ``tests/goldens_torch/`` of the repository; the committed
fixtures are the CPU's, which ``tests/test_torch_goldens.py`` reads; on a
card, the default device, the files are named ``<name>.cuda.nc``).  An existing file is
never regenerated unless ``--force`` is given: re-baseline only on
purpose, and say so in the commit message.  The fixtures depend on the
PyTorch version's CPU arithmetic and random stream.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import config
from ..cases.profiles import make_atmosphere
from ..data import synthetic
from ..models import CloudLUT, KDist
from ..models import raytracer_bw as rbw
from ..models.radiation_bw import RadiationSolverBW
from ..models.radiation_rt import RadiationSolverRT
from ..utils.ncio import NcWriter

GOLDEN_GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "goldens_torch")
RT_NAME, BW_NAME = "rt_f32.nc", "bw_f32.nc"
# Tolerances of the gate, as the JAX package's (tests/golden_case.py): loose
# enough for benign reassociation, far below any physics change.
MC_RTOL = 1e-4
MC_ATOL = 1e-5
# The camera case's regression cut: one spectral step at 1 photon a pixel,
# the first whose XYZ factors are not zero (g-point 10 of 14, the visible
# band; the whole render of 28 steps takes ~20 min on a CPU, its
# grazing-ray tails ~1,400 steps of a nested sun walk each; the cut ~6 s).
# The whole render's arrays are frozen beside it, held to the JAX package's
# frozen means, and the cut's arrays (``<name>_cut``) gate the tracer.
BW_CUT = dict(photons_per_pixel=1, spectral_steps=slice(20, 21))


def _tables(gpt_per_band: int, device):
    kd = KDist.from_raw(synthetic.make_kdist_raw(False, gpt_per_band=gpt_per_band),
                        GOLDEN_GASES, dtype=torch.float32, device=device)
    clut = CloudLUT.from_raw(synthetic.make_cloud_raw(False),
                             dtype=torch.float32, device=device)
    return kd, clut


def solve_rt_case(device="cpu") -> dict:
    """Fixed-seed cloudy 3D forward-MC solve (float32): {name: array}."""
    ny, nx, nz, nlay = 4, 4, 12, 24
    kd, clut = _tables(2, device)
    atm = make_atmosphere(ny * nx, nlay, seed=5)
    ncol = ny * nx
    out = RadiationSolverRT(kd, clut).solve(
        gas_concs=atm["gas_concs"], p_lay=atm["p_lay"], p_lev=atm["p_lev"],
        t_lay=atm["t_lay"], mu0=np.full(ncol, 0.8), azi=np.zeros(ncol),
        sfc_alb_dir=np.full((ncol, kd.nbnd), 0.06),
        sfc_alb_dif=np.full((ncol, kd.nbnd), 0.06),
        grid_cells=(nz, ny, nx), grid_d=(500.0, 1000.0, 1000.0),
        kn_grid=(4, 2, 2), photons_per_pixel=32,
        lwp=atm["lwp"], iwp=atm["iwp"], rel=atm["rel"], dei=atm["dei"],
        delta_cloud=True, seed=0)
    names = ("rt_flux_tod_dn", "rt_flux_tod_up", "rt_flux_sfc_dir",
             "rt_flux_sfc_dif", "rt_flux_sfc_up", "rt_flux_abs_dir",
             "rt_flux_abs_dif")
    return {k: getattr(out, k).cpu().numpy() for k in names}


def solve_bw_case(device="cpu", photons_per_pixel: int = 32,
                  spectral_steps: slice = slice(None)) -> dict:
    """Fixed-seed cloudy camera render (float32): radiance + XYZ image.
    ``spectral_steps`` / ``photons_per_pixel`` cut the render
    (:data:`BW_CUT`)."""
    ny = nx = 4
    nz, nlay = 6, 12
    kd, clut = _tables(1, device)
    atm = make_atmosphere(ny * nx, nlay, seed=11, perturb=True)
    atm["lwp"][:, 2:4] = 30.0
    cam = rbw.Camera(cam_type=2, ny=8, nx=8, fov=80.0,
                     position=(0.0, 0.0, 0.0))
    out = RadiationSolverBW(kd, clut).solve(
        gas_concs=atm["gas_concs"], p_lay=atm["p_lay"], p_lev=atm["p_lev"],
        t_lay=atm["t_lay"], mu0=np.full(ny * nx, 0.8),
        azi=np.zeros(ny * nx), sfc_alb=np.full((ny * nx, kd.nbnd), 0.1),
        land_use_map=np.zeros(ny * nx), camera=cam,
        grid_cells=(nz, ny, nx), grid_d=(400.0, 500.0, 500.0),
        kn_grid=(2, 2, 2), z_lev=np.arange(nlay + 1) * 400.0,
        photons_per_pixel=photons_per_pixel, lwp=atm["lwp"], iwp=atm["iwp"],
        rel=atm["rel"], dei=atm["dei"], mode="image", n_sub=2, seed=5,
        spectral_steps=spectral_steps)
    return {"bw_radiance": out["radiance"].cpu().numpy(),
            "bw_xyz": out["XYZ"].cpu().numpy()}


def _write(path, out, dims_of):
    with NcWriter(path) as w:
        for name, arr in sorted(out.items()):
            w.write(name, arr, dims_of(arr), attrs={"units": "W m-2"})
    print(f"wrote {path} ({len(out)} variables)")
    for name, arr in sorted(out.items()):
        print(f"  {name:24s} mean={arr.mean():10.4f} max={arr.max():10.4f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--force", action="store_true",
                   help="overwrite existing fixtures (re-baseline)")
    p.add_argument("--out-dir", default=OUT_DIR)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; the committed fixtures are "
                        "the CPU's, a card's go to <name>.<device type>.nc")
    a = p.parse_args(argv)
    dev = config.resolve_device(a.device)
    os.makedirs(a.out_dir, exist_ok=True)
    suffix = "" if dev.type == "cpu" else "." + dev.type
    rt_path, bw_path = (os.path.join(a.out_dir, n.replace(".nc", suffix + ".nc"))
                        for n in (RT_NAME, BW_NAME))
    if a.force or not os.path.exists(rt_path):
        _write(rt_path, solve_rt_case(dev),
               lambda x: ("y", "x") if x.ndim == 2 else ("zr", "y", "x"))
    if a.force or not os.path.exists(bw_path):
        cut = solve_bw_case(dev, **BW_CUT)
        _write(bw_path, {**solve_bw_case(dev),
                         **{k + "_cut": v for k, v in cut.items()}},
               lambda x: ("py", "px") if x.ndim == 2 else ("chan", "py", "px"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
