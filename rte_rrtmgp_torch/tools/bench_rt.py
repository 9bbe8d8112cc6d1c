"""Forward Monte-Carlo tracer benchmark at the reference's RCEMIP-like
scale (rcemip/test_rcemip_input.py: 64x64 columns; photon grid per
src_cuda_rt/Raytracer.cu:344-374).

The port's copy of the JAX package's ``tools/bench_rt.py``
(``make_fields`` / ``measure_mc``).  Workload: an idealized cloud deck and
an exponential gas profile at 64x64xNZ cells, 32 photons per pixel, NGPT
g-points traced one after another ("scan"), in one pooled photon loop
("pooled") or in one batched loop ("lanes").  Reports photons/s and ms per
g-point, each run synchronized with the card.

Usage (on a machine with a card):
    python -m rte_rrtmgp_torch.tools.bench_rt [--nx 64] [--nz 256] [--ppp 32]
        [--ngpt 1] [--knull 4,4,4] [--mode scan] [--respawn fifo]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models import raytracer as rt

SZA = 0.64
GRID_D = (500.0, 100.0, 100.0)
TOD_FLUX = 1361.0 * 0.8
ALBEDO = 0.06


def make_fields(nz, ny, nx, seed=0):
    """Idealized RCEMIP-ish single-g-point optics: exponential gas profile
    with Rayleigh scattering + a broken cloud deck.  The gas extinction is
    normalized to a FIXED column optical depth (the nz=64 value) so deeper
    grids refine the same atmosphere instead of thickening it.  Returns
    float32 (k_ext, k_sca_gas, k_sca_cld, k_sca_aer, asy_cld, asy_aer)."""
    rng = np.random.default_rng(seed)
    z = (np.arange(nz) + 0.5) / nz
    k_gas = (64.0 / nz) * (
        0.3e-3 * np.exp(-3.0 * z))[:, None, None] * np.ones((nz, ny, nx))
    ssa_gas = 0.3
    cloud = np.zeros((nz, ny, nx), np.float32)
    deck = (rng.random((ny, nx)) < 0.4)
    zc0, zc1 = int(0.2 * nz), int(0.3 * nz)
    cloud[zc0:zc1] = (64.0 / nz) * 10e-3 * deck \
        * rng.uniform(0.5, 1.5, (zc1 - zc0, ny, nx))
    k_ext = (k_gas + cloud).astype(np.float32)
    k_sca_gas = (k_gas * ssa_gas).astype(np.float32)
    k_sca_cld = (cloud * 0.9999).astype(np.float32)
    asy_cld = np.full((nz, ny, nx), 0.86, np.float32)
    zeros = np.zeros((nz, ny, nx), np.float32)
    return k_ext, k_sca_gas, k_sca_cld, zeros, asy_cld, zeros


def write_lite_input(path, nz, ny, nx, kn=(4, 4, 4), seed=0):
    """The :func:`make_fields` optics as an ``rt_lite_input.nc`` (the
    variables ``cli_rt_lite`` reads), with the bench's sun, albedo and
    incident flux."""
    from ..utils.ncio import NcWriter

    k_ext, k_sca_gas, k_sca_cld, _, asy_cld, zeros = make_fields(nz, ny, nx,
                                                                 seed)
    dz, dy, dx = GRID_D
    k_cld = k_sca_cld / np.float32(0.9999)
    with NcWriter(path) as w:
        for name, n, d in (("x", nx, dx), ("y", ny, dy), ("z", nz, dz)):
            w.def_dim(name, n)
            w.write(name, (np.arange(n) + 0.5) * d, (name,))
        f3 = ("z", "y", "x")
        w.write("tot_tau", k_ext * dz, f3)
        w.write("tot_ssa", (k_sca_gas + k_sca_cld) / k_ext, f3)
        w.write("tot_asy", np.where(k_cld > 0, asy_cld, 0.0), f3)
        w.write("cld_tau", k_cld * dz, f3)
        w.write("cld_ssa", np.where(k_cld > 0, 0.9999, 0.0), f3)
        w.write("cld_asy", np.where(k_cld > 0, asy_cld, 0.0), f3)
        for name in ("aer_tau", "aer_ssa", "aer_asy"):
            w.write(name, zeros, f3)
        w.write("albedo", np.full((ny, nx), ALBEDO), ("y", "x"))
        for name, v in (("sza", SZA), ("azi", 0.0),
                        ("tod_direct", TOD_FLUX / np.cos(SZA)),
                        ("tod_diffuse", 0.0), ("ngrid_z", kn[0]),
                        ("ngrid_y", kn[1]), ("ngrid_x", kn[2])):
            w.write_scalar(name, v)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _runner(nx, nz, ppp, ngpt, kn, mode, compact, respawn, device, **kw):
    """``run(seed) -> (RaytracerOutput summed over the g-points, aux)``."""
    ny = nx
    fields = [torch.as_tensor(f, device=device) for f in make_fields(nz, ny, nx)]
    alb = torch.full((ny, nx), ALBEDO, dtype=torch.float32, device=device)
    sun = rt.sun_direction_from_angles(SZA, 0.0)
    tod = TOD_FLUX / ngpt
    common = dict(photons_per_pixel=ppp, compact=compact,
                  respawn_mode=respawn, return_aux=True, **kw)

    def run(seed):
        if mode == "pooled":
            stack = [f.expand((ngpt,) + f.shape) for f in fields]
            return rt.trace_rays_pooled(
                seed, *stack, None, alb.expand(ngpt, ny, nx), kn, GRID_D,
                torch.full((ngpt,), tod, device=device),
                torch.zeros(ngpt, device=device), sun, **common)
        if mode == "lanes":
            stack = [f.expand((ngpt,) + f.shape) for f in fields]
            out, aux = rt.trace_rays_batched(
                [seed + g for g in range(ngpt)], *stack, None,
                alb.expand(ngpt, ny, nx), kn, GRID_D,
                torch.full((ngpt,), tod, device=device),
                torch.zeros(ngpt, device=device), sun, **common)
            return rt.RaytracerOutput(*(f.sum(0) for f in out)), aux
        total, aux = None, []
        for g in range(ngpt):
            out, a = rt.trace_rays(seed + g, *fields, None, alb, kn, GRID_D,
                                   tod, 0.0, sun, **common)
            total = out if total is None else rt.RaytracerOutput(
                *(x + y for x, y in zip(total, out)))
            aux.append(a)
        return total, aux[0] if ngpt == 1 else aux
    return run


def measure_mc(nx=64, nz=256, ppp=32, ngpt=1, kn=(4, 4, 4), mode="scan",
               compact=True, respawn="fifo", iters=3, reps=3, device="cuda",
               warmup=True, **kw):
    """Measure the forward MC tracer at the bench workload: the best over
    ``reps`` of the mean of ``iters`` synchronized runs (each run a new
    seed), after one warm-up run unless ``warmup`` is false (a process
    that has traced once already).  Returns a result dict; ``"out"`` and
    ``"aux"`` hold the last timed run's fluxes and loop counts (with the
    host ms of each width phase).  ``kw``
    (``compact_floor``, ``photons_per_lane``) goes to the tracer."""
    run = _runner(nx, nz, ppp, ngpt, kn, mode, compact, respawn, device, **kw)
    if warmup:
        run(0)
        _sync(device)
    best = float("inf")
    for rep in range(reps):
        t0 = time.perf_counter()
        for it in range(iters):
            out, aux = run(1000 + rep * iters + it)
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    sfc = float((out.flux_sfc_dir + out.flux_sfc_dif).mean())
    if not (np.isfinite(sfc) and sfc > 0):
        raise RuntimeError(f"bench_rt: surface flux {sfc}")
    n_photons = nx * nx * ppp * ngpt
    return {
        "metric": f"MC forward tracer photons/s ({nx}x{nx}x{nz}, "
                  f"{ngpt} gpt, {ppp} ppp, {mode})",
        "value": n_photons / best, "unit": "photons/s",
        "ms_per_gpt": best / ngpt * 1e3, "sfc_mean_wm2": sfc,
        "respawn": respawn, "knull": list(kn), "out": out, "aux": aux,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--nz", type=int, default=256)
    p.add_argument("--ppp", type=int, default=32)
    p.add_argument("--ngpt", type=int, default=1)
    p.add_argument("--knull", default="4,4,4", help="z,y,x")
    p.add_argument("--mode", choices=("scan", "pooled", "lanes"),
                   default="scan")
    p.add_argument("--respawn", default="fifo",
                   choices=("fifo", "arith", "pool", "auto"))
    p.add_argument("--no-compact", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    from .. import config

    dev = config.resolve_device(a.device)
    res = measure_mc(a.nx, a.nz, a.ppp, a.ngpt,
                     tuple(int(v) for v in a.knull.split(",")), a.mode,
                     not a.no_compact, a.respawn, device=dev)
    res.pop("out")
    res["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
