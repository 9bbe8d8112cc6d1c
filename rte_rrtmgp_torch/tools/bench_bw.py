"""Backward (camera) ray-tracer benchmark — ms per rendered frame.

The port's copy of the JAX package's root ``tools/bench_bw.py``: one
broadband fisheye frame (CAM x CAM pixels, PPP photons a pixel) over a
32x32x24 domain under 36 layers (``make_atmosphere(1024, 36, seed=4)``,
400 m layers, 500 m columns, knull (4, 4, 4), sun at mu0 0.7) with the
synthetic tables at one g-point a band: 14 spectral steps, each its own
photon loop ("scan") or all in one batched loop ("lanes").  Like the JAX
bench it passes the atmosphere's gases only (gas absorption and Rayleigh
scattering), not its cloud fields.

Reports ms per frame (CUDA events around synchronized frames on the card,
the host clock on the CPU), camera rays/s (pixels x ppp x spectral steps /
s), the photon-loop steps and the sun-transmission walk's sub-steps of the
frame, and ms a step by width phase (host clock).  ``--steps A:B`` renders
only spectral steps A..B-1 of the frame (one step's loop costs).

Usage (on a machine with a card):
    python -m rte_rrtmgp_torch.tools.bench_bw [--cam 64] [--ppp 16]
        [--nee walk|field] [--spectral scan|lanes] [--spd 4]
        [--respawn auto|pool|fifo] [--steps A:B]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..cases.profiles import make_atmosphere
from ..data import synthetic
from ..models import KDist
from ..models import raytracer_bw as rbw
from ..models.radiation_bw import RadiationSolverBW

NY = NX = 32
NZ, NLAY = 24, 36
GRID_D = (400.0, 500.0, 500.0)
KNULL = (4, 4, 4)
MU0 = 0.7
GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]


def make_render(cam: int = 64, ppp: int = 16, nee_mode: str = "walk",
                spectral_mode: str = "scan", steps_per_dispatch=4,
                respawn_mode: str = "auto", device="cuda",
                dtype=torch.float32, steps: slice = slice(None)):
    """``render(seed) -> (out, aux)`` of the bench frame (the solver's
    ``return_aux`` dict) and the number of spectral steps rendered:
    ``steps``, a slice of the frame's spectral steps."""
    kd = KDist.from_raw(synthetic.make_kdist_raw(False, gpt_per_band=1),
                        GASES, dtype=dtype, device=device)
    atm = make_atmosphere(NY * NX, NLAY, seed=4, perturb=True)
    cam_ = rbw.Camera(cam_type=0, ny=cam, nx=cam, fov=180.0,
                      position=(NX * GRID_D[2] / 2, NY * GRID_D[1] / 2, 100.0))
    solver = RadiationSolverBW(kd)
    ncol = NY * NX

    def render(seed):
        return solver.solve(
            gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
            p_lev=atm["p_lev"], t_lay=atm["t_lay"],
            mu0=np.full(ncol, MU0), azi=np.zeros(ncol),
            sfc_alb=np.full((ncol, kd.nbnd), 0.1),
            land_use_map=np.zeros(ncol), camera=cam_,
            grid_cells=(NZ, NY, NX), grid_d=GRID_D, kn_grid=KNULL,
            z_lev=np.arange(NLAY + 1) * GRID_D[0], photons_per_pixel=ppp,
            mode="broadband", seed=seed, nee_mode=nee_mode,
            spectral_mode=spectral_mode,
            steps_per_dispatch=steps_per_dispatch, respawn_mode=respawn_mode,
            return_aux=True, spectral_steps=steps, dtype=dtype)
    return render, len(range(kd.ngpt)[steps])


def loop_counts(aux) -> dict:
    """The frame's photon-loop steps and walk sub-steps, in all and by
    width phase (steps, sub-steps, host ms), summed over its traces (a
    ``lanes`` trace's steps are those of its longest render)."""
    steps = sub = pre = 0
    phases = {}
    for a in aux["traces"]:
        n = a["steps"] if isinstance(a["steps"], int) else max(a["steps"])
        steps += n
        sub += a["sub_steps"]
        pre += a["prepass_sub_steps"]
        prev = 0
        for w, s_end, ms, ns in zip(a["phase_widths"], a["phase_steps"],
                                    a["phase_ms"], a["phase_sub_steps"]):
            s_end = s_end if isinstance(s_end, int) else max(s_end)
            p = phases.setdefault(w, [0, 0, 0.0])
            p[0] += s_end - prev
            p[1] += ns
            p[2] += ms
            prev = s_end
    return {"steps": steps, "sub_steps": sub, "prepass_sub_steps": pre,
            "phases": {w: dict(steps=v[0], sub_steps=v[1], ms=v[2])
                       for w, v in sorted(phases.items(), reverse=True)}}


def measure_bw(cam: int = 64, ppp: int = 16, iters: int = 1, reps: int = 1,
               warmup: bool = False, device="cuda", **kw):
    """Time the bench frame: the best over ``reps`` of the mean of
    ``iters`` frames (each a new seed), after one untimed frame if
    ``warmup``.  Returns a result dict with the last frame's radiance
    (``"radiance"``) and loop counts."""
    dev = torch.device(device)
    render, n_steps = make_render(cam, ppp, device=dev, **kw)
    cuda = dev.type == "cuda"
    if warmup:
        render(0)
    best = float("inf")
    for rep in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
        t0 = time.perf_counter()
        for it in range(iters):
            out, aux = render(1 + rep * iters + it)
        if cuda:
            end.record()
            torch.cuda.synchronize(dev)
            ms = start.elapsed_time(end) / iters
        else:
            ms = (time.perf_counter() - t0) * 1e3 / iters
        best = min(best, ms)
    rad = out["radiance"]
    if not (bool(torch.isfinite(rad).all()) and float(rad.max()) > 0):
        raise RuntimeError("bench_bw: radiance not finite and positive")
    counts = loop_counts(aux)
    n_rays = cam * cam * ppp * n_steps
    return {
        "metric": f"bw camera render ({cam}x{cam} px, {ppp} ppp, "
                  f"{n_steps} spectral steps, {NX}x{NY}x{NZ} domain, walk "
                  f"blocks of {rbw.WALK_BLOCK})",
        "ms_per_frame": best, "camera_rays_per_s": n_rays / best * 1e3,
        "ms_per_step": best / max(counts["steps"], 1),
        "radiance_mean": float(rad.double().mean()), "radiance": rad,
        "spectral_steps": n_steps, **counts}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cam", type=int, default=64)
    p.add_argument("--ppp", type=int, default=16)
    p.add_argument("--nee", choices=("walk", "field"), default="walk")
    p.add_argument("--spectral", choices=("scan", "lanes"), default="scan")
    p.add_argument("--spd", default="4",
                   help="spectral steps a window (or 'auto': one window)")
    p.add_argument("--respawn", default="auto",
                   choices=("auto", "pool", "fifo"))
    p.add_argument("--steps", default=":", help="spectral steps A:B")
    p.add_argument("--iters", type=int, default=1)
    p.add_argument("--reps", type=int, default=1)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    from .. import config

    dev = config.resolve_device(a.device)
    steps = slice(*(int(v) if v else None for v in a.steps.split(":")))
    res = measure_bw(a.cam, a.ppp, a.iters, a.reps, warmup=True, device=dev,
                     nee_mode=a.nee, spectral_mode=a.spectral,
                     steps_per_dispatch=None if a.spd == "auto" else int(a.spd),
                     respawn_mode=a.respawn, steps=steps)
    res.pop("radiance")
    res["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
