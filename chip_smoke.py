#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``rte_rrtmgp_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py            # a few minutes, builds the kernels
    python3 chip_smoke.py --profile  # adds a torch.profiler table per layout

The flagship step (2048 columns x 72 layers, 256 LW + 224 SW g-points,
gpt_chunk 128, float32) runs in three layouts, which choose the kernels:

* ``default``: per-cell-weight gas optics (B1), column-major solvers (B2, B3);
* ``cellw_off``: weight-plane gas optics (B4 for the major gases, B5 for
  the minor ones), B2, B3;
* ``layer_major``: B1 on layer-major inputs, layer-major solvers (B6, B7).

Phases (any failure ends the run with a nonzero exit):

1. Card: name, power limit and device count.  No card -> exit 2.
2. Build: compiles ``rte_rrtmgp_torch/csrc/*.cu`` with nvcc for sm_90a and
   prints the build seconds and the ``-Xptxas -v`` register / shared-memory
   / spill lines.
3. Kernels: every launch of one step in each layout, and of one full-width
   ``gas_optics_lw`` + ``gas_optics_sw`` call (B5 outside the chunk loop),
   is recorded with its real inputs; each is replayed through its kernel
   and its plain PyTorch twin on the card and held to ``REL_TOL`` of the
   output's largest value, then both are timed with CUDA events beside the
   computed bound (inputs read once and outputs written once; a kernel's
   staging and scratch are never counted).  Each line names the launch
   geometry the wrapper chose (tile or g-points a block, branch) and the
   share of the bound reached.  The LW and SW wrappers' device allocation
   beyond their outputs is measured at the flagship shape (no scratch at 72
   layers: the working sets stay in shared memory).
4. Full steps through ``step.make_step``, one layout at a time: launch
   counts of one step (the counts set to 0 just before, read just after,
   held to the exact counts of that layout), ms/step and col*gpt/s over a
   few synchronized steps, physics sanity, and the fluxes against the same
   step with the plain twins on the card and against the default layout.
5. The user's path at the RCEMIP extent (in ``build/chip_cli``): the
   ``rcemip`` case generated by ``cases.inputs.make_case_files`` (4096
   columns x 256 layers, clouds, classic NetCDF), the tables loaded from
   it, the launches a solve makes in the solvers' default layout (with
   the LW and SW launch geometry: one 256-g LW chunk takes the
   sweep's device-scratch branch at 256 layers), then ``cli.main``
   broadband (``--cloud-optics --delta-cloud --timings 3``), the same with
   the plain twins, and by band (``--output-bnd-fluxes``), each held to
   its exact launch counts; the broadband fluxes of the three within
   ``STEP_TOL_WM2``; ``cases.check.self_consistency`` on the broadband and
   by-band files and ``check.compare`` between them at 5.8e-2 W m-2; then
   ``cases.rfmip.run`` (18 experiments x 100 sites x 60 layers), its
   launch counts, ms per experiment and fluxes.
6. The forward Monte-Carlo tracer (in ``build/chip_rt``): the MC workload
   of ``bench.py`` (64x64x256, 32 photons a pixel, 1 g-point, fifo) through
   ``tools/bench_rt.py`` at knull (4,4,4) and (32,48,48): photons/s, ms per
   g-point, the steps and ms a step of each width phase, the flux at the
   top exact and energy closed within ``RT_CLOSURE``; one profiled trace
   cut at ``RT_PROFILE_STEPS`` (device events a step, busy share);
   ``cli_rt`` on the ``rcemip``
   atmosphere at 64x64x256 with one g-point (cloudy, cloudy with
   ``--longwave`` — its kernel launches replayed against their twins —,
   Mie clouds, clear sky), each timed as pass 1 + MC, held to its exact
   launch counts and energy closure, the clear sky's surface fluxes within
   ``RT_TWOSTREAM_TOL`` of the two-stream's; ``cli_rt_lite`` on the bench
   optics; the tracer on the card against the CPU within 4 sigma.
7. The backward (camera) tracer (in ``build/chip_bw``): the JAX README's
   headline frame through ``tools/bench_bw.py`` (a 64x64 px broadband
   fisheye frame, 14 spectral steps, over 32x32x24 cells under 36 layers,
   knull (4,4,4), walk NEE, ``lanes`` in one window; ``BW_PPP`` photons a
   pixel, cut from 16: a grazing-ray tail of thousands of host-bound steps
   sets a frame's time, so the frame in scan mode and with the field NEE
   (``tools/bench_bw.py --spectral scan`` / ``--nee field``, 1.5-4 min
   each) stays out of this script's time limit) with ms a frame, camera
   rays/s, the photon-loop steps, the walk's sub-steps and ms a step by
   width phase; one profiled trace cut at ``BW_PROFILE_STEPS`` steps
   (device events a step, busy share); ``cli_bw`` on the ``rcemip``
   atmosphere (64x64 columns, 256 layers, the lowest ``BW_CLI_NZ`` rendered
   in 3D, a ``BW_CLI_CAM``-pixel TOA camera written in the classic form)
   broadband with ``--cloud-optics --cloud-cam --nee-mode field`` in the
   CLI's default scan (scan and the field NEE at the user's entry point),
   then ``--image --n-sub 2`` in ``lanes`` with the walk NEE, each timed
   as gas optics + render, with its peak device memory and
   its exact gas-optics launch count, the launches replayed against their
   twins; ``cli_rt_lite --bw-raytracing`` on the bench optics; physics
   checks (the vacuum Lambertian limit, an absorbing
   layer, fifo against pool, field against walk NEE), the render on the
   card against the CPU within 4 sigma, and the cloud-camera images
   against the CPU's within 1e-5 of their largest value.
8. The sharding layer (``rte_rrtmgp_torch/parallel``): the flagship step
   on a (4,) cols mesh and a (2, 2) cols x gpt mesh, each listing the card
   4 times, and ``RadiationSolverLW/SW.solve(mesh=)`` on the (4,) mesh,
   each within ``STEP_TOL_WM2`` of the unsharded run with its exact launch
   counts summed over the shards, ms/step beside the unsharded step's; a
   one-process NCCL group; two processes of ``tools/multihost_smoke.py``
   sharing the card over gloo, the gpt axis across them, their means
   against each other and the one-process run; the gradient guard (a
   float32 input requiring grad raises; float64 on the card differentiates
   as on the CPU).
9. The solvers' ``dtype=`` at the RCEMIP extent (phase 5's case, its
   inputs as NumPy float64 arrays, clouds, one spectral chunk, the default
   layout): (a) float32 tables with ``dtype=torch.float32`` launch B1 2,
   B2 1 and B3 1 for an LW + SW pair, each launch replayed against its
   twin, the fluxes within ``STEP_TOL_WM2`` of phase 5's broadband run;
   (b) float32 tables with ``dtype`` None solve in float64 (no launch)
   within ``DTYPE_GAP_WM2`` of a float64-tables solve; (c) float64 tables
   with ``dtype=torch.float32``: float64, no launch, within
   ``DTYPE_GAP_WM2`` of (b); ms a solve of each.  Then the three
   walkthroughs (``rte_rrtmgp_torch/examples``) on the card, each passing
   its own asserts, with their launches; ``basic_usage``'s float64
   gradient within ``GRAD_RTOL`` of the CPU's.
10. The repository's tools around the main path
   (``rte_rrtmgp_torch/tools``, in ``build/chip_tools``): ``crosscheck``
   (the ``allsky`` and ``aerosky`` cases through the CLI in CPU float64,
   CPU float32 and card float32, the card within 0.7 W m-2 of the CPU's
   float32, each card run's B1-B3 launches held to the exact counts of the
   default layout at ``gpt_chunk`` 64; the aerosol optics on the
   card); ``profile_stages`` at the flagship shape in the three layouts
   and at 4096x256 in the default layout: the step profiled, the card's
   time by the driver's stage ranges, their sum between 90% and 100% of
   the step's device ms, the profiled step's fluxes within
   ``STEP_TOL_WM2`` of an unprofiled ``make_step``'s; ``ablate`` at the
   flagship shape (B5 launched); ``bench_rt_solve`` at ``RT_SOLVE_CUT``
   (one solve of 14 g-points in ``lanes`` over the full 64x64 columns at 4
   photons a pixel), its flux at the top exact and energy closed within
   ``RT_CLOSURE``; ``scaling_bench`` on meshes of 1, 2 and
   4 positions in both modes, each within ``STEP_TOL_WM2`` of the
   unsharded step.
11. One line ``{"kernels": [...]}`` (each kernel's numbers from the layout
   that runs it in phase 4), then the last line ``{"ok": true, "device":
   {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

NCOL, NLAY = 2048, 72
GPT_PER_BAND, GPT_CHUNK = 16, 128
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# Kernel vs twin: float32 g-sums in another order (warp shuffles) and, for
# the solvers, a direct beam by running product vs cumprod.
REL_TOL = 1e-5
STEP_TOL_WM2 = 0.1             # step with kernels vs twins / vs default
CLI_DIR = os.path.join("build", "chip_cli")
CLI_TIMINGS = 3                # --timings of the CLI runs
RFMIP_EXPERIMENTS = 18
RT_DIR = os.path.join("build", "chip_rt")
RT_NX, RT_NZ, RT_PPP = 64, 256, 32   # bench.py's MC workload, the RCEMIP extent
RT_GPT = 150                   # cli_rt --single-gpt: a visible band (10 of 14)
RT_CLOSURE = 0.02              # MC energy closure (tests/test_radiation_rt.py)
RT_TWOSTREAM_TOL = 0.05        # clear-sky MC vs two-stream (ibid.)
RT_SEEDS = 6                   # card vs CPU: seeds on each side
RT_PROFILE_STEPS = 256         # steps of the profiled trace
BW_DIR = os.path.join("build", "chip_bw")
BW_CAM = 64                    # the headline frame's camera (64x64 px)
BW_PPP = 1                     # photons a pixel of the frame (the JAX bench: 16)
BW_PROFILE_STEPS = 16          # steps of the profiled camera trace
BW_CLI_NZ = 128                # cli_bw: 3D layers of 256 (the uniform half)
BW_CLI_CAM, BW_CLI_PPP = 8, 1  # cli_bw / cli_rt_lite: TOA camera px a side, ppp
BW_SEEDS = 12                  # card vs CPU: seeds on each side
BW_MEANS_TOL = {"fifo": 0.05, "field": 0.08}   # tests/test_raytracer_bw.py
N_ROUNDS, N_STEPS = 3, 5       # step timing
MESH_PROC_COLS = 1024          # columns a process of the two-process run
MESH_PROC_TIMEOUT = 300        # seconds for the two processes
MESH_MEAN_RTOL = 1e-5          # float32 flux means, sums in another order
GRAD_NCOL, GRAD_RTOL = 16, 1e-10   # float64 gradient, card vs CPU
DTYPE_GAP_WM2 = 1e-3           # phase 9 (b) vs float64 tables, (c) vs (b)
TOOLS_DIR = os.path.join("build", "chip_tools")
TOOLS_BIG = (4096, 256)        # profile_stages at the RCEMIP extent
SCALING_NCOL = 1024            # scaling_bench's columns a mesh position
# bench_rt_solve's cut: the full 64x64 columns at 4 photons a pixel (of
# 16), one g-point a band (14 of 224) traced in one batched loop (``lanes``:
# the longest walk's tail once, not 14 times), no warm-up solve (phases 1-9
# have warmed the card): 41.7 s a solve where 16 photons a pixel took 73.7
# s in lanes and 509 s in the tool's default scan.
RT_SOLVE_CUT = dict(nx=64, nlay=256, nz=64, ppp=4, gpt_per_band=1,
                    spectral="lanes", warmup=0)
SIGMA = 5.670374419e-8
LAYOUTS = {"default": dict(cellw=True, layer_major=False),
           "cellw_off": dict(cellw=False, layer_major=False),
           "layer_major": dict(cellw=True, layer_major=True)}
PALLAS = "rte_rrtmgp_tpu/ops/pallas/"
CSRC = "rte_rrtmgp_torch/csrc/"
# Each kernel's source, the TPU kernel it replaces, and the layout whose
# step reports its launches and times.
KERNEL_INFO = {
    "gas_optics_interp": dict(source=CSRC + "gas_optics_interp.cu",
                              replaces=PALLAS + "interp_kernel.py:725",
                              layout="default"),
    "lw_sweep": dict(source=CSRC + "lw_sweep.cu",
                     replaces=PALLAS + "solver_kernels.py:127",
                     layout="default"),
    "sw_2stream": dict(source=CSRC + "sw_2stream.cu",
                       replaces=PALLAS + "solver_kernels.py:272",
                       layout="default"),
    "interp_rows_multi": dict(source=CSRC + "interp_rows.cu",
                              replaces=PALLAS + "interp_kernel.py:862",
                              layout="cellw_off"),
    "interp_rows": dict(source=CSRC + "interp_rows.cu",
                        replaces=PALLAS + "interp_kernel.py:977",
                        layout="cellw_off"),
    "lw_sweep_lm": dict(source=CSRC + "lw_sweep.cu",
                        replaces=PALLAS + "solver_layergrid.py:151",
                        layout="layer_major"),
    "sw_2stream_lm": dict(source=CSRC + "sw_2stream.cu",
                          replaces=PALLAS + "solver_layergrid.py:399",
                          layout="layer_major"),
}


# Wrappers that launch another wrapper's kernel: the fused SW entries run
# B3 / B7 on the gas optics and count as their launches.
LAUNCHED_AS = {"sw_2stream_fused": "sw_2stream",
               "sw_2stream_fused_lm": "sw_2stream_lm"}


def recorded(calls: dict) -> dict:
    """Launches of each kernel counter in ``record``'s calls by wrapper."""
    got = {}
    for name, recs in calls.items():
        if recs:
            k = LAUNCHED_AS.get(name, name)
            got[k] = got.get(k, 0) + len(recs)
    return got


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


class Patch:
    """Replace module attributes for the duration of a ``with`` block."""

    def __init__(self, *triples):
        self.triples = triples
        self.saved = []

    def __enter__(self):
        for mod, name, fn in self.triples:
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        return False


def bound(bytes_moved: float, ops: float):
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def expected_launches(kd_lw, kd_sw, gpt_chunk):
    """Exact kernel launches of one LW + SW broadband solve (one Gauss
    angle) in each layout, at ``gpt_chunk`` g-points a chunk (None: one
    chunk a spectrum).  Each chunk makes one gas-optics launch and one
    solver launch; ``interp_rows`` runs once per chunk that has minor
    intervals, counted from the chunked k-distributions."""
    from rte_rrtmgp_torch.models.radiation import _chunks

    chunks = [kd.slice_gpt(g0, g1) for kd in (kd_lw, kd_sw)
              for g0, g1 in _chunks(kd.ngpt, gpt_chunk)]
    n_lw = len(_chunks(kd_lw.ngpt, gpt_chunk))
    n_sw = len(chunks) - n_lw
    n_minor = sum(bool(c.minor_lower or c.minor_upper) for c in chunks)
    return {
        "default": {"gas_optics_interp": n_lw + n_sw, "lw_sweep": n_lw,
                    "sw_2stream": n_sw},
        "cellw_off": {"interp_rows_multi": n_lw + n_sw,
                      "interp_rows": n_minor, "lw_sweep": n_lw,
                      "sw_2stream": n_sw},
        "layer_major": {"gas_optics_interp": n_lw + n_sw,
                        "lw_sweep_lm": n_lw, "sw_2stream_lm": n_sw},
    }


def scaled(counts: dict, n: int) -> dict:
    """Launch counts of ``n`` solves."""
    return {k: v * n for k, v in counts.items() if v}


def cli_phase(dev, twins, record, replay, lw_scratch):
    """The user's path at the RCEMIP extent: generate the case, run the CLI
    (broadband, with the plain twins, by band), check the files, run the
    RFMIP sweep.  Each run's launch counts are set to 0 just before it and
    held to the exact counts of the default layout just after.  One
    more broadband run is recorded and its kernel launches replayed against
    their twins at the CLI's shapes (``record`` / ``replay`` / ``lw_scratch``
    of ``main``)."""
    import numpy as np
    import torch

    from rte_rrtmgp_torch import cli
    from rte_rrtmgp_torch.cases import check, inputs, rfmip
    from rte_rrtmgp_torch.cases.profiles import make_atmosphere
    from rte_rrtmgp_torch.models import CloudLUT, KDist
    from rte_rrtmgp_torch.ops import kernels
    from rte_rrtmgp_torch.ops.kernels import solvers as k_solvers
    from rte_rrtmgp_torch.utils.ncio import NcReader

    os.makedirs(CLI_DIR, exist_ok=True)
    t0 = time.perf_counter()
    paths = inputs.make_case_files(CLI_DIR, "rcemip", gpt_per_band=GPT_PER_BAND)
    with NcReader(paths["input"]) as nc:
        nx, ny, nlay = nc.dim("x"), nc.dim("y"), nc.dim("lay")
    ncol = nx * ny
    print(f"[cli] case generation (rcemip, {nx}x{ny} columns x {nlay} "
          f"layers, clouds, classic NetCDF): {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    gases = make_atmosphere(1, nlay)["gas_concs"].names()
    kd_lw = KDist.from_netcdf(paths["coefs_lw"], gases, device=dev)
    kd_sw = KDist.from_netcdf(paths["coefs_sw"], gases, device=dev)
    for k in ("cloud_lw", "cloud_sw"):
        CloudLUT.from_netcdf(paths[k], device=dev)
    torch.cuda.synchronize()
    print(f"[cli] table load (LW + SW k-distributions and cloud tables from "
          f"NetCDF onto the card): {(time.perf_counter() - t0) * 1e3:.1f} ms")

    per_solve = expected_launches(kd_lw, kd_sw, None)["default"]
    print(f"[cli] launches per LW + SW solve (default layout): {per_solve}")
    geo = k_solvers.lw_geometry(ncol, nlay, kd_lw.ngpt)
    print(f"[lw] cli {ncol}x{nlay} G={kd_lw.ngpt} (one chunk): "
          f"{geo.describe()}")
    if not geo.scratch_floats:
        fail(f"LW sweep at {nlay} layers: expected the device-scratch branch")
    print(f"[sw] cli {ncol}x{nlay} G={kd_sw.ngpt} (one chunk): "
          f"{k_solvers.sw_geometry(ncol, nlay, kd_sw.ngpt).describe()}")

    files = ["--input", paths["input"], "--coefs-lw", paths["coefs_lw"],
             "--coefs-sw", paths["coefs_sw"], "--cloud-lw", paths["cloud_lw"],
             "--cloud-sw", paths["cloud_sw"], "--aerosol", paths["aerosol"]]
    out = {k: os.path.join(CLI_DIR, f"out_{k}.nc")
           for k in ("broadband", "plain", "bybnd", "recorded")}
    clouds = ["--cloud-optics", "--delta-cloud"]

    # Each kernel at the CLI's shapes against its twin, timed beside its
    # bound (one broadband solve of each spectrum, recorded).
    calls = record(lambda: cli.main(files + ["--output", out["recorded"]]
                                    + clouds))
    got = recorded(calls)
    if got != per_solve:
        fail(f"cli recorded run: launches {got}, expected {per_solve}")
    extra, helper, C, L, G = lw_scratch("lw_sweep", *calls["lw_sweep"][0])
    print(f"[lw] cli lw_sweep device scratch at {C}x{L} G={G}: {helper} "
          f"B by the wrapper's geometry, {extra} B allocated beyond the "
          "outputs (measured)")
    for name, recs in calls.items():
        if recs:
            replay(name, recs, "cli")
    del calls

    def run(name, flags, expected, timings=0, patch=None):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        argv = files + ["--output", out[name]] + flags
        if timings:
            argv += ["--timings", str(timings)]
        if patch is None:
            rc = cli.main(argv)
        else:
            with patch:
                rc = cli.main(argv)
        torch.cuda.synchronize()
        got = {k: v for k, v in kernels.launch_counts().items() if v}
        print(f"[cli] {name}: rc {rc}, {time.perf_counter() - t0:.2f} s "
              f"(reads, {1 + timings} solves of each spectrum, writes); peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
              f"GiB; launches {got}")
        if rc != 0 or got != expected:
            fail(f"cli {name}: rc {rc}, launches {got}, expected {expected}")

    run("broadband", clouds, scaled(per_solve, 1 + CLI_TIMINGS),
        CLI_TIMINGS)
    run("plain", clouds, {}, patch=twins)
    gas_only = {"gas_optics_interp": per_solve["gas_optics_interp"]}
    run("bybnd", clouds + ["--output-bnd-fluxes"],
        scaled(gas_only, 1 + CLI_TIMINGS), CLI_TIMINGS)

    with NcReader(out["broadband"]) as nb, NcReader(out["plain"]) as npl, \
            NcReader(out["bybnd"]) as nbb:
        names = [v for v in check.DEFAULT_VARS if nb.has(v)]
        if len(names) != len(check.DEFAULT_VARS):
            fail(f"cli broadband output holds only {names}")
        for what, other in (("plain twins", npl), ("by-band run", nbb)):
            worst = {}
            for v in names:
                a, b = nb.read(v), other.read(v)
                if a.shape != (nlay + 1, ny, nx) or a.shape != b.shape:
                    fail(f"cli {v}: shapes {a.shape} / {b.shape}")
                worst[v] = float(np.abs(a.astype(np.float64) - b).max())
            print(f"[cli] broadband vs {what} (W m-2): " + ", ".join(
                f"{k}={v:.3e}" for k, v in worst.items()))
            if max(worst.values()) > STEP_TOL_WM2:
                fail(f"cli broadband vs {what}: {max(worst.values()):.3e} "
                     f"W m-2 > {STEP_TOL_WM2}")
    for name in ("broadband", "bybnd"):
        if not check.self_consistency(out[name], verbose=False):
            fail(f"cli {name}: self_consistency failed")
    print("[cli] self_consistency passes on the broadband and by-band files")
    if not check.compare(out["bybnd"], out["broadband"]):
        fail("cli: compare(by-band, broadband) above its 5.8e-2 W m-2 gate")
    print("[cli] compare(by-band, broadband) within 5.8e-2 W m-2")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    path = rfmip.run(CLI_DIR, n_experiments=RFMIP_EXPERIMENTS, device=dev)
    dt = time.perf_counter() - t0
    got = {k: v for k, v in kernels.launch_counts().items() if v}
    expected = scaled(per_solve, RFMIP_EXPERIMENTS)
    print(f"[rfmip] {RFMIP_EXPERIMENTS} experiments x 100 sites x 60 layers "
          f"(float32, clear sky): {dt * 1e3 / RFMIP_EXPERIMENTS:.1f} ms per "
          "experiment (host clock over the whole run, tables loaded and "
          f"file written included; each experiment's own ms above); "
          f"launches {got}")
    if got != expected:
        fail(f"rfmip launches {got}, expected {expected}")
    with NcReader(path) as nc:
        for v in ("rld", "rlu", "rsd", "rsu"):
            a = nc.read(v)
            if a.shape != (RFMIP_EXPERIMENTS, 61, 100) or \
                    not np.isfinite(a).all() or a.min() < 0:
                fail(f"rfmip {v}: shape {a.shape}, finite "
                     f"{np.isfinite(a).all()}, min {a.min()}")
    print(f"[rfmip] rld/rlu/rsd/rsu finite and non-negative, "
          f"({RFMIP_EXPERIMENTS}, 61, 100)")
    return paths, out["broadband"]


def closure(out, dz) -> float:
    """Relative energy closure of MC fluxes: TOD up + net surface + the
    column's absorption, against the incident flux (domain means)."""
    import numpy as np

    m = lambda a: float(np.asarray(a, np.float64).mean())
    toa = m(out["tod_dn"])
    absorbed = float((np.asarray(out["abs_dir"], np.float64)
                      + np.asarray(out["abs_dif"], np.float64))
                     .mean(axis=(1, 2)).sum() * dz)
    return (m(out["tod_up"]) + m(out["sfc_dir"]) + m(out["sfc_dif"])
            - m(out["sfc_up"]) + absorbed - toa) / toa


def tracer_phase(dev, card, record, replay):
    """6. The forward Monte-Carlo tracer: the MC workload of ``bench.py``
    (through ``tools/bench_rt.py``) at both knull grids, one profiled
    trace, ``cli_rt`` at the RCEMIP extent (pass 1 and MC timed apart,
    exact gas-optics and LW launch counts, energy closure, clear sky
    against the two-stream), ``cli_rt_lite`` at 64x64x256, and the tracer
    on the card against the CPU.  Every line names the card."""
    import numpy as np
    import torch

    from rte_rrtmgp_torch import cli_rt, cli_rt_lite
    from rte_rrtmgp_torch.cases import inputs
    from rte_rrtmgp_torch.cases.profiles import make_atmosphere
    from rte_rrtmgp_torch.data import synthetic
    from rte_rrtmgp_torch.models import KDist
    from rte_rrtmgp_torch.models import radiation_rt, raytracer
    from rte_rrtmgp_torch.ops import kernels
    from rte_rrtmgp_torch.tools import bench_rt
    from rte_rrtmgp_torch.utils.ncio import NcReader

    tag = f"[rt] ({card})"
    os.makedirs(RT_DIR, exist_ok=True)

    # ---- the MC workload (bench.py:190-225) ----
    ppp, n_photons = RT_PPP, RT_NX * RT_NX * RT_PPP
    # One timed trace each, no warm-up trace: a trace is seconds of
    # host-bound steps, and phases 1-5 have warmed the card and allocator.
    for kn in ((4, 4, 4), (32, 48, 48)):
        res = bench_rt.measure_mc(nx=RT_NX, nz=RT_NZ, ppp=ppp, kn=kn,
                                  iters=1, reps=1, device=dev, warmup=False)
        aux, out = res["aux"], res["out"]
        print(f"{tag} MC {RT_NX}x{RT_NX}x{RT_NZ}, {ppp} ppp, 1 g-point, "
              f"knull {kn}, {aux['respawn_mode']}: {res['value']:.1f} "
              f"photons/s, {res['ms_per_gpt']:.2f} ms per g-point (one "
              f"synchronized trace); {aux['n_lanes']} lanes x "
              f"{aux['ppl']} photons a lane, {aux['steps']} steps")
        prev = 0
        for w, s_end, ms in zip(aux["phase_widths"], aux["phase_steps"],
                                aux["phase_ms"]):
            n = s_end - prev
            prev = s_end
            print(f"{tag}   width {w}: {n} steps, "
                  f"{ms / max(n, 1):.3f} ms a step (host clock, {ms:.1f} ms)")
        got = {k: getattr(out, "flux_" + k) for k in
               ("sfc_dir", "sfc_dif", "sfc_up", "tod_up", "abs_dir",
                "abs_dif")}
        got["tod_dn"] = out.flux_toa_down
        sfc = (got["sfc_dir"] + got["sfc_dif"]).double()
        if not (bool(torch.isfinite(sfc).all()) and float(sfc.min()) >= 0
                and float(sfc.mean()) > 0):
            fail(f"MC knull {kn}: surface fluxes not finite, non-negative "
                 "and of positive mean")
        toa = float(got["tod_dn"].double().mean())
        if abs(toa - bench_rt.TOD_FLUX) > 1e-5 * bench_rt.TOD_FLUX:
            fail(f"MC knull {kn}: flux_toa_down {toa}, exact "
                 f"{bench_rt.TOD_FLUX}")
        c = closure({k: v.cpu().numpy() for k, v in got.items()},
                    bench_rt.GRID_D[0])
        print(f"{tag}   toa_down {toa:.4f} W m-2 (exact {bench_rt.TOD_FLUX}), "
              f"energy closure {c:+.4%}")
        if abs(c) > RT_CLOSURE:
            fail(f"MC knull {kn}: energy closure {c:+.4%}")

    # One profiled trace, cut at RT_PROFILE_STEPS steps (all in the widest
    # phase; a whole trace under the profiler takes minutes): device events
    # a step and the card's busy time (the kernels' summed device time),
    # against the profiled span and against the same trace unprofiled
    # (the profiler slows the host).
    from rte_rrtmgp_torch.tools.profile_stages import device_rows, profiled

    fields = [torch.as_tensor(f, device=dev)
              for f in bench_rt.make_fields(RT_NZ, RT_NX, RT_NX)]
    alb = torch.full((RT_NX, RT_NX), bench_rt.ALBEDO, device=dev)
    sun = raytracer.sun_direction_from_angles(bench_rt.SZA, 0.0)
    trace = lambda seed: raytracer.trace_rays(
        seed, *fields, None, alb, (4, 4, 4), bench_rt.GRID_D,
        bench_rt.TOD_FLUX, 0.0, sun, photons_per_pixel=ppp,
        respawn_mode="fifo", max_steps=RT_PROFILE_STEPS, return_aux=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace(7)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    (_, aux), prof = profiled(lambda: trace(7), dev)
    span = (time.perf_counter() - t0) * 1e3
    dev_rows = device_rows(prof)
    busy = sum(e.device_time_total for e in dev_rows) / 1e3
    events = sum(e.count for e in dev_rows)
    print(f"{tag} profiled trace (knull (4,4,4), its first {aux['steps']} "
          f"steps, width {aux['phase_widths'][0]}): device busy {busy:.1f} "
          f"ms in a profiled span of {span:.1f} ms ({busy / span:.1%}) and "
          f"{busy / plain_ms:.1%} of the same steps unprofiled "
          f"({plain_ms:.1f} ms, {plain_ms / aux['steps']:.3f} ms a step); "
          f"{events} device events, {events / aux['steps']:.1f} a step")
    for e in dev_rows[:6]:
        print(f"{tag}   {e.device_time_total / 1e3:9.3f} ms {e.count:7d}x "
              f"{e.key[:90]}")
    del fields, prof, dev_rows

    # ---- cli_rt at the RCEMIP extent ----
    t0 = time.perf_counter()
    paths = inputs.make_case_files(RT_DIR, "rcemip", gpt_per_band=GPT_PER_BAND)
    atm = make_atmosphere(RT_NX * RT_NX, RT_NZ, seed=0, perturb=True)
    inputs.write_input_nc(paths["input"], atm, RT_NX, RT_NX,
                          rt_grid={"nz": RT_NZ, "ngrid_x": 4, "ngrid_y": 4,
                                   "ngrid_z": 4})
    mie = os.path.join(RT_DIR, "mie_lut_broadband.nc")
    synthetic.write_mie_nc(mie, synthetic.make_mie_raw())
    with NcReader(paths["input"]) as nc:
        z = nc.read("z")
    dz = float(z[1] - z[0])
    print(f"{tag} cli_rt case: rcemip atmosphere {RT_NX}x{RT_NX} columns x "
          f"{RT_NZ} layers, rt grid nz {RT_NZ} knull (4,4,4), dz {dz:.2f} m; "
          f"files {time.perf_counter() - t0:.2f} s")
    gases = make_atmosphere(1, RT_NZ)["gas_concs"].names()
    kd_sw = KDist.from_netcdf(paths["coefs_sw"], gases, device=dev)
    band = kd_sw.gpt2band[RT_GPT - 1]
    sw_counts = {"gas_optics_interp": 1}
    files = ["--input", paths["input"], "--coefs-sw", paths["coefs_sw"],
             "--coefs-lw", paths["coefs_lw"], "--cloud-sw", paths["cloud_sw"],
             "--cloud-lw", paths["cloud_lw"], "--mie-file", mie]
    base = ["--raytracing", str(RT_PPP), "--two-stream", "--single-gpt",
            str(RT_GPT)]
    runs = {
        "cloudy": (["--cloud-optics", "--delta-cloud"], sw_counts),
        "cloudy_longwave": (["--cloud-optics", "--delta-cloud", "--longwave"],
                            {"gas_optics_interp": 2, "lw_sweep": 1}),
        "mie": (["--cloud-mie", "--liq-cloud-optics", "--delta-cloud"],
                sw_counts),
        "clear": ([], sw_counts),
    }
    print(f"{tag} cli_rt flags {' '.join(base)} (g-point {RT_GPT}, band "
          f"{band + 1})")
    timing = {}
    orig_pass1 = radiation_rt._pass1
    orig_solve = radiation_rt.RadiationSolverRT.solve

    def timed_pass1(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = orig_pass1(*a, **kw)
        torch.cuda.synchronize()
        timing["pass1"] = timing.get("pass1", 0.0) + time.perf_counter() - t
        return r

    def timed_solve(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = orig_solve(self, *a, **kw)
        torch.cuda.synchronize()
        timing["solve"] = time.perf_counter() - t
        return r

    timers = Patch((radiation_rt, "_pass1", timed_pass1),
                   (radiation_rt.RadiationSolverRT, "solve", timed_solve))
    for name, (flags, expected) in runs.items():
        out_path = os.path.join(RT_DIR, f"out_{name}.nc")
        argv = files + base + flags + ["--output", out_path]
        timing.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        rcs = []
        with timers:
            if name == "cloudy_longwave":
                calls = record(lambda: rcs.append(cli_rt.main(argv)))
            else:
                rcs.append(cli_rt.main(argv))
        rc = rcs[0]
        torch.cuda.synchronize()
        got = {k: v for k, v in kernels.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        solve_ms, p1_ms = timing["solve"] * 1e3, timing["pass1"] * 1e3
        print(f"{tag} cli_rt {name}: rc {rc}, {solve_ms:.1f} ms a solve = "
              f"pass 1 (gas optics, two-stream) {p1_ms:.1f} ms + MC "
              f"{solve_ms - p1_ms:.1f} ms; peak device memory {peak:.3f} GiB; "
              f"launches {got}")
        if rc != 0 or got != expected:
            fail(f"cli_rt {name}: rc {rc}, launches {got}, expected {expected}")
        with NcReader(out_path) as nc:
            o = {k: nc.read("rt_flux_" + k) for k in
                 ("tod_dn", "tod_up", "sfc_dir", "sfc_dif", "sfc_up",
                  "abs_dir", "abs_dif")}
            ts_dn, ts_dir = nc.read("sw_flux_dn")[0], nc.read("sw_flux_dn_dir")[0]
            if name == "cloudy_longwave":
                lw_up = nc.read("lw_flux_up")
                if not np.isfinite(lw_up).all() or lw_up.min() <= 0:
                    fail("cli_rt --longwave: lw_flux_up not finite and positive")
        if not all(np.isfinite(v).all() for v in o.values()):
            fail(f"cli_rt {name}: non-finite MC fluxes")
        c = closure(o, dz)
        mc_sfc = float((o["sfc_dir"] + o["sfc_dif"]).astype(np.float64).mean())
        mc_dir = float(o["sfc_dir"].astype(np.float64).mean())
        msg = (f"{tag} cli_rt {name}: energy closure {c:+.4%}; surface MC "
               f"{mc_sfc:.3f} (direct {mc_dir:.3f}) vs two-stream "
               f"{float(ts_dn.mean()):.3f} ({float(ts_dir.mean()):.3f}) W m-2")
        print(msg)
        if abs(c) > RT_CLOSURE:
            fail(f"cli_rt {name}: energy closure {c:+.4%}")
        if name == "clear":
            for what, a, b in (("total", mc_sfc, float(ts_dn.mean())),
                               ("direct", mc_dir, float(ts_dir.mean()))):
                if abs(a - b) > RT_TWOSTREAM_TOL * b:
                    fail(f"cli_rt clear sky: MC {what} {a:.3f} vs two-stream "
                         f"{b:.3f} W m-2")
        if name == "cloudy_longwave":
            for kname, recs in calls.items():
                if recs:
                    replay(kname, recs, "cli_rt")
            del calls

    # ---- cli_rt_lite on the bench optics ----
    lite_in = os.path.join(RT_DIR, "rt_lite_input.nc")
    lite_out = os.path.join(RT_DIR, "rt_lite_output.nc")
    bench_rt.write_lite_input(lite_in, RT_NZ, RT_NX, RT_NX)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli_rt_lite.main(["--input", lite_in, "--output", lite_out,
                           "--raytracing", str(RT_PPP)])
    dt = time.perf_counter() - t0
    with NcReader(lite_out) as nc:
        o = {k: nc.read("flux_" + k) for k in
             ("tod_dn", "tod_up", "sfc_dir", "sfc_dif", "sfc_up", "abs_dir",
              "abs_dif")}
    c = closure(o, bench_rt.GRID_D[0])
    print(f"{tag} cli_rt_lite {RT_NX}x{RT_NX}x{RT_NZ}, {RT_PPP} ppp: rc {rc}, "
          f"{dt * 1e3:.1f} ms (read, trace, write); energy closure {c:+.4%}")
    if rc != 0 or abs(c) > RT_CLOSURE:
        fail(f"cli_rt_lite: rc {rc}, energy closure {c:+.4%}")

    # ---- the tracer on the card against the CPU ----
    rng = np.random.default_rng(2)
    shape = (8, 6, 6)
    kg = rng.uniform(1e-5, 1e-4, shape)
    cld = np.where(rng.random(shape) < 0.4, rng.uniform(1e-3, 5e-3, shape), 0.0)
    small = [kg + cld, 0.5 * kg, 0.99 * cld, np.zeros(shape),
             np.where(cld > 0, 0.85, 0.0), np.zeros(shape)]
    alb_s = rng.uniform(0.05, 0.3, shape[1:])

    def means(device, seed):
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        o = raytracer.trace_rays(seed, *map(t, small), None, t(alb_s),
                                 (2, 2, 2), (500.0, 800.0, 700.0), 900.0,
                                 100.0, raytracer.sun_direction_from_angles(
                                     0.6, 0.3), photons_per_pixel=64)
        return {n: float(getattr(o, n).double().mean()) for n in o._fields}

    card_runs = [means(dev, s) for s in range(RT_SEEDS)]
    cpu_runs = [means(torch.device("cpu"), s) for s in range(RT_SEEDS)]
    worst = 0.0
    for name in card_runs[0]:
        a = np.array([r[name] for r in card_runs])
        b = np.array([r[name] for r in cpu_runs])
        sigma = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / RT_SEEDS)
        diff = abs(a.mean() - b.mean())
        worst = max(worst, diff / sigma if sigma > 0 else 0.0)
        print(f"{tag} card vs CPU {shape}, 64 ppp, {RT_SEEDS} seeds each: "
              f"{name} {a.mean():.5f} vs {b.mean():.5f} (sigma of the "
              f"difference {sigma:.2e})")
        if diff > 4 * sigma + 1e-6 * abs(b.mean()):
            fail(f"tracer card vs CPU: {name} {a.mean()} vs {b.mean()}, "
                 f"4 sigma = {4 * sigma}")
    print(f"{tag} card vs CPU: every domain mean within 4 sigma (largest "
          f"{worst:.2f} sigma)")


def bw_phase(dev, card, record, replay):
    """7. The backward (camera) tracer: the headline frame (walk, field,
    lanes) through ``tools/bench_bw.py``, one profiled trace, ``cli_bw``
    at the RCEMIP extent (gas optics and render timed apart, exact
    gas-optics launch counts replayed against their twins, peak memory),
    ``cli_rt_lite --bw-raytracing``, the physics checks, and the card
    against the CPU.  Every line names the card."""
    import numpy as np
    import torch

    from rte_rrtmgp_torch import cli_bw, cli_rt_lite
    from rte_rrtmgp_torch.cases import inputs
    from rte_rrtmgp_torch.cases.profiles import make_atmosphere
    from rte_rrtmgp_torch.models import CloudLUT, KDist
    from rte_rrtmgp_torch.models import radiation_bw, raytracer_bw as rbw
    from rte_rrtmgp_torch.ops import kernels
    from rte_rrtmgp_torch.tools import bench_bw, bench_rt
    from rte_rrtmgp_torch.tools import set_virtual_camera as cam_tool
    from rte_rrtmgp_torch.utils.ncio import NcReader

    tag = f"[bw] ({card})"
    os.makedirs(BW_DIR, exist_ok=True)
    sync = torch.cuda.synchronize

    # ---- the headline frame (tools/bench_bw.py) ----
    print(f"{tag} frame: {BW_CAM}x{BW_CAM} px broadband fisheye, {BW_PPP} "
          f"photons a pixel (the JAX bench's 16 cut to {BW_PPP}: a frame's "
          "time is its grazing-ray tail of host-bound steps), 14 spectral "
          f"steps, {bench_bw.NX}x{bench_bw.NY}x{bench_bw.NZ} cells under "
          f"{bench_bw.NLAY} layers, knull {bench_bw.KNULL}")
    t0 = time.perf_counter()
    res = bench_bw.measure_bw(BW_CAM, BW_PPP, device=dev,
                              spectral_mode="lanes", steps_per_dispatch=None)
    rad = res["radiance"]
    if not (bool(torch.isfinite(rad).all()) and float(rad.min()) >= 0):
        fail("bw frame: radiance not finite and non-negative")
    print(f"{tag} frame, walk NEE, lanes (one window): "
          f"{res['ms_per_frame']:.1f} ms a frame (CUDA events), "
          f"{res['camera_rays_per_s']:.1f} camera rays/s, {res['steps']} "
          f"photon-loop steps, {res['sub_steps']} walk sub-steps "
          f"(+{res['prepass_sub_steps']} in the launch pre-pass), "
          f"{res['ms_per_step']:.3f} ms a step; radiance mean "
          f"{res['radiance_mean']:.6e}; {time.perf_counter() - t0:.1f} s with "
          "setup")
    for w, ph in res["phases"].items():
        n = max(ph["steps"], 1)
        print(f"{tag}   width {w}: {ph['steps']} steps, "
              f"{ph['sub_steps'] / n:.2f} walk sub-steps a step, "
              f"{ph['ms'] / n:.3f} ms a step (host clock)")

    # One profiled trace of the frame's 10th spectral step, cut at
    # BW_PROFILE_STEPS steps (all in the widest phase): device events a
    # step and the card's busy time, against the same steps unprofiled.
    from rte_rrtmgp_torch.tools.profile_stages import device_rows, profiled

    class _Captured(Exception):
        pass

    captured = {}

    def capture(*a, **kw):
        captured.update(a=a, kw=kw)
        raise _Captured

    render, _ = bench_bw.make_render(BW_CAM, BW_PPP, device=dev,
                                     steps=slice(9, 10))
    with Patch((rbw, "trace_rays_bw", capture)):
        try:
            render(7)
        except _Captured:
            pass
    kw = dict(captured["kw"], max_steps=BW_PROFILE_STEPS)
    trace = lambda: rbw.trace_rays_bw(*captured["a"], **kw)
    sync()
    t0 = time.perf_counter()
    trace()
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    (_, aux), prof = profiled(trace, dev)
    span = (time.perf_counter() - t0) * 1e3
    dev_rows = device_rows(prof)
    busy = sum(e.device_time_total for e in dev_rows) / 1e3
    events = sum(e.count for e in dev_rows)
    n = aux["steps"]
    print(f"{tag} profiled trace (g-point 10, its first {n} steps, width "
          f"{aux['phase_widths'][0]}, {aux['sub_steps']} walk sub-steps, "
          f"{aux['prepass_sub_steps']} in the pre-pass): device busy "
          f"{busy:.1f} ms in a profiled span of {span:.1f} ms "
          f"({busy / span:.1%}) and {busy / plain_ms:.1%} of the same trace "
          f"unprofiled ({plain_ms:.1f} ms, {plain_ms / n:.3f} ms a step); "
          f"{events} device events, {events / n:.1f} a step, "
          f"{events / max(n + aux['sub_steps'] + aux['prepass_sub_steps'], 1):.1f}"
          " a step or sub-step")
    for e in dev_rows[:6]:
        print(f"{tag}   {e.device_time_total / 1e3:9.3f} ms {e.count:7d}x "
              f"{e.key[:90]}")
    del prof, dev_rows, captured, render

    # ---- cli_bw at the RCEMIP extent ----
    t0 = time.perf_counter()
    paths = inputs.make_case_files(BW_DIR, "rcemip", gpt_per_band=1)
    with NcReader(paths["input"]) as nc:
        nx, ny, nlay = nc.dim("x"), nc.dim("y"), nc.dim("lay")
    atm = make_atmosphere(nx * ny, nlay, seed=0, perturb=True)
    inputs.write_input_nc(paths["input"], atm, nx, ny,
                          rt_grid={"nz": BW_CLI_NZ, "ngrid_x": 4,
                                   "ngrid_y": 4, "ngrid_z": 4, "sza": 0.6,
                                   "azi": 0.4})
    cam_tool.main(["--name", paths["input"], "--toa", "--nx", str(BW_CLI_CAM),
                   "--ny", str(BW_CLI_CAM)])
    with NcReader(paths["input"]) as nc:
        if nc.is_hdf5 or "camera-settings.nx" not in nc.variables():
            fail("cli_bw input: the camera is not in the classic form")
        camera = cam_tool.read_camera(nc)
        z = nc.read("z")
    grid_d = (float(z[1] - z[0]), 1000.0, 1000.0)
    print(f"{tag} cli_bw case: rcemip atmosphere {nx}x{ny} columns x {nlay} "
          f"layers, the lowest {BW_CLI_NZ} in 3D (dz {grid_d[0]:.4f} m) under "
          f"{nlay - BW_CLI_NZ} background layers, knull (4,4,4), TOA camera "
          f"{camera.nx}x{camera.ny} (classic camera-settings.* variables); "
          f"files {time.perf_counter() - t0:.2f} s")
    gases = make_atmosphere(1, nlay)["gas_concs"].names()
    kd = KDist.from_netcdf(paths["coefs_sw"], gases, device=dev)
    expected = {"gas_optics_interp": 1}
    files = ["--input", paths["input"], "--coefs-sw", paths["coefs_sw"],
             "--cloud-sw", paths["cloud_sw"]]
    # The broadband run takes the CLI's defaults (scan, one window) with
    # the field NEE; the image run the batched lanes with the walk.
    common = ["--cloud-optics", "--bw-raytracing", str(BW_CLI_PPP)]
    runs = {"broadband": ["--broadband", "--cloud-cam", "--nee-mode", "field"],
            "image": ["--image", "--n-sub", "2", "--spectral-mode", "lanes",
                      "--steps-per-dispatch", "off"]}
    timing = {}
    orig_planes = radiation_bw.gas_planes
    orig_solve = radiation_bw.RadiationSolverBW.solve

    def timed_planes(*a, **kw):
        sync()
        t = time.perf_counter()
        r = orig_planes(*a, **kw)
        sync()
        timing["gas"] = time.perf_counter() - t
        return r

    def timed_solve(self, *a, **kw):
        sync()
        t = time.perf_counter()
        r = orig_solve(self, *a, **kw)
        sync()
        timing["solve"] = time.perf_counter() - t
        return r

    timers = Patch((radiation_bw, "gas_planes", timed_planes),
                   (radiation_bw.RadiationSolverBW, "solve", timed_solve))
    for name, flags in runs.items():
        out_path = os.path.join(BW_DIR, f"out_{name}.nc")
        argv = files + common + flags + ["--output", out_path]
        print(f"{tag} cli_bw {name}: flags {' '.join(common + flags)}",
              flush=True)
        timing.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        rcs = []
        with timers:
            calls = record(lambda: rcs.append(cli_bw.main(argv)))
        sync()
        got = {k: len(v) for k, v in calls.items() if v}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        solve_ms, gas_ms = timing["solve"] * 1e3, timing["gas"] * 1e3
        print(f"{tag} cli_bw {name}: rc {rcs[0]}, {solve_ms:.1f} ms a solve = "
              f"gas optics {gas_ms:.1f} ms + render {solve_ms - gas_ms:.1f} ms;"
              f" peak device memory {peak:.3f} GiB; gas-optics launches {got}"
              f" (expected {expected})")
        if rcs[0] != 0 or got != expected:
            fail(f"cli_bw {name}: rc {rcs[0]}, launches {got}, expected "
                 f"{expected}")
        for kname, recs in calls.items():
            if recs:
                replay(kname, recs, f"cli_bw {name}")
        del calls
        with NcReader(out_path) as nc:
            out = {v: nc.read(v) for v in nc.variables()
                   if v not in ("x", "y", "n")}
        want = {"radiance"} | ({"XYZ"} if name == "image" else set()) | (
            {"liq_ice_wp_cam", "tau_cld_cam", "dist_cld_cam", "zen_cam"}
            if name == "broadband" else set())
        if set(out) != want or not all(np.isfinite(v).all()
                                       for v in out.values()):
            fail(f"cli_bw {name}: variables {sorted(out)} (expected "
                 f"{sorted(want)}) or non-finite values")
        rad = out["radiance"].astype(np.float64)
        if not (rad.min() >= 0 and rad.mean() > 0):
            fail(f"cli_bw {name}: radiance min {rad.min()} mean {rad.mean()}")
        print(f"{tag} cli_bw {name}: radiance mean {rad.mean():.6e} max "
              f"{rad.max():.6e}" + (
                  f"; XYZ means {out['XYZ'].reshape(3, -1).mean(1)}"
                  if name == "image" else ""))
        if name == "broadband":
            # The cloud-camera march is deterministic: the card's images
            # against the CPU's.
            clouds = {k: inputs_field(paths["input"], k, nlay, nx * ny)
                      for k in ("lwp", "iwp", "rel", "dei")}
            clut = CloudLUT.from_netcdf(paths["cloud_sw"], device="cpu")
            cpu_imgs = cli_bw.cloud_cam_images(
                camera, grid_d, (BW_CLI_NZ, ny, nx), kd, clut, clouds,
                torch.device("cpu"))
            for v, ref in zip(("liq_ice_wp_cam", "tau_cld_cam",
                               "dist_cld_cam", "zen_cam"), cpu_imgs):
                ref = ref.numpy()
                err = float(np.abs(out[v] - ref).max())
                scale = float(np.abs(ref).max())
                print(f"{tag} cloud camera {v}: card vs CPU max abs err "
                      f"{err:.3e} (max {scale:.4e})")
                if err > 1e-5 * scale:
                    fail(f"cloud camera {v}: card vs CPU {err:.3e} > 1e-5 x "
                         f"{scale:.4e}")

    # ---- cli_rt_lite --bw-raytracing on the bench optics ----
    lite_in = os.path.join(BW_DIR, "rt_lite_input.nc")
    lite_out = os.path.join(BW_DIR, "rt_lite_output.nc")
    bench_rt.write_lite_input(lite_in, RT_NZ, RT_NX, RT_NX)
    cam_tool.main(["--name", lite_in, "--toa", "--nx", str(BW_CLI_CAM), "--ny",
                   str(BW_CLI_CAM)])
    sync()
    t0 = time.perf_counter()
    rc = cli_rt_lite.main(["--input", lite_in, "--output", lite_out,
                           "--raytracing", "0", "--bw-raytracing",
                           str(BW_CLI_PPP)])
    dt = time.perf_counter() - t0
    with NcReader(lite_out) as nc:
        rad = nc.read("radiance").astype(np.float64)
        dims = (nc.dim("cam_y"), nc.dim("cam_x"))
    print(f"{tag} cli_rt_lite --bw-raytracing {BW_CLI_PPP} on the bench optics "
          f"({RT_NX}x{RT_NX}x{RT_NZ}, TOA camera {dims[1]}x{dims[0]}): rc {rc}, "
          f"{dt * 1e3:.1f} ms (read, render, write); radiance mean "
          f"{rad.mean():.6e}")
    if rc != 0 or dims != (BW_CLI_CAM, BW_CLI_CAM) or not (
            np.isfinite(rad).all() and rad.min() >= 0 and rad.mean() > 0):
        fail(f"cli_rt_lite --bw-raytracing: rc {rc}, dims {dims}, radiance "
             f"finite {np.isfinite(rad).all()} mean {rad.mean()}")

    # ---- physics checks (tests/test_raytracer_bw.py) ----
    def simple(device, seed, k_ext, ksg, cam, ppp, albedo=0.2, **kw):
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        sh = k_ext.shape
        zeros = torch.zeros(sh, dtype=torch.float32, device=device)
        (count, shot), aux = rbw.trace_rays_bw(
            rbw._key(seed), cam, t(k_ext), t(ksg), zeros, zeros, zeros, zeros,
            t([1e-9, 1e-9]), t([0.0, 0.0]), t(np.zeros((2, 3))),
            t([sh[0] * 500.0, sh[0] * 500.0 + 1000.0, sh[0] * 500.0 + 2000.0]),
            t(np.full(sh[1:], albedo)), t(np.ones(sh[1:])), (2, 2, 2),
            (500.0, 500.0, 500.0), np.array([0.6, 0.0, 0.8]), 0.8,
            photons_per_pixel=ppp, return_aux=True, **kw)
        return float(count.double().sum() / shot.double().sum()), aux

    sh = (4, 8, 8)
    toa8 = rbw.Camera(cam_type=2, nx=8, ny=8)
    t0 = time.perf_counter()
    vac, aux = simple(dev, 0, np.full(sh, 1e-9), np.zeros(sh), toa8, 64)
    expect = 0.2 * rbw.SUN_SOLID_ANGLE / np.pi
    print(f"{tag} vacuum Lambertian: {vac:.6e} a photon, expected "
          f"albedo*SUN_SOLID_ANGLE/pi = {expect:.6e} ({vac / expect - 1:+.3%};"
          f" {aux['steps']} steps)")
    if abs(vac / expect - 1) > 0.05:
        fail(f"vacuum Lambertian: {vac} vs {expect}")
    absorbed, _ = simple(dev, 1, np.full(sh, 2e-4), np.zeros(sh), toa8, 64)
    want = np.exp(-0.4 / 0.8 - 0.4)
    print(f"{tag} absorbing layer (tau 0.4): attenuation {absorbed / vac:.4f}, "
          f"expected exp(-tau (1/mu0 + 1)) = {want:.4f}")
    if abs(absorbed / vac / want - 1) > 0.1:
        fail(f"absorbing layer: {absorbed / vac} vs {want}")
    k3 = np.full(sh, 3e-4)
    means = {}
    for mode, kw in (("pool", dict(respawn_mode="pool")),
                     ("fifo", dict(respawn_mode="fifo"))):
        means[mode], aux = simple(dev, 0, k3, 0.9 * k3,
                                  rbw.Camera(cam_type=2, nx=32, ny=32), 128,
                                  albedo=0.3, **kw)
        if aux["rpl"] < 2:
            fail(f"fifo vs pool: {aux['rpl']} rays a lane, respawn never fires")
    zz = np.add.outer(np.arange(4) * 0.7, np.add.outer(np.arange(8) * 0.5,
                                                       np.arange(8) * 0.9))
    cloud = 0.4e-3 * (1.0 + np.sin(zz))
    for mode in ("walk", "field"):
        means["nee_" + mode], _ = simple(dev, 5, 2e-4 + cloud, 1e-4 + cloud,
                                         toa8, 128, albedo=0.25,
                                         nee_mode=mode)
    for a, b, tol in (("fifo", "pool", BW_MEANS_TOL["fifo"]),
                      ("nee_field", "nee_walk", BW_MEANS_TOL["field"])):
        rel = means[a] / means[b] - 1
        print(f"{tag} {a} vs {b}: {means[a]:.6e} vs {means[b]:.6e} a photon "
              f"({rel:+.3%}, limit {tol:.0%})")
        if abs(rel) > tol:
            fail(f"{a} vs {b}: {rel:+.3%}")
    print(f"{tag} physics checks: {time.perf_counter() - t0:.1f} s")

    # ---- the camera tracer on the card against the CPU ----
    rng = np.random.default_rng(2)
    shape = (6, 6, 6)
    kg = rng.uniform(2e-5, 1e-4, shape)
    cld = np.where(rng.random(shape) < 0.3, rng.uniform(5e-4, 2e-3, shape), 0.0)
    small = [kg + cld, 0.7 * kg, 0.99 * cld, np.zeros(shape),
             np.where(cld > 0, 0.85, 0.0), np.zeros(shape)]
    fish = rbw.Camera(cam_type=0, nx=6, ny=5, fov=170.0, pitch_deg=-40.0,
                      position=(1500.0, 1500.0, 300.0))

    def bw_mean(device, seed):
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        (c, _) = rbw.trace_rays_bw(
            rbw._key(seed), fish, *map(t, small), t([2e-6, 1e-6]),
            t([0.8, 0.9]), t(np.tile([1.0, 0.0, 0.0], (2, 1))),
            t([3000.0, 5000.0, 9000.0]), t(np.full(shape[1:], 0.2)),
            t(np.ones(shape[1:])), (2, 2, 2), (500.0, 500.0, 500.0),
            np.array([0.5, 0.3, np.sqrt(1 - 0.34)]), float(np.sqrt(1 - 0.34)),
            photons_per_pixel=16)
        return float(c.double().mean())

    a = np.array([bw_mean(dev, s) for s in range(BW_SEEDS)])
    b = np.array([bw_mean(torch.device("cpu"), s) for s in range(BW_SEEDS)])
    sigma = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / BW_SEEDS)
    diff = abs(a.mean() - b.mean())
    print(f"{tag} card vs CPU {shape}, fisheye 6x5 px, 16 ppp, {BW_SEEDS} "
          f"seeds each: count mean {a.mean():.6e} vs {b.mean():.6e}, "
          f"{diff / sigma:.2f} sigma of the difference ({sigma:.2e})")
    if not (a.mean() > 0 and diff <= 4 * sigma):
        fail(f"camera tracer card vs CPU: {a.mean()} vs {b.mean()}, 4 sigma "
             f"= {4 * sigma}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(dev, card, tables, args):
    """Phase 8: the sharding layer (``rte_rrtmgp_torch/parallel``) on the
    card.  The flagship step on a (4,) cols mesh and a (2, 2) cols x gpt
    mesh, each listing the card 4 times, and ``RadiationSolverLW/SW.solve(
    mesh=)`` on the (4,) mesh: each within ``STEP_TOL_WM2`` of the
    unsharded run, with its exact launch counts summed over the shards
    (each shard's counted from its own g-slice), ms/step beside the
    unsharded step's.  Then a one-process NCCL group (``initialize``, the
    sharded step, an all-reduce), two processes of
    ``tools/multihost_smoke.py`` sharing the card over gloo with the gpt
    axis across them (``MESH_PROC_COLS`` columns each), their ``RESULT``
    numbers (flux means and column-order check) within ``MESH_MEAN_RTOL``
    of each other and of the one-process
    run, and the gradient guard: a float32 step whose input requires grad
    raises, the float64 step's gradient on the card equals the CPU's
    within ``GRAD_RTOL``."""
    import numpy as np
    import torch

    from rte_rrtmgp_torch import step
    from rte_rrtmgp_torch.cases.profiles import make_atmosphere
    from rte_rrtmgp_torch.models import RadiationSolverLW, RadiationSolverSW
    from rte_rrtmgp_torch.ops import kernels
    from rte_rrtmgp_torch.parallel import distributed as dist
    from rte_rrtmgp_torch.parallel import make_mesh, shard_kdist
    from rte_rrtmgp_torch.parallel.sharded import sharded_step
    from rte_rrtmgp_torch.tools.multihost_smoke import (result_values,
                                                        slab_sums)
    from rte_rrtmgp_torch.tools.profile_stages import event_ms

    tag = "[mesh]"
    t_phase = time.perf_counter()
    kd_lw, kd_sw, cl_lw, cl_sw = tables

    def launches_of(fn):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in kernels.launch_counts().items() if v}

    def held(what, out, ref, got, want):
        worst = max(float((out[k] - ref[k]).abs().max()) for k in ref)
        print(f"{tag} {what}: max |diff| vs unsharded {worst:.3e} W m-2 "
              f"(limit {STEP_TOL_WM2}); launches {got} (expected {want})")
        if set(out) != set(ref) or worst > STEP_TOL_WM2:
            fail(f"{what}: {worst:.3e} W m-2 from the unsharded run")
        if got != want:
            fail(f"{what}: launches {got} != {want}")

    one = step.make_step(*tables, gpt_chunk=GPT_CHUNK)
    ref, _ = launches_of(lambda: one(*args))
    runs = {"unsharded": one}
    for shape in ((4,), (2, 2)):
        mesh = make_mesh(shape, devices=[dev] * 4)
        run = sharded_step(mesh, *tables, gpt_chunk=GPT_CHUNK)
        want = {}
        slices = zip(shard_kdist(kd_lw, mesh).local(),
                     shard_kdist(kd_sw, mesh).local())
        for (_, kl), (_, ks) in slices:
            shard = expected_launches(kl, ks, GPT_CHUNK)["default"]
            for k, v in shard.items():
                want[k] = want.get(k, 0) + v
        out, got = launches_of(lambda: run(*args))
        held(f"sharded_step {shape} mesh, card x4", out, ref, got, want)
        runs[f"mesh {shape}"] = run
    ms = {name: [] for name in runs}
    for _ in range(N_ROUNDS):
        for name, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(N_STEPS):
                run(*args)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) / N_STEPS * 1e3)
    for name, v in ms.items():
        print(f"{tag} {name}: {sorted(v)[len(v) // 2]:.3f} ms/step (median "
              f"of {N_ROUNDS} rounds of {N_STEPS} steps, in turns; rounds "
              f"{', '.join(f'{x:.3f}' for x in v)}); card {card}")

    # ---- solve(mesh=) on the (4,) mesh ----
    mesh4 = make_mesh((4,), devices=[dev] * 4)
    atm = make_atmosphere(NCOL, NLAY, seed=0)
    common = dict(gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
                  p_lev=atm["p_lev"], t_lay=atm["t_lay"], lwp=atm["lwp"],
                  iwp=atm["iwp"], rel=atm["rel"], dei=atm["dei"],
                  gpt_chunk=GPT_CHUNK)
    n_lw = expected_launches(kd_lw, kd_sw, GPT_CHUNK)["default"]["lw_sweep"]
    n_sw = expected_launches(kd_lw, kd_sw, GPT_CHUNK)["default"]["sw_2stream"]
    lw, sw = RadiationSolverLW(kd_lw, cl_lw), RadiationSolverSW(kd_sw, cl_sw)
    alb = np.full((NCOL, kd_sw.nbnd), 0.06)
    solves = {
        "LW": (lambda **kw: lw.solve(t_lev=atm["t_lev"], t_sfc=atm["t_sfc"],
                                     emis_sfc=np.full((NCOL, kd_lw.nbnd),
                                                      0.98),
                                     dtype=torch.float32, **common, **kw),
               {"gas_optics_interp": 4 * n_lw, "lw_sweep": 4 * n_lw}),
        "SW": (lambda **kw: sw.solve(mu0=atm["mu0"], sfc_alb_dir=alb,
                                     sfc_alb_dif=alb, delta_cloud=True,
                                     dtype=torch.float32, **common, **kw),
               {"gas_optics_interp": 4 * n_sw, "sw_2stream": 4 * n_sw})}
    for band, (solve, want) in solves.items():
        base, _ = launches_of(solve)
        out, got = launches_of(lambda: solve(mesh=mesh4))
        held(f"RadiationSolver{band}.solve(mesh=(4,) mesh)", out, base, got,
             want)
        t_one = event_ms(solve, dev, warmup=1, iters=3)
        t_mesh = event_ms(lambda: solve(mesh=mesh4), dev, warmup=1,
                          iters=3)
        print(f"{tag} {band} solve: {t_one:.3f} ms unsharded, {t_mesh:.3f} "
              f"ms on the (4,) mesh (host input preparation included); "
              f"card {card}")
    del runs, mesh4, solves

    # ---- a one-process NCCL group ----
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    gdev = dist.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    if torch.distributed.get_backend() != "nccl":
        fail("one process on its own card chose "
             f"{torch.distributed.get_backend()}")
    gmesh = dist.make_global_mesh()
    arrs = step.atmos_arrays(NCOL, NLAY, seed=0)
    local = tuple(arrs[k] for k in step.ARG_NAMES)
    gout = sharded_step(gmesh, *tables, gpt_chunk=GPT_CHUNK)(
        dist.host_shard_columns(gmesh, local))
    sums = slab_sums(gout, 0)
    torch.distributed.all_reduce(sums)
    torch.cuda.synchronize()
    one_proc = tuple(result_values(sums, *gout["lw_flux_up"].shape))
    dist.shutdown()
    held_means = tuple(result_values(slab_sums(ref, 0),
                                     *ref["lw_flux_up"].shape))
    print(f"{tag} NCCL group of one process on {gdev}: means lw_flux_up, "
          f"sw_flux_dn, order check {one_proc} (unsharded {held_means}), "
          f"{time.perf_counter() - t0:.1f} s")
    if not np.allclose(one_proc, held_means, rtol=MESH_MEAN_RTOL, atol=0):
        fail(f"NCCL one-process means {one_proc} vs {held_means}")

    # ---- two processes sharing the card over gloo, gpt across them ----
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, "-m", "rte_rrtmgp_torch.tools.multihost_smoke",
           "--device", f"cuda:{dev.index or 0}",
           "--gpt-shards", "2", "--ncol-per-process", str(MESH_PROC_COLS),
           "--nlay", str(NLAY), "--gpt-per-band", str(GPT_PER_BAND),
           "--gpt-chunk", str(GPT_CHUNK), "--coordinator",
           f"127.0.0.1:{port}", "--num-processes", "2"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=root,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=MESH_PROC_TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        fail(f"multihost_smoke did not finish in {MESH_PROC_TIMEOUT} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    results = {}
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            fail(f"multihost_smoke exited {p.returncode}: {se[-2000:]}")
        if "backend gloo" not in so:
            fail("a process sharing the card did not choose gloo")
        for line in so.splitlines():
            print(f"{tag} multihost_smoke: {line}")
            if line.startswith("RESULT"):
                _, pid, *values = line.split()
                results[int(pid)] = tuple(float(v) for v in values)
    if set(results) != {0, 1}:
        fail(f"multihost_smoke printed RESULT lines for {sorted(results)}")
    print(f"{tag} two gloo processes on the card, gpt across them: "
          f"{time.perf_counter() - t0:.1f} s")
    for pid, got in results.items():
        if not np.allclose(got, one_proc, rtol=MESH_MEAN_RTOL, atol=0):
            fail(f"process {pid} numbers {got} vs one process {one_proc}")

    # ---- the gradient guard ----
    small = step.atmos_arrays(GRAD_NCOL, NLAY, dtype=np.float32)
    t32 = [torch.as_tensor(small[k], device=dev) for k in step.ARG_NAMES]
    t32[4].requires_grad_()
    try:
        one(*t32)
        fail("a float32 step whose t_sfc requires grad did not raise")
    except RuntimeError as e:
        print(f"{tag} float32 step with t_sfc requiring grad raised: {e}")
    small = step.atmos_arrays(GRAD_NCOL, NLAY, dtype=np.float64)
    grads = []
    for where in (dev, torch.device("cpu")):
        tabs = step.build_tables(GPT_PER_BAND, dtype=torch.float64,
                                 device=where)
        a = [torch.as_tensor(small[k], device=where) for k in step.ARG_NAMES]
        a[4].requires_grad_()
        a[11].requires_grad_()
        out = step.make_step(*tabs, gpt_chunk=GPT_CHUNK)(*a)
        loss = out["lw_flux_up"][:, -1].sum() + out["sw_flux_dn"][:, 0].sum()
        grads.append([g.cpu() for g in
                      torch.autograd.grad(loss, (a[4], a[11]))])
    for name, gc, gh in zip(("t_sfc", "mu0"), *grads):
        rel = float((gc - gh).abs().max() / gh.abs().max())
        print(f"{tag} float64 gradient d(TOA LW up + sfc SW down)/d {name} "
              f"on the card vs the CPU ({GRAD_NCOL}x{NLAY}): max rel diff "
              f"{rel:.3e} (limit {GRAD_RTOL:g})")
        if not (bool(torch.isfinite(gc).all()) and rel <= GRAD_RTOL):
            fail(f"float64 gradient wrt {name}: {rel:.3e} from the CPU's")
    print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s")


def case_inputs(path):
    """Phase 5's case input as the CLI reads it (``cli.main``), as NumPy
    float64 arrays: (gas concentrations, the common solve arguments with
    clouds, LW-only, SW-only without the TSI scaling, (ny, nx, nlay))."""
    import numpy as np

    from rte_rrtmgp_torch.cli import GAS_NAMES_ALL, _read_field, _read_vmr
    from rte_rrtmgp_torch.models import GasConcs
    from rte_rrtmgp_torch.utils.ncio import NcReader

    with NcReader(path) as nc:
        nx, ny, nlay = nc.dim("x"), nc.dim("y"), nc.dim("lay")
        ncol = nx * ny
        f = lambda name, n: np.asarray(_read_field(nc, name, n, ncol),
                                       np.float64)
        r = lambda name, *shape: np.asarray(nc.read(name),
                                            np.float64).reshape(ncol, *shape)
        gas = GasConcs()
        for g in GAS_NAMES_ALL:
            _read_vmr(nc, g, gas, nlay, ncol)
        common = dict(gas_concs=gas, p_lay=f("p_lay", nlay),
                      p_lev=f("p_lev", nlay + 1), t_lay=f("t_lay", nlay),
                      col_dry=f("col_dry", nlay) if nc.has("col_dry")
                      else None,
                      **{k: f(k, nlay) for k in ("lwp", "iwp", "rel", "dei")})
        lw = dict(t_lev=f("t_lev", nlay + 1), t_sfc=r("t_sfc"),
                  emis_sfc=r("emis_sfc", -1))
        sw = dict(mu0=r("mu0"), sfc_alb_dir=r("sfc_alb_dir", -1),
                  sfc_alb_dif=r("sfc_alb_dif", -1), delta_cloud=True)
        tsi = r("tsi") if nc.has("tsi") else None
    return gas, common, lw, sw, tsi, (ny, nx, nlay)


def dtype_phase(dev, card, record, replay, paths, cli_broadband):
    """Phase 9: the solvers' ``dtype=`` at the RCEMIP extent, then the
    walkthroughs on the card (module docstring)."""
    import numpy as np
    import torch

    from rte_rrtmgp_torch import config
    from rte_rrtmgp_torch.cases import check
    from rte_rrtmgp_torch.data import synthetic
    from rte_rrtmgp_torch.examples import (basic_usage, multichip_sharding,
                                           raytrace_3d)
    from rte_rrtmgp_torch.models import (CloudLUT, KDist, RadiationSolverLW,
                                         RadiationSolverSW)
    from rte_rrtmgp_torch.ops import kernels
    from rte_rrtmgp_torch.tools.profile_stages import event_ms
    from rte_rrtmgp_torch.utils.ncio import NcReader

    tag = "[dtype]"
    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    gas, common, lw_kw, sw_kw, tsi, (ny, nx, nlay) = case_inputs(
        paths["input"])
    names = gas.names()
    tabs = {}
    for dt in (f32, f64):
        kd_lw = KDist.from_netcdf(paths["coefs_lw"], names, dtype=dt,
                                  device=dev)
        kd_sw = KDist.from_netcdf(paths["coefs_sw"], names, dtype=dt,
                                  device=dev)
        tabs[dt] = (RadiationSolverLW(kd_lw, CloudLUT.from_netcdf(
                        paths["cloud_lw"], dtype=dt, device=dev)),
                    RadiationSolverSW(kd_sw, CloudLUT.from_netcdf(
                        paths["cloud_sw"], dtype=dt, device=dev)))
    sw_kw["tsi_scaling"] = (
        np.ones(ny * nx) if tsi is None
        else tsi / tabs[f32][1].kdist.total_solar_irradiance())

    def pair(tables, dtype):
        """An LW + SW solve (the default layout, one chunk a spectrum)."""
        lw, sw = tabs[tables]
        out = lw.solve(**common, **lw_kw, dtype=dtype)
        out.update(sw.solve(**common, **sw_kw, dtype=dtype))
        return out

    def counted(fn):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in kernels.launch_counts().items() if v}

    def gap(a, b):
        return max(float((a[k].double() - b[k].double()).abs().max())
                   for k in a if k in b)

    want = {"gas_optics_interp": 2, "lw_sweep": 1, "sw_2stream": 1}
    print(f"{tag} the rcemip case at {ny}x{nx} columns x {nlay} layers, "
          "NumPy float64 inputs, clouds, one chunk a spectrum, the default "
          f"layout; card {card}")

    # (a) float32 tables, dtype=torch.float32: the kernels, recorded and
    # replayed against their twins.
    kernels.reset_launch_counts()
    box = {}
    calls = record(lambda: box.update(out=pair(f32, f32)))
    got = {k: v for k, v in kernels.launch_counts().items() if v}
    out_a = box.pop("out")
    print(f"{tag} (a) float32 tables, dtype=float32: launches {got} "
          f"(expected {want}); output dtype {out_a['lw_flux_up'].dtype}")
    if got != want or out_a["lw_flux_up"].dtype != f32:
        fail(f"dtype (a): launches {got}, dtype {out_a['lw_flux_up'].dtype}")
    for name, recs in calls.items():
        if recs:
            replay(name, recs, "dtype (a)")
    del calls
    with NcReader(cli_broadband) as nc:
        worst = {}
        for v in check.DEFAULT_VARS:
            a = out_a[v].double().cpu().numpy().T.reshape(nlay + 1, ny, nx)
            worst[v] = float(np.abs(a - nc.read(v)).max())
    print(f"{tag} (a) vs phase 5's broadband CLI run (W m-2): " + ", ".join(
        f"{k}={v:.3e}" for k, v in worst.items()))
    if max(worst.values()) > STEP_TOL_WM2:
        fail(f"dtype (a): {max(worst.values()):.3e} W m-2 from phase 5's run")

    # (b) float32 tables, dtype None: float64 (the dtype of p_lay), twins.
    ref64, got64 = counted(lambda: pair(f64, None))
    out_b, got_b = counted(lambda: pair(f32, None))
    # (c) float64 tables, dtype=float32: float64, twins.
    out_c, got_c = counted(lambda: pair(f64, f32))
    gaps = {"(b) vs float64 tables": gap(out_b, ref64),
            "(c) vs (b)": gap(out_c, out_b)}
    for what, out, got in (("(b) float32 tables, dtype None", out_b, got_b),
                           ("(c) float64 tables, dtype=float32", out_c,
                            got_c),
                           ("float64 tables, dtype None", ref64, got64)):
        dts = sorted({str(v.dtype) for v in out.values()})
        print(f"{tag} {what}: launches {got or 0}; output dtypes {dts}")
        if got or dts != ["torch.float64"]:
            fail(f"dtype {what}: launches {got}, output dtypes {dts}")
    print(f"{tag} gaps (W m-2, limit {DTYPE_GAP_WM2}): " + ", ".join(
        f"{k} {v:.3e}" for k, v in gaps.items()))
    if max(gaps.values()) > DTYPE_GAP_WM2:
        fail(f"dtype gaps {gaps} above {DTYPE_GAP_WM2} W m-2")
    del out_a, out_b, out_c, ref64
    for what, tables, dtype in (("(a) float32 tables, dtype=float32", f32,
                                 f32),
                                ("(b) float32 tables, dtype None", f32, None),
                                ("(c) float64 tables, dtype=float32", f64,
                                 f32)):
        ms = event_ms(lambda: pair(tables, dtype), dev, warmup=1,
                      iters=3) / 2
        print(f"{tag} {what}: {ms:.3f} ms a solve (LW + SW pair / 2, CUDA "
              f"events, mean of 3 pairs, host input preparation included); "
              f"card {card}")
    del tabs
    torch.cuda.empty_cache()

    # (d) the walkthroughs on the card.
    t0 = time.perf_counter()
    res, got = counted(lambda: basic_usage.main(dev))
    want = expected_launches(res["kd_lw"], res["kd_sw"], None)["default"]
    print(f"{tag} basic_usage: {time.perf_counter() - t0:.2f} s; launches "
          f"{got} (the two float32 solves in the default layout: {want}; "
          "the float64 gradient through the twins: none)")
    if got != want:
        fail(f"basic_usage launches {got}, expected {want}")
    kd_cpu = KDist.from_raw(synthetic.make_kdist_raw(True, gpt_per_band=4),
                            basic_usage.GASES, dtype=f32, device="cpu")
    g_cpu = basic_usage.olr_gradient(basic_usage.olr_function(
        kd_cpu, res["atm"], res["gas"], f64), f64, "cpu")
    rel = abs(res["dolr"] - g_cpu) / abs(g_cpu)
    print(f"{tag} basic_usage float64 d(OLR)/d(CO2 scale): card "
          f"{res['dolr']:.15g}, CPU {g_cpu:.15g}, {rel:.3e} relative "
          f"(limit {GRAD_RTOL:g})")
    if rel > GRAD_RTOL:
        fail(f"basic_usage gradient {rel:.3e} relative off the CPU's")
    del res

    t0 = time.perf_counter()
    res, got = counted(lambda: multichip_sharding.main(dev))
    n = 1 + res["shards"]
    print(f"{tag} multichip_sharding: {time.perf_counter() - t0:.2f} s; "
          f"{res['shards']} shards; launches {got} (1 + {res['shards']} LW "
          "solves, one chunk each)")
    if got.get("gas_optics_interp") != n or got.get("lw_sweep") != n:
        fail(f"multichip_sharding launches {got}: expected gas_optics_interp "
             f"and lw_sweep {n} times")
    del res

    t0 = time.perf_counter()
    res, got = counted(lambda: raytrace_3d.main(dev))
    print(f"{tag} raytrace_3d: {time.perf_counter() - t0:.2f} s; launches "
          f"{got} (pass 1's gas optics)")
    if not got.get("gas_optics_interp"):
        fail(f"raytrace_3d: no gas_optics_interp launch ({got})")
    del res
    print(f"{tag} phase 9: {time.perf_counter() - t_phase:.1f} s; card {card}")


def inputs_field(path, name, nlay, ncol):
    """An (ncol, nlay) field of a case input file (``cli._read_field``)."""
    from rte_rrtmgp_torch.cli import _read_field
    from rte_rrtmgp_torch.utils.ncio import NcReader

    with NcReader(path) as nc:
        return _read_field(nc, name, nlay, ncol)


def tools_phase(dev, card, tables, args):
    """10. The tools of ``rte_rrtmgp_torch/tools`` that drive the main path:
    crosscheck, profile_stages, ablate, bench_rt_solve, scaling_bench."""
    import torch

    from rte_rrtmgp_torch import step
    from rte_rrtmgp_torch.cases.profiles import make_atmosphere
    from rte_rrtmgp_torch.models import KDist
    from rte_rrtmgp_torch.ops import kernels
    from rte_rrtmgp_torch.tools import (ablate, bench_rt_solve, crosscheck,
                                        profile_stages, scaling_bench)

    tag = f"[tools] ({card})"
    t_phase = time.perf_counter()
    os.makedirs(TOOLS_DIR, exist_ok=True)

    # ---- crosscheck: allsky and aerosky, card f32 against the CPU ----
    t0 = time.perf_counter()
    res = crosscheck.run(os.path.join(TOOLS_DIR, "crosscheck"), device=dev)
    gases = make_atmosphere(1, 72)["gas_concs"].names()
    for case in crosscheck.CASES:
        r = res[case]
        kd_lw, kd_sw = (KDist.from_netcdf(os.path.join(
            TOOLS_DIR, "crosscheck", case, f"coefficients_{s}.nc"), gases,
            device=dev) for s in ("lw", "sw"))
        expected = {k: v for k, v in expected_launches(
            kd_lw, kd_sw, 64)["default"].items() if v}
        got = r["launches"]
        print(f"{tag} crosscheck {case}: card f32 vs CPU f32 (W m-2) " + ", ".join(
            f"{k}={v:.3e}" for k, v in r["dev_vs_cpu_f32"].items()))
        print(f"{tag} crosscheck {case}: CPU f32 vs CPU f64 (W m-2) " + ", ".join(
            f"{k}={v:.3e}" for k, v in r["cpu_f32_vs_f64"].items()))
        print(f"{tag} crosscheck {case}: launches {got} (default layout, "
              f"expected on the card {expected})")
        if got["dev_f32"] != expected or got["cpu_f64"] or got["cpu_f32"]:
            fail(f"crosscheck {case}: launches {got}, expected {expected} "
                 "on the card and none on the CPU")
    if not res["ok"]:
        fail("crosscheck: card f32 beyond 0.7 W m-2 of CPU f32")
    print(f"{tag} crosscheck passed (card f32 within "
          f"{crosscheck.GATE_WM2} W m-2 of CPU f32): "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- profile_stages: three layouts at the flagship shape, then the
    # default layout at the RCEMIP extent; the card's time by the driver's
    # stage ranges ----
    shapes = [(name, NCOL, NLAY) for name in LAYOUTS]
    shapes.append(("default", *TOOLS_BIG))
    for name, ncol, nlay in shapes:
        t0 = time.perf_counter()
        if (ncol, nlay) == (NCOL, NLAY):
            a = args
        else:
            arrs = step.atmos_arrays(ncol, nlay, seed=0)
            a = [torch.as_tensor(arrs[k], device=dev) for k in step.ARG_NAMES]
        r = profile_stages.profile(ncol, nlay, GPT_CHUNK, dev, tables=tables,
                                   **LAYOUTS[name])
        ref = step.make_step(*tables, gpt_chunk=GPT_CHUNK,
                             **LAYOUTS[name])(*a)
        print(f"{tag} profile_stages {ncol}x{nlay}, gpt_chunk {GPT_CHUNK}, "
              f"layout {r['layout']} (device ms a call, x calls, ms a step):")
        profile_stages.print_table(r, prefix=f"{tag}   ")
        worst = max(float((r["out"][k] - ref[k]).abs().max()) for k in ref)
        print(f"{tag}   stages {r['sum_ms']:.3f} of the step's "
              f"{r['device_ms']:.3f} device ms; profiled step vs make_step "
              f"{worst:.3e} W m-2; {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"profile_stages": {
            k: r[k] for k in ("stages", "calls", "sum_ms", "device_ms",
                              "other_ms", "event_ms", "layout", "shape")},
            "card": card}))
        if r["layout"] != name:
            fail(f"profile_stages: layout {r['layout']}, expected {name}")
        if worst > STEP_TOL_WM2 or sorted(r["out"]) != sorted(ref):
            fail(f"profile_stages {name} {ncol}x{nlay}: profiled step vs "
                 f"make_step {worst:.3e} W m-2")
        # Every stage's work counted once: the ranges hold all the card's
        # time but make_step's zero inputs.
        if not 0.9 * r["device_ms"] <= r["sum_ms"] <= r["device_ms"] * 1.001:
            fail(f"profile_stages {name} {ncol}x{nlay}: stages {r['sum_ms']}"
                 f" ms of the step's {r['device_ms']} device ms")
        del r, ref, a
        torch.cuda.empty_cache()

    # ---- ablate at the flagship shape ----
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    print(f"{tag} ablate {NCOL}x{NLAY}, full spectrum (ms a pipeline, "
          "delta from the previous of its spectrum):")
    abl = ablate.run(NCOL, NLAY, dev)
    got = {k: v for k, v in kernels.launch_counts().items() if v}
    print(f"{tag} ablate: {time.perf_counter() - t0:.1f} s; launches {got}")
    if not got.get("interp_rows") or set(got) != {"interp_rows"}:
        fail(f"ablate: launches {got}, expected interp_rows (B5) only")
    print(json.dumps({"ablate_ms": abl, "card": card}))
    torch.cuda.empty_cache()

    # ---- bench_rt_solve at its cut ----
    t0 = time.perf_counter()
    r = bench_rt_solve.measure(device=dev, **RT_SOLVE_CUT)
    out = r.pop("out")
    print(f"{tag} bench_rt_solve cut {RT_SOLVE_CUT} (the tool's defaults: "
          "gpt_per_band 16, 224 g-points in scan, one warm-up solve): "
          f"{r['value']:.2f} s a solve, {r['photons_per_s']:.1f} photons/s, "
          f"{r['ngpt']} g-points; toa_down {r['tod_dn_mean_wm2']:.4f} W m-2 "
          f"(exact {r['tod_dn_exact_wm2']:.4f}), energy closure "
          f"{r['closure']:+.4%}; {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"bench_rt_solve": r, "cut": RT_SOLVE_CUT, "card": card}))
    fields = [getattr(out, k) for k in out._fields if k.startswith("rt_flux")]
    if not all(bool(torch.isfinite(f).all()) for f in fields):
        fail("bench_rt_solve: non-finite MC fluxes")
    if abs(r["tod_dn_mean_wm2"] - r["tod_dn_exact_wm2"]) > \
            1e-5 * r["tod_dn_exact_wm2"]:
        fail(f"bench_rt_solve: toa_down {r['tod_dn_mean_wm2']}, exact "
             f"{r['tod_dn_exact_wm2']}")
    if abs(r["closure"]) > RT_CLOSURE:
        fail(f"bench_rt_solve: energy closure {r['closure']:+.4%}")
    del out, fields
    torch.cuda.empty_cache()

    # ---- scaling_bench: 1, 2, 4 positions, both modes ----
    t0 = time.perf_counter()
    for n in (1, 2, 4):
        arrs = step.atmos_arrays(SCALING_NCOL * n, NLAY, seed=0)
        ref = step.make_step(*tables, gpt_chunk=GPT_CHUNK)(
            *[torch.as_tensor(arrs[k], device=dev) for k in step.ARG_NAMES])
        for mode in ("annotate", "shardmap"):
            r, out = scaling_bench.measure(n, mode, tables, arrs, GPT_CHUNK,
                                           iters=3, device=dev)
            worst = max(float((out[k] - ref[k]).abs().max()) for k in ref)
            print(f"{tag} scaling_bench {json.dumps(r)}; vs the unsharded "
                  f"step {worst:.3e} W m-2")
            if worst > STEP_TOL_WM2:
                fail(f"scaling_bench {mode} {n}: {worst:.3e} W m-2 from the "
                     "unsharded step")
    print(f"{tag} scaling_bench: {time.perf_counter() - t0:.1f} s")
    print(f"{tag} phase 10: {time.perf_counter() - t_phase:.1f} s")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from rte_rrtmgp_torch import step
    from rte_rrtmgp_torch.ops import gas_optics as go
    from rte_rrtmgp_torch.ops import kernels, rte_lw, rte_sw
    from rte_rrtmgp_torch.ops.kernels import gas_optics_interp as k_interp
    from rte_rrtmgp_torch.ops.kernels import interp_rows as k_rows
    from rte_rrtmgp_torch.ops.kernels import solvers as k_solvers
    from rte_rrtmgp_torch.tools.profile_stages import event_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(card)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {count}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    info = kernels.build()
    print(f"[build] {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s, "
          f"cached={info['cached']}) -> {info['path']}")
    for line in info["log"].splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line \
                or "smem" in line:
            print(f"[build] {line.strip()}")

    # ---- tables and inputs of the main path ----
    t0 = time.perf_counter()
    tables = step.build_tables(GPT_PER_BAND, dtype=torch.float32, device=dev)
    kd_lw, kd_sw = tables[0], tables[1]
    arrs = step.atmos_arrays(NCOL, NLAY, seed=0)
    args = [torch.as_tensor(arrs[k], device=dev) for k in step.ARG_NAMES]
    arg = dict(zip(step.ARG_NAMES, args))
    torch.cuda.synchronize()
    expected = expected_launches(kd_lw, kd_sw, GPT_CHUNK)
    print(f"[setup] tables + atmosphere {time.perf_counter() - t0:.2f} s; "
          f"ngpt LW {kd_lw.ngpt} SW {kd_sw.ngpt}, {NCOL}x{NLAY}, "
          f"gpt_chunk {GPT_CHUNK}; expected launches per step {expected}")
    steps = {name: step.make_step(*tables, gpt_chunk=GPT_CHUNK, **kw)
             for name, kw in LAYOUTS.items()}

    # Every wrapper (module, name) and its plain twin, same signature.
    wrappers = {
        "gas_optics_interp": (k_interp, go.majmin_cells_plain),
        "interp_rows_multi": (k_rows, go.interp_rows_plain),
        "interp_rows": (k_rows, lambda table, rows, jes, fms, fp=None,
                        cms=None: go.interp_rows_plain(
                            [table], [rows], jes, fms, fp, [cms])[0]),
        "lw_sweep": (k_solvers, lambda *a, D, w:
                     rte_lw.lw_sweep_plain(*a, D, w)),
        "sw_2stream": (k_solvers, rte_sw.sw_2stream_plain),
        "lw_sweep_lm": (k_solvers, lambda *a, ncol, D, w:
                        rte_lw.lw_sweep_lm_plain(*a, ncol, D, w)),
        "sw_2stream_lm": (k_solvers, rte_sw.sw_2stream_lm_plain),
        "sw_2stream_fused": (k_solvers, rte_sw.sw_2stream_fused_plain),
        "sw_2stream_fused_lm": (k_solvers, rte_sw.sw_2stream_fused_lm_plain),
    }
    twins = Patch(*[(mod, name, twin)
                    for name, (mod, twin) in wrappers.items()])

    def gas_optics_call():
        """Full-width top-level gas optics (bottom-up inputs: the surface
        layer is 0)."""
        lw = go.gas_optics_lw(kd_lw, arg["p_lay"], arg["p_lev"],
                              arg["t_lay"], arg["t_lev"], arg["t_sfc"],
                              arg["vmr"], arg["col_dry"], sfc_lay=0)
        sw = go.gas_optics_sw(kd_sw, arg["p_lay"], arg["p_lev"],
                              arg["t_lay"], arg["vmr"], arg["col_dry"])
        return dict(lw_tau=lw[0].tau, sfc_src=lw[1].sfc_src,
                    lay_src=lw[1].lay_src, lev_src=lw[1].lev_src,
                    sw_tau=sw[0].tau, ssa=sw[0].ssa)

    # ---- 3. every kernel launch, replayed against its twin ----
    def record(fn):
        calls = {name: [] for name in wrappers}

        def recorder(name, kern):
            def rec(*a, **kw):
                calls[name].append((a, kw))
                return kern(*a, **kw)
            return rec
        with Patch(*[(mod, name, recorder(name, getattr(mod, name)))
                     for name, (mod, _) in wrappers.items()]):
            fn()
        torch.cuda.synchronize()
        return calls

    def interp_call(a, kw):
        kd, interp, play, tlay, col_gas = a
        rayleigh = kw["rayleigh"]
        tab_b = kd.krayl_rows if rayleigh else kd.planck_rows
        C, L = interp.tropo.shape
        G = kd.kmajor_rows.shape[2]
        specs = go.minor_specs(kd)
        in_b = nbytes(kd.kmajor_rows, tab_b, interp.jtemp0, interp.jpress0,
                      interp.itropo01, interp.jeta0, interp.col_mix,
                      interp.fminor, interp.fmajor, play, tlay, col_gas)
        if specs:
            in_b += nbytes(kd.kminor_lower_trows, kd.kminor_upper_trows)
        out_b = 2 * C * L * G * 4
        # ops: 20 for tau's major sum, 17 (planck) or 8 (krayl) for the
        # second output, 9 per minor contributor of the cell's atmosphere.
        n_up = int(interp.itropo01.sum())
        n_lo = C * L - n_up
        contrib = sum((s.gpt_end - s.gpt_start) * (n_up if atm else n_lo)
                      for atm, s in specs)
        ops = C * L * G * (20 + (8 if rayleigh else 17)) + 9 * contrib
        kern = lambda: k_interp.gas_optics_interp(*a, rayleigh=rayleigh)
        plain = lambda: go.majmin_cells_plain(*a, rayleigh)
        label = (f"{'SW' if rayleigh else 'LW'} {C}x{L} G={G} "
                 f"minor={len(specs)}")
        nent = k_interp._minor_entries(tuple(specs), G, dev)[2]
        geo = k_interp.interp_geometry(C, L, G, kd.nflav, len(specs), nent,
                                       col_gas.shape[-1], k_interp.TILE_CELLS,
                                       k_interp.THREADS)
        return label, kern, plain, in_b + out_b, ops, geo.describe()

    def rows_ops(rows_list, cms_list):
        # per output element: 4 corners 2 x (two pressure blends, the eta
        # pair, the sum) = 20 (+2 with col_mix); 2 corners 2 x (eta pair,
        # sum) = 8 (+2 with col_mix)
        return sum((20 if r.shape[1] == 4 else 8) + (2 if c is not None else 0)
                   for r, c in zip(rows_list, cms_list))

    def rows_multi_call(a, kw):
        tables, rows_list, jes, fms, fp, cms_list = a
        N, G = jes[0].shape
        b = (nbytes(*tables, *rows_list, *jes, *fms, fp)
             + sum(nbytes(*c) for c in cms_list if c is not None)
             + len(tables) * N * G * 4)
        kern = lambda: k_rows.interp_rows_multi(*a)
        plain = lambda: go.interp_rows_plain(*a)
        return (f"N={N} G={G} ops={len(tables)}", kern, plain, b,
                N * G * rows_ops(rows_list, cms_list), "thread per (cell, g)")

    def rows_call(a, kw):
        table, rows, jes, fms = a
        fp, cms = kw.get("fp"), kw.get("cms")
        N, G = jes[0].shape
        b = (nbytes(table, rows, *jes, *fms, fp)
             + (nbytes(*cms) if cms is not None else 0) + N * G * 4)
        kern = lambda: (k_rows.interp_rows(*a, **kw),)
        plain = lambda: tuple(go.interp_rows_plain([table], [rows], jes, fms,
                                                   fp, [cms]))
        return (f"N={N} G={G} corners={rows.shape[1]}", kern, plain, b,
                N * G * rows_ops([rows], [cms]), "thread per (cell, g)")

    def lw_geometry(C, L, G):
        return k_solvers.lw_geometry(C, L, G, k_solvers.LW_BLOCK_G)

    def lw_call(a, kw):
        tau = a[0]
        C, L, G = tau.shape
        kern = lambda: k_solvers.lw_sweep(*a, **kw)
        plain = lambda: rte_lw.lw_sweep_plain(*a, kw["D"], kw["w"])
        return (f"G={G}", kern, plain, nbytes(*a) + 3 * C * (L + 1) * 4,
                25 * C * L * G, lw_geometry(C, L, G).describe())

    def lw_lm_call(a, kw):
        tau, lev = a[0], a[2]
        NL, G = tau.shape
        C = kw["ncol"]
        kern = lambda: k_solvers.lw_sweep_lm(*a, **kw)
        plain = lambda: rte_lw.lw_sweep_lm_plain(*a, C, kw["D"], kw["w"])
        b = (nbytes(*[x for x in a if torch.is_tensor(x)], *lev)
             + 3 * (NL + C) * 4)
        return (f"G={G}", kern, plain, b, 25 * NL * G,
                lw_geometry(C, NL // C, G).describe())

    def sw_call(name, a, kw):
        tau = a[0]
        G = tau.shape[-1]
        C = a[3].shape[0]
        nlev = tau.numel() // (C * G) + 1
        kern = lambda: getattr(k_solvers, name)(*a, **kw)
        plain = lambda: wrappers[name][1](*a, **kw)
        geo = k_solvers.sw_geometry(C, nlev - 1, G, k_solvers.SW_TILE)
        return (f"G={G}", kern, plain,
                nbytes(*[x for x in a if torch.is_tensor(x)]) + 3 * C * nlev * 4,
                80 * tau.numel(), geo.describe())

    def sw_fused_call(name, a, kw):
        """A fused SW launch: the gas pair, the increments (clouds, then
        aerosols) and the bands, then the plane entries' other inputs."""
        tau_abs, _, incs, bands, mu0 = a[:5]
        G = tau_abs.shape[-1]
        C = mu0.shape[0]
        nlev = tau_abs.numel() // (C * G) + 1
        kern = lambda: getattr(k_solvers, name)(*a, **kw)
        plain = lambda: wrappers[name][1](*a, **kw)
        geo = k_solvers.sw_geometry(C, nlev - 1, G, k_solvers.SW_TILE,
                                    gpt2band=bands, ninc=len(incs))
        b = (nbytes(*[x for x in a if torch.is_tensor(x)],
                    *[t for op in incs for t in (op.tau, op.ssa, op.g)])
             + 3 * C * nlev * 4)
        # ~15 operations a (cell, g) for the combination and each
        # increment, on top of the plane entry's 80.
        return (f"G={G} increments={len(incs)}", kern, plain, b,
                (80 + 15 * (1 + len(incs))) * tau_abs.numel(),
                geo.describe())

    makers = {"gas_optics_interp": interp_call,
              "interp_rows_multi": rows_multi_call, "interp_rows": rows_call,
              "lw_sweep": lw_call, "lw_sweep_lm": lw_lm_call,
              "sw_2stream": lambda a, kw: sw_call("sw_2stream", a, kw),
              "sw_2stream_lm": lambda a, kw: sw_call("sw_2stream_lm", a, kw),
              "sw_2stream_fused": lambda a, kw: sw_fused_call(
                  "sw_2stream_fused", a, kw),
              "sw_2stream_fused_lm": lambda a, kw: sw_fused_call(
                  "sw_2stream_fused_lm", a, kw)}

    def replay(name, recs, tag):
        """Each recorded launch through its kernel and its twin: agreement,
        then CUDA-event times.  Returns the sums over the launches."""
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, b_bytes=0.0,
                   b_ops=0.0)
        for a, kw in recs:
            label, kern, plain, b_bytes, ops, geom = makers[name](a, kw)
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            errs = []
            for g, r in zip(got, ref):
                if g.shape != r.shape:
                    fail(f"{name} {label}: shape {tuple(g.shape)} vs {tuple(r.shape)}")
                if not bool(torch.isfinite(g).all()):
                    fail(f"{name} {label}: non-finite kernel output")
                err = float((g - r).abs().max())
                scale = float(r.abs().max())
                errs.append(err)
                if err > REL_TOL * scale:
                    fail(f"{name} {label}: max abs err {err:.3e} > "
                         f"{REL_TOL:g} * max {scale:.4e}")
            del got, ref
            ms = event_ms(kern, dev, warmup=3, iters=20)
            plain_ms = event_ms(plain, dev, warmup=1, iters=3)
            b_ms, b_by = bound(b_bytes, ops)
            print(f"[kernel] {tag} {name} {label}: max abs err {max(errs):.3e} "
                  f"(tol {REL_TOL:g} x output max) ms {ms:.4f} plain_ms "
                  f"{plain_ms:.3f} bound_ms {b_ms:.4f} ({b_by}: "
                  f"{b_bytes / 1e6:.1f} MB, {ops / 1e9:.3f} Gop) share of "
                  f"bound {b_ms / ms:.3f} library_ms null; {geom}")
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += b_ms
            tot["b_bytes"] += b_bytes
            tot["b_ops"] += ops
            tot["err"] = max(tot["err"], max(errs))
        return tot

    def peak_extra(fn, out_floats):
        """Device bytes ``fn`` allocates beyond ``out_floats`` floats of
        outputs, measured."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base - 4 * out_floats
        del out
        return extra

    def sw_scratch(name, a, kw):
        """Device bytes one SW launch allocates beyond its outputs (up, dn,
        dir and the returned dn + dir), measured, and the wrapper's own
        count."""
        fused = name in LAUNCHED_AS
        C = a[4 if fused else 3].shape[0]
        G = a[0].shape[-1]
        nlev = a[0].numel() // (C * G) + 1
        extra = peak_extra(lambda: getattr(k_solvers, name)(*a, **kw),
                           4 * C * nlev)
        bands = dict(gpt2band=a[3], ninc=len(a[2])) if fused else {}
        geo = k_solvers.sw_geometry(C, nlev - 1, G, k_solvers.SW_TILE,
                                    **bands)
        return extra, 4 * geo.scratch_floats, C, nlev - 1, G

    def lw_scratch(name, a, kw):
        """Device bytes one LW launch allocates beyond its outputs (up, dn,
        jac), measured, and the wrapper's own count."""
        C = a[3].shape[0]
        G = a[0].shape[-1]
        L = a[0].numel() // (C * G)
        extra = peak_extra(lambda: getattr(k_solvers, name)(*a, **kw),
                           3 * C * (L + 1))
        return extra, 4 * lw_geometry(C, L, G).scratch_floats, C, L, G

    per_layout = {}
    for layout, run_step in steps.items():
        calls = record(lambda: run_step(*args))
        got = recorded(calls)
        if got != expected[layout]:
            fail(f"{layout}: launches recorded in one step {got}, expected "
                 f"{expected[layout]}")
        for tag, name, scratch in (
                ("sw", "sw_2stream", sw_scratch),
                ("sw", "sw_2stream_lm", sw_scratch),
                ("sw", "sw_2stream_fused", sw_scratch),
                ("sw", "sw_2stream_fused_lm", sw_scratch),
                ("lw", "lw_sweep", lw_scratch),
                ("lw", "lw_sweep_lm", lw_scratch)):
            if calls[name]:
                extra, helper, C, L, G = scratch(name, *calls[name][0])
                print(f"[{tag}] {layout} {name} device scratch at {C}x{L} "
                      f"G={G}: {helper} B by the wrapper's geometry, {extra} "
                      "B allocated beyond the outputs (measured)")
                if helper or extra > 1 << 20:
                    fail(f"{name}: device scratch at {L} layers")
        per_layout[layout] = {LAUNCHED_AS.get(name, name):
                              replay(name, recs, layout)
                              for name, recs in calls.items() if recs}
        del calls
    calls = record(gas_optics_call)
    if {k: len(v) for k, v in calls.items() if v} != {"interp_rows": 6}:
        fail("gas_optics_lw + gas_optics_sw: expected 6 interp_rows launches, "
             f"got {({k: len(v) for k, v in calls.items()})}")
    gas_tot = replay("interp_rows", calls["interp_rows"], "gas_optics")
    del calls
    print(f"[kernel] gas_optics_lw + gas_optics_sw (full width, 6 launches of "
          f"interp_rows): kernel ms {gas_tot['ms']:.4f} plain_ms "
          f"{gas_tot['plain_ms']:.3f} bound_ms {gas_tot['bound_ms']:.4f}")
    with twins:
        plain_gas = gas_optics_call()
    kern_gas = gas_optics_call()
    torch.cuda.synchronize()
    for k, v in kern_gas.items():
        err = float((v - plain_gas[k]).abs().max())
        scale = float(plain_gas[k].abs().max())
        if not bool(torch.isfinite(v).all()) or err > REL_TOL * scale:
            fail(f"gas_optics {k}: max abs err {err:.3e} vs plain path "
                 f"(max {scale:.4e}) or non-finite values")
    print("[gas_optics] gas_optics_lw/sw outputs within "
          f"{REL_TOL:g} x max of the plain path: {sorted(kern_gas)}")
    del kern_gas, plain_gas

    # ---- 4. the full steps ----
    launches, outs = {}, {}
    t_sfc = arg["t_sfc"]
    ngpt = kd_lw.ngpt + kd_sw.ngpt
    for layout, run_step in steps.items():
        kernels.reset_launch_counts()
        out = run_step(*args)
        torch.cuda.synchronize()
        launches[layout] = {k: v for k, v in kernels.launch_counts().items()
                            if v}
        print(f"[step] {layout}: launches in one step: {launches[layout]}")
        if launches[layout] != expected[layout]:
            fail(f"{layout}: launch counts {launches[layout]} != "
                 f"{expected[layout]}")

        for k, v in out.items():
            if tuple(v.shape) != (NCOL, NLAY + 1) or not bool(torch.isfinite(v).all()):
                fail(f"{layout} output {k}: shape {tuple(v.shape)} or "
                     "non-finite values")
        ratio = out["lw_flux_up"][:, 0] / (SIGMA * t_sfc ** 4)
        if not (0.5 <= float(ratio.min()) and float(ratio.max()) <= 1.05):
            fail(f"{layout}: LW surface up / sigma T^4 in "
                 f"[{float(ratio.min()):.3f}, {float(ratio.max()):.3f}], "
                 "expected within [0.5, 1.05]")
        if not bool((out["sw_flux_up"][:, -1] < out["sw_flux_dn"][:, -1]).all()):
            fail(f"{layout}: SW TOA up >= TOA in for some column")
        print(f"[step] {layout} physics: LW sfc up / sigma T^4 in "
              f"[{float(ratio.min()):.3f}, {float(ratio.max()):.3f}]; SW TOA "
              "up < TOA in for all columns")

        kernels.reset_launch_counts()
        with twins:
            plain_out = run_step(*args)
        torch.cuda.synchronize()
        if any(kernels.launch_counts().values()):
            fail(f"{layout}: the plain-twin step launched a kernel")
        refs = {"plain twins": plain_out}
        if layout != "default":
            refs["default layout"] = outs["default"]
        for what, ref in refs.items():
            worst = {k: float((out[k] - ref[k]).abs().max()) for k in out}
            print(f"[step] {layout} vs {what} (W m-2): " + ", ".join(
                f"{k}={v:.3e}" for k, v in sorted(worst.items())))
            if max(worst.values()) > STEP_TOL_WM2:
                fail(f"{layout} vs {what}: {max(worst.values()):.3e} W m-2 > "
                     f"{STEP_TOL_WM2}")
        del plain_out, refs
        outs[layout] = out

        if "--profile" in argv:
            from rte_rrtmgp_torch.tools.profile_stages import profiled
            _, prof = profiled(lambda: run_step(*args), dev)
            print(f"[profile] {layout}")
            print(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=25))

    # Step times: the layouts in turns, N_ROUNDS rounds of N_STEPS
    # synchronized steps each; the median round and the spread.
    ms = {layout: [] for layout in steps}
    for _ in range(N_ROUNDS):
        for layout, run_step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(N_STEPS):
                run_step(*args)
            torch.cuda.synchronize()
            ms[layout].append((time.perf_counter() - t0) / N_STEPS * 1e3)
    for layout, v in ms.items():
        med = sorted(v)[len(v) // 2]
        print(f"[step] {layout}: {med:.3f} ms/step (median of {N_ROUNDS} "
              f"rounds of {N_STEPS} steps, layouts in turns; rounds "
              f"{', '.join(f'{x:.3f}' for x in v)}), "
              f"{NCOL * ngpt / med * 1e3:.4e} col*gpt/s ({NCOL}x{NLAY}, "
              f"{ngpt} g-points)")

    # ---- 5. the CLI, the case tools and the RFMIP sweep ----
    del steps, outs
    torch.cuda.empty_cache()
    case_paths, cli_broadband = cli_phase(dev, twins, record, replay,
                                          lw_scratch)

    # ---- 6. the forward Monte-Carlo tracer ----
    torch.cuda.empty_cache()
    tracer_phase(dev, card, record, replay)

    # ---- 7. the backward (camera) tracer ----
    torch.cuda.empty_cache()
    bw_phase(dev, card, record, replay)

    # ---- 8. the sharding layer ----
    torch.cuda.empty_cache()
    mesh_phase(dev, card, tables, args)

    # ---- 9. the solvers' dtype and the walkthroughs ----
    torch.cuda.empty_cache()
    dtype_phase(dev, card, record, replay, case_paths, cli_broadband)

    # ---- 10. the tools around the main path ----
    torch.cuda.empty_cache()
    tools_phase(dev, card, tables, args)

    # ---- 11. result lines ----
    rows = []
    for name, meta in KERNEL_INFO.items():
        layout = meta["layout"]
        tot = per_layout[layout][name]
        _, b_by = bound(tot["b_bytes"], tot["b_ops"])
        rows.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], layout=layout,
            launches=launches[layout][name], max_abs_err=tot["err"],
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=b_by, library_ms=None))
    b1_lm = per_layout["layer_major"]["gas_optics_interp"]
    print(f"[result] gas_optics_interp in the layer_major layout: "
          f"{launches['layer_major']['gas_optics_interp']} launches, ms "
          f"{b1_lm['ms']:.4f} plain_ms {b1_lm['plain_ms']:.3f} bound_ms "
          f"{b1_lm['bound_ms']:.4f} max abs err {b1_lm['err']:.3e}")
    print(f"[result] kernel ms, plain_ms and bound_ms are per step (sums over "
          f"the step's launches in the kernel's layout); card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
