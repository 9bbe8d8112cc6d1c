#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``rte_rrtmgp_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py            # under a minute, builds the kernels
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
5. One line ``{"kernels": [...]}`` (each kernel's numbers from the layout
   that runs it), then the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
N_ROUNDS, N_STEPS = 3, 5       # step timing
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


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def cuda_ms(fn, warmup: int, iters: int) -> float:
    """Mean ms of ``fn`` on the card (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def expected_launches(kd_lw, kd_sw):
    """Exact kernel launches of one step in each layout.  ``interp_rows``
    runs once per chunk that has minor intervals, counted from the
    chunked k-distributions."""
    from rte_rrtmgp_torch.models.radiation import _chunks

    n_minor = sum(bool(c.minor_lower or c.minor_upper)
                  for kd in (kd_lw, kd_sw)
                  for c in (kd.slice_gpt(g0, g1)
                            for g0, g1 in _chunks(kd.ngpt, GPT_CHUNK)))
    return {
        "default": {"gas_optics_interp": 4, "lw_sweep": 2, "sw_2stream": 2},
        "cellw_off": {"interp_rows_multi": 4, "interp_rows": n_minor,
                      "lw_sweep": 2, "sw_2stream": 2},
        "layer_major": {"gas_optics_interp": 4, "lw_sweep_lm": 2,
                        "sw_2stream_lm": 2},
    }


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
    expected = expected_launches(kd_lw, kd_sw)
    print(f"[setup] tables + atmosphere {time.perf_counter() - t0:.2f} s; "
          f"ngpt LW {kd_lw.ngpt} SW {kd_sw.ngpt}, {NCOL}x{NLAY}, "
          f"gpt_chunk {GPT_CHUNK}; expected launches per step {expected}")
    steps = {name: step.make_step(*tables, gpt_chunk=GPT_CHUNK, **kw)
             for name, kw in LAYOUTS.items()}

    # Every wrapper (module, name) and its plain twin, same signature.
    wrappers = {
        "gas_optics_interp": (k_interp, lambda kd, interp, sc, rayleigh:
                              go.majmin_plain(kd, interp, sc, rayleigh)),
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
        kd, interp, sc = a
        rayleigh = kw["rayleigh"]
        tab_b = kd.krayl_rows if rayleigh else kd.planck_rows
        C, L = interp.tropo.shape
        G = kd.kmajor_rows.shape[2]
        specs = go.minor_specs(kd)
        in_b = nbytes(kd.kmajor_rows, tab_b, interp.jtemp0, interp.jpress0,
                      interp.itropo01, interp.jeta0, interp.col_mix,
                      interp.fminor, interp.fmajor, sc)
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
        kern = lambda: k_interp.gas_optics_interp(kd, interp, sc,
                                                  rayleigh=rayleigh)
        plain = lambda: go.majmin_plain(kd, interp, sc, rayleigh)
        label = (f"{'SW' if rayleigh else 'LW'} {C}x{L} G={G} "
                 f"minor={len(specs)}")
        nent = k_interp._minor_entries(tuple(specs), G, dev)[2]
        geo = k_interp.interp_geometry(C, L, G, kd.nflav, len(specs), nent,
                                       k_interp.TILE_CELLS, k_interp.THREADS)
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
        geo = k_solvers.sw_geometry(C, nlev - 1, G, k_solvers.SW_TILE,
                                    k_solvers.SW_THREADS)
        return (f"G={G}", kern, plain,
                nbytes(*[x for x in a if torch.is_tensor(x)]) + 3 * C * nlev * 4,
                80 * tau.numel(), geo.describe())

    makers = {"gas_optics_interp": interp_call,
              "interp_rows_multi": rows_multi_call, "interp_rows": rows_call,
              "lw_sweep": lw_call, "lw_sweep_lm": lw_lm_call,
              "sw_2stream": lambda a, kw: sw_call("sw_2stream", a, kw),
              "sw_2stream_lm": lambda a, kw: sw_call("sw_2stream_lm", a, kw)}

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
            ms = cuda_ms(kern, warmup=3, iters=20)
            plain_ms = cuda_ms(plain, warmup=1, iters=3)
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
        C = a[3].shape[0]
        G = a[0].shape[-1]
        nlev = a[0].numel() // (C * G) + 1
        extra = peak_extra(lambda: getattr(k_solvers, name)(*a, **kw),
                           4 * C * nlev)
        geo = k_solvers.sw_geometry(C, nlev - 1, G, k_solvers.SW_TILE,
                                    k_solvers.SW_THREADS)
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
        got = {k: len(v) for k, v in calls.items() if v}
        if got != expected[layout]:
            fail(f"{layout}: launches recorded in one step {got}, expected "
                 f"{expected[layout]}")
        for tag, name, scratch in (
                ("sw", "sw_2stream", sw_scratch),
                ("sw", "sw_2stream_lm", sw_scratch),
                ("lw", "lw_sweep", lw_scratch),
                ("lw", "lw_sweep_lm", lw_scratch)):
            if calls[name]:
                extra, helper, C, L, G = scratch(name, *calls[name][0])
                print(f"[{tag}] {layout} {name} device scratch at {C}x{L} "
                      f"G={G}: {helper} B by the wrapper's geometry, {extra} "
                      "B allocated beyond the outputs (measured)")
                if helper or extra > 1 << 20:
                    fail(f"{name}: device scratch at {L} layers")
        per_layout[layout] = {name: replay(name, recs, layout)
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
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_step(*args)
                torch.cuda.synchronize()
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

    # ---- 5. result lines ----
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
