#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``rte_rrtmgp_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py            # ~1-2 minutes, builds the kernels
    python3 chip_smoke.py --profile  # adds a torch.profiler table of one step

Phases (any failure ends the run with a nonzero exit):

1. Card: name, power limit and device count.  No card -> exit 2.
2. Build: compiles ``rte_rrtmgp_torch/csrc/*.cu`` with nvcc for sm_90a and
   prints the build seconds and the ``-Xptxas -v`` register / shared-memory
   / spill lines.
3. Kernels: every launch the flagship step makes (2048 columns x 72 layers,
   256 LW + 224 SW g-points, gpt_chunk 128, float32) is recorded with its
   real inputs; each is replayed through its kernel and its plain PyTorch
   twin on the card and held to ``REL_TOL`` of the output's largest value,
   then both are timed with CUDA events beside the computed bound.
4. Full step through ``step.make_step``: launch counts of one step (with
   the counts set to 0 just before), ms/step and col*gpt/s over a few
   synchronized steps, physics sanity, and the step's fluxes against the
   same step with the plain twins on the card.
5. One line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.
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
STEP_TOL_WM2 = 0.1             # step with kernels vs step with twins
SIGMA = 5.670374419e-8
EXPECTED_LAUNCHES = {"gas_optics_interp": 4, "lw_sweep": 2, "sw_2stream": 2}
KERNEL_INFO = {
    "gas_optics_interp": dict(
        source="rte_rrtmgp_torch/csrc/gas_optics_interp.cu",
        replaces="rte_rrtmgp_tpu/ops/pallas/interp_kernel.py:725"),
    "lw_sweep": dict(
        source="rte_rrtmgp_torch/csrc/lw_sweep.cu",
        replaces="rte_rrtmgp_tpu/ops/pallas/solver_kernels.py:127"),
    "sw_2stream": dict(
        source="rte_rrtmgp_torch/csrc/sw_2stream.cu",
        replaces="rte_rrtmgp_tpu/ops/pallas/solver_kernels.py:272"),
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


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from rte_rrtmgp_torch import step
    from rte_rrtmgp_torch.ops import gas_optics as go
    from rte_rrtmgp_torch.ops import kernels, rte_lw, rte_sw
    from rte_rrtmgp_torch.ops.kernels import gas_optics_interp as k_interp
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
    torch.cuda.synchronize()
    print(f"[setup] tables + atmosphere {time.perf_counter() - t0:.2f} s; "
          f"ngpt LW {kd_lw.ngpt} SW {kd_sw.ngpt}, {NCOL}x{NLAY}, "
          f"gpt_chunk {GPT_CHUNK}")
    run_step = step.make_step(*tables, gpt_chunk=GPT_CHUNK)

    # ---- 3. every kernel launch of one step, replayed against its twin ----
    calls = {"gas_optics_interp": [], "lw_sweep": [], "sw_2stream": []}

    def recorder(name, fn):
        def rec(*a, **kw):
            calls[name].append((a, kw))
            return fn(*a, **kw)
        return rec

    with Patch((k_interp, "gas_optics_interp",
                recorder("gas_optics_interp", k_interp.gas_optics_interp)),
               (k_solvers, "lw_sweep", recorder("lw_sweep", k_solvers.lw_sweep)),
               (k_solvers, "sw_2stream",
                recorder("sw_2stream", k_solvers.sw_2stream))):
        run_step(*args)
    torch.cuda.synchronize()

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
        label = f"{'SW' if rayleigh else 'LW'} G={G} minor={len(specs)}"
        return label, kern, plain, in_b + out_b, ops

    def lw_call(a, kw):
        tau = a[0]
        C, L, G = tau.shape
        in_b = nbytes(*a)
        ops = 25 * C * L * G
        kern = lambda: k_solvers.lw_sweep(*a, **kw)
        plain = lambda: rte_lw.lw_sweep_plain(*a, kw["D"], kw["w"])
        return f"G={G}", kern, plain, in_b + 3 * C * (L + 1) * 4, ops

    def sw_call(a, kw):
        tau = a[0]
        C, L, G = tau.shape
        in_b = nbytes(*[x for x in a if torch.is_tensor(x)])
        ops = 80 * C * L * G
        kern = lambda: k_solvers.sw_2stream(*a, **kw)
        plain = lambda: rte_sw.sw_2stream_plain(*a, **kw)
        return f"G={G}", kern, plain, in_b + 3 * C * (L + 1) * 4, ops

    makers = {"gas_optics_interp": interp_call, "lw_sweep": lw_call,
              "sw_2stream": sw_call}
    per_kernel = {}
    for name, recs in calls.items():
        if len(recs) != EXPECTED_LAUNCHES[name]:
            fail(f"{name}: {len(recs)} launches recorded in one step, "
                 f"expected {EXPECTED_LAUNCHES[name]}")
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, b_bytes=0.0,
                   b_ops=0.0)
        for a, kw in recs:
            label, kern, plain, b_bytes, ops = makers[name](a, kw)
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
            ms = cuda_ms(kern, warmup=3, iters=20)
            plain_ms = cuda_ms(plain, warmup=1, iters=3)
            b_ms, b_by = bound(b_bytes, ops)
            print(f"[kernel] {name} {label}: max abs err {max(errs):.3e} "
                  f"(tol {REL_TOL:g} x output max) ms {ms:.4f} plain_ms "
                  f"{plain_ms:.3f} bound_ms {b_ms:.4f} ({b_by}: "
                  f"{b_bytes / 1e6:.1f} MB, {ops / 1e9:.3f} Gop) library_ms null")
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += b_ms
            tot["b_bytes"] += b_bytes
            tot["b_ops"] += ops
            tot["err"] = max(tot["err"], max(errs))
        per_kernel[name] = tot
    del calls

    # ---- 4. the full step ----
    kernels.reset_launch_counts()
    out = run_step(*args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"[step] launches in one step: {launches}")
    if launches != EXPECTED_LAUNCHES:
        fail(f"launch counts {launches} != {EXPECTED_LAUNCHES}")

    n_steps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        run_step(*args)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / n_steps
    ngpt = kd_lw.ngpt + kd_sw.ngpt
    print(f"[step] {sec * 1e3:.3f} ms/step over {n_steps} steps, "
          f"{NCOL * ngpt / sec:.4e} col*gpt/s ({NCOL}x{NLAY}, {ngpt} g-points)")

    for k, v in out.items():
        if tuple(v.shape) != (NCOL, NLAY + 1) or not bool(torch.isfinite(v).all()):
            fail(f"step output {k}: shape {tuple(v.shape)} or non-finite values")
    t_sfc = args[step.ARG_NAMES.index("t_sfc")]
    ratio = out["lw_flux_up"][:, 0] / (SIGMA * t_sfc ** 4)
    if not (0.5 <= float(ratio.min()) and float(ratio.max()) <= 1.05):
        fail(f"LW surface up / sigma T^4 in [{float(ratio.min()):.3f}, "
             f"{float(ratio.max()):.3f}], expected within [0.5, 1.05]")
    if not bool((out["sw_flux_up"][:, -1] < out["sw_flux_dn"][:, -1]).all()):
        fail("SW TOA up >= TOA in for some column")
    print(f"[step] physics: LW sfc up / sigma T^4 in [{float(ratio.min()):.3f}, "
          f"{float(ratio.max()):.3f}]; SW TOA up < TOA in for all columns")

    twins = Patch(
        (k_interp, "gas_optics_interp",
         lambda kd, interp, sc, rayleigh: go.majmin_plain(kd, interp, sc, rayleigh)),
        (k_solvers, "lw_sweep",
         lambda *a, D, w: rte_lw.lw_sweep_plain(*a, D, w)),
        (k_solvers, "sw_2stream", rte_sw.sw_2stream_plain))
    kernels.reset_launch_counts()
    with twins:
        plain_out = run_step(*args)
    torch.cuda.synchronize()
    if any(kernels.launch_counts().values()):
        fail("the plain-twin step launched a kernel")
    worst = {k: float((out[k] - plain_out[k]).abs().max()) for k in out}
    print("[step] vs plain twins (W m-2): " + ", ".join(
        f"{k}={v:.3e}" for k, v in sorted(worst.items())))
    if max(worst.values()) > STEP_TOL_WM2:
        fail(f"step vs plain twins {max(worst.values()):.3e} W m-2 > {STEP_TOL_WM2}")

    if "--profile" in argv:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_step(*args)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))

    # ---- 5. result lines ----
    rows = []
    for name, tot in per_kernel.items():
        _, b_by = bound(tot["b_bytes"], tot["b_ops"])
        rows.append(dict(
            name=name, route="cuda", **KERNEL_INFO[name],
            launches=launches[name], max_abs_err=tot["err"],
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=b_by, library_ms=None))
    print(f"[result] kernel ms, plain_ms and bound_ms are per step (sums over "
          f"the step's launches); card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
